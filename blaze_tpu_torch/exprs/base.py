"""Physical expression base: evaluation over ColumnBatch (port of the part
of blaze_tpu/exprs/base.py the port uses).

An expression evaluates a ColumnBatch to a `ColVal`, in one of two forms,
as in the JAX package:

  * device form: a (data, validity) pair of tensors over the batch's
    capacity, for fixed-width values;
  * host form: an Arrow array of exactly `num_rows`, for variable-width
    values (utf8, binary, list, struct, map) and for fixed-width values
    a host function computed (a string length, a predicate's bools).

A value evaluated from a `Literal` is marked `literal`, so a function can
take a constant argument without reading every row.  A decimal of
precision <= 18 is fixed-width (its unscaled int64 values on the device);
a wider one is a host value (a decimal128 Arrow array).
"""

from __future__ import annotations

import decimal as pydec
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.batch import (ColumnBatch, DeviceColumn, HostColumn,
                                   to_device)
from blaze_tpu_torch.schema import DataType, Schema, TypeId

@dataclass
class ColVal:
    """Evaluated column value: device (padded) or host (exact-length)
    form."""

    dtype: DataType
    data: Optional[torch.Tensor] = None      # (capacity,) device form
    validity: Optional[torch.Tensor] = None  # (capacity,) bool
    array: Optional[pa.Array] = None         # num_rows long, host form
    literal: bool = False                    # evaluated from a Literal

    @property
    def is_device(self) -> bool:
        return self.data is not None

    @staticmethod
    def device(dtype: DataType, data: torch.Tensor,
               validity: Optional[torch.Tensor] = None) -> "ColVal":
        """Device form; no validity means every row is valid."""
        if validity is None:
            validity = torch.ones(data.shape[0], dtype=torch.bool,
                                  device=data.device)
        return ColVal(dtype, data, validity)

    @staticmethod
    def host(dtype: DataType, array: pa.Array) -> "ColVal":
        return ColVal(dtype, array=array)

    def to_host(self, num_rows: int) -> pa.Array:
        """The first `num_rows` values as an Arrow array (a device copy
        for the device form)."""
        if self.array is not None:
            return self.array.slice(0, num_rows)
        return DeviceColumn(self.dtype, self.data,
                            self.validity).to_arrow(num_rows)

    def to_device(self, capacity: int,
                  device: Optional[torch.device] = None) -> "ColVal":
        """The device form: a fixed-width host value is uploaded, padded
        to `capacity`, onto `device` (the configured one when None)."""
        if self.is_device:
            return self
        if not self.dtype.is_fixed_width:
            raise TypeError(f"{self.dtype} values have no device form")
        if device is None:
            from blaze_tpu_torch.device import resolve
            device = resolve()
        arr = self.array
        if not arr.type.equals(self.dtype.to_arrow()):
            arr = arr.cast(self.dtype.to_arrow())
        dc = DeviceColumn.from_arrow(arr, self.dtype, capacity, device)
        return ColVal(self.dtype, dc.data, dc.validity, literal=self.literal)

    def to_column(self, capacity: int, device: torch.device):
        """The value as a batch column.  A fixed-width value computed on
        the host (a utf8 comparison's bools, an exact decimal product of
        precision <= 18) is uploaded: fixed-width columns live on the
        device, as in the JAX package; a wider decimal stays a host
        column."""
        if self.is_device:
            return DeviceColumn(self.dtype, self.data, self.validity)
        if self.dtype.is_fixed_width:
            v = self.to_device(capacity, device)
            return DeviceColumn(self.dtype, v.data, v.validity)
        return HostColumn(self.dtype, self.array)

    def as_mask(self, batch: ColumnBatch) -> torch.Tensor:
        """SQL predicate -> bool over capacity on the batch's device (null
        counts as False)."""
        if self.is_device:
            return self.data.to(torch.bool) & self.validity
        vals = self.array.slice(0, batch.num_rows)
        padded = np.zeros(batch.capacity, dtype=bool)
        padded[:len(vals)] = np.asarray(vals.fill_null(False), dtype=bool)
        return to_device(padded, batch.device)


class PhysicalExpr:
    """Base physical expression."""

    def data_type(self, schema: Schema) -> DataType:
        raise NotImplementedError

    def children(self) -> Sequence["PhysicalExpr"]:
        return ()

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        raise NotImplementedError

    def cache_key(self) -> Any:
        """Hashable identity of what the expression computes: its class
        and fields, children by their own keys (the evaluator's
        per-batch cache and the program fingerprints read it).  A
        stateful expression keys on its identity, so it is never
        shared."""
        import dataclasses
        if not dataclasses.is_dataclass(self):
            return (type(self).__name__, id(self))
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, PhysicalExpr):
                parts.append(v.cache_key())
            elif isinstance(v, (tuple, list)):
                parts.append(tuple(_key_part(x) for x in v))
            else:
                parts.append(repr(v))
        return (type(self).__name__, *parts)

    def __repr__(self):
        cs = ", ".join(repr(c) for c in self.children())
        return f"{type(self).__name__}({cs})"


def _key_part(x):
    if isinstance(x, PhysicalExpr):
        return x.cache_key()
    if isinstance(x, (tuple, list)):
        return tuple(_key_part(y) for y in x)
    return repr(x)


@dataclass(frozen=True, repr=False)
class BoundReference(PhysicalExpr):
    """Column by ordinal."""

    index: int
    name: str = ""

    def data_type(self, schema: Schema) -> DataType:
        return schema[self.index].data_type

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        col = batch.columns[self.index]
        if isinstance(col, HostColumn):
            return ColVal(col.dtype, array=col.array)
        return ColVal(col.dtype, col.data, col.validity)

    def cache_key(self):
        return ("col", self.index)

    def __repr__(self):
        return f"#{self.index}" + (f"({self.name})" if self.name else "")


@dataclass(frozen=True, repr=False)
class Literal(PhysicalExpr):
    """Scalar literal of a fixed-width type (device form) or of a
    variable-width one (host form, `num_rows` copies, as the JAX package
    evaluates it)."""

    value: Any
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        value = self.value
        if self.dtype.id == TypeId.DECIMAL and value is not None:
            value = decimal_value(value, self.dtype.scale)
        if not self.dtype.is_fixed_width:
            return ColVal(self.dtype, array=pa.array(
                [value] * batch.num_rows, type=self.dtype.to_arrow()),
                literal=True)
        cap = batch.capacity
        dev = batch.device
        dt = self.dtype.torch_dtype()
        if value is None:
            return ColVal(self.dtype, torch.zeros(cap, dtype=dt, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev),
                          literal=True)
        if self.dtype.id == TypeId.DECIMAL:
            # the unscaled value, value x 10^scale, exactly
            value = int(value.scaleb(self.dtype.scale))
        return ColVal(self.dtype,
                      torch.full((cap,), value, dtype=dt, device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev),
                      literal=True)

    def cache_key(self):
        # the whole type and the value's repr: -0.0 stays apart from 0.0,
        # and one decimal value apart at two scales
        return ("lit", repr(self.dtype), type(self.value).__name__,
                repr(self.value))

    def __repr__(self):
        return f"lit({self.value!r})"


def decimal_value(value: Any, scale: int) -> pydec.Decimal:
    """A decimal literal's value (a Decimal, int, float or string) as a
    Decimal at `scale`, exactly (HALF_UP where it has more digits; a float
    reads as its shortest repr, 1.2 as 1.2)."""
    if isinstance(value, float):
        value = repr(value)
    with pydec.localcontext() as ctx:
        ctx.prec = 76
        return pydec.Decimal(value).quantize(pydec.Decimal(1).scaleb(-scale),
                                             rounding=pydec.ROUND_HALF_UP)
