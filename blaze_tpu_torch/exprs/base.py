"""Physical expression base: evaluation over ColumnBatch (port of the part
of blaze_tpu/exprs/base.py the port uses).

An expression evaluates a ColumnBatch to a `ColVal`, in one of two forms,
as in the JAX package:

  * device form: a (data, validity) pair of tensors over the batch's
    capacity, for fixed-width values;
  * host form: an Arrow array of exactly `num_rows`, for utf8 values (a
    utf8 column or literal).

Decimal values belong to the strings/decimals slice (ROADMAP item 13).
"""

from __future__ import annotations

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

    @property
    def is_device(self) -> bool:
        return self.data is not None

    def to_host(self, num_rows: int) -> pa.Array:
        """The first `num_rows` values as an Arrow array (a device copy
        for the device form)."""
        if self.array is not None:
            return self.array.slice(0, num_rows)
        return DeviceColumn(self.dtype, self.data,
                            self.validity).to_arrow(num_rows)

    def to_device(self, capacity: int) -> "ColVal":
        if not self.is_device:
            raise NotImplementedError(
                f"{self.dtype} values stay on the host in the PyTorch port "
                f"(ROADMAP Queue 1 item 13)")
        return self

    def to_column(self, capacity: int, device: torch.device):
        """The value as a batch column.  A fixed-width value computed on
        the host (a utf8 comparison's bools) is uploaded: fixed-width
        columns live on the device, as in the JAX package."""
        if self.is_device:
            return DeviceColumn(self.dtype, self.data, self.validity)
        if self.dtype.is_fixed_width:
            return DeviceColumn.from_arrow(self.array, self.dtype, capacity,
                                           device)
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

    def __repr__(self):
        cs = ", ".join(repr(c) for c in self.children())
        return f"{type(self).__name__}({cs})"


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

    def __repr__(self):
        return f"#{self.index}" + (f"({self.name})" if self.name else "")


@dataclass(frozen=True, repr=False)
class Literal(PhysicalExpr):
    """Scalar literal of a fixed-width type (device form) or utf8 (host
    form, `num_rows` copies, as the JAX package evaluates it)."""

    value: Any
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        if self.dtype.id == TypeId.UTF8:
            return ColVal(self.dtype, array=pa.array(
                [self.value] * batch.num_rows, type=pa.string()))
        if not self.dtype.is_fixed_width or self.dtype.id.value == "decimal":
            raise NotImplementedError(
                f"{self.dtype} literals belong to the strings/decimals "
                f"slice of the PyTorch port (ROADMAP Queue 1 item 13)")
        cap = batch.capacity
        dev = batch.device
        dt = self.dtype.torch_dtype()
        if self.value is None:
            return ColVal(self.dtype, torch.zeros(cap, dtype=dt, device=dev),
                          torch.zeros(cap, dtype=torch.bool, device=dev))
        return ColVal(self.dtype,
                      torch.full((cap,), self.value, dtype=dt, device=dev),
                      torch.ones(cap, dtype=torch.bool, device=dev))

    def __repr__(self):
        return f"lit({self.value!r})"

