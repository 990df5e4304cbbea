"""Physical expression base: evaluation over ColumnBatch (port of the part
of blaze_tpu/exprs/base.py the q01 filter uses).

An expression evaluates a ColumnBatch to a `ColVal`: a (data, validity)
pair of tensors over the batch's capacity.  This slice has column
references and literals of fixed-width types; host (var-width) values
belong to the strings slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence

import torch

from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn
from blaze_tpu_torch.schema import DataType, Schema


@dataclass
class ColVal:
    """Evaluated column value in device form."""

    dtype: DataType
    data: torch.Tensor      # (capacity,)
    validity: torch.Tensor  # (capacity,) bool

    def to_device(self, capacity: int) -> "ColVal":
        return self

    def to_column(self, capacity: int) -> DeviceColumn:
        return DeviceColumn(self.dtype, self.data, self.validity)

    def as_mask(self, batch: ColumnBatch) -> torch.Tensor:
        """SQL predicate -> bool over capacity (null counts as False)."""
        return self.data.to(torch.bool) & self.validity


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
        if not isinstance(col, DeviceColumn):
            raise NotImplementedError(
                f"column {self.index} ({col.dtype}) is a host column: "
                f"expressions over var-width values belong to the strings "
                f"slice of the PyTorch port (ROADMAP Queue 1 item 13)")
        return ColVal(col.dtype, col.data, col.validity)

    def __repr__(self):
        return f"#{self.index}" + (f"({self.name})" if self.name else "")


@dataclass(frozen=True, repr=False)
class Literal(PhysicalExpr):
    """Scalar literal of a fixed-width type."""

    value: Any
    dtype: DataType

    def data_type(self, schema: Schema) -> DataType:
        return self.dtype

    def evaluate(self, batch: ColumnBatch) -> ColVal:
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

