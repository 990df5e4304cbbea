"""Comparisons and AND with Spark null semantics (port of the part of
blaze_tpu/exprs/binary.py the q01 filter uses).

  * comparisons `>= <= < > =` promote mismatched widths like Spark (the
    widest type wins); the result is NULL where either side is NULL, and
    NaN == NaN is false;
  * AND is Kleene three-valued logic: FALSE AND NULL is FALSE.

Arithmetic, OR, `!=`, `<=>` and decimal/string operands belong to later
slices and raise NotImplementedError.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass

import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.schema import BOOL, DataType, Schema, TypeId

_CMP = {">=": operator.ge, "<=": operator.le, "<": operator.lt,
        ">": operator.gt, "==": operator.eq}
_BOOLEAN = {"and"}


def _check_op(op: str) -> None:
    if op not in _CMP and op not in _BOOLEAN:
        raise NotImplementedError(
            f"binary operator {op!r} belongs to a later slice of the "
            f"PyTorch port (ROADMAP Queue 1 item 3); this slice has "
            f">= <= < > == and")


@dataclass(frozen=True, repr=False)
class BinaryExpr(PhysicalExpr):
    op: str
    left: PhysicalExpr
    right: PhysicalExpr

    def __post_init__(self):
        _check_op(self.op)

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema: Schema) -> DataType:
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        a = self.left.evaluate(batch)
        b = self.right.evaluate(batch)
        for side in (a, b):
            if side.dtype.id == TypeId.DECIMAL:
                raise NotImplementedError(
                    "decimal comparisons belong to the strings/decimals "
                    "slice of the PyTorch port (ROADMAP Queue 1 item 13)")
        if self.op == "and":
            return _kleene_and(a, b)
        return _compare(self.op, a, b)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _kleene_and(a: ColVal, b: ColVal) -> ColVal:
    av, bv = a.validity, b.validity
    ad = a.data.to(torch.bool)
    bd = b.data.to(torch.bool)
    data = ad & bd
    # known when both are valid, or either side is a known False
    valid = (av & bv) | (av & ~ad) | (bv & ~bd)
    return ColVal(BOOL, data & valid, valid)


def _compare(op: str, a: ColVal, b: ColVal) -> ColVal:
    dt = torch.promote_types(a.data.dtype, b.data.dtype)
    data = _CMP[op](a.data.to(dt), b.data.to(dt))
    valid = a.validity & b.validity
    return ColVal(BOOL, data & valid, valid)

