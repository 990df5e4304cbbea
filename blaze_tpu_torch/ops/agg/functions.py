"""Aggregate functions: the parts the planner and the fused aggregation
read (port of SumAgg/CountAgg/MinMaxAgg of blaze_tpu/ops/agg/functions.py).

This slice runs aggregation only through the fused hash lane
(plan/fused.py), which reads each function's kind, its accumulator fields
and its output type.  The segmented-sort update/merge phases of the
generic AggExec, and every other function (avg, first, collect, bloom,
UDAF), belong to a later slice.
"""

from __future__ import annotations

from typing import List, Sequence

from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.schema import (DataType, Field, FLOAT64, INT64, Schema,
                                    TypeId)


class AggFunction:
    """One aggregate function instance bound to its input expressions."""

    name = "agg"

    def __init__(self, children: Sequence[PhysicalExpr]):
        self.children = list(children)
        self.input_type = None

    def bind(self, input_schema: Schema) -> None:
        if self.children:
            self.input_type = self.children[0].data_type(input_schema)

    def acc_fields(self, input_schema: Schema) -> List[Field]:
        """Accumulator columns as materialized in partial batches."""
        raise NotImplementedError

    def output_type(self, input_schema: Schema) -> DataType:
        raise NotImplementedError


def _out_num_type(dt: DataType) -> DataType:
    """Spark sum result types: int sums are int64, float sums float64."""
    if dt.id == TypeId.DECIMAL:
        raise NotImplementedError(
            "decimal sums belong to the strings/decimals slice of the "
            "PyTorch port (ROADMAP Queue 1 item 13)")
    if dt.id in (TypeId.FLOAT32, TypeId.FLOAT64):
        return FLOAT64
    return INT64


class SumAgg(AggFunction):
    name = "sum"

    def acc_fields(self, s):
        return [Field("sum", _out_num_type(self.children[0].data_type(s)))]

    def output_type(self, s):
        return _out_num_type(self.children[0].data_type(s))


class CountAgg(AggFunction):
    """count(expr), or count(*) when there is no child (never null)."""

    name = "count"

    def acc_fields(self, s):
        return [Field("count", INT64, nullable=False)]

    def output_type(self, s):
        return INT64


class MinMaxAgg(AggFunction):
    def __init__(self, children, minimum: bool):
        super().__init__(children)
        self.minimum = minimum
        self.name = "min" if minimum else "max"

    def acc_fields(self, s):
        return [Field(self.name, self.children[0].data_type(s))]

    def output_type(self, s):
        return self.children[0].data_type(s)


def make_agg(name: str, children: Sequence[PhysicalExpr],
             **_kw) -> AggFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(children)
    if name == "count":
        return CountAgg(children)
    if name in ("min", "max"):
        return MinMaxAgg(children, minimum=(name == "min"))
    raise NotImplementedError(
        f"aggregate function {name!r} belongs to a later slice of the "
        f"PyTorch port (ROADMAP Queue 1 item 5); this slice has sum, "
        f"count, min and max")
