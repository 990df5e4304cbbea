"""Aggregate functions over segmented (sort-based) group layouts (port of
SumAgg, CountAgg, AvgAgg and MinMaxAgg of blaze_tpu/ops/agg/functions.py).

Groups arrive as sorted segments with dense group ids (ops/agg/exec.py),
so every accumulator update is one segmented reduction on the batch's
device (kernels/sort.py).  An accumulator is a tuple of (data, validity)
tensors indexed by group id.  The fused lanes (plan/fused.py) read only
each function's kind, accumulator fields and output type.

first and collect (item 13), bloom (item 11) and UDAFs (item 16) belong
to later slices, and so do decimal sums and averages and min/max over
strings (a host accumulator in the JAX package; item 13).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.schema import (DataType, Field, FLOAT64, INT64, Schema,
                                    TypeId)

Acc = Tuple[torch.Tensor, torch.Tensor]  # (data, validity) per group


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

    def partial_update(self, args: List[Acc], gids: torch.Tensor,
                       num_segments: int) -> Tuple[Acc, ...]:
        """Raw inputs (gathered in group order) -> per-group
        accumulators."""
        raise NotImplementedError

    def partial_merge(self, accs: List[Acc], gids: torch.Tensor,
                      num_segments: int) -> Tuple[Acc, ...]:
        """Partial accumulator columns (in group order) -> combined
        accumulators."""
        raise NotImplementedError

    def final_eval(self, accs: List[Acc]) -> Acc:
        """Combined accumulators -> the result column."""
        raise NotImplementedError

    @property
    def is_host(self) -> bool:
        return False


def _out_num_type(dt: DataType) -> DataType:
    """Spark sum/avg accumulator types: int sums are int64, float sums
    float64."""
    if dt.id == TypeId.DECIMAL:
        raise NotImplementedError(
            "decimal sums and averages belong to the strings/decimals "
            "slice of the PyTorch port (ROADMAP Queue 1 item 13)")
    if dt.id in (TypeId.FLOAT32, TypeId.FLOAT64):
        return FLOAT64
    return INT64


def _acc_dtype(data: torch.Tensor) -> torch.dtype:
    return torch.float64 if data.dtype.is_floating_point else torch.int64


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=like.device)


class SumAgg(AggFunction):
    name = "sum"

    def acc_fields(self, s):
        return [Field("sum", _out_num_type(self.children[0].data_type(s)))]

    def output_type(self, s):
        return _out_num_type(self.children[0].data_type(s))

    def partial_update(self, args, gids, n):
        data, valid = args[0]
        s = K.segment_sum(data.to(_acc_dtype(data)), gids, n, valid)
        has = K.segment_count(valid, gids, n) > 0
        return ((s, has),)

    def partial_merge(self, accs, gids, n):
        data, valid = accs[0]
        s = K.segment_sum(data, gids, n, valid)
        has = K.segment_count(valid, gids, n) > 0
        return ((s, has),)

    def final_eval(self, accs):
        return accs[0]


class CountAgg(AggFunction):
    """count(expr), or count(*) when there is no child (never null)."""

    name = "count"

    def acc_fields(self, s):
        return [Field("count", INT64, nullable=False)]

    def output_type(self, s):
        return INT64

    def partial_update(self, args, gids, n):
        if self.children:
            _, valid = args[0]
        else:
            valid = _ones(gids.shape[0], gids)
        return ((K.segment_count(valid, gids, n), _ones(n, gids)),)

    def partial_merge(self, accs, gids, n):
        data, valid = accs[0]
        c = K.segment_sum(data, gids, n, valid)
        return ((c, _ones(c.shape[0], c)),)

    def final_eval(self, accs):
        data, _ = accs[0]
        return data, _ones(data.shape[0], data)


class AvgAgg(AggFunction):
    """avg: a (sum, count) accumulator; the sum is float64 for floats and
    int64 for integers, and the result float64 sum / count, NULL where the
    count is 0."""

    name = "avg"

    def acc_fields(self, s):
        t = _out_num_type(self.children[0].data_type(s))
        return [Field("sum", t), Field("count", INT64, nullable=False)]

    def output_type(self, s):
        _out_num_type(self.children[0].data_type(s))
        return FLOAT64

    def partial_update(self, args, gids, n):
        data, valid = args[0]
        s = K.segment_sum(data.to(_acc_dtype(data)), gids, n, valid)
        c = K.segment_count(valid, gids, n)
        return ((s, c > 0), (c, _ones(n, c)))

    def partial_merge(self, accs, gids, n):
        (s_d, s_v), (c_d, c_v) = accs
        s = K.segment_sum(s_d, gids, n, s_v)
        c = K.segment_sum(c_d, gids, n, c_v)
        return ((s, c > 0), (c, _ones(c.shape[0], c)))

    def final_eval(self, accs):
        (s_d, _), (c_d, _) = accs
        valid = c_d > 0
        denom = torch.where(valid, c_d, torch.ones_like(c_d))
        return s_d / denom.to(torch.float64), valid


class MinMaxAgg(AggFunction):
    def __init__(self, children, minimum: bool):
        super().__init__(children)
        self.minimum = minimum
        self.name = "min" if minimum else "max"

    def acc_fields(self, s):
        return [Field(self.name, self.children[0].data_type(s))]

    def output_type(self, s):
        return self.children[0].data_type(s)

    @property
    def is_host(self) -> bool:
        # min/max over utf8/binary is a host accumulator in the JAX
        # package; the engine raises for it (item 13)
        return (self.input_type is not None
                and not self.input_type.is_fixed_width)

    def _reduce(self, data, valid, gids, n):
        vals, nan_mask = data, None
        if self.minimum and data.dtype.is_floating_point:
            # Spark's total order puts NaN last: min skips NaN unless the
            # group holds nothing else
            nan_mask = torch.isnan(data)
            vals = torch.where(nan_mask, torch.full_like(data, float("inf")),
                               data)
        fn = K.segment_min if self.minimum else K.segment_max
        out = fn(vals, gids, n, valid)
        has = K.segment_count(valid, gids, n) > 0
        if nan_mask is not None:
            has_real = K.segment_count(valid & ~nan_mask, gids, n) > 0
            out = torch.where(has & ~has_real,
                              torch.full_like(out, float("nan")), out)
        out = torch.where(has, out, torch.zeros_like(out))
        return ((out, has),)

    def partial_update(self, args, gids, n):
        return self._reduce(args[0][0], args[0][1], gids, n)

    def partial_merge(self, accs, gids, n):
        return self._reduce(accs[0][0], accs[0][1], gids, n)

    def final_eval(self, accs):
        return accs[0]


#: ROADMAP Queue 1 item of each function the port does not have yet
_LATER = {"first": 13, "first_ignores_null": 13, "collect_list": 13,
          "collect_set": 13, "brickhouse.collect": 13,
          "combine_unique": 13, "brickhouse.combine_unique": 13,
          "bloom_filter": 11, "udaf": 16}


def make_agg(name: str, children: Sequence[PhysicalExpr],
             **_kw) -> AggFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(children)
    if name == "count":
        return CountAgg(children)
    if name == "avg":
        return AvgAgg(children)
    if name in ("min", "max"):
        return MinMaxAgg(children, minimum=(name == "min"))
    if name in _LATER:
        raise NotImplementedError(
            f"aggregate function {name!r} belongs to a later slice of the "
            f"PyTorch port (ROADMAP Queue 1 item {_LATER[name]})")
    raise KeyError(f"unknown aggregate function {name}")
