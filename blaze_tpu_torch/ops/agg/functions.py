"""Aggregate functions over segmented (sort-based) group layouts (port of
SumAgg, CountAgg, AvgAgg, MinMaxAgg, FirstAgg, CollectAgg,
CombineUniqueAgg and BloomFilterAgg of blaze_tpu/ops/agg/functions.py).

Groups arrive as sorted segments with dense group ids (ops/agg/exec.py),
so every device accumulator update is one segmented reduction on the
batch's device (kernels/sort.py).  A device accumulator is a tuple of
(data, validity) tensors indexed by group id.  A host accumulator
(`is_host`: collect_list/collect_set/combine_unique, whose values are
lists, bloom_filter, and min/max over utf8 or binary) folds Arrow arrays with numpy
group ids in row order (`host_update`, `host_merge`, `host_eval`), as in
the JAX package.  The fused lanes (plan/fused.py) read only each
function's kind, accumulator fields and output type.

Decimal sums and averages accumulate the unscaled int64s, exactly, and
take the JAX package's result types: sum decimal(min(p + 10, 18), s), avg
decimal(min(p + 4, 18), min(s + 4, 18)) as unscaled x 10^4 / count,
HALF_UP (Spark caps both at 38: ROADMAP Queue 3).  `bloom_filter`
builds a Spark bloom filter on the host (kernels/bloom.py).  UDAFs
(item 16) belong to a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.schema import (BOOL, DataType, Field, FLOAT64, INT64,
                                    Schema, TypeId)

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
    float64, decimal sums keep the scale and widen the precision (capped
    at 18, as the JAX package)."""
    if dt.id == TypeId.DECIMAL:
        return DataType(TypeId.DECIMAL, min(dt.precision + 10, 18), dt.scale)
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
        s = K.segment_sum(data.to(_acc_dtype(data)), gids, n, valid,
                          contiguous=True)
        has = K.segment_count(valid, gids, n) > 0
        return ((s, has),)

    def partial_merge(self, accs, gids, n):
        data, valid = accs[0]
        s = K.segment_sum(data, gids, n, valid, contiguous=True)
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
        c = K.segment_sum(data, gids, n, valid, contiguous=True)
        return ((c, _ones(c.shape[0], c)),)

    def final_eval(self, accs):
        data, _ = accs[0]
        return data, _ones(data.shape[0], data)


class AvgAgg(AggFunction):
    """avg: a (sum, count) accumulator; the sum is float64 for floats and
    int64 for integers and decimals (unscaled), and the result float64 sum
    / count, NULL where the count is 0; a decimal's is decimal(p + 4,
    s + 4), unscaled sum x 10^4 / count rounded HALF_UP."""

    name = "avg"

    def acc_fields(self, s):
        t = _out_num_type(self.children[0].data_type(s))
        return [Field("sum", t), Field("count", INT64, nullable=False)]

    def output_type(self, s):
        t = self.children[0].data_type(s)
        if t.id == TypeId.DECIMAL:
            return DataType(TypeId.DECIMAL, min(t.precision + 4, 18),
                            min(t.scale + 4, 18))
        return FLOAT64

    def partial_update(self, args, gids, n):
        data, valid = args[0]
        s = K.segment_sum(data.to(_acc_dtype(data)), gids, n, valid,
                          contiguous=True)
        c = K.segment_count(valid, gids, n)
        return ((s, c > 0), (c, _ones(n, c)))

    def partial_merge(self, accs, gids, n):
        (s_d, s_v), (c_d, c_v) = accs
        s = K.segment_sum(s_d, gids, n, s_v, contiguous=True)
        c = K.segment_sum(c_d, gids, n, c_v, contiguous=True)
        return ((s, c > 0), (c, _ones(c.shape[0], c)))

    def final_eval(self, accs):
        (s_d, _), (c_d, _) = accs
        valid = c_d > 0
        denom = torch.where(valid, c_d, torch.ones_like(c_d))
        if self.input_type is not None and \
                self.input_type.id == TypeId.DECIMAL:
            return decimal_avg(s_d, denom), valid
        return s_d / denom.to(torch.float64), valid


def decimal_avg(sums: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Unscaled decimal sums over positive counts -> the averages at 4
    more digits of scale: sum x 10^4 / count, HALF_UP on the magnitude
    (truncating division of |num| + count // 2)."""
    num = sums.to(torch.int64) * 10_000
    q = torch.div(num.abs() + torch.div(counts, 2, rounding_mode="floor"),
                  counts, rounding_mode="floor")
    return torch.where(num < 0, -q, q)


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
        # min/max over utf8/binary accumulates on the host: a
        # variable-width value has no device form
        return (self.input_type is not None
                and not self.input_type.is_fixed_width)

    def host_update(self, args: List[pa.Array], gids: np.ndarray,
                    num_segments: int) -> List[pa.Array]:
        vals = args[0]
        out: List = [None] * num_segments
        for v, g in zip(vals.to_pylist(), gids):
            if g < num_segments and v is not None:
                cur = out[g]
                if cur is None or (v < cur if self.minimum else v > cur):
                    out[g] = v
        return [pa.array(out, type=vals.type)]

    def host_merge(self, accs, gids, num_segments):
        # the min of mins, the max of maxes: the same fold
        return self.host_update(accs, gids, num_segments)

    def host_eval(self, accs: List[pa.Array]) -> pa.Array:
        return accs[0]

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


class FirstAgg(AggFunction):
    """first(x): the group's first row's value, null or not (a `has`
    field tells a first NULL from no row yet); first_ignores_null: its
    first non-null value."""

    def __init__(self, children, ignores_null: bool = False):
        super().__init__(children)
        self.ignores_null = ignores_null
        self.name = "first_ignores_null" if ignores_null else "first"

    def acc_fields(self, s):
        fields = [Field("first", self.children[0].data_type(s))]
        if not self.ignores_null:
            fields.append(Field("has", BOOL, nullable=False))
        return fields

    def output_type(self, s):
        return self.children[0].data_type(s)

    def partial_update(self, args, gids, n):
        data, valid = args[0]
        if self.ignores_null:
            return (K.segment_first_ignores_null(data, valid, gids, n),)
        v = K.segment_first(data, valid, gids, n)
        has_rows = K.segment_count(torch.ones_like(valid), gids, n) > 0
        return (v, (has_rows, _ones(n, has_rows)))

    def partial_merge(self, accs, gids, n):
        if self.ignores_null:
            data, valid = accs[0]
            return (K.segment_first_ignores_null(data, valid, gids, n),)
        (data, valid), (has, _) = accs
        # the first partial that HAS a value (its has flag), null or not
        has = has.to(torch.bool)
        v, _ = K.segment_first_ignores_null(data, has, gids, n)
        vv, _ = K.segment_first_ignores_null(valid, has, gids, n)
        any_has = K.segment_count(has, gids, n) > 0
        return ((v, vv.to(torch.bool) & any_has), (any_has, _ones(n, v)))

    def final_eval(self, accs):
        return accs[0]


class CollectAgg(AggFunction):
    """collect_list / collect_set: the group's non-null values as a list
    (a set keeps the first of equal values), a host accumulator."""

    def __init__(self, children, distinct: bool):
        super().__init__(children)
        self.distinct = distinct
        self.name = "collect_set" if distinct else "collect_list"

    @property
    def is_host(self) -> bool:
        return True

    def acc_fields(self, s):
        return [Field("items", self.output_type(s))]

    def output_type(self, s):
        item = self.children[0].data_type(s)
        return DataType(TypeId.LIST, children=(Field("item", item),))

    def _fold(self, rows, gids, num_segments, extend: bool) -> List[List]:
        out: List[List] = [[] for _ in range(num_segments)]
        for v, g in zip(rows, gids):
            if g < num_segments and v is not None:
                if extend:
                    out[g].extend(v)
                else:
                    out[g].append(v)
        if self.distinct:
            out = [list(dict.fromkeys(x)) for x in out]
        return out

    def host_update(self, args: List[pa.Array], gids: np.ndarray,
                    num_segments: int) -> List[pa.Array]:
        vals = args[0]
        out = self._fold(vals.to_pylist(), gids, num_segments, False)
        return [pa.array(out, type=pa.list_(vals.type))]

    def host_merge(self, accs: List[pa.Array], gids: np.ndarray,
                   num_segments: int) -> List[pa.Array]:
        lists = accs[0]
        out = self._fold(lists.to_pylist(), gids, num_segments, True)
        return [pa.array(out, type=lists.type)]

    def host_eval(self, accs: List[pa.Array]) -> pa.Array:
        return accs[0]


class CombineUniqueAgg(CollectAgg):
    """brickhouse.combine_unique: collect_set over the elements of a
    list-typed input, flattened across the group's rows."""

    def __init__(self, children):
        super().__init__(children, distinct=True)
        self.name = "combine_unique"

    def output_type(self, s):
        t = self.children[0].data_type(s)
        if t.id != TypeId.LIST:
            raise TypeError("combine_unique expects an array input")
        return t

    def host_update(self, args, gids, num_segments):
        lists = args[0]
        rows = [None if v is None else [e for e in v if e is not None]
                for v in lists.to_pylist()]
        return [pa.array(self._fold(rows, gids, num_segments, True),
                         type=lists.type)]


class BloomFilterAgg(AggFunction):
    """bloom_filter: a Spark bloom filter of the group's int64 values (the
    build side of a runtime-filter join), a host accumulator holding the
    filter's serialized bytes; merge ORs the words.  Sized from
    `expected_items` at Spark's fpp of 0.03, or `num_bits`."""

    name = "bloom_filter"

    def __init__(self, children, expected_items: int = 1_000_000,
                 num_bits: Optional[int] = None):
        super().__init__(children)
        from blaze_tpu_torch.kernels import bloom
        self.num_bits = num_bits or bloom.optimal_num_bits(expected_items,
                                                           0.03)
        self.num_hashes = bloom.optimal_num_hashes(expected_items,
                                                   self.num_bits)

    @property
    def is_host(self) -> bool:
        return True

    def acc_fields(self, s):
        return [Field("bloom", DataType(TypeId.BINARY))]

    def output_type(self, s):
        return DataType(TypeId.BINARY)

    def host_update(self, args, gids, num_segments):
        from blaze_tpu_torch.kernels.bloom import SparkBloomFilter
        vals = args[0].cast(pa.int64())
        npg = np.asarray(gids)
        npv = np.asarray(vals.fill_null(0), dtype=np.int64)
        valid = np.asarray(vals.is_valid())
        out = []
        for g in range(num_segments):
            f = SparkBloomFilter(self.num_bits, self.num_hashes)
            f.put_longs(npv[(npg == g) & valid])
            out.append(f.to_bytes())
        return [pa.array(out, type=pa.binary())]

    def host_merge(self, accs, gids, num_segments):
        from blaze_tpu_torch.kernels.bloom import SparkBloomFilter
        npg = np.asarray(gids)
        out = []
        for g in range(num_segments):
            f: Optional[SparkBloomFilter] = None
            for i in np.nonzero(npg == g)[0]:
                v = accs[0][int(i)]
                if not v.is_valid:
                    continue
                other = SparkBloomFilter.from_bytes(v.as_py())
                if f is None:
                    f = other
                else:
                    f.merge(other)
            out.append(f.to_bytes() if f is not None else None)
        return [pa.array(out, type=pa.binary())]

    def host_eval(self, accs):
        return accs[0]


#: ROADMAP Queue 1 item of each function the port does not have yet
_LATER = {"udaf": 16}


def make_agg(name: str, children: Sequence[PhysicalExpr],
             **kw) -> AggFunction:
    name = name.lower()
    if name == "sum":
        return SumAgg(children)
    if name == "count":
        return CountAgg(children)
    if name == "avg":
        return AvgAgg(children)
    if name in ("min", "max"):
        return MinMaxAgg(children, minimum=(name == "min"))
    if name in ("first", "first_ignores_null"):
        return FirstAgg(children, ignores_null=(name != "first"))
    if name in ("collect_list", "collect_set", "brickhouse.collect"):
        # brickhouse's collect delegates to collect_set
        return CollectAgg(children, distinct=(name != "collect_list"))
    if name in ("combine_unique", "brickhouse.combine_unique"):
        return CombineUniqueAgg(children)
    if name == "bloom_filter":
        return BloomFilterAgg(children, **kw)
    if name in _LATER:
        raise NotImplementedError(
            f"aggregate function {name!r} belongs to a later slice of the "
            f"PyTorch port (ROADMAP Queue 1 item {_LATER[name]})")
    raise KeyError(f"unknown aggregate function {name}")
