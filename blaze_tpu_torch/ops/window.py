"""The window operator: the rank family, lead/lag, nth_value and aggregates
over a window (port of WindowRankType, RankFunc, LeadLagFunc,
NthValueFunc, WindowAggFunc and WindowExec of blaze_tpu/ops/window.py).

The input arrives sorted by (partition keys, order keys): Spark plans a
sort under every window.  So every function is a prefix scan over the
batch's segment structure, on the batch's device:

  * partition starts and order-key changes come from the host order keys
    of ops/sort.py `host_sort_keys` (as in the JAX package), then move to
    the device as bool masks;
  * a row's partition start and its rank are running maxima of marked
    positions (`torch.cummax`); partition ends and tie ends are running
    minima from the right (`torch.flip` around `torch.cummin`);
  * running sums and counts are one global `torch.cumsum` minus its value
    before the row's partition start (a NaN or an infinity counts only in
    its own partition, where the JAX package lets it reach every later
    one); running min/max are a log-step doubling scan bounded by
    partition membership.

Lead/lag and nth_value take rows of the host Arrow array, as in the JAX
package.  `execute` streams: once the buffer holds 4 x `auron.batch.size`
rows, every partition before the last partition start seen is complete
and is processed and emitted; the rest stays buffered.

Not here: the buffer's spill (the memory manager, ROADMAP Queue 1 item
8), the host route for small batches (item 15), the event-time windows
of the streaming runtime (item 16) and decimal arguments (item 13).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, to_device, to_host
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.agg.functions import (AggFunction, AvgAgg, CountAgg,
                                               MinMaxAgg, SumAgg)
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.ops.sort import host_sort_keys
from blaze_tpu_torch.schema import FLOAT64, INT32, Field, Schema, TypeId


class WindowRankType(enum.Enum):
    ROW_NUMBER = "row_number"
    RANK = "rank"
    DENSE_RANK = "dense_rank"
    PERCENT_RANK = "percent_rank"
    CUME_DIST = "cume_dist"


@dataclass
class WindowFunc:
    name: str

    def out_field(self, in_schema: Schema) -> Field:
        raise NotImplementedError

    def args(self) -> List[PhysicalExpr]:
        return []


@dataclass
class RankFunc(WindowFunc):
    kind: WindowRankType = WindowRankType.ROW_NUMBER

    def out_field(self, in_schema):
        if self.kind in (WindowRankType.PERCENT_RANK, WindowRankType.CUME_DIST):
            return Field(self.name, FLOAT64, False)
        return Field(self.name, INT32, False)


@dataclass
class LeadLagFunc(WindowFunc):
    expr: PhysicalExpr = None
    offset: int = 1          # positive = lead, negative = lag
    default: Optional[object] = None

    def out_field(self, in_schema):
        return Field(self.name, self.expr.data_type(in_schema), True)

    def args(self):
        return [self.expr]


@dataclass
class NthValueFunc(WindowFunc):
    expr: PhysicalExpr = None
    n: int = 1               # 1-based
    ignore_nulls: bool = False

    def out_field(self, in_schema):
        return Field(self.name, self.expr.data_type(in_schema), True)

    def args(self):
        return [self.expr]


@dataclass
class WindowAggFunc(WindowFunc):
    agg: AggFunction = None
    running: bool = True     # unbounded preceding..current row, else the
    #                          whole partition

    def out_field(self, in_schema):
        return Field(self.name, self.agg.output_type(in_schema), True)

    def args(self):
        return list(self.agg.children)


class WindowExec(ExecutionPlan):

    def __init__(self, child: ExecutionPlan,
                 funcs: Sequence[WindowFunc],
                 partition_by: Sequence[PhysicalExpr],
                 order_by: Sequence[Tuple[PhysicalExpr, bool, bool]],
                 group_limit: Optional[int] = None):
        super().__init__([child])
        self.funcs = list(funcs)
        self.partition_by = list(partition_by)
        self.order_by = list(order_by)
        self.group_limit = group_limit
        in_schema = child.schema
        for f in self.funcs:
            for e in f.args():
                if e.data_type(in_schema).id == TypeId.DECIMAL:
                    raise NotImplementedError(
                        f"window function {f.name!r} over a decimal "
                        f"argument belongs to the strings/decimals slice "
                        f"of the PyTorch port (ROADMAP Queue 1 item 13)")
            if isinstance(f, WindowAggFunc):
                f.agg.bind(in_schema)
        self._out_schema = Schema(
            list(in_schema) + [f.out_field(in_schema) for f in self.funcs])

    @property
    def schema(self) -> Schema:
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        """Counters: `output_rows`, and the processed batches by device
        (`cuda_batches` / `cpu_batches`)."""
        buf: List[pa.RecordBatch] = []
        segs: List[np.ndarray] = []  # each buffered batch's partition
        #                              starts (with partition_by)
        buf_rows = 0
        flush_rows = 4 * config.BATCH_SIZE.get()
        prev_last: Optional[tuple] = None  # the last row's partition keys
        last_cut: Optional[int] = None  # buffer row of the last partition
        #                                 start
        device = None
        for b in self.children[0].execute(partition):
            b = b.compact()
            if b.num_rows == 0:
                continue
            device = b.device
            rb = b.to_arrow()
            if self.partition_by:
                # only this batch's keys are evaluated; the seam is row 0
                # against the previous batch's last row
                keys = self._part_keys(b, rb.num_rows)
                seg = np.zeros(rb.num_rows, dtype=bool)
                for k in keys:
                    seg[1:] |= k[1:] != k[:-1]
                if prev_last is not None:
                    seg[0] = any(k[0] != pl for k, pl in zip(keys, prev_last))
                idx = np.flatnonzero(seg)
                idx = idx[idx + buf_rows > 0]  # buffer row 0 is not a cut
                if len(idx):
                    last_cut = int(idx[-1]) + buf_rows
                prev_last = tuple(k[-1] for k in keys)
                segs.append(seg)
            buf.append(rb)
            buf_rows += rb.num_rows
            if self.partition_by and buf_rows >= flush_rows \
                    and last_cut is not None:
                whole, seg = _combine(buf), np.concatenate(segs)
                # take() copies the tail, so the drained batches are freed
                tail = whole.take(pa.array(
                    np.arange(last_cut, whole.num_rows), type=pa.int64()))
                buf, segs, buf_rows = [tail], [seg[last_cut:]], tail.num_rows
                head, head_seg = whole.slice(0, last_cut), seg[:last_cut]
                last_cut = None
                yield self._process(head, device, head_seg)
        if buf_rows:
            yield self._process(_combine(buf), device,
                                np.concatenate(segs) if segs else None)

    # ------------------------------------------------------------------
    def _process(self, rb: pa.RecordBatch, device,
                 part_seg: Optional[np.ndarray]) -> ColumnBatch:
        """The window functions over whole partitions of rows, given
        where a partition starts after row 0 (None: no partition_by)."""
        n = rb.num_rows
        cb = ColumnBatch.from_arrow(rb, device=device)
        dev = cb.device
        part_seg, order_change = self._segments(rb, cb, dev, part_seg)
        pos = torch.arange(n, dtype=torch.int64, device=dev)
        seg_start = _running_max_where(part_seg, pos)
        row_number = (pos - seg_start + 1).to(torch.int32)
        part_size = _segment_size(part_seg, pos, seg_start)
        # rank: position of the last (partition or order) change at or
        # before the row
        change = part_seg | order_change
        rank_val = (_running_max_where(change, pos) - seg_start + 1) \
            .to(torch.int32)
        dense = _segmented_cumsum((order_change & ~part_seg).to(torch.int64),
                                  seg_start).to(torch.int32) + 1

        out_cols: List[pa.Array] = list(rb.columns)
        for f in self.funcs:
            if isinstance(f, RankFunc):
                out_cols.append(self._rank_col(f, row_number, rank_val, dense,
                                               part_size, seg_start, change,
                                               pos))
            elif isinstance(f, LeadLagFunc):
                out_cols.append(self._lead_lag(f, cb, part_seg, n))
            elif isinstance(f, NthValueFunc):
                out_cols.append(self._nth_value(f, cb, seg_start, part_size,
                                                n))
            elif isinstance(f, WindowAggFunc):
                out_cols.append(self._window_agg(f, cb, part_seg,
                                                 order_change, seg_start,
                                                 pos))
            else:
                raise TypeError(f"unknown window function {f}")

        out_schema = self.schema.to_arrow()
        out_cols = [a.cast(fld.type, safe=False)
                    if not a.type.equals(fld.type) else a
                    for a, fld in zip(out_cols, out_schema)]
        out = pa.RecordBatch.from_arrays(out_cols, schema=out_schema)
        if self.group_limit is not None:
            # window group limit: keep the rows ranked <= k
            out = out.filter(pa.array(to_host(rank_val) <= self.group_limit))
        self.metrics.add(f"{dev.type}_batches")
        self.metrics.add("output_rows", out.num_rows)
        return ColumnBatch.from_arrow(out, device=dev)

    def _part_keys(self, cb: ColumnBatch, n: int) -> List[np.ndarray]:
        """Order-key-encoded partition_by columns (host arrays)."""
        arrays = [e.evaluate(cb).to_host(n) for e in self.partition_by]
        prb = pa.RecordBatch.from_arrays(
            arrays, names=[f"p{i}" for i in range(len(arrays))])
        return host_sort_keys(prb, list(range(len(arrays))),
                              [False] * len(arrays), [True] * len(arrays))

    def _segments(self, rb: pa.RecordBatch, cb: ColumnBatch, dev,
                  part_seg: Optional[np.ndarray]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(partition start, order change) bool masks over rows, on the
        batch's device."""
        n = rb.num_rows
        part_seg = (np.zeros(n, dtype=bool) if part_seg is None
                    else part_seg.copy())
        part_seg[0] = True
        if self.order_by:
            arrays = [e.evaluate(cb).to_host(n) for e, _, _ in self.order_by]
            orb = pa.RecordBatch.from_arrays(
                arrays, names=[f"o{i}" for i in range(len(arrays))])
            keys = host_sort_keys(orb, list(range(len(arrays))),
                                  [d for _, d, _ in self.order_by],
                                  [f for _, _, f in self.order_by])
            order_change = np.zeros(n, dtype=bool)
            order_change[0] = True
            for k in keys:
                order_change[1:] |= k[1:] != k[:-1]
        else:
            order_change = np.ones(n, dtype=bool)
        masks = to_device(np.stack([part_seg, order_change]), dev)
        return masks[0], masks[1]

    def _rank_col(self, f: RankFunc, row_number, rank_val, dense, part_size,
                  seg_start, change, pos) -> pa.Array:
        k = f.kind
        if k == WindowRankType.ROW_NUMBER:
            return pa.array(to_host(row_number), type=pa.int32())
        if k == WindowRankType.RANK:
            return pa.array(to_host(rank_val), type=pa.int32())
        if k == WindowRankType.DENSE_RANK:
            return pa.array(to_host(dense), type=pa.int32())
        if k == WindowRankType.PERCENT_RANK:
            denom = torch.clamp(part_size - 1, min=1).to(torch.float64)
            out = (rank_val.to(torch.float64) - 1.0) / denom
            out = torch.where(part_size == 1, torch.zeros_like(out), out)
            return pa.array(to_host(out), type=pa.float64())
        # CUME_DIST: (end of the row's tie run - partition start) / size
        last_same = _next_change_pos(change, pos)
        out = (last_same - seg_start).to(torch.float64) / \
            part_size.to(torch.float64)
        return pa.array(to_host(out), type=pa.float64())

    def _lead_lag(self, f: LeadLagFunc, cb: ColumnBatch,
                  part_seg: torch.Tensor, n: int) -> pa.Array:
        vals = f.expr.evaluate(cb).to_host(n)
        pid = np.cumsum(to_host(part_seg)) - 1
        idx = np.arange(n) + f.offset
        ok = (idx >= 0) & (idx < n)
        safe = np.clip(idx, 0, n - 1)
        ok &= pid[safe] == pid  # stay inside the partition
        shifted = vals.take(pa.array(safe, type=pa.int64()))
        default = pa.scalar(f.default, type=vals.type)
        return pc.if_else(pa.array(ok), shifted, default)

    def _nth_value(self, f: NthValueFunc, cb: ColumnBatch, seg_start,
                   part_size, n: int) -> pa.Array:
        vals = f.expr.evaluate(cb).to_host(n)
        starts = to_host(seg_start)
        if f.ignore_nulls:
            # the nth non-null row of the partition: a prefix count ranks
            # each non-null value within its partition
            valid = np.asarray(vals.is_valid())
            cum = np.cumsum(valid)
            rank = cum - (cum[starts] - valid[starts])
            rows = np.flatnonzero(valid & (rank == f.n))
            nth_idx = np.full(n, -1, dtype=np.int64)
            nth_idx[starts[rows]] = rows
            target = nth_idx[starts]
            ok = target >= 0
        else:
            target = starts + (f.n - 1)
            ok = (f.n - 1) < to_host(part_size)
        taken = vals.take(pa.array(np.clip(target, 0, n - 1),
                                   type=pa.int64()))
        return pc.if_else(pa.array(ok), taken,
                          pa.scalar(None, type=vals.type))

    def _window_agg(self, f: WindowAggFunc, cb: ColumnBatch, part_seg,
                    order_change, seg_start, pos) -> pa.Array:
        n = pos.shape[0]
        dev = pos.device
        if f.agg.children:
            v = f.agg.children[0].evaluate(cb).to_device(cb.capacity)
            data, valid = v.data[:n], v.validity[:n]
        else:
            data = torch.ones(n, dtype=torch.int64, device=dev)
            valid = torch.ones(n, dtype=torch.bool, device=dev)
        counts = _segmented_cumsum(valid.to(torch.int64), seg_start)
        if isinstance(f.agg, CountAgg):
            out, ovalid = counts, torch.ones(n, dtype=torch.bool, device=dev)
        elif isinstance(f.agg, (SumAgg, AvgAgg)):
            dt = torch.float64 if data.is_floating_point() else torch.int64
            s = _segmented_cumsum(
                torch.where(valid, data.to(dt), torch.zeros((), dtype=dt,
                                                            device=dev)),
                seg_start)
            out = s if isinstance(f.agg, SumAgg) else \
                s.to(torch.float64) / torch.clamp(counts, min=1)
            ovalid = counts > 0
        elif isinstance(f.agg, MinMaxAgg):
            # a null never wins: it takes the far end of the type's range
            if data.is_floating_point():
                fill = float("inf") if f.agg.minimum else float("-inf")
            elif data.dtype == torch.bool:
                fill = f.agg.minimum
            else:
                info = torch.iinfo(data.dtype)
                fill = info.max if f.agg.minimum else info.min
            x = torch.where(valid, data, torch.full((), fill,
                                                    dtype=data.dtype,
                                                    device=dev))
            out = _segmented_cumext(x, part_seg, f.agg.minimum)
            ovalid = counts > 0
        else:
            raise TypeError(f"window agg {f.agg.name} unsupported")
        if f.running and self.order_by:
            # RANGE frame: ties (equal order values) share the frame end
            last = _next_change_pos(part_seg | order_change, pos) - 1
        else:
            # whole partition: every row takes the partition's last value
            last = _partition_last_pos(part_seg, pos)
        out, ovalid = out[last], ovalid[last]
        return pa.array(to_host(out), mask=~to_host(ovalid))


def _combine(batches: List[pa.RecordBatch]) -> pa.RecordBatch:
    if len(batches) == 1:
        return batches[0]
    return pa.Table.from_batches(batches).combine_chunks().to_batches()[0]


# -- prefix scans on the batch's device ---------------------------------------

def _running_max_where(mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """For each row, the position of the most recent row where mask is
    True (-1 before the first)."""
    marked = torch.where(mask, pos, torch.full_like(pos, -1))
    return torch.cummax(marked, 0).values


def _next_true_pos(mask: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """For each row, the position of the next row (>= current) where mask
    is True (n after the last)."""
    marked = torch.where(mask, pos, torch.full_like(pos, pos.shape[0]))
    return torch.flip(torch.cummin(torch.flip(marked, (0,)), 0).values, (0,))


def _shift_left(mask: torch.Tensor) -> torch.Tensor:
    """mask[1:] followed by True: a row is the last of its run when the
    next row starts a new one."""
    return torch.cat([mask[1:], mask.new_ones(1)])


def _next_change_pos(change: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Exclusive end of the run of rows equal to this row: the position of
    the next change after the row, or n."""
    return _next_true_pos(_shift_left(change), pos) + 1


def _partition_last_pos(part_seg: torch.Tensor, pos: torch.Tensor
                        ) -> torch.Tensor:
    """For each row, the position of its partition's last row."""
    return _next_true_pos(_shift_left(part_seg), pos)


def _segment_size(part_seg: torch.Tensor, pos: torch.Tensor,
                  seg_start: torch.Tensor) -> torch.Tensor:
    return _partition_last_pos(part_seg, pos) - seg_start + 1


def _segmented_cumsum(values: torch.Tensor, seg_start: torch.Tensor
                      ) -> torch.Tensor:
    """Cumulative sum restarting at each partition start: the global
    cumsum minus its value just before the row's partition start.

    A NaN or an infinity would poison the global cumsum for every later
    partition (the JAX package's `_segmented_cumsum` does so), so float
    values that are not all finite are summed as zeros, and each row then
    takes the NaN or infinity that a sum of its own partition's values up
    to it gives."""
    if values.is_floating_point():
        finite = torch.isfinite(values)
        if not bool(finite.all()):
            out = _segmented_cumsum(
                torch.where(finite, values, torch.zeros_like(values)),
                seg_start)
            nan, pos, neg = (
                _segmented_cumsum(m.to(torch.int64), seg_start) > 0
                for m in (torch.isnan(values), values == float("inf"),
                          values == float("-inf")))
            out = torch.where(pos, float("inf"), out)
            out = torch.where(neg, float("-inf"), out)
            return torch.where(nan | (pos & neg), float("nan"), out)
    total = torch.cumsum(values, 0)
    base = total[torch.clamp(seg_start - 1, min=0)]
    base = torch.where(seg_start == 0, torch.zeros_like(base), base)
    return total - base


def _segmented_cumext(values: torch.Tensor, part_seg: torch.Tensor,
                      minimum: bool) -> torch.Tensor:
    """Running min or max restarting at each partition start: a log-step
    doubling scan with torch.minimum or torch.maximum (NaN dominates, as
    both propagate it; no negation, so an integer type's minimum and bool
    values stay exact)."""
    ext = torch.minimum if minimum else torch.maximum
    n = values.shape[0]
    pid = torch.cumsum(part_seg.to(torch.int64), 0) - 1
    out = values
    shift = 1
    while shift < n:
        prev = torch.cat([out[:shift], out[:-shift]])
        prev_pid = torch.cat([pid[:shift], pid[:-shift]])
        # the first `shift` rows meet themselves: ext(x, x) = x
        out = torch.where(prev_pid == pid, ext(out, prev), out)
        shift *= 2
    return out
