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
  * running float sums add each partition's rows in row order from +0.0
    (kernels/sort.py `segmented_running_sum`, csrc/segment_sum.cu on the
    card), so a NaN or an infinity counts only in its own partition, where
    the JAX package lets it reach every later one; running counts and
    integer sums are one global `torch.cumsum` minus its value before the
    row's partition start; running min/max are a log-step doubling scan
    bounded by partition membership.

Lead/lag and nth_value take rows of the host Arrow array, as in the JAX
package.  `execute` streams: once the buffer holds 4 x `auron.batch.size`
rows, every partition before the last partition start seen is complete
and is processed and emitted; the rest stays buffered.  The buffer
(`_WindowBuffer`) is a `MemConsumer` charged with its Arrow bytes: under
pressure its batches spill (`try_new_spill`), and at the next boundary
flush, or at the end, the spilled runs are read back oldest first,
ahead of the batches still in memory.

A decimal argument's sums and extremes run on its unscaled int64s and
the output column is rebuilt from the unscaled values at the function's
output type (sum decimal(min(p + 10, 18), s)); avg follows AvgAgg's
decimal rule, sum x 10^4 / count HALF_UP (the JAX package casts the
unscaled sums as whole numbers there: ROADMAP Queue 3).

The event-time windows of the streaming runtime (`EventTimeWindowSpec`,
`WatermarkTracker`, `EventTimeWindowState`) are at the end: the JAX
package's host state, copied as it is (Python accumulators, integer sums
unbounded, panes fired in (window_start, str(key)) order, the whole open
state in every checkpoint snapshot).

Not here: the host route for small batches (ROADMAP step 13's
`_window_xp`).
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
from blaze_tpu_torch.batch import (ColumnBatch, decimal_from_unscaled,
                                   to_device, to_host)
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.memory import MemConsumer, MemManager, try_new_spill
from blaze_tpu_torch.ops.agg.functions import (AggFunction, AvgAgg, CountAgg,
                                               MinMaxAgg, SumAgg,
                                               decimal_avg)
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


class _WindowBuffer(MemConsumer):
    """The window's buffered input batches, spillable: under pressure
    the batches in memory move to a spill, and `drain` reads them back
    (spilled runs first, since a spill always takes the oldest rows)."""

    def __init__(self, op: "WindowExec"):
        super().__init__("WindowExec.buffer")
        self._op = op
        self.metrics = op.metrics
        self._mem: List[pa.RecordBatch] = []
        self._mem_bytes = 0
        self._spills: list = []
        self.rows = 0

    def add(self, rb: pa.RecordBatch) -> None:
        self._mem.append(rb)
        self._mem_bytes += rb.nbytes
        self.rows += rb.num_rows
        self.update_mem_used(self._mem_bytes)

    def spill(self) -> int:
        if not self._mem:
            return 0
        s = try_new_spill()
        s.write_batches(iter(self._mem))
        self._spills.append(s)
        released = self._mem_bytes
        self._mem = []
        self._mem_bytes = 0
        self._mem_used = 0
        self.spill_metrics.spill_count += 1
        self.spill_metrics.spilled_bytes += released
        self._op.metrics.add("spill_count")
        self._op.metrics.add("spilled_bytes", released)
        return released

    def drain(self) -> List[pa.RecordBatch]:
        """Every buffered batch in arrival order; empties the buffer."""
        out: List[pa.RecordBatch] = []
        for s in self._spills:
            out.extend(s.read_batches())
        self.release()
        out.extend(self._mem)
        self._mem = []
        self._mem_bytes = 0
        self.rows = 0
        self.update_mem_used(0)
        return out

    def release(self) -> None:
        for s in self._spills:
            s.release()
        self._spills = []


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
            if isinstance(f, WindowAggFunc):
                f.agg.bind(in_schema)
        self._out_schema = Schema(
            list(in_schema) + [f.out_field(in_schema) for f in self.funcs])

    @property
    def schema(self) -> Schema:
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        """Counters: the processed batches by device
        (`cuda_batches` / `cpu_batches`), and the buffer's `spill_count`
        and `spilled_bytes`."""
        buf = _WindowBuffer(self)
        buf.set_spillable(MemManager.get())
        segs: List[np.ndarray] = []  # each buffered batch's partition
        #                              starts (with partition_by)
        flush_rows = 4 * config.BATCH_SIZE.get()
        prev_last: Optional[tuple] = None  # the last row's partition keys
        last_cut: Optional[int] = None  # buffer row of the last partition
        #                                 start
        device = None
        try:
            for b in self.children[0].execute(partition):
                b = b.compact()
                if b.num_rows == 0:
                    continue
                device = b.device
                rb = b.to_arrow()
                if self.partition_by:
                    # only this batch's keys are evaluated; the seam is
                    # row 0 against the previous batch's last row
                    keys = self._part_keys(b, rb.num_rows)
                    seg = np.zeros(rb.num_rows, dtype=bool)
                    for k in keys:
                        seg[1:] |= k[1:] != k[:-1]
                    if prev_last is not None:
                        seg[0] = any(k[0] != pl
                                     for k, pl in zip(keys, prev_last))
                    idx = np.flatnonzero(seg)
                    idx = idx[idx + buf.rows > 0]  # buffer row 0: no cut
                    if len(idx):
                        last_cut = int(idx[-1]) + buf.rows
                    prev_last = tuple(k[-1] for k in keys)
                    segs.append(seg)
                buf.add(rb)
                if self.partition_by and buf.rows >= flush_rows \
                        and last_cut is not None:
                    whole, seg = _combine(buf.drain()), np.concatenate(segs)
                    # take() copies the tail: a slice would pin every
                    # drained batch while the buffer is charged only
                    # the slice's bytes
                    buf.add(whole.take(pa.array(
                        np.arange(last_cut, whole.num_rows),
                        type=pa.int64())))
                    segs = [seg[last_cut:]]
                    head, head_seg = whole.slice(0, last_cut), seg[:last_cut]
                    last_cut = None
                    yield self._process(head, device, head_seg)
            tail = buf.drain()
            if tail:
                yield self._process(_combine(tail), device,
                                    np.concatenate(segs) if segs else None)
        finally:
            buf.unregister()
            buf.release()

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
            v = f.agg.children[0].evaluate(cb).to_device(cb.capacity, cb.device)
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
            if isinstance(f.agg, SumAgg):
                out = s
            elif f.agg.input_type.id == TypeId.DECIMAL:
                out = decimal_avg(s, torch.clamp(counts, min=1))
            else:
                out = s.to(torch.float64) / torch.clamp(counts, min=1)
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
        out, ovalid = to_host(out[last]), to_host(ovalid[last])
        out_t = f.out_field(cb.schema).data_type
        if out_t.id == TypeId.DECIMAL:
            return decimal_from_unscaled(out, ovalid, out_t.to_arrow())
        return pa.array(out, mask=~ovalid)


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
    """Cumulative sum restarting at each partition start.

    Floats add in row order within each partition, from +0.0
    (kernels/sort.py `segmented_running_sum`: a matrix cumsum on the CPU,
    csrc/segment_sum.cu on the card), the order Spark's window frame adds
    in, so the card gives the CPU's bits and a NaN or an infinity stays in
    its own partition.  The JAX package's `_segmented_cumsum` takes the
    global cumsum minus its value before the partition, which spreads a
    NaN or an infinity to every later partition and cancels.  Integers
    (counts, int64 sums, unscaled decimals), exact in any order, keep
    that global cumsum minus base."""
    if values.is_floating_point():
        return K.segmented_running_sum(values, seg_start)
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


# -- event-time windows (the streaming runtime) ------------------------------
# Parity: Flink's SliceAssigners / WindowOperator watermark semantics (the
# reference accelerates the operator body; window assignment and the
# watermark clock stay on the host, as here).  streaming/executor.py feeds
# each epoch's plan output through EventTimeWindowState and fires panes
# when the watermark passes their end; the state's snapshot rides in the
# checkpoint manifest.


@dataclass(frozen=True)
class EventTimeWindowSpec:
    """Tumbling (slide_ms None) or sliding event-time window, epoch ms."""

    size_ms: int
    slide_ms: Optional[int] = None

    def __post_init__(self):
        if self.size_ms <= 0:
            raise ValueError("window size_ms must be > 0")
        if self.slide_ms is not None and self.slide_ms <= 0:
            raise ValueError("window slide_ms must be > 0")

    def assign(self, ts_ms: int) -> List[int]:
        """The starts of the windows holding ts (Flink
        SlidingEventTimeWindows.assignWindows; one start when tumbling)."""
        slide = self.slide_ms or self.size_ms
        last = ts_ms - (ts_ms % slide)
        starts = []
        w = last
        while w > ts_ms - self.size_ms:
            starts.append(w)
            w -= slide
        return starts

    def end(self, start_ms: int) -> int:
        return start_ms + self.size_ms


class WatermarkTracker:
    """Event-time clock: the max record timestamp a partition, watermark =
    the min over the partitions that have emitted, less the allowed
    lateness (Flink's per-split watermark combination: a partition never
    seen is idle and holds nothing back).  A record with ts >= watermark
    is on time; the watermark only moves forward."""

    def __init__(self, lateness_ms: int = 0):
        self.lateness_ms = int(lateness_ms)
        self._max_ts: dict = {}
        self._wm: Optional[int] = None

    def observe(self, partition: int, ts_ms: int) -> None:
        cur = self._max_ts.get(partition)
        if cur is None or ts_ms > cur:
            self._max_ts[partition] = int(ts_ms)

    def watermark(self) -> Optional[int]:
        if not self._max_ts:
            return self._wm
        wm = min(self._max_ts.values()) - self.lateness_ms
        if self._wm is None or wm > self._wm:
            self._wm = wm
        return self._wm

    def snapshot(self) -> dict:
        return {"max_ts": {str(p): t for p, t in self._max_ts.items()},
                "wm": self._wm}

    def restore(self, state: dict) -> None:
        self._max_ts = {int(p): int(t)
                        for p, t in (state.get("max_ts") or {}).items()}
        self._wm = state.get("wm")


_ETW_AGGS = ("count", "sum", "min", "max", "avg")


class EventTimeWindowState(MemConsumer):
    """Keyed windowed-aggregation state of the streaming runtime.

    Folds each epoch's output rows into per-(window, key) accumulators;
    `advance(wm)` fires every pane whose window end <= watermark.  Late
    rows (ts < watermark on arrival) follow the late-side policy: `drop`
    counts them, `side` buffers them for `take_late()`, `accept` folds
    them into the pane's RETAINED accumulator, so a fired pane re-opens
    with the state it fired with and re-emits corrected cumulative
    values.  Accept keeps the fired accumulators for the query's life;
    drop and side retain nothing after a fire.  The whole state is
    JSON-snapshotable, and the object is a MemConsumer charged with
    `state_bytes()`, so a query's memory quota sees it (`spill()`
    releases nothing: there is no cheaper tier than firing, so quota
    pressure climbs the degrade ladder)."""

    def __init__(self, spec: EventTimeWindowSpec, in_schema: pa.Schema,
                 ts_field: str, key_fields: Sequence[str],
                 aggs: Sequence[Tuple[str, Optional[str]]],
                 late_policy: str = "drop"):
        MemConsumer.__init__(self, "EventTimeWindowState")
        self.spec = spec
        self.ts_field = ts_field
        self.key_fields = list(key_fields)
        for fn, _col in aggs:
            if fn not in _ETW_AGGS:
                raise ValueError(f"unsupported window agg {fn!r}")
        self.aggs = [(fn, col) for fn, col in aggs]
        self.late_policy = late_policy
        if late_policy not in ("drop", "side", "accept"):
            raise ValueError(f"unknown late-side policy {late_policy!r}")
        self._in_schema = in_schema
        # (window_start, key tuple) -> [acc per agg]
        self._state: dict = {}
        self.late_records = 0
        self._late_rows: List[dict] = []
        # accept policy: the accumulators of fired panes, kept so a late
        # row re-opens its pane with cumulative state
        self._fired: dict = {}
        self.set_spillable(MemManager.get())

    # -- accumulators ---------------------------------------------------
    @staticmethod
    def _acc_init(fn: str):
        if fn == "count":
            return 0
        if fn == "avg":
            return [0.0, 0]
        return None  # sum/min/max start empty (null on no input)

    @staticmethod
    def _acc_result(fn: str, acc):
        if fn == "avg":
            return acc[0] / acc[1] if acc[1] else None
        return acc

    # -- folding --------------------------------------------------------
    def add_batch(self, rb, partition: Optional[int] = None,
                  watermark: Optional[int] = None) -> int:
        """Fold one RecordBatch or Table; returns this batch's late-record
        count (already routed by the policy).  The loop is the JAX
        package's, with `assign` and the JAX package's `_acc_fold`
        (blaze_tpu/ops/window.py) written out in it: the same windows,
        accumulators and order of adds."""
        cols = {name: rb.column(i).to_pylist()
                for i, name in enumerate(rb.schema.names)}
        ts_col = cols[self.ts_field]
        keys = [cols[k] for k in self.key_fields]
        vals = [cols[c] if c is not None else None for _fn, c in self.aggs]
        fns = [fn for fn, _col in self.aggs]
        aggs = list(enumerate(zip(fns, vals)))
        size = self.spec.size_ms
        slide = self.spec.slide_ms or size
        state, fired = self._state, self._fired
        init, policy = self._acc_init, self.late_policy
        late = 0
        for r in range(len(ts_col)):
            ts = ts_col[r]
            key = tuple([k[r] for k in keys])
            if (watermark is not None and ts is not None
                    and ts < watermark):
                late += 1
                if policy == "drop":
                    continue
                if policy == "side":
                    self._late_rows.append(
                        {n: cols[n][r] for n in rb.schema.names})
                    continue
                # accept: fold (the pane may re-fire)
            t = int(ts)
            w = t - (t % slide)
            while w > t - size:
                slot = state.get((w, key))
                if slot is None:
                    # re-open a fired pane with the accumulators it fired
                    # with (accept), else start fresh
                    slot = fired.pop((w, key), None)
                    if slot is None:
                        slot = [init(fn) for fn in fns]
                    state[(w, key)] = slot
                for i, (fn, col) in aggs:
                    # col None = count(*): every row counts
                    v = col[r] if col is not None else 1
                    acc = slot[i]
                    if fn == "count":
                        slot[i] = acc + (1 if v is not None else 0)
                    elif v is None:
                        pass
                    elif fn == "sum":
                        slot[i] = v if acc is None else acc + v
                    elif fn == "max":
                        slot[i] = v if acc is None or v > acc else acc
                    elif fn == "min":
                        slot[i] = v if acc is None or v < acc else acc
                    else:  # avg
                        slot[i] = [acc[0] + v, acc[1] + 1]
                w -= slide
        self.late_records += late
        self.update_mem_used(self.state_bytes())
        return late

    # -- firing ---------------------------------------------------------
    def _out_schema(self) -> pa.Schema:
        fields = [self._in_schema.field(k) for k in self.key_fields]
        fields += [pa.field("window_start", pa.int64()),
                   pa.field("window_end", pa.int64())]
        for fn, col in self.aggs:
            name = f"{fn}_{col}" if col else fn
            if fn == "count":
                t = pa.int64()
            elif fn == "avg":
                t = pa.float64()
            else:
                t = self._in_schema.field(col).type
            fields.append(pa.field(name, t))
        return pa.schema(fields)

    def advance(self, watermark: Optional[int]) -> pa.Table:
        """Fire every pane whose window end <= watermark (every pane when
        the watermark is None, the end-of-stream flush), in (window_start,
        key) order."""
        due = [wk for wk in self._state
               if watermark is None or self.spec.end(wk[0]) <= watermark]
        # sorted by (window_start, the key's strings), ties in insertion
        # order: a stable sort's order, each key's strings made once
        strs = {key: tuple(str(k) for k in key)
                for key in {key for _w, key in due}}
        due = [due[i] for _w, _s, i in sorted(
            [(w, strs[key], i) for i, (w, key) in enumerate(due)])]
        schema = self._out_schema()
        rows: List[list] = [[] for _ in schema]
        for w, key in due:
            accs = self._state.pop((w, key))
            c = 0
            for k in key:
                rows[c].append(k)
                c += 1
            rows[c].append(w)
            rows[c + 1].append(self.spec.end(w))
            c += 2
            for i, (fn, _col) in enumerate(self.aggs):
                rows[c + i].append(self._acc_result(fn, accs[i]))
            if self.late_policy == "accept":
                self._fired[(w, key)] = accs
        self.update_mem_used(self.state_bytes())
        arrays = [pa.array(v, type=f.type)
                  for v, f in zip(rows, schema)]
        return pa.Table.from_arrays(arrays, schema=schema)

    def flush(self) -> pa.Table:
        """End of stream: fire everything still open."""
        return self.advance(None)

    def take_late(self) -> List[dict]:
        out, self._late_rows = self._late_rows, []
        return out

    # -- checkpoint snapshot --------------------------------------------
    def state_bytes(self) -> int:
        # the retained-bytes model: dict entry + key tuple + accumulators
        per = 96 + 24 * (len(self.key_fields) + len(self.aggs))
        return ((len(self._state) + len(self._fired)) * per
                + 48 * len(self._late_rows))

    @staticmethod
    def _panes_out(panes: dict) -> list:
        # sorted by (window_start, str(key)), ties in insertion order (a
        # stable sort's order), str(key) made once a key
        items = list(panes.items())
        strs = {key: str(key) for key in {key for _w, key in panes}}
        order = sorted([(w, strs[key], i)
                        for i, ((w, key), _a) in enumerate(items)])
        return [[items[i][0][0], list(items[i][0][1]), items[i][1]]
                for _w, _s, i in order]

    def snapshot(self) -> dict:
        return {"windows": self._panes_out(self._state),
                "fired": self._panes_out(self._fired),
                "late_records": self.late_records}

    def restore(self, state: dict) -> None:
        self._state = {(int(w), tuple(key)): list(accs)
                       for w, key, accs in (state.get("windows") or [])}
        self._fired = {(int(w), tuple(key)): list(accs)
                       for w, key, accs in (state.get("fired") or [])}
        self.late_records = int(state.get("late_records", 0))
        self.update_mem_used(self.state_bytes())

    def spill(self) -> int:
        # no colder tier (firing early would break event-time semantics):
        # nothing released, so quota arbitration climbs the degrade ladder
        return 0

    def close(self) -> None:
        self.unregister()
