"""Broadcast nested-loop join: joins without equi-keys over a broadcast
side (port of blaze_tpu/ops/joins/bnlj.py, Spark's
BroadcastNestedLoopJoinExec).

There is no keyed probe: every probe row pairs with every build row
through the condition.  The cross product runs in chunks of at most
`auron.batch.size` pairs (whole probe rows against the whole build side,
or one probe row against a slice of a larger build side), in the
reference's pair order, so it never materializes at once.  The condition
is evaluated on the batch's device: each chunk's joined rows become a
ColumnBatch there, and only the kept pairs' indices come back.  Every
join type of the reference, the existence output and the join filter;
the build is collected once per `broadcast_id` and shared by every probe
partition.

Counters: the standard meter's (ops/base.py), and `cuda_batches`/
`cpu_batches` for the chunks whose condition ran on each device.
"""

from __future__ import annotations

import threading
from typing import Iterator, List, Optional

import numpy as np
import pyarrow as pa

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.base import BatchIterator, CoalesceStream, \
    ExecutionPlan
from blaze_tpu_torch.ops.joins.exec import JoinType, _local_bid, _null_out
from blaze_tpu_torch.schema import BOOL, Field, Schema


class BroadcastNestedLoopJoinExec(ExecutionPlan):

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 join_type: JoinType, build_side: str = "right",
                 join_filter: Optional[PhysicalExpr] = None,
                 existence_col: str = "exists",
                 broadcast_id: Optional[str] = None):
        super().__init__([left, right])
        assert build_side in ("left", "right")
        if join_type == JoinType.EXISTENCE and build_side != "right":
            # the existence output carries LEFT rows and a flag: the left
            # side must probe (Spark's BNLJ imposes the same)
            raise ValueError("existence BNLJ requires build_side='right'")
        self.join_type = join_type
        self.build_side = build_side
        self.join_filter = join_filter
        self._existence_col = existence_col
        # process-unique, never recycled (an id(self) can come back for a
        # new object and hit a stale cache entry)
        self._broadcast_id = broadcast_id or f"bnlj-{next(_local_bid)}"
        self._out_schema = self._build_schema()
        # the matched build rows are shared across probe partitions
        # (Spark unions matchedBroadcastRows); the LAST partition to
        # finish emits the unmatched build rows
        self._state_lock = threading.Lock()
        self._build_matched: Optional[np.ndarray] = None
        self._pending_partitions: Optional[set] = None

    def _build_schema(self) -> Schema:
        left, right = self.children[0].schema, self.children[1].schema
        jt = self.join_type
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return left
        if jt in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return right
        if jt == JoinType.EXISTENCE:
            return Schema(list(left) + [Field(self._existence_col, BOOL,
                                              False)])
        fields = []
        for f in left:
            nullable = f.nullable or jt in (JoinType.RIGHT, JoinType.FULL)
            fields.append(Field(f.name, f.data_type, nullable))
        for f in right:
            nullable = f.nullable or jt in (JoinType.LEFT, JoinType.FULL)
            fields.append(Field(f.name, f.data_type, nullable))
        return Schema(fields)

    @property
    def schema(self) -> Schema:
        return self._out_schema

    @property
    def num_partitions(self) -> int:
        probe = 0 if self.build_side == "right" else 1
        return self.children[probe].num_partitions

    def _collect_build(self) -> pa.Table:
        from blaze_tpu_torch.bridge.resource import get_or_create

        def factory() -> pa.Table:
            child = self.children[1 if self.build_side == "right" else 0]
            batches: List[pa.RecordBatch] = []
            for p in range(child.num_partitions):
                batches.extend(b.compact().to_arrow()
                               for b in child.execute(p))
            batches = [b for b in batches if b.num_rows]
            if not batches:
                return pa.Table.from_batches(
                    [], schema=child.schema.to_arrow())
            return pa.Table.from_batches(batches).combine_chunks()

        # built once per broadcast, shared by every probe partition
        return get_or_create(f"bnlj://{self._broadcast_id}", factory)

    def execute(self, partition: int) -> BatchIterator:
        build_tbl = self._collect_build()
        probe_is_left = self.build_side == "right"
        probe = self.children[0 if probe_is_left else 1]
        with self._state_lock:
            if self._build_matched is None:
                self._build_matched = np.zeros(build_tbl.num_rows,
                                               dtype=bool)
                self._pending_partitions = set(range(self.num_partitions))
        build_matched = self._build_matched

        def gen():
            for batch in probe.execute(partition):
                batch = batch.compact()
                if batch.num_rows == 0:
                    continue
                yield from self._join_batch(batch.to_arrow(), build_tbl,
                                            build_matched, probe_is_left)
            with self._state_lock:
                self._pending_partitions.discard(partition)
                last = not self._pending_partitions
            if last:
                yield from self._emit_unmatched_build(
                    build_tbl, build_matched, probe_is_left)

        return iter(CoalesceStream(gen(), metrics=self.metrics))

    # ------------------------------------------------------------------
    def _pairs(self, probe_rb: pa.RecordBatch, build_tbl: pa.Table):
        """(probe_idx, build_idx) of the kept pairs, chunk by chunk over
        the cross product."""
        pn, bn = probe_rb.num_rows, build_tbl.num_rows
        if bn == 0:
            return
        size = config.BATCH_SIZE.get()
        if bn <= size:  # whole probe rows against the whole build side
            block = size // bn
            chunks = ((ps, min(ps + block, pn), 0, bn)
                      for ps in range(0, pn, block))
        else:  # one probe row against a slice of the build side
            chunks = ((p, p + 1, bs, min(bs + size, bn))
                      for p in range(pn) for bs in range(0, bn, size))
        for ps, pe, bs, be in chunks:
            p_idx = np.repeat(np.arange(ps, pe, dtype=np.int64), be - bs)
            b_idx = np.tile(np.arange(bs, be, dtype=np.int64), pe - ps)
            if self.join_filter is None:
                yield p_idx, b_idx
                continue
            cb = ColumnBatch.from_arrow(
                self._joined(probe_rb, build_tbl, p_idx, b_idx))
            self.metrics.add(f"{cb.device.type}_batches")
            keep = self.join_filter.evaluate(cb).as_mask(cb)[:cb.num_rows]
            keep = keep.cpu().numpy()
            yield p_idx[keep], b_idx[keep]

    def _joined(self, probe_rb, build_tbl, p_idx, b_idx) -> pa.RecordBatch:
        """The joined rows of the pairs, left columns then right; a build
        index of -1 gives nulls on the build side."""
        pt = probe_rb.take(pa.array(p_idx, type=pa.int64()))
        if build_tbl.num_rows:
            bt = build_tbl.take(pa.array(np.where(b_idx < 0, 0, b_idx),
                                         type=pa.int64()))
            bt_cols = [c.combine_chunks() for c in bt.columns]
            if (b_idx < 0).any():
                mask = b_idx < 0
                bt_cols = [_null_out(c, mask) for c in bt_cols]
        else:
            build_schema = self.children[
                1 if self.build_side == "right" else 0].schema
            bt_cols = [pa.nulls(len(b_idx), f.data_type.to_arrow())
                       for f in build_schema]
        probe_is_left = self.build_side == "right"
        left_cols = list(pt.columns) if probe_is_left else bt_cols
        right_cols = bt_cols if probe_is_left else list(pt.columns)
        return pa.RecordBatch.from_arrays(
            [a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a
             for a in left_cols + right_cols],
            schema=pa.schema(
                [f.to_arrow() for f in self.children[0].schema] +
                [f.to_arrow() for f in self.children[1].schema]))

    def _project_out(self, rb: pa.RecordBatch) -> ColumnBatch:
        out_arrow = self.schema.to_arrow()
        arrays = [col.cast(f.type, safe=False)
                  if not col.type.equals(f.type) else col
                  for col, f in zip(rb.columns, out_arrow)]
        return ColumnBatch.from_arrow(
            pa.RecordBatch.from_arrays(arrays, schema=out_arrow))

    def _join_batch(self, probe_rb, build_tbl, build_matched,
                    probe_is_left) -> Iterator[ColumnBatch]:
        jt = self.join_type
        probe_matched = np.zeros(probe_rb.num_rows, dtype=bool)
        pair_emitting = jt in (JoinType.INNER, JoinType.LEFT,
                               JoinType.RIGHT, JoinType.FULL)
        for p_idx, b_idx in self._pairs(probe_rb, build_tbl):
            probe_matched[p_idx] = True
            build_matched[b_idx] = True
            if pair_emitting and len(p_idx):
                yield self._project_out(
                    self._joined(probe_rb, build_tbl, p_idx, b_idx))

        probe_semi = ((jt == JoinType.LEFT_SEMI and probe_is_left) or
                      (jt == JoinType.RIGHT_SEMI and not probe_is_left))
        probe_anti = ((jt == JoinType.LEFT_ANTI and probe_is_left) or
                      (jt == JoinType.RIGHT_ANTI and not probe_is_left))
        if probe_semi or probe_anti:
            keep = np.nonzero(probe_matched if probe_semi
                              else ~probe_matched)[0]
            if len(keep):
                yield ColumnBatch.from_arrow(
                    probe_rb.take(pa.array(keep, type=pa.int64())))
            return
        if jt == JoinType.EXISTENCE:
            arrays = list(probe_rb.columns) + \
                [pa.array(probe_matched, type=pa.bool_())]
            yield ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
                arrays, schema=self.schema.to_arrow()))
            return
        outer_probe = (jt == JoinType.FULL or
                       (jt == JoinType.LEFT and probe_is_left) or
                       (jt == JoinType.RIGHT and not probe_is_left))
        if outer_probe:
            un = np.nonzero(~probe_matched)[0]
            if len(un):
                yield self._project_out(self._joined(
                    probe_rb, build_tbl, un,
                    np.full(len(un), -1, dtype=np.int64)))

    def _emit_unmatched_build(self, build_tbl, build_matched,
                              probe_is_left) -> Iterator[ColumnBatch]:
        jt = self.join_type
        build_outer = (jt == JoinType.FULL or
                       (jt == JoinType.RIGHT and probe_is_left) or
                       (jt == JoinType.LEFT and not probe_is_left))
        build_semi = ((jt == JoinType.RIGHT_SEMI and probe_is_left) or
                      (jt == JoinType.LEFT_SEMI and not probe_is_left))
        build_anti = ((jt == JoinType.RIGHT_ANTI and probe_is_left) or
                      (jt == JoinType.LEFT_ANTI and not probe_is_left))
        if build_semi or build_anti:
            want = build_matched if build_semi else ~build_matched
            idx = np.nonzero(want)[0]
            if len(idx):
                rb = build_tbl.take(pa.array(idx, type=pa.int64())) \
                    .combine_chunks()
                yield ColumnBatch.from_arrow(rb.to_batches()[0])
            return
        if not build_outer or build_tbl.num_rows == 0:
            return
        idx = np.nonzero(~build_matched)[0]
        if not len(idx):
            return
        bt = build_tbl.take(pa.array(idx, type=pa.int64()))
        probe_schema = self.children[0 if probe_is_left else 1].schema
        null_probe = [pa.nulls(len(idx), f.data_type.to_arrow())
                      for f in probe_schema]
        bt_cols = [c.combine_chunks() for c in bt.columns]
        arrays = (null_probe + bt_cols) if probe_is_left else \
            (bt_cols + null_probe)
        rb = pa.RecordBatch.from_arrays(
            arrays, schema=pa.schema(
                [f.to_arrow() for f in self.children[0].schema] +
                [f.to_arrow() for f in self.children[1].schema]))
        yield self._project_out(rb)
