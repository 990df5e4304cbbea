"""Equi-joins: sort-merge, shuffled-hash and broadcast, every join type
(port of the device-placement route of blaze_tpu/ops/joins/exec.py).

The build side becomes a HASH-SORTED table (`JoinMap`): xxhash64 (seed
42) over the join keys on the device, a stable device sort by hash, and a
run-length index over the unique hashes (kernels/join.py `build_runs`).
The sorted hashes, the run index and the build permutation stay on the
device for the life of the map, so a probe batch uploads nothing of the
build side.  Each probe batch is hashed on its device and probed there
(`probe_expand_device`: searchsorted, scan-based pair expansion, one
scalar sync, one copy of the pairs); every candidate pair is then
verified against the real key columns on the host, so a hash collision
never makes a wrong row.  The three exec flavours share this probe core.

This is the route the JAX package takes under device placement
(`host_resident()` False).  Its host-placement lanes (the Acero join
`_pa_join`, `_acero_sorted`, the join-key runtime filter and the
direct-address join) and the shuffled hash join's `smjfallback` branch
are not ported (ROADMAP Queue 1 item 11 follow-ups); keyless
(nested-loop) joins are `bnlj.py`'s.
"""

from __future__ import annotations

import enum
import itertools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.bridge.resource import get_or_create
from blaze_tpu_torch.exprs import BoundReference, PhysicalExpr
from blaze_tpu_torch.kernels import hashing as H
from blaze_tpu_torch.ops.base import BatchIterator, CoalesceStream, \
    ExecutionPlan
from blaze_tpu_torch.schema import BOOL, FLOAT64, INT64, Field, Schema

# process-unique default broadcast ids (see BroadcastJoinExec.__init__)
_local_bid = itertools.count()


class JoinType(enum.Enum):
    INNER = "inner"
    LEFT = "left"            # left outer
    RIGHT = "right"          # right outer
    FULL = "full"
    LEFT_SEMI = "left_semi"
    LEFT_ANTI = "left_anti"
    RIGHT_SEMI = "right_semi"
    RIGHT_ANTI = "right_anti"
    EXISTENCE = "existence"  # left rows + bool `exists` column


def _device_hash_keys(batch: ColumnBatch, key_exprs: Sequence[PhysicalExpr]
                      ) -> Tuple[torch.Tensor, torch.Tensor, List[pa.Array]]:
    """(xxhash64 int64[num_rows], any_null bool[num_rows], the key arrays
    on the host) of a compact batch.  The hash and the null mask stay on
    the batch's device; float keys are normalized (-0.0 -> 0.0, one NaN)
    first, utf8 keys cross to the device as padded byte matrices."""
    n = batch.num_rows
    cap = batch.capacity
    dev = batch.device
    flat_cols, tids, key_arrays = [], [], []
    for e in key_exprs:
        v = e.evaluate(batch)
        key_arrays.append(v.to_host(n))
        if v.is_device:
            flat_cols.append((v.data, v.validity))
        else:
            flat_cols.append(H.padded_string_key(key_arrays[-1], cap, dev))
        tids.append(v.dtype.id.value)
    flat_cols = H.norm_float_keys(flat_cols, tids)
    h = H.hash_columns([(v, val, tid) for (v, val), tid
                        in zip(flat_cols, tids)], seed=42, algo="xxhash64",
                       num_rows=cap)
    any_null = torch.zeros(cap, dtype=torch.bool, device=dev)
    for _v, val in flat_cols:
        any_null = any_null | ~val
    return h[:n], any_null[:n], key_arrays


def promote_join_key_exprs(lkeys, rkeys, lschema, rschema):
    """Widen mismatched numeric join-key pairs to a common type
    (int/int -> int64, a numeric mix -> float64) by a Cast, as Spark's
    analyzer does, so both sides hash and compare one type: xxhash64
    hashes int32 and int64 of equal value differently."""
    from blaze_tpu_torch.exprs.cast import Cast
    out_l, out_r = [], []
    for le, re in zip(lkeys, rkeys):
        lt = le.data_type(lschema)
        rt = re.data_type(rschema)
        if lt.id == rt.id:
            out_l.append(le)
            out_r.append(re)
            continue
        if lt.is_integer and rt.is_integer:
            common = INT64
        elif ((lt.is_integer or lt.is_floating) and
              (rt.is_integer or rt.is_floating)):
            common = FLOAT64
        else:
            out_l.append(le)
            out_r.append(re)
            continue
        out_l.append(le if lt.id == common.id else Cast(le, common))
        out_r.append(re if rt.id == common.id else Cast(re, common))
    return out_l, out_r


class JoinMap:
    """Hash-sorted build table (the JoinHashMap analog).  The device
    index is built on the first probe; `matched` records the build rows
    any probe matched (for outer, semi and anti joins of the build
    side)."""

    def __init__(self, table: pa.Table, key_exprs: Sequence[PhysicalExpr],
                 schema: Schema):
        self.table = table.combine_chunks()
        self.schema = schema
        self._key_exprs = list(key_exprs)
        self._built = False
        self.matched = np.zeros(self.table.num_rows, dtype=bool)

    def _ensure_index(self) -> None:
        if self._built:
            return
        from blaze_tpu_torch.kernels.join import build_runs
        n = self.table.num_rows
        if n:
            cb = ColumnBatch.from_arrow(self.table)
            hashes, any_null, self.key_arrays = _device_hash_keys(
                cb, self._key_exprs)
            # null keys never match: their pairs are dropped at verify
            self._valid = (~any_null).cpu().numpy()
            sorted_hashes, order = torch.sort(hashes, stable=True)
            self.sorted_idx = order.to(torch.int32 if n < (1 << 31)
                                       else torch.int64)
            self.uh, self.ustart, self.ucount = build_runs(sorted_hashes)
        else:
            self._valid = np.zeros(0, dtype=bool)
            self.key_arrays = []
        self._built = True

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    @property
    def has_null_keys(self) -> bool:
        self._ensure_index()
        return bool((~self._valid).any())

    def lookup(self, probe_hashes: torch.Tensor, probe_null: torch.Tensor,
               probe_keys: List[pa.Array]) -> Tuple[np.ndarray, np.ndarray]:
        """Candidate-verified (probe_idx, build_idx) int64 pair arrays."""
        n = probe_hashes.shape[0]
        if self.num_rows == 0 or n == 0:
            return (np.zeros(0, dtype=np.int64),) * 2
        self._ensure_index()
        from blaze_tpu_torch.kernels.join import probe_expand_device
        dev = self.uh.device
        probe_idx, build_idx = probe_expand_device(
            self.uh, self.ustart, self.ucount, self.sorted_idx,
            probe_hashes.to(dev), probe_null.to(dev))
        if not len(probe_idx):
            return (np.zeros(0, dtype=np.int64),) * 2
        # drop null-key build rows, then verify true equality per key
        # column (NaN == NaN for float keys: Spark join-key semantics)
        keep = self._valid[build_idx]
        for pk, bk in zip(probe_keys, self.key_arrays):
            if not keep.any():
                break
            pe = pk.take(pa.array(probe_idx, type=pa.int64()))
            be = bk.take(pa.array(build_idx, type=pa.int64()))
            eq = pc.equal(pe, be).fill_null(False)
            if pa.types.is_floating(pe.type):
                eq = pc.or_(eq, pc.and_(pc.is_nan(pe), pc.is_nan(be)))
                eq = eq.fill_null(False)
            keep &= np.asarray(eq)
        return probe_idx[keep], build_idx[keep]


def build_join_map(batches: Iterator[pa.RecordBatch], schema: Schema,
                   key_exprs: Sequence[PhysicalExpr]) -> JoinMap:
    blist = list(batches)
    table = (pa.Table.from_batches(blist) if blist
             else pa.Table.from_batches([], schema=schema.to_arrow()))
    return JoinMap(table, key_exprs, schema)


class BaseJoinExec(ExecutionPlan):
    """Shared probe core.  `build_side` names the child that is
    materialized into the JoinMap; the other streams through it."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 left_keys: Sequence[PhysicalExpr],
                 right_keys: Sequence[PhysicalExpr],
                 join_type: JoinType,
                 build_side: str = "right",
                 join_filter: Optional[PhysicalExpr] = None,
                 existence_col: str = "exists",
                 null_aware_anti: bool = False):
        super().__init__([left, right])
        assert build_side in ("left", "right")
        if not left_keys:
            raise ValueError(
                "an equi-join needs keys; a keyless join is a "
                "broadcast_nested_loop_join (ops/joins/bnlj.py)")
        self.left_keys, self.right_keys = promote_join_key_exprs(
            list(left_keys), list(right_keys), left.schema, right.schema)
        self.join_type = join_type
        self.build_side = build_side
        self.join_filter = join_filter
        self._existence_col = existence_col
        # NOT IN semantics: a NULL build key rejects every probe row, and
        # a NULL probe key never passes
        self.null_aware_anti = null_aware_anti
        self._out_schema = self._build_schema()

    # -- schema -------------------------------------------------------------
    def _build_schema(self) -> Schema:
        l, r = self.children[0].schema, self.children[1].schema
        jt = self.join_type
        if jt in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return l
        if jt in (JoinType.RIGHT_SEMI, JoinType.RIGHT_ANTI):
            return r
        if jt == JoinType.EXISTENCE:
            return Schema(list(l) + [Field(self._existence_col, BOOL, False)])
        fields = []
        for f in l:
            nullable = f.nullable or jt in (JoinType.RIGHT, JoinType.FULL)
            fields.append(Field(f.name, f.data_type, nullable))
        for f in r:
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

    # -- build side (BroadcastJoinExec overrides) ---------------------------
    def _get_join_map(self, partition: int) -> JoinMap:
        build = 1 if self.build_side == "right" else 0
        child = self.children[build]
        stream = (b.compact().to_arrow() for b in child.execute(partition))
        keys = self.right_keys if build == 1 else self.left_keys
        return build_join_map(stream, child.schema, keys)

    # -- execution ----------------------------------------------------------
    def execute(self, partition: int) -> BatchIterator:
        return self._probe_with_map(self._get_join_map(partition),
                                    partition)

    def _probe_with_map(self, jmap: JoinMap, partition: int
                        ) -> BatchIterator:
        probe_is_left = self.build_side == "right"
        probe = self.children[0 if probe_is_left else 1]
        probe_keys = self.left_keys if probe_is_left else self.right_keys
        return iter(CoalesceStream(
            self._stream_probe(jmap, probe.execute(partition), probe_keys,
                               probe_is_left),
            metrics=self.metrics))

    def _stream_probe(self, jmap, batches, probe_keys, probe_is_left):
        """Batches stream through the lookup; the build index is hashed
        once."""
        for batch in batches:
            batch = batch.compact()
            if batch.num_rows == 0:
                continue
            yield from self._probe_batch(jmap, batch, probe_keys,
                                         probe_is_left)
        yield from self._emit_unmatched_build(jmap, probe_is_left)

    # -- probe one batch ----------------------------------------------------
    def _probe_batch(self, jmap: JoinMap, batch: ColumnBatch,
                     probe_keys: Sequence[PhysicalExpr], probe_is_left: bool
                     ) -> Iterator[ColumnBatch]:
        n = batch.num_rows
        hashes, any_null, key_arrays = _device_hash_keys(batch, probe_keys)
        self.metrics.add("probe_batches", 1)
        p_idx, b_idx = jmap.lookup(hashes, any_null, key_arrays)
        probe_rb = batch.to_arrow()

        if self.join_filter is not None and len(p_idx):
            mask = self._apply_filter(probe_rb, jmap, p_idx, b_idx,
                                      probe_is_left)
            p_idx, b_idx = p_idx[mask], b_idx[mask]

        jt = self.join_type
        jmap.matched[b_idx] = True
        match_count = np.bincount(p_idx, minlength=n)

        probe_semi = ((jt == JoinType.LEFT_SEMI and probe_is_left) or
                      (jt == JoinType.RIGHT_SEMI and not probe_is_left))
        probe_anti = ((jt == JoinType.LEFT_ANTI and probe_is_left) or
                      (jt == JoinType.RIGHT_ANTI and not probe_is_left))
        if probe_anti and self.null_aware_anti and jmap.num_rows:
            if jmap.has_null_keys:
                return  # NULL in the IN-list: nothing ever qualifies
            # NOT IN over a non-empty list: a NULL probe key is UNKNOWN
            keep = np.nonzero((match_count == 0)
                              & ~any_null.cpu().numpy())[0]
            yield from self._emit_probe_rows(probe_rb, keep)
            return
        if probe_semi or probe_anti:
            keep = np.nonzero(match_count > 0 if probe_semi
                              else match_count == 0)[0]
            yield from self._emit_probe_rows(probe_rb, keep)
            return
        if jt in (JoinType.LEFT_SEMI, JoinType.RIGHT_SEMI,
                  JoinType.LEFT_ANTI, JoinType.RIGHT_ANTI):
            # semi/anti of the BUILD side: the probe records matches;
            # _emit_unmatched_build emits
            return
        if jt == JoinType.EXISTENCE:
            arrays = list(probe_rb.columns) + \
                [pa.array(match_count > 0, type=pa.bool_())]
            yield ColumnBatch.from_arrow(pa.RecordBatch.from_arrays(
                arrays, schema=self.schema.to_arrow()))
            return

        # inner/outer: matched pairs
        outer_probe = (jt == JoinType.FULL or
                       (jt == JoinType.LEFT and probe_is_left) or
                       (jt == JoinType.RIGHT and not probe_is_left))
        if outer_probe:
            un = np.nonzero(match_count == 0)[0]
            if len(un):
                p_idx = np.concatenate([p_idx, un])
                b_idx = np.concatenate([b_idx,
                                        np.full(len(un), -1, dtype=np.int64)])
        if not len(p_idx):
            return
        yield self._materialize(probe_rb, jmap, p_idx, b_idx, probe_is_left)

    def _emit_probe_rows(self, probe_rb: pa.RecordBatch, keep: np.ndarray
                         ) -> Iterator[ColumnBatch]:
        """The probe rows at `keep` (a semi or anti join's output)."""
        if len(keep):
            yield ColumnBatch.from_arrow(
                probe_rb.take(pa.array(keep, type=pa.int64())))

    def _apply_filter(self, probe_rb, jmap: JoinMap, p_idx, b_idx,
                      probe_is_left) -> np.ndarray:
        joined = self._joined_batch(probe_rb, jmap, p_idx, b_idx,
                                    probe_is_left, allow_missing=False)
        v = self.join_filter.evaluate(joined)
        return v.as_mask(joined).cpu().numpy()[:joined.num_rows]

    def _joined_batch(self, probe_rb, jmap, p_idx, b_idx, probe_is_left,
                      allow_missing=True) -> ColumnBatch:
        pt = probe_rb.take(pa.array(p_idx, type=pa.int64()))
        bi = pa.array(b_idx, type=pa.int64())
        if jmap.num_rows == 0:
            bt_cols = [pa.nulls(len(b_idx), f.data_type.to_arrow())
                       for f in jmap.schema]
        elif allow_missing and (b_idx < 0).any():
            bi = pa.array(np.where(b_idx < 0, 0, b_idx), type=pa.int64())
            bt = jmap.table.take(bi)
            null_mask = b_idx < 0
            bt_cols = [_null_out(c, null_mask) for c in bt.columns]
        else:
            bt = jmap.table.take(bi)
            bt_cols = [c.combine_chunks() if isinstance(c, pa.ChunkedArray)
                       else c for c in bt.columns]
        left_cols = (list(pt.columns) if probe_is_left else bt_cols)
        right_cols = (bt_cols if probe_is_left else list(pt.columns))
        arrays = left_cols + right_cols
        out_schema = self.schema if self.join_type in (
            JoinType.INNER, JoinType.LEFT, JoinType.RIGHT, JoinType.FULL) \
            else Schema(list(self.children[0].schema) +
                        list(self.children[1].schema))
        arrays = [a.combine_chunks() if isinstance(a, pa.ChunkedArray) else a
                  for a in arrays]
        rb = pa.RecordBatch.from_arrays(
            [a.cast(f.data_type.to_arrow(), safe=False)
             if not a.type.equals(f.data_type.to_arrow()) else a
             for a, f in zip(arrays, out_schema)],
            schema=out_schema.to_arrow())
        return ColumnBatch.from_arrow(rb)

    def _materialize(self, probe_rb, jmap, p_idx, b_idx, probe_is_left
                     ) -> ColumnBatch:
        return self._joined_batch(probe_rb, jmap, p_idx, b_idx, probe_is_left)

    def _emit_unmatched_build(self, jmap: JoinMap, probe_is_left: bool
                              ) -> Iterator[ColumnBatch]:
        jt = self.join_type
        build_outer = (jt == JoinType.FULL or
                       (jt == JoinType.RIGHT and probe_is_left) or
                       (jt == JoinType.LEFT and not probe_is_left))
        build_semi = ((jt == JoinType.RIGHT_SEMI and probe_is_left) or
                      (jt == JoinType.LEFT_SEMI and not probe_is_left))
        build_anti = ((jt == JoinType.RIGHT_ANTI and probe_is_left) or
                      (jt == JoinType.LEFT_ANTI and not probe_is_left))
        if build_semi or build_anti:
            want = jmap.matched if build_semi else ~jmap.matched
            idx = np.nonzero(want)[0]
            if len(idx):
                rb = jmap.table.take(pa.array(idx, type=pa.int64())) \
                    .combine_chunks()
                yield ColumnBatch.from_arrow(rb.to_batches()[0])
            return
        if not build_outer or jmap.num_rows == 0:
            return
        idx = np.nonzero(~jmap.matched)[0]
        if not len(idx):
            return
        bt = jmap.table.take(pa.array(idx, type=pa.int64()))
        probe_schema = self.children[0 if probe_is_left else 1].schema
        null_probe = [pa.nulls(len(idx), f.data_type.to_arrow())
                      for f in probe_schema]
        bt_cols = [c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c
                   for c in bt.columns]
        arrays = (null_probe + bt_cols) if probe_is_left else \
            (bt_cols + null_probe)
        rb = pa.RecordBatch.from_arrays(arrays, schema=self.schema.to_arrow())
        yield ColumnBatch.from_arrow(rb)


def _null_out(col, null_mask: np.ndarray) -> pa.Array:
    col = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    return pc.if_else(pa.array(~null_mask), col,
                      pa.nulls(len(col), col.type))


def _same_key(a: PhysicalExpr, b: PhysicalExpr) -> bool:
    """Two key expressions that evaluate to the same values (a column
    reference is its index, whatever its name)."""
    if isinstance(a, BoundReference) and isinstance(b, BoundReference):
        return a.index == b.index
    return a == b


class SortMergeJoinExec(BaseJoinExec):
    """Streaming merge join over key-sorted children (ascending, nulls
    first).  A child that is already a SortExec on the join keys streams
    straight through; otherwise a SortExec on the keys is inserted."""

    def _sorted_child(self, side: int) -> ExecutionPlan:
        from blaze_tpu_torch.ops.sort import SortExec
        child = self.children[side]
        keys = self.left_keys if side == 0 else self.right_keys
        if isinstance(child, SortExec):
            specs = child._specs
            if len(specs) >= len(keys) and all(
                    _same_key(s[0], k) and not s[1] and s[2]
                    for s, k in zip(specs, keys)):
                return child
        return SortExec(child, [(k, False, True) for k in keys])

    def execute(self, partition: int) -> BatchIterator:
        from blaze_tpu_torch.ops.joins.smj import MergeJoiner, _Side

        def gen():
            joiner = MergeJoiner(self.children[0].schema,
                                 self.children[1].schema, self.schema,
                                 self.join_type, self.join_filter)
            left, right = (
                _Side(self._sorted_child(i).execute(partition),
                      self.left_keys if i == 0 else self.right_keys,
                      self.children[i].schema) for i in (0, 1))
            for rb in joiner.join(left, right):
                yield ColumnBatch.from_arrow(rb)
        return iter(CoalesceStream(gen(), metrics=self.metrics))


class ShuffledHashJoinExec(BaseJoinExec):
    """Shuffled hash join: the build side is one shuffled partition.  The
    JAX package's `auron.smjfallback.enable` branch (re-run as a
    sort-merge join past a build-size threshold) is not ported."""

    def execute(self, partition: int) -> BatchIterator:
        if str(config.conf.get_raw("auron.smjfallback.enable") or "") \
                .strip().lower() in ("1", "true", "yes", "on"):
            raise NotImplementedError(
                "auron.smjfallback.enable: the hash join's sort-merge "
                "fallback is not ported (ROADMAP Queue 1 item 11)")
        return super().execute(partition)


class BroadcastJoinExec(BaseJoinExec):
    """Broadcast hash join: the build side is materialized and hashed once
    per broadcast and cached in the resource map."""

    def __init__(self, *args, broadcast_id: Optional[str] = None, **kw):
        super().__init__(*args, **kw)
        # default ids must be process-unique forever: a recycled id would
        # serve a stale build map out of the long-lived cache
        self._broadcast_id = broadcast_id or f"bhj-{next(_local_bid)}"

    def _get_join_map(self, partition: int) -> JoinMap:
        build = 1 if self.build_side == "right" else 0
        child = self.children[build]

        def factory():
            keys = self.right_keys if build == 1 else self.left_keys
            batches = []
            for p in range(child.num_partitions):
                batches.extend(b.compact().to_arrow()
                               for b in child.execute(p))
            return build_join_map(iter(batches), child.schema, keys)
        # the key folds the build side's output schema: two plans sharing
        # one broadcast_id must not serve each other different columns
        sig = ",".join(f.name for f in child.schema)
        return get_or_create(
            f"join_map://{self._broadcast_id}/{hash(sig) & 0xffffffff:x}",
            factory)


class BuildHashMapExec(ExecutionPlan):
    """Broadcast build-map stage: materializes the build side once per
    broadcast so BroadcastJoinExec tasks share it through the resource
    map.  Batches stream through unchanged."""

    def __init__(self, child: ExecutionPlan, keys: Sequence[PhysicalExpr],
                 cache_id: Optional[str] = None):
        super().__init__([child])
        self.keys = list(keys)
        self.cache_id = cache_id

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        child = self.children[0]
        if not self.cache_id:  # no consumer to share with: stream through
            yield from child.execute(partition)
            return
        batches = [b.compact() for b in child.execute(partition)]
        arrow = [b.to_arrow() for b in batches]
        get_or_create(
            f"join_map://{self.cache_id}",
            lambda: build_join_map(iter(arrow), child.schema, self.keys))
        yield from iter(batches)
