"""Fused aggregation: planner trees -> one step per batch on a device hash
table (port of the hash lane of blaze_tpu/plan/fused.py).

`fuse_plan` rewrites an eligible `AggExec` (sum/count/min/max over
fixed-width keys) into `FusedPartialAggExec`.  The filter/project chain
between the aggregation and its source is absorbed: each source batch is
filtered, projected and inserted into the group table in one step,
evaluated eagerly on the device (the JAX package traces the same chain
into one XLA program).  The table is the open-addressing carry of
parallel/stage.py, placed by the CUDA placement kernel on the card.

Overflow handling is the JAX package's: exact modes (final, merge,
complete) double the table and rehash; PARTIAL mode emits what it has and
degrades to batch-local tables passed straight through, since the final
stage re-merges.  Nothing is emitted before the table's final drain,
except by the partial-mode skip.

The JAX package also plans a dense lane when every key is an integer with
known bounds (parquet statistics) that survive the sparsity heuristic.
That lane, with its window-table kernel, belongs to the next slice: here
the plan raises NotImplementedError where JAX would take it, so the lane
choice never differs from JAX's unseen.  So do string keys, the host
Arrow lane and the device stage loop.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import (ColumnBatch, DeviceColumn,
                                   bucket_capacity)
from blaze_tpu_torch.exprs import BoundReference, PhysicalExpr
from blaze_tpu_torch.ops.agg import (AggExec, AggMode, CountAgg, MinMaxAgg,
                                     SumAgg)
from blaze_tpu_torch.ops.agg.exec import build_agg_schema
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.ops.basic import FilterExec, ProjectExec, \
    apply_filter, apply_project
from blaze_tpu_torch.ops.scan import ParquetScanExec, parquet_metadata
from blaze_tpu_torch.parallel.stage import (HashAggCarry, hash_agg_step,
                                            init_hash_carry, rehash_carry)
from blaze_tpu_torch.schema import Schema

_DENSE_LATER = ("belongs to the next slice of the PyTorch port (ROADMAP "
                "Queue 2 item 1: the window-table kernel with the dense "
                "lane)")


def fuse_plan(plan: ExecutionPlan) -> ExecutionPlan:
    """Rewrite eligible AggExec nodes into FusedPartialAggExec, in place
    for inner nodes."""
    if not config.FUSED_STAGE_ENABLE.get():
        return plan
    replaced = _try_fuse_agg(plan)
    if replaced is not None:
        plan = replaced
    for i, child in enumerate(plan.children):
        plan.children[i] = fuse_plan(child)
    return plan


# ---------------------------------------------------------------------------
# eligibility + bounds discovery
# ---------------------------------------------------------------------------

_FUSABLE_CHAIN = (FilterExec, ProjectExec)


def _try_fuse_agg(node: ExecutionPlan) -> Optional["FusedPartialAggExec"]:
    """None where the JAX package keeps the generic AggExec (which raises
    in this slice); raises where JAX would take a lane this slice lacks."""
    if not isinstance(node, AggExec):
        return None
    groups = node._group_exprs
    aggs = node._aggs
    if not groups or not aggs:
        return None
    child = node.children[0]
    in_schema = child.schema

    modes = {m for _, m, _ in aggs}
    if len(modes) != 1:
        return None
    mode = next(iter(modes))
    complete = mode in (AggMode.COMPLETE, AggMode.FINAL)
    merging = mode in (AggMode.PARTIAL_MERGE, AggMode.FINAL)

    specs: List[Tuple[str, str, Optional[PhysicalExpr]]] = []
    for fn, _m, _name in aggs:
        if isinstance(fn, SumAgg):
            out_kind = "sum"
        elif isinstance(fn, CountAgg):
            out_kind = "count"
        elif isinstance(fn, MinMaxAgg):
            out_kind = fn.name  # "min" | "max"
        else:
            return None
        arg = fn.children[0] if fn.children else None
        if merging and arg is None:
            return None  # merge modes must reference their acc column
        if arg is not None and not arg.data_type(in_schema).is_fixed_width:
            return None
        if out_kind in ("sum", "min", "max"):
            if arg is None or not (arg.data_type(in_schema).is_integer or
                                   arg.data_type(in_schema).is_floating):
                return None
        # merging counts SUMS the partial counts
        reduce_kind = "sum" if (merging and out_kind == "count") \
            else out_kind
        specs.append((reduce_kind, out_kind, arg))

    key_types = [e.data_type(in_schema) for e, _ in groups]
    if not all(t.is_fixed_width for t in key_types):
        raise NotImplementedError(
            "aggregation over string keys (the host Arrow lane and the "
            "dictionary-code lane) belongs to the strings slice of the "
            "PyTorch port (ROADMAP Queue 1 item 13)")

    # the JAX package's dense lane: integer keys with discoverable bounds
    # whose table is not much sparser than the input
    if all(t.is_integer for t in key_types):
        ranges = _discover_ranges(child, groups)
        if ranges is not None:
            total = 1
            for lo, hi in ranges:
                total *= (hi - lo + 2)
            if total > config.FUSED_STAGE_CAPACITY.get():
                ranges = None
            elif total > (1 << 20):
                rows = _source_row_count(child)
                if rows is not None and total > 4 * rows:
                    ranges = None
        if ranges is not None:
            raise NotImplementedError(
                f"the dense aggregation lane (key ranges {ranges}, bounded "
                f"by parquet statistics) {_DENSE_LATER}")
    grow = complete or merging
    source, chain = _absorbable_chain(child)
    return FusedPartialAggExec(child, groups, aggs, specs, grow,
                               source=source, chain=chain)


def _absorbable_chain(child: ExecutionPlan):
    """Peel Filter/Project off the agg's child.  Returns (source_plan,
    chain_steps) with chain_steps in source -> agg order."""
    steps = []
    node = child
    while True:
        if isinstance(node, FilterExec):
            steps.append(("filter", node._predicates, None, None))
        elif isinstance(node, ProjectExec):
            steps.append(("project", None, node._exprs, node.schema))
        else:
            break
        node = node.children[0]
    steps.reverse()
    return node, steps


def _source_row_count(child: ExecutionPlan) -> Optional[int]:
    """Total input rows from parquet footers; None when the source is not
    a parquet scan."""
    node = child
    while isinstance(node, _FUSABLE_CHAIN):
        node = node.children[0]
    if not isinstance(node, ParquetScanExec):
        return None
    try:
        return sum(parquet_metadata(path).num_rows
                   for group in node._file_groups for path in group)
    except OSError:
        return None


def _discover_ranges(child: ExecutionPlan,
                     groups) -> Optional[List[Tuple[int, int]]]:
    ranges = []
    for e, _name in groups:
        b = _column_bounds(child, e)
        if b is None:
            return None
        ranges.append(b)
    return ranges


def _column_bounds(node: ExecutionPlan,
                   expr: PhysicalExpr) -> Optional[Tuple[int, int]]:
    """Trace a grouping expression down a schema-transparent chain to its
    source scan column and read its global [min, max] from parquet
    row-group statistics."""
    while True:
        if not isinstance(expr, BoundReference):
            return None
        if isinstance(node, FilterExec):
            node = node.children[0]
            continue
        if isinstance(node, ProjectExec):
            if expr.index >= len(node._exprs):
                return None
            expr = node._exprs[expr.index]
            node = node.children[0]
            continue
        break
    if isinstance(node, ParquetScanExec):
        return _parquet_bounds(node, expr.index)
    return None


def _parquet_bounds(scan: ParquetScanExec,
                    col_index: int) -> Optional[Tuple[int, int]]:
    name = scan.schema[col_index].name
    lo = hi = None
    for group in scan._file_groups:
        for path in group:
            try:
                md = parquet_metadata(path)
            except OSError:
                return None
            names = md.schema.names
            if name not in names:
                return None
            fidx = names.index(name)
            for rg in range(md.num_row_groups):
                st = md.row_group(rg).column(fidx).statistics
                if st is None or not st.has_min_max:
                    return None
                mn, mx = st.min, st.max
                if not isinstance(mn, int):
                    return None
                lo = mn if lo is None else min(lo, mn)
                hi = mx if hi is None else max(hi, mx)
    if lo is None:
        return None
    return int(lo), int(hi)


# ---------------------------------------------------------------------------
# the fused operator: hash lane
# ---------------------------------------------------------------------------

class FusedPartialAggExec(ExecutionPlan):
    """Replacement for an AggExec over fixed-width keys: same output
    schema; one table step per source batch."""

    def __init__(self, child: ExecutionPlan, group_exprs, aggs,
                 specs: Sequence[Tuple[str, str, Optional[PhysicalExpr]]],
                 grow: bool, source: ExecutionPlan, chain):
        super().__init__([child])
        self._group_exprs = list(group_exprs)
        self._aggs = list(aggs)
        self._specs = list(specs)  # (reduce_kind, out_kind, arg)
        self._grow = grow  # exact modes grow the table instead of skipping
        self._in_schema = child.schema
        self._out_schema = build_agg_schema(self._in_schema,
                                            self._group_exprs, self._aggs)
        self._source = source
        self._chain = list(chain)

    @property
    def schema(self) -> Schema:
        return self._out_schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions

    def _acc_dtypes(self) -> Tuple[torch.dtype, ...]:
        """Carry accumulator dtype per spec."""
        out = []
        for rk, _ok, arg in self._specs:
            if rk == "count" or arg is None:
                out.append(torch.int64)
                continue
            dt = arg.data_type(self._in_schema).torch_dtype()
            if rk == "sum":
                dt = torch.float64 if dt.is_floating_point else torch.int64
            out.append(dt)
        return tuple(out)

    def _step(self, carry: HashAggCarry, batch: ColumnBatch):
        """Chain + placement + accumulation for one source batch."""
        kd, kv, ad, av, mask = self._device_inputs(batch)
        specs = [(rk, d, v) for (rk, _ok, _a), d, v in
                 zip(self._specs, ad, av)]
        return hash_agg_step(carry, list(zip(kd, kv)), specs, mask)

    def execute(self, partition: int) -> BatchIterator:
        return self._execute_sorted(partition)

    # -- unbounded keys: device open-addressing hash table -----------------
    def _execute_sorted(self, partition: int) -> BatchIterator:
        slots = _pow2(config.ON_DEVICE_AGG_CAPACITY.get())
        kinds = tuple(rk for rk, _ok, _a in self._specs)
        key_dtypes = [e.data_type(self._in_schema).torch_dtype()
                      for e, _n in self._group_exprs]
        carry = None
        skipping = False
        for batch in self._source.execute(partition):
            # input batches by device type (cuda_batches / cpu_batches)
            self.metrics.add(f"{batch.device.type}_batches")
            if skipping:
                # batch-local dedup, passed through (the final stage
                # re-merges)
                yield from self._emit_hash(
                    self._insert_batch_local(key_dtypes, kinds, batch))
                continue
            if carry is None:
                carry = init_hash_carry(key_dtypes, kinds,
                                        self._acc_dtypes(), slots,
                                        batch.device)
            new_carry, overflow, _ng = self._step(carry, batch)
            while overflow > 0:
                if not self._grow:
                    new_carry = None
                    break
                # exact modes double and rehash; the step is atomic, so
                # the carry is intact
                slots *= 2
                self.metrics.add("table_grown", 1)
                bigger, re_ovf, _ = rehash_carry(carry, list(kinds), slots)
                if re_ovf > 0:
                    continue  # rare probe clustering: double again
                carry = bigger
                new_carry, overflow, _ng = self._step(carry, batch)
            if new_carry is None:
                skipping = True
                self.metrics.add("partial_skipped", 1)
                yield from self._emit_hash(carry)
                carry = None
                yield from self._emit_hash(
                    self._insert_batch_local(key_dtypes, kinds, batch))
                continue
            carry = new_carry
        if carry is not None:
            yield from self._emit_hash(carry)

    def _insert_batch_local(self, key_dtypes, kinds, batch):
        """One batch into a fresh table (grow-on-overflow; a batch has at
        most capacity distinct groups, so this terminates)."""
        slots = _pow2(2 * batch.capacity)
        while True:
            local = init_hash_carry(key_dtypes, kinds, self._acc_dtypes(),
                                    slots, batch.device)
            out, overflow, _ng = self._step(local, batch)
            if overflow == 0:
                return out
            slots *= 2

    def _emit_hash(self, carry: HashAggCarry) -> BatchIterator:
        """The table's used slots in slot order, as device batches."""
        sel = torch.nonzero(carry.used).squeeze(1)
        if sel.shape[0] == 0:
            return
        keys = [(k.index_select(0, sel), v.index_select(0, sel))
                for k, v in zip(carry.keys, carry.key_valid)]
        accs = [a.index_select(0, sel) for a in carry.accs]
        avalid = [v.index_select(0, sel) for v in carry.acc_valid]
        yield from self._emit_rows(keys, accs, avalid)

    # -- shared emission ----------------------------------------------------
    def _device_inputs(self, batch: ColumnBatch):
        """Run the absorbed chain on a source batch, then evaluate the
        grouping keys and aggregate arguments: (kd, kv, ad, av, mask)."""
        cap = batch.capacity
        for kind, preds, exprs, out_schema in self._chain:
            if kind == "filter":
                batch = apply_filter(batch, preds)
            else:
                batch = apply_project(batch, exprs, out_schema)
        kd, kv = [], []
        for e, _name in self._group_exprs:
            v = e.evaluate(batch).to_device(cap)
            kd.append(v.data)
            kv.append(v.validity)
        ad, av = [], []
        for _rk, _ok, arg in self._specs:
            if arg is None:
                ad.append(None)
                av.append(None)
            else:
                v = arg.evaluate(batch).to_device(cap)
                ad.append(v.data)
                av.append(v.validity)
        return kd, kv, ad, av, batch.row_mask()

    def _emit_rows(self, keys, accs, avalid) -> BatchIterator:
        """Device columns of n rows -> batches of at most batch-size rows,
        each padded onto the bucket ladder, in the output schema's types."""
        n = accs[0].shape[0] if accs else keys[0][0].shape[0]
        cols = list(keys)
        for (_rk, out_kind, _arg), a, v in zip(self._specs, accs, avalid):
            # count never nulls, whether counted or summed from accs
            cols.append((a, torch.ones_like(v) if out_kind == "count"
                         else v))
        bs = config.BATCH_SIZE.get()
        for off in range(0, n, bs):
            m = min(bs, n - off)
            cap = bucket_capacity(m)
            out = []
            for f, (d, v) in zip(self._out_schema, cols):
                dt = f.data_type.torch_dtype()
                data = torch.zeros(cap, dtype=dt, device=d.device)
                valid = torch.zeros(cap, dtype=torch.bool, device=d.device)
                data[:m] = d[off:off + m].to(dt)
                valid[:m] = v[off:off + m]
                out.append(DeviceColumn(f.data_type, data, valid))
            yield ColumnBatch(self._out_schema, out, m)


def _pow2(n: int) -> int:
    return max(16, 1 << (int(n) - 1).bit_length())
