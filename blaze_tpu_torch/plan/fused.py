"""Fused aggregation: planner trees -> one step per batch on a device group
table (port of the dense, window-table and hash lanes of
blaze_tpu/plan/fused.py).

`fuse_plan` rewrites an eligible `AggExec` (sum/count/min/max) into
`FusedPartialAggExec`.  The filter/project chain
between the aggregation and its source is absorbed: each source batch is
filtered, projected and folded into the group table in one step,
evaluated eagerly on the device (the JAX package traces the same chain
into one XLA program).  The lane is chosen at plan time, as in JAX:

  * DENSE: every grouping key is an integer column whose [min, max] the
    parquet statistics bound, and the table (the product of the key
    ranges, one extra slot per key for NULL) is not much sparser than the
    input.  Group ids are pure arithmetic (`pack_dense_keys`).  Where the
    value bounds also admit it (`_plan_mxu_meta`), the window-table lane
    folds each batch into an exact int32 table of 8-bit limb sums with one
    `window_step` (kernels/window_table.py: one kernel launch per batch on
    the card) and drains it into int64 within its exactness bound; it runs
    on a CUDA device, and on the CPU only under `auron.tpu.mxuAgg.force`,
    so each device picks the lane the JAX package picks on its own tier.
    Otherwise the scatter dense lane scatter-accumulates into a dense
    carry.
  * HASH: fixed-width keys without usable bounds.  The open-addressing
    carry of parallel/stage.py, placed by the placement kernel.
  * DICT: any utf8 key (`auron.tpu.fused.dictDevice`; not over min/max of
    a float argument).  Every key column dictionary-encodes on the host
    against a per-key dictionary that grows across batches; the codes
    pack into a dense group id whose table doubles a key's capacity (and
    re-lays the carry out) as its dictionary grows.  Past
    `auron.tpu.fused.dictDevice.maxSlots` the partition re-runs through
    the generic AggExec.  The JAX package's host Arrow lane, which it
    takes under host placement, is not ported.

Overflow handling is the JAX package's: exact modes (final, merge,
complete) double the hash table and rehash; PARTIAL mode emits what it has
and degrades to batch-local tables passed straight through, since the
final stage re-merges.  Nothing is emitted before a table's final drain,
except by the partial-mode skip, so a window-table partition whose float
sums fail the fixed-point verify re-runs losslessly on the scatter dense
lane.

Where the device stage loop is active (`auron.tpu.stage.deviceLoop.enable`:
`auto` on a CUDA device, `on` anywhere) and the stage compiles
(plan/stage_compiler.py: the hash lane, fixed-width keys, a re-executable
source), `execute` takes the loop first (runtime/loop.py: a chunk of
source batches per CUDA graph replay), as the JAX package does; a
`StageLoopFallback` (a partial-mode overflow) re-runs the partition
through the lanes above, counted in `stage_loop_fallback`.  The loop
declines utf8 keys.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import (ColumnBatch, DeviceColumn,
                                   bucket_capacity, to_device)
from blaze_tpu_torch.exprs import BoundReference, PhysicalExpr
from blaze_tpu_torch.kernels import window_table as WT
from blaze_tpu_torch.ops.agg import (AggExec, AggMode, CountAgg, MinMaxAgg,
                                     SumAgg)
from blaze_tpu_torch.ops.agg.exec import (_host_copies, build_agg_schema,
                                          incremental_dict_codes)
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.ops.basic import (FilterExec, FilterProjectExec,
                                      ProjectExec, apply_filter,
                                      apply_project)
from blaze_tpu_torch.ops.scan import ParquetScanExec, parquet_metadata
from blaze_tpu_torch.parallel.stage import (HashAggCarry, _identity,
                                            dense_partial_agg,
                                            hash_agg_step,
                                            init_accumulators,
                                            init_dense_carry,
                                            init_hash_carry,
                                            pack_dense_keys,
                                            pack_dense_keys_i32,
                                            rehash_carry,
                                            scatter_into_dense_carry,
                                            unpack_dense_keys)
from blaze_tpu_torch.schema import Schema, TypeId


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

_FUSABLE_CHAIN = (FilterExec, ProjectExec, FilterProjectExec)


def _try_fuse_agg(node: ExecutionPlan) -> Optional["FusedPartialAggExec"]:
    """None where the JAX package keeps the generic AggExec (which raises
    in the port); raises where JAX would take a lane the port lacks."""
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
    fixed_keys = all(t.is_fixed_width for t in key_types)
    if not fixed_keys:
        # utf8 keys take the dict-device lane (the JAX package's device
        # placement branch; its host Arrow lane is not ported).  min/max
        # over float arguments stay with the generic engine: the lane's
        # elementwise minimum/maximum propagates NaN where Spark's total
        # order skips it
        if not all(t.is_fixed_width or t.id == TypeId.UTF8
                   for t in key_types):
            return None
        if not _dict_lane_ok(specs, in_schema):
            return None

    # the dense lane: integer keys with discoverable bounds whose table is
    # not much sparser than the input
    ranges = None
    if fixed_keys and all(t.is_integer for t in key_types):
        ranges = _discover_ranges(child, groups)
        if ranges is not None:
            total = _num_slots(ranges)
            if total > config.FUSED_STAGE_CAPACITY.get():
                ranges = None
            elif total > (1 << 20):
                # sparsity heuristic: distinct groups <= rows, so a table
                # much larger than the input loses to the hash table
                rows = _source_row_count(child)
                if rows is not None and total > 4 * rows:
                    ranges = None
    grow = complete or merging
    source, chain = _absorbable_chain(child)
    node = FusedPartialAggExec(child, groups, aggs, specs, grow,
                               source=source, chain=chain, ranges=ranges)
    if ranges is not None:
        node._mxu_meta = _plan_mxu_meta(child, specs, ranges, in_schema)
    return node


def _dict_lane_ok(specs, in_schema) -> bool:
    """The dict-device lane's admission (also re-checked at execution)."""
    return (config.FUSED_DICT_DEVICE_ENABLE.get() and
            not any(rk in ("min", "max") and arg is not None
                    and arg.data_type(in_schema).is_floating
                    for rk, _ok, arg in specs))


def _num_slots(ranges) -> int:
    total = 1
    for lo, hi in ranges:
        total *= (hi - lo + 2)
    return total


def _absorbable_chain(child: ExecutionPlan):
    """Peel Filter/Project/FilterProject off the agg's child.  Returns
    (source_plan, chain_steps) with chain_steps in source -> agg order."""
    steps = []
    node = child
    while True:
        if isinstance(node, FilterExec):
            steps.append(("filter", node._predicates, None, None))
        elif isinstance(node, ProjectExec):
            steps.append(("project", None, node._exprs, node.schema))
        elif isinstance(node, FilterProjectExec):
            # appended top-down; the reverse below restores filter, then
            # project
            steps.append(("project", None, node._exprs, node.schema))
            steps.append(("filter", node._predicates, None, None))
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


def _column_bounds(node: ExecutionPlan, expr: PhysicalExpr,
                   float_ok: bool = False) -> Optional[Tuple]:
    """Trace an expression down a schema-transparent chain to its source
    scan column and read its global [min, max] from parquet row-group
    statistics.  `float_ok` also admits float statistics (the window-table
    lane's fixed-point planning needs value bounds, not only key bounds)."""
    while True:
        if not isinstance(expr, BoundReference):
            return None
        if isinstance(node, FilterExec):
            node = node.children[0]
            continue
        if isinstance(node, (ProjectExec, FilterProjectExec)):
            if expr.index >= len(node._exprs):
                return None
            expr = node._exprs[expr.index]
            node = node.children[0]
            continue
        break
    if isinstance(node, ParquetScanExec):
        return _parquet_bounds(node, expr.index, float_ok)
    return None


def _parquet_bounds(scan: ParquetScanExec, col_index: int,
                    float_ok: bool = False) -> Optional[Tuple]:
    name = scan.schema[col_index].name
    lo = hi = None
    is_float = False
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
                if isinstance(mn, float):
                    if not float_ok:
                        return None
                    is_float = True
                elif not isinstance(mn, int):
                    return None
                lo = mn if lo is None else min(lo, mn)
                hi = mx if hi is None else max(hi, mx)
    if lo is None:
        return None
    if is_float:
        return float(lo), float(hi)
    return int(lo), int(hi)


# ---------------------------------------------------------------------------
# window-table lane planning (kernels/window_table.py): compact dense tables
# aggregate as exact 8-bit-limb integer histograms
# ---------------------------------------------------------------------------

class _MxuVerifyFailed(Exception):
    """A float sum column failed the fixed-point exactness verify (or one
    batch exceeds the table's exactness bound); the partition re-runs
    through the scatter dense lane."""


def _plan_mxu_meta(child, specs, ranges, in_schema) -> Optional[WT.MxuMeta]:
    """Eligibility and layout of the window-table lane.  Every aggregated
    value must map to a non-negative integer domain that 8-bit limbs
    cover: ints shift by their statistics' minimum; float64s scale to
    fixed-point cents (verified exactly on the device at run time).  Any
    miss keeps the stage on the scatter dense lane."""
    if not config.AGG_MXU_ENABLE.get():
        return None
    if len(ranges) > WT.MAX_KEYS or len(specs) > WT.MAX_SPECS:
        return None  # past what the step kernel takes
    total = _num_slots(ranges)
    if total > config.AGG_MXU_MAX_SLOTS.get():
        return None
    scale_conf = config.AGG_MXU_DECIMAL_SCALE.get()
    arrays: List[Tuple[str, int]] = []
    bits: List[int] = []
    mspecs: List[WT.MxuSpec] = []
    scatter: List[Tuple[bool, int]] = []
    valid_by_arg: Dict = {}  # argument -> shared validity array index

    def valid_block(si, arg) -> int:
        """Validity blocks are shared by specs over the same argument
        (sum + count over one column is the rollup shape)."""
        k = ("col", arg.index) if isinstance(arg, BoundReference) \
            else repr(arg)
        if k not in valid_by_arg:
            arrays.append(("valid", si))
            bits.append(1)
            valid_by_arg[k] = len(arrays) - 1
        return valid_by_arg[k]

    for si, (rk, _ok, arg) in enumerate(specs):
        if rk == "count":
            if arg is None:
                mspecs.append(WT.MxuSpec("count_star", -1, -1, -1, 0, 1,
                                         False))
            else:
                mspecs.append(WT.MxuSpec("count", valid_block(si, arg),
                                         -1, -1, 0, 1, False))
            continue
        if rk not in ("sum", "min", "max") or arg is None:
            return None
        t = arg.data_type(in_schema)
        is_float = t.is_floating
        if not (is_float or t.is_integer):
            return None
        if is_float and t.id != TypeId.FLOAT64:
            # float32's ~6e-8 relative rounding would fail the verify
            # every time
            return None
        b = _column_bounds(child, arg, float_ok=is_float)
        if b is None:
            return None
        lo, hi = b
        if is_float:
            if not (math.isfinite(float(lo)) and math.isfinite(float(hi))):
                return None
            clo = int(math.floor(float(lo) * scale_conf)) - 1
            chi = int(math.ceil(float(hi) * scale_conf)) + 1
            scale = scale_conf
        else:
            clo, chi, scale = int(lo), int(hi), 1
        span_bits = WT.limb_bits_for(clo, chi)
        if span_bits > 31:
            return None
        vi = valid_block(si, arg)
        if rk == "sum":
            arrays.append(("cents", si))
            bits.append(span_bits)
            mspecs.append(WT.MxuSpec("sum", vi, len(arrays) - 1, -1, clo,
                                     scale, is_float))
        else:
            scatter.append((rk == "min", si))
            mspecs.append(WT.MxuSpec(rk, vi, -1, len(scatter) - 1, clo,
                                     scale, is_float))
    layout = WT.plan_layout(total, bits)
    if layout is None:
        return None
    return WT.MxuMeta(layout, tuple(mspecs), tuple(arrays), tuple(scatter))


# ---------------------------------------------------------------------------
# the fused operator
# ---------------------------------------------------------------------------

class FusedPartialAggExec(ExecutionPlan):
    """Replacement for an AggExec over fixed-width keys: same output
    schema; one table step per source batch."""

    def __init__(self, child: ExecutionPlan, group_exprs, aggs,
                 specs: Sequence[Tuple[str, str, Optional[PhysicalExpr]]],
                 grow: bool, source: ExecutionPlan, chain,
                 ranges: Optional[List[Tuple[int, int]]] = None):
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
        self._ranges = ranges  # dense key ranges, None for the hash lane
        self._mxu_meta: Optional[WT.MxuMeta] = None  # set by _try_fuse_agg

    @property
    def schema(self) -> Schema:
        return self._out_schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions

    @property
    def fused_mode(self) -> str:
        return "dense" if self._ranges is not None else "sorted"

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

    def _stage_loop_program(self):
        """StageProgram for the device stage loop, or None where the knob
        or the device declines it or the stage does not compile."""
        from blaze_tpu_torch.plan import stage_compiler
        if not stage_compiler.stage_loop_active():
            return None
        return stage_compiler.try_compile(self)

    def execute(self, partition: int) -> BatchIterator:
        prog = self._stage_loop_program()
        if prog is not None:
            # the loop emits only at its final drain, so a fallback here is
            # lossless and the partition re-runs through the lanes below
            from blaze_tpu_torch.runtime.loop import (StageLoopFallback,
                                                      execute_loop)
            try:
                yield from execute_loop(prog, partition)
                return
            except StageLoopFallback:
                self.metrics.add("stage_loop_fallback", 1)
        if self._has_var_keys:
            yield from self._execute_var_keys(partition)
            return
        if self._ranges is None:
            yield from self._execute_sorted(partition)
            return
        if self._mxu_meta is not None and self._mxu_active():
            try:
                yield from self._execute_mxu(partition)
                return
            except _MxuVerifyFailed:
                # nothing has been emitted yet (the lane emits only after
                # its final drain), so the partition re-runs losslessly
                self.metrics.add("mxu_verify_fallback", 1)
        yield from self._execute_dense(partition)

    @property
    def _has_var_keys(self) -> bool:
        return any(not e.data_type(self._in_schema).is_fixed_width
                   for e, _n in self._group_exprs)

    def _execute_var_keys(self, partition: int) -> BatchIterator:
        """The dict-device lane; where its code table would pass
        `maxSlots`, the generic AggExec engine runs the partition instead
        (the lane emits only at its final drain, so nothing has left
        yet).  The JAX package would first try its host Arrow lane, which
        the port does not have."""
        if not _dict_lane_ok(self._specs, self._in_schema):
            # the admission changed after fusion: never run the
            # NaN-propagating fold on float min/max arguments
            raise RuntimeError(
                "fused utf8-key aggregation needs the dict-device lane "
                f"({config.FUSED_DICT_DEVICE_ENABLE.key} changed after "
                "plan fusion?)")
        try:
            yield from self._execute_dict_device(partition)
        except _DictCapExceeded:
            self.metrics.add("dict_device_fallback", 1)
            agg = AggExec(self.children[0], self._group_exprs, self._aggs)
            # its counters (cuda_batches, partial_skipped, ...) go to this
            # operator's node, the one the plan's metric tree holds
            agg.metrics = self.metrics
            yield from agg.execute(partition)

    def _mxu_active(self) -> bool:
        """The window-table lane runs on a CUDA device, as the JAX package
        runs it on the TPU; on the CPU only when forced."""
        if config.AGG_MXU_FORCE.get():
            return True
        from blaze_tpu_torch.device import resolve
        return resolve().type == "cuda"

    # -- bounded keys, window-table lane: exact int32 limb tables ----------
    def _execute_mxu(self, partition: int) -> BatchIterator:
        """Fold batches into the window table; drain it into int64
        accumulators within its exactness bound; emit once at the end.
        Raises _MxuVerifyFailed before any emission when a float column
        breaks the fixed-point contract."""
        meta = self._mxu_meta
        layout = meta.layout
        S = layout.num_slots
        wide = None  # (presence, [array sums], [min/max]) int64 on device
        carry = None
        bound = 0

        def drain():
            nonlocal carry, bound
            if carry is None:
                return
            table, mm, ok = carry
            carry = None
            bound = 0
            if not bool(ok):
                raise _MxuVerifyFailed()
            presence, vals = WT.split_blocks(table, layout)
            wide[0].add_(presence)
            for acc, v in zip(wide[1], vals):
                acc.add_(v)
            for i, (is_min, _si) in enumerate(meta.scatter):
                op = torch.minimum if is_min else torch.maximum
                wide[2][i] = op(wide[2][i], mm[i][:S].to(torch.int64))

        for batch in self._source.execute(partition):
            self.metrics.add(f"{batch.device.type}_batches")
            wrows = batch.capacity
            if wrows > WT.MAX_ROWS_PER_TABLE:
                # one batch past the int32 exactness bound cannot drain
                # mid-fold; the scatter lane re-runs the partition
                raise _MxuVerifyFailed()
            if bound + wrows > WT.MAX_ROWS_PER_TABLE:
                drain()
            dev = batch.device
            if wide is None:
                wide = (torch.zeros(S, dtype=torch.int64, device=dev),
                        [torch.zeros(S, dtype=torch.int64, device=dev)
                         for _ in meta.arrays],
                        [torch.full((S,), WT.MM_IDENT[is_min],
                                    dtype=torch.int64, device=dev)
                         for is_min, _si in meta.scatter])
            if carry is None:
                carry = (torch.zeros(layout.sh, layout.sl * layout.n_blocks,
                                     dtype=torch.int32, device=dev),
                         [torch.full((S + 1,), WT.MM_IDENT[is_min],
                                     dtype=torch.int32, device=dev)
                          for is_min, _si in meta.scatter],
                         torch.ones((), dtype=torch.bool, device=dev))
            carry = self._mxu_step(carry, batch)
            bound += wrows
        drain()
        if wide is None:
            return
        presence, vals, mm = wide
        self.metrics.add("mxu_rows", int(presence.sum()))
        slots = torch.nonzero(presence).squeeze(1)
        if slots.shape[0] == 0:
            return
        keys = unpack_dense_keys(slots, self._ranges)
        accs, avalid = [], []
        ones = torch.ones(slots.shape[0], dtype=torch.bool,
                          device=slots.device)
        for sp in meta.specs:
            if sp.kind == "count_star":
                accs.append(presence[slots])
                avalid.append(ones)
            elif sp.kind == "count":
                accs.append(vals[sp.arr_valid][slots])
                avalid.append(ones)
            elif sp.kind == "sum":
                vc = vals[sp.arr_valid][slots]
                # an exact int64 total, divided once by the scale
                tot = vals[sp.arr_cents][slots] + vc * sp.off
                accs.append(tot.to(torch.float64) / sp.scale if sp.is_float
                            else tot)
                avalid.append(vc > 0)
            else:  # min / max
                vc = vals[sp.arr_valid][slots]
                raw = mm[sp.scatter_idx][slots] + sp.off
                accs.append(raw.to(torch.float64) / sp.scale if sp.is_float
                            else raw)
                avalid.append(vc > 0)
        yield from self._emit_rows(keys, accs, avalid)

    def _mxu_step(self, carry, batch: ColumnBatch):
        """One batch into the window table: the chain, then one
        `window_step` (int32 group ids, the fixed-point limb domain and its
        verify, the table update and the min/max accumulators: the loop
        body of blaze_tpu/plan/fused.py _mxu_fold_factory)."""
        kd, kv, ad, av, m = self._device_inputs(batch)
        return WT.window_step(self._mxu_meta, self._ranges, kd, kv, ad, av,
                              m, carry)

    # -- bounded keys, scatter dense lane ------------------------------------
    def _execute_dense(self, partition: int) -> BatchIterator:
        num_slots = _num_slots(self._ranges)
        kinds = [rk for rk, _ok, _a in self._specs]
        carry = None
        for batch in self._source.execute(partition):
            self.metrics.add(f"{batch.device.type}_batches")
            kd, kv, ad, av, mask = self._device_inputs(batch)
            gid, _total = pack_dense_keys(list(zip(kd, kv)), self._ranges)
            if carry is None:
                carry = init_dense_carry(kinds, self._acc_dtypes(),
                                         num_slots, batch.device)
            carry = scatter_into_dense_carry(carry, gid, kinds, ad, av, mask)
        if carry is not None:
            yield from self._emit_dense(carry)

    def _emit_dense(self, carry) -> BatchIterator:
        """The occupied slots in slot order, keys decoded from the slot."""
        accs, avalid, occupied = carry
        slots = torch.nonzero(occupied).squeeze(1)
        if slots.shape[0] == 0:
            return
        keys = unpack_dense_keys(slots, self._ranges)
        yield from self._emit_rows(keys,
                                   [a.index_select(0, slots) for a in accs],
                                   [v.index_select(0, slots) for v in avalid])

    # -- utf8 keys: the dict-device lane -------------------------------------
    def _execute_dict_device(self, partition: int) -> BatchIterator:
        """Group by utf8 keys on the device: every key column (fixed-width
        ones too) dictionary-encodes on the host against an accumulated
        per-key dictionary; the codes pack into one dense group id, each
        key's range its power-of-two capacity (from 16) plus a NULL slot,
        and each batch's own table adds into the carry.  A capacity that
        doubles re-lays the carry out; keys decode through the
        dictionaries only at emit."""
        nkeys = len(self._group_exprs)
        kinds = tuple(rk for rk, _ok, _a in self._specs)
        acc_dtypes = self._acc_dtypes()
        dicts: List[Optional[pa.Array]] = [None] * nkeys
        caps = [16] * nkeys
        old_caps = list(caps)
        limit = config.FUSED_DICT_DEVICE_MAX_SLOTS.get()
        carry = None  # (accs, acc_valid, occupied) on the batch's device
        n_batches = 0
        for batch in self.children[0].execute(partition):
            self.metrics.add(f"{batch.device.type}_batches")
            cap = batch.capacity
            dev = batch.device
            sel = (batch.row_mask().cpu().numpy()[:batch.num_rows]
                   if batch.selection is not None else None)
            kd, kv = [], []
            grew = False
            for i, (e, _n) in enumerate(self._group_exprs):
                arr = e.evaluate(batch).to_host(batch.num_rows)
                codes, valid, dicts[i] = _global_dict_codes(
                    arr, dicts[i], cap, sel)
                while len(dicts[i]) > caps[i]:
                    caps[i] *= 2
                    grew = True
                    self.metrics.add("dict_device_doublings", 1)
                kd.append(to_device(codes, dev))
                kv.append(to_device(valid, dev))
            if _dict_slots(caps) > limit:
                raise _DictCapExceeded
            if grew and carry is not None:
                carry = _relayout_dict_table(carry, kinds, acc_dtypes,
                                             old_caps, caps)
                self.metrics.add("dict_device_relayouts", 1)
            old_caps = list(caps)
            ad, av = [], []
            for _rk, _ok, arg in self._specs:
                if arg is None:
                    ad.append(None)
                    av.append(None)
                else:
                    v = arg.evaluate(batch).to_device(cap)
                    ad.append(v.data)
                    av.append(v.validity)
            if carry is None:
                carry = init_dense_carry(kinds, acc_dtypes,
                                         _dict_slots(caps), dev)
            carry = _dict_dense_step(carry, caps, kinds, kd, kv, ad, av,
                                     batch.row_mask())
            n_batches += 1
        self.metrics.add("fused_batches", n_batches)
        self.metrics.add("dict_device_batches", n_batches)
        if carry is not None:
            yield from self._emit_dict(carry, caps, dicts)

    def _emit_dict(self, carry, caps, dicts) -> BatchIterator:
        """The occupied slots in slot order: keys decoded from the slot
        through the dictionaries, accumulators in one device-to-host
        copy."""
        accs, avalid, occupied = carry
        slots = torch.nonzero(occupied).squeeze(1)
        count = slots.shape[0]
        if count == 0:
            return
        host = _host_copies([slots] + [a.index_select(0, slots)
                                       for a in accs]
                            + [v.index_select(0, slots) for v in avalid])
        slots_h, nacc = host[0], len(accs)
        host_accs, host_avalid = host[1:1 + nacc], host[1 + nacc:]
        decoded = unpack_dense_keys(slots_h, [(0, c - 1) for c in caps])
        out_arrow = self._out_schema.to_arrow()
        arrays: List[pa.Array] = []
        for i, ((code, kvalid), d) in enumerate(zip(decoded, dicts)):
            idx = pa.array(np.where(kvalid, code, 0), pa.int64(),
                           mask=~kvalid)  # a NULL code is a NULL key
            arrays.append(d.take(idx).cast(out_arrow.field(i).type))
        for i, ((_rk, out_kind, _arg), a, v) in enumerate(
                zip(self._specs, host_accs, host_avalid), len(dicts)):
            if out_kind == "count":
                v = np.ones(count, dtype=bool)
            arr = pa.array(a, mask=~v)
            t = out_arrow.field(i).type
            arrays.append(arr if arr.type.equals(t)
                          else arr.cast(t, safe=False))
        rb = pa.RecordBatch.from_arrays(arrays, schema=out_arrow)
        bs = config.BATCH_SIZE.get()
        for off in range(0, rb.num_rows, bs):
            yield ColumnBatch.from_arrow(
                rb.slice(off, min(bs, rb.num_rows - off)), device=slots.device)

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


class _DictCapExceeded(Exception):
    """The dict-device code table would pass maxSlots; the partition
    re-runs through the generic engine."""


def _dict_slots(caps) -> int:
    """Slots of the dict-device table: each key's range 0..cap-1 plus its
    NULL slot."""
    total = 1
    for c in caps:
        total *= c + 1
    return total


def _global_dict_codes(arr: pa.Array, global_arr: Optional[pa.Array],
                       cap: int, sel: Optional[np.ndarray] = None):
    """The dict-device lane's encoding over the shared incremental encoder
    (ops/agg/exec.py incremental_dict_codes): int32 codes for
    pack_dense_keys_i32, with the rows a filter deselected nulled before
    encoding, so they neither grow the dictionary nor the code table (the
    mask drops them from the reduction anyway)."""
    if sel is not None and not sel.all():
        import pyarrow.compute as pc
        arr = pc.if_else(pa.array(sel[:len(arr)]), arr,
                         pa.nulls(len(arr), arr.type))
    codes, valid, global_arr, _grew = incremental_dict_codes(
        arr, global_arr, cap)
    return codes.astype(np.int32), valid, global_arr


def _relayout_dict_table(carry, kinds, acc_dtypes, old_caps, new_caps):
    """Move a dict-code table to the layout of larger key capacities:
    decode the occupied slots to per-key codes (stride arithmetic), place
    each under the new strides, and move its accumulators there one to
    one (codes are unique per slot, nothing merges).  On the carry's
    device."""
    accs, avalid, occupied = carry
    dev = occupied.device
    occ = torch.nonzero(occupied).squeeze(1)
    decoded = unpack_dense_keys(occ, [(0, c - 1) for c in old_caps])
    new_total, new_slot = 1, torch.zeros_like(occ)
    for (code, kvalid), c in zip(decoded, new_caps):
        # the NULL slot is code == cap
        new_slot += torch.where(kvalid, code, c) * new_total
        new_total *= c + 1
    fresh_accs, fresh_avalid = init_accumulators(kinds, acc_dtypes,
                                                 new_total, dev)
    for fa, a in zip(fresh_accs, accs):
        fa[new_slot] = a[occ]
    for fv, v in zip(fresh_avalid, avalid):
        fv[new_slot] = v[occ]
    n_occ = torch.zeros(new_total, dtype=torch.bool, device=dev)
    n_occ[new_slot] = True
    return fresh_accs, fresh_avalid, n_occ


def _dict_dense_step(carry, caps, kinds, kd, kv, ad, av, mask):
    """One batch into the dict-code table: the packed code id, the batch's
    own dense table (dense_partial_agg), then an elementwise combine into
    the carry, in the JAX step's order (the batch's float sums form first
    and add to the carry once)."""
    accs, avalid, occupied = carry
    gid, total = pack_dense_keys_i32(list(zip(kd, kv)),
                                     [(0, c - 1) for c in caps])
    b_accs, b_avalid, b_occ = dense_partial_agg(
        gid, total, list(zip(kinds, ad, av)), mask)
    out_accs, out_avalid = [], []
    for kind, ca, cv, ba, bv in zip(kinds, accs, avalid, b_accs, b_avalid):
        if kind in ("sum", "count"):
            out_accs.append(ca + ba)  # a batch's empty slots hold 0
        else:
            # the batch table zeroes its empty slots: back to the identity
            # first, or a later batch drags every min/max toward 0
            ident = _identity(ba.dtype, kind == "max")
            ba = torch.where(bv, ba, torch.full_like(ba, ident))
            out_accs.append(torch.minimum(ca, ba) if kind == "min"
                            else torch.maximum(ca, ba))
        out_avalid.append(cv | bv)
    return tuple(out_accs), tuple(out_avalid), occupied | b_occ


def _batch_windows(stream, window: int):
    """Lists of up to `window` consecutive source batches (the device stage
    loop copies each into its graph's input slabs)."""
    buf = []
    for batch in stream:
        buf.append(batch)
        if len(buf) >= window:
            yield buf
            buf = []
    if buf:
        yield buf


def _pow2(n: int) -> int:
    return max(16, 1 << (int(n) - 1).bit_length())
