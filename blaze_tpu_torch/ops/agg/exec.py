"""The aggregation operator and its generic engine (port of
blaze_tpu/ops/agg/exec.py).

`create_plan` builds an `AggExec` for every `hash_agg`/`sort_agg` node;
`fuse_plan` replaces the eligible ones (sum/count/min/max over fixed-width
keys) with the fused lanes of plan/fused.py.  What stays an `AggExec` (avg,
global aggregations, mixed modes) runs the JAX package's segmented-sort
engine on the batch's device:

  * each input batch becomes one partial batch (group keys + accumulator
    columns, one row per group): the keys' order operands are lexsorted
    (kernels/compare.py), boundaries give dense group ids, and every key
    and accumulator is a segmented reduction (kernels/sort.py); the group
    count costs one host sync per batch, and all of the batch's key and
    accumulator columns come back to the host in one copy;
  * partial batches are buffered as Arrow and re-aggregated through the
    same sort (partial_merge) when the buffer grows past 8 batch sizes of
    groups, and once more at the end;
  * a keyed all-PARTIAL aggregation runs a one-shot cardinality probe once
    it has seen `auron.tpu.partialAgg.skipping.minRows` rows and, past the
    ratio, flushes its buffer and passes every further row through as its
    own group (the final stage re-merges);
  * a global aggregation over empty input still emits one row;
  * the buffered partials and the utf8 dictionaries are charged to the
    memory manager (`_AggState` is a `MemConsumer`).  Under pressure the
    buffer is combined into one key-sorted run and spilled
    (`try_new_spill`); at the end the spilled runs and the in-memory run
    are merged by key (ops/sort.py `merge_sorted_batches`) and
    re-aggregated chunk by chunk, the last group of each chunk carried
    into the next.  With `auron.tpu.partialAgg.skipping.onSpill`, an
    aggregation that may pass rows through takes pressure by handing its
    buffer downstream un-merged and switching to pass-through
    (`try_release_pressure`) instead of spilling.

utf8 group keys dictionary-encode per operator instance
(`incremental_dict_codes`: first-seen order, stable across batches) into
int64 codes on the batch's device, so they sort and segment like integer
keys; partial batches carry the codes, and keys decode back through the
dictionaries at emit (and on the pass-through lane), so what leaves the
operator holds real values.  `count` over a utf8 column counts validity
only.  A host accumulator (collect_*, combine_unique, min/max over
strings) folds the batch's Arrow values with the group ids in row order
on the host, beside the device accumulators.

The wire's `supports_partial_skipping` flag (a host engine's, or
adaptive execution's history seed, plan/adaptive.py) reaches the
operator as `skip_partial_hint`: an eligible partial aggregation then
skips the probe window and passes rows through from its first batch.
The first rung of a serving query's degradation ladder
(`force_agg_passthrough`, serving/context.py, climbed by the memory
manager on a quota breach) forces the same pass-through at the next
batch, whatever the probe would say.  The probe, the skip and the
pass-through rows count in bridge/device_stats.py (`partial_agg_*`).
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.batch import (ColumnBatch, DeviceColumn,
                                   bucket_capacity, decimal_from_unscaled,
                                   to_device)
from blaze_tpu_torch.device import resolve
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import compare
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.memory import (MemConsumer, MemManager, Spill,
                                    try_new_spill)
from blaze_tpu_torch.ops.agg.functions import AggFunction, CountAgg
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.ops.sort import merge_sorted_batches
from blaze_tpu_torch.schema import Field, INT64, Schema, TORCH_TO_NP


class AggMode(enum.Enum):
    PARTIAL = "partial"              # raw input -> acc columns
    PARTIAL_MERGE = "partial_merge"  # acc columns -> acc columns
    FINAL = "final"                  # acc columns -> final values
    COMPLETE = "complete"            # raw input -> final values


class AggExecMode(enum.Enum):
    HASH_AGG = "hash_agg"  # both names run the segmented-sort engine
    SORT_AGG = "sort_agg"


class AggExec(ExecutionPlan):

    def __init__(self, child: ExecutionPlan,
                 group_exprs: Sequence[Tuple[PhysicalExpr, str]],
                 aggs: Sequence[Tuple[AggFunction, AggMode, str]],
                 exec_mode: AggExecMode = AggExecMode.HASH_AGG,
                 skip_partial_hint: bool = False):
        super().__init__([child])
        self._group_exprs = list(group_exprs)
        self._aggs = list(aggs)
        self._exec_mode = exec_mode
        # the wire's supports_partial_skipping: go straight to pass-through
        # without the probe window; _skip_eligible still decides
        self.skip_partial_hint = bool(skip_partial_hint)
        in_schema = child.schema
        for fn, _, _ in self._aggs:
            fn.bind(in_schema)
        self._out_schema = build_agg_schema(in_schema, self._group_exprs,
                                            self._aggs)

    @property
    def schema(self) -> Schema:
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        state = _AggState(self)
        state.set_spillable(MemManager.get())
        try:
            for batch in self.children[0].execute(partition):
                yield from state.process(batch)
            yield from state.output()
        finally:
            state.unregister()
            state.release_spills()


def build_agg_schema(in_schema: Schema, group_exprs, aggs) -> Schema:
    """Grouping columns, then each agg's final value (final/complete
    modes) or its accumulator fields named `<name>.<acc>`."""
    fields: List[Field] = []
    for e, name in group_exprs:
        fields.append(Field(name, e.data_type(in_schema)))
    for fn, mode, name in aggs:
        if mode in (AggMode.FINAL, AggMode.COMPLETE):
            fields.append(Field(name, fn.output_type(in_schema)))
        else:
            for f in fn.acc_fields(in_schema):
                fields.append(Field(f"{name}.{f.name}", f.data_type,
                                    f.nullable))
    return Schema(fields)


_RAW_MODES = (AggMode.PARTIAL, AggMode.COMPLETE)


class _AggState(MemConsumer):
    """Per-partition aggregation state (the JAX package's AggTable
    analog)."""

    def __init__(self, op: AggExec):
        super().__init__("agg")
        self.op = op
        self.metrics = op.metrics
        self.in_schema = op.children[0].schema
        self.num_keys = len(op._group_exprs)
        # per utf8 key: the accumulated dictionary (codes are positions);
        # None for a fixed-width key
        self.dict_arrays: List[Optional[pa.Array]] = []
        for e, _ in op._group_exprs:
            t = e.data_type(self.in_schema)
            self.dict_arrays.append(None if t.is_fixed_width else
                                    pa.array([], type=t.to_arrow()))
        self.buffer: List[pa.RecordBatch] = []
        self.buffered_bytes = 0
        self.spills: List[Spill] = []
        #: the buffer handed over by try_release_pressure, emitted at the
        #: next pull
        self.flush_pending: List[pa.RecordBatch] = []
        self._output_started = False
        self.skipping = False
        self.rows_seen = 0
        self._probe_done = False  # the cardinality probe runs once
        self._internal_schema: Optional[pa.Schema] = None

    # ------------------------------------------------------------------
    # ingest
    # ------------------------------------------------------------------
    def process(self, batch: ColumnBatch) -> Iterator[ColumnBatch]:
        if self.skipping:
            # pass-through lane: raw rows leave as accumulator-shaped
            # batches, each row its own group
            yield from self._drain_pending()
            n = batch.selected_count()
            if n == 0:
                return
            self.rows_seen += n
            out = self._passthrough_batch(batch)
            if out is not None:
                yield out
            return
        partial = self._aggregate_input_batch(batch)
        if partial is None:
            return
        self.rows_seen += batch.selected_count()
        self.buffer.append(partial)
        self.buffered_bytes += partial.nbytes
        self.update_mem_used(self.buffered_bytes + self._dict_bytes())
        if self.skipping:
            # the manager took try_release_pressure's offer during the
            # update: the buffer moved to flush_pending
            yield from self._drain_pending()
            return
        if self._should_skip_partials():
            self.skipping = True
            self.op.metrics.add("partial_skipped", 1)
            device_stats.note_partial_agg_skip(self.rows_seen)
            flushed, self.buffer, self.buffered_bytes = self.buffer, [], 0
            self.update_mem_used(self._dict_bytes())
            yield from self._emit(flushed)
            return
        limit = config.BATCH_SIZE.get() * 4
        if sum(rb.num_rows for rb in self.buffer) >= limit * 2:
            self._combine_buffer()

    def _drain_pending(self) -> Iterator[ColumnBatch]:
        if self.flush_pending:
            pending, self.flush_pending = self.flush_pending, []
            yield from self._emit(pending)

    def _skip_eligible(self) -> bool:
        """Pass-through keeps the semantics only for keyed all-PARTIAL
        device aggregations: host accumulators, merge and final stages
        must keep grouping."""
        return (bool(self.op._aggs)
                and all(m == AggMode.PARTIAL for _, m, _ in self.op._aggs)
                and self.num_keys > 0
                and not any(fn.is_host for fn, _, _ in self.op._aggs))

    def _should_skip_partials(self) -> bool:
        if self._probe_done or not self._skip_eligible():
            return False
        # degradation rung 1 (a serving quota breach): pass-through
        # regardless of the probe, trading the merge ratio for bounded
        # partial state
        from blaze_tpu_torch.bridge.context import active_query
        q = active_query()
        if q is not None and getattr(q, "force_agg_passthrough", False):
            self._probe_done = True
            return True
        if self.op.skip_partial_hint:
            self._probe_done = True
            return True
        if not config.PARTIAL_AGG_SKIPPING_ENABLE.get():
            return False
        if self.rows_seen < config.PARTIAL_AGG_SKIPPING_MIN_ROWS.get():
            return False
        # one-shot probe at the end of the minRows window
        self._probe_done = True
        self._combine_buffer()
        distinct = sum(rb.num_rows for rb in self.buffer)
        device_stats.note_partial_agg_probe(self.rows_seen, distinct)
        ratio = distinct / max(1, self.rows_seen)
        return ratio > config.PARTIAL_AGG_SKIPPING_RATIO.get()

    # ------------------------------------------------------------------
    # pass-through lane
    # ------------------------------------------------------------------
    def _passthrough_batch(self, batch: ColumnBatch) -> Optional[ColumnBatch]:
        """One raw batch -> one accumulator-shaped batch, each row its own
        group: partial_update over identity group ids, so every
        accumulator is made by the same code as the sorted engine's."""
        op = self.op
        cb = batch.compact()
        n = cb.num_rows
        if n == 0:
            return None
        cap = cb.capacity
        sink = _ArrowSink()
        for e, _name in op._group_exprs:
            cv = e.evaluate(cb)
            if cv.is_device:
                sink.add_device(cv.data, cv.validity, n)
            else:
                # utf8 keys leave as their values: the dictionary never
                # grows on this lane
                sink.add_host(cv.to_host(n))
        gids = torch.arange(cap, device=cb.device)
        for fn, _mode, _name in op._aggs:
            args = [_agg_arg(fn, c.evaluate(cb), cap, cb.device)
                    for c in fn.children]
            for ad, av in fn.partial_update(args, gids, cap):
                sink.add_device(ad, av, n)
        out_schema = op.schema.to_arrow()
        arrays = [_cast_output(a, f.type)
                  for a, f in zip(sink.materialize(), out_schema)]
        out = pa.RecordBatch.from_arrays(arrays, schema=out_schema)
        op.metrics.add("passthrough_rows", n)
        device_stats.note_partial_agg_rows(n)
        return ColumnBatch.from_arrow(out)

    # ------------------------------------------------------------------
    # one input batch -> one partial batch (keys + accs, one row per group)
    # ------------------------------------------------------------------
    def _group(self, keys, valid_mask, cap):
        """(perm, sorted valid mask, group ids, group count) of a batch
        whose grouping columns are `keys` [(data, validity, dtype)]."""
        if not self.num_keys:
            # one group: its rows first, in row order, the masked ones
            # after them, so that the group is one run of ids (the
            # row-order sums' contract, kernels/sort.py `segment_sum`)
            perm = torch.sort((~valid_mask).to(torch.int32),
                              stable=True).indices
            sorted_valid = valid_mask.index_select(0, perm)
            return perm, sorted_valid, torch.where(sorted_valid, 0, 1), 1
        operands = []
        for data, valid, dtype in keys:
            b, k = compare.order_key(data, valid, dtype, False, True)
            operands.extend([b, k])
        perm = compare.lexsort_indices(operands, valid_mask)
        sorted_ops = [o.index_select(0, perm) for o in operands]
        sorted_valid = valid_mask.index_select(0, perm)
        gids, ng = K.group_ids_from_sorted(sorted_ops, sorted_valid)
        return perm, sorted_valid, gids, int(ng)  # one host sync

    def _aggregate_input_batch(self, batch: ColumnBatch
                               ) -> Optional[pa.RecordBatch]:
        op = self.op
        if batch.selected_count() == 0:
            return None
        cap = batch.capacity
        valid_mask = batch.row_mask()
        key_dev = self._encode_keys(
            [e.evaluate(batch) for e, _ in op._group_exprs], batch)
        op.metrics.add("cuda_batches" if valid_mask.device.type == "cuda"
                       else "cpu_batches", 1)
        perm, sorted_valid, gids, num_groups = self._group(
            key_dev, valid_mask, cap)
        if num_groups == 0:
            return None
        sink = _ArrowSink()
        for data, valid, _dtype in key_dev:
            sd = data.index_select(0, perm)
            sv = valid.index_select(0, perm) & sorted_valid
            sink.add_device(*K.segment_first(sd, sv, gids, num_groups),
                            num_groups)
        host_gids = None
        for fn, mode, _name in op._aggs:
            if fn.is_host:
                if host_gids is None:
                    host_gids = _row_order_gids(perm, gids, num_groups,
                                                batch.num_rows)
                args_host = [c.evaluate(batch).to_host(batch.num_rows)
                             for c in fn.children]
                fold = fn.host_update if mode in _RAW_MODES \
                    else fn.host_merge
                for a in fold(args_host, host_gids, num_groups):
                    sink.add_host(a)
                continue
            args = []
            for c in fn.children:
                data, valid = _agg_arg(fn, c.evaluate(batch), cap,
                                       valid_mask.device)
                args.append((data.index_select(0, perm),
                             valid.index_select(0, perm) & sorted_valid))
            if mode in _RAW_MODES:
                accs = fn.partial_update(args, gids, num_groups)
            else:
                accs = fn.partial_merge(args, gids, num_groups)
            for ad, av in accs:
                sink.add_device(ad, av, num_groups)
        arrays = sink.materialize()
        return pa.RecordBatch.from_arrays(
            arrays, schema=self._internal_pa_schema(arrays))

    # ------------------------------------------------------------------
    # key encoding
    # ------------------------------------------------------------------
    def _encode_keys(self, key_vals, batch: ColumnBatch):
        """[(data, validity, dtype)] per grouping key: fixed-width keys as
        they are, utf8 keys as int64 dictionary codes on the batch's
        device."""
        out = []
        for i, cv in enumerate(key_vals):
            if self.dict_arrays[i] is None:
                out.append((cv.data, cv.validity, cv.dtype))
                continue
            codes, valid, self.dict_arrays[i], grew = \
                incremental_dict_codes(cv.to_host(batch.num_rows),
                                       self.dict_arrays[i], batch.capacity)
            if grew:
                # the dictionaries count against the budget beside the
                # buffered partials
                self.update_mem_used(self.buffered_bytes + self._dict_bytes())
            dev = batch.device
            out.append((to_device(codes, dev), to_device(valid, dev), INT64))
        return out

    def _dict_bytes(self) -> int:
        return sum(a.nbytes for a in self.dict_arrays if a is not None)

    def _decode_keys(self, rb: pa.RecordBatch) -> List[pa.Array]:
        """The key columns of an internal partial batch with every code
        column decoded through its dictionary."""
        import pyarrow.compute as pc
        out = []
        for i in range(self.num_keys):
            col = rb.column(i)
            dec = self.dict_arrays[i]
            if dec is None:
                out.append(col)
                continue
            taken = dec.take(col.fill_null(0).cast(pa.int64()))
            decoded = pc.if_else(col.is_valid(), taken,
                                 pa.scalar(None, type=dec.type))
            f = self.op._group_exprs[i][0].data_type(self.in_schema)
            out.append(decoded.cast(f.to_arrow()))
        return out

    def _internal_pa_schema(self, arrays: List[pa.Array]) -> pa.Schema:
        if self._internal_schema is None:
            fields = [pa.field(f"__k{i}", arrays[i].type)
                      for i in range(self.num_keys)]
            fields += [pa.field(f"__a{j}", arrays[j].type)
                       for j in range(self.num_keys, len(arrays))]
            self._internal_schema = pa.schema(fields)
        return self._internal_schema

    # ------------------------------------------------------------------
    # buffer combine and spill (MemConsumer)
    # ------------------------------------------------------------------
    def _combine_buffer(self) -> None:
        if len(self.buffer) <= 1:
            return
        tbl = pa.Table.from_batches(self.buffer).combine_chunks()
        merged = self._merge_partial_chunk(tbl.to_batches()[0])
        self.buffer = [merged] if merged is not None else []
        self.buffered_bytes = merged.nbytes if merged is not None else 0
        self.update_mem_used(self.buffered_bytes + self._dict_bytes())

    def _merge_partial_chunk(self, rb: pa.RecordBatch
                             ) -> Optional[pa.RecordBatch]:
        """Re-aggregate a partial batch (rows = groups, possibly repeated)
        through the sort and partial_merge."""
        if rb.num_rows == 0:
            return None
        cb = ColumnBatch.from_arrow(rb)
        cap = cb.capacity
        keys = [(c.data, c.validity, c.dtype)
                for c in cb.columns[:self.num_keys]]
        perm, sorted_valid, gids, num_groups = self._group(
            keys, cb.row_mask(), cap)
        if num_groups == 0:
            return None
        sink = _ArrowSink()
        for data, valid, _dtype in keys:
            sd = data.index_select(0, perm)
            sv = valid.index_select(0, perm) & sorted_valid
            sink.add_device(*K.segment_first(sd, sv, gids, num_groups),
                            num_groups)
        j = self.num_keys
        host_gids = None
        for fn, _mode, _name in self.op._aggs:
            nacc = len(fn.acc_fields(self.in_schema))
            if fn.is_host:
                if host_gids is None:
                    host_gids = _row_order_gids(perm, gids, num_groups,
                                                rb.num_rows)
                for a in fn.host_merge([rb.column(j + t)
                                        for t in range(nacc)],
                                       host_gids, num_groups):
                    sink.add_host(a)
                j += nacc
                continue
            args = []
            for col in cb.columns[j:j + nacc]:
                args.append((col.data.index_select(0, perm),
                             col.validity.index_select(0, perm)
                             & sorted_valid))
            for ad, av in fn.partial_merge(args, gids, num_groups):
                sink.add_device(ad, av, num_groups)
            j += nacc
        return pa.RecordBatch.from_arrays(sink.materialize(),
                                          schema=self._internal_schema)

    def try_release_pressure(self) -> int:
        """Skip-on-spill: with `auron.tpu.partialAgg.skipping.onSpill`, or
        for a query on its degradation ladder (its quota breach already
        chose degradation over spill IO), an aggregation that may pass
        rows through hands its buffered partials downstream un-merged
        (emitted at the next pull) and switches to pass-through instead
        of spilling them."""
        q = self.query
        degraded = q is not None and getattr(q, "force_agg_passthrough",
                                             False)
        if not ((config.PARTIAL_AGG_SKIPPING_ON_SPILL.get() or degraded)
                and not self.skipping and not self._output_started and
                self.buffer and self._skip_eligible()):
            return 0
        self.skipping = True
        self._probe_done = True
        self.flush_pending.extend(self.buffer)
        released = self.buffered_bytes
        self.buffer = []
        self.buffered_bytes = 0
        self._mem_used = self._dict_bytes()  # the dictionaries stay
        self.op.metrics.add("partial_skipped", 1)
        device_stats.note_partial_agg_skip(self.rows_seen, on_spill=True)
        return released

    def spill(self) -> int:
        if not self.buffer:
            return 0
        released = self.try_release_pressure()
        if released:
            return released
        self._combine_buffer()
        if not self.buffer:
            return 0
        # the combined buffer is in key order (the lexsort's)
        run = self.buffer[0]
        spill = try_new_spill()
        bs = config.BATCH_SIZE.get()
        spill.write_batches(run.slice(i, min(bs, run.num_rows - i))
                            for i in range(0, run.num_rows, bs))
        self.spills.append(spill)
        released = self.buffered_bytes
        self.buffer = []
        self.buffered_bytes = 0
        self._mem_used = self._dict_bytes()  # the dictionaries stay
        self.op.metrics.add("spill_count")
        self.op.metrics.add("spilled_bytes", released)
        return released

    def release_spills(self) -> None:
        spills, self.spills = self.spills, []
        for s in spills:
            s.release()

    # ------------------------------------------------------------------
    # output
    # ------------------------------------------------------------------
    def output(self) -> Iterator[ColumnBatch]:
        # a skip-on-spill from here on would strand rows in flush_pending
        self._output_started = True
        yield from self._drain_pending()
        self._combine_buffer()
        if not self.spills:
            batches = self.buffer
            if not batches and not self.num_keys and not self.skipping:
                batches = [self._empty_global_accs()]
            yield from self._emit(batches)
            return
        # the spilled runs and the in-memory run merged by key; each
        # chunk re-aggregated, its last group carried into the next chunk
        runs = [s.read_batches() for s in self.spills]
        if self.buffer:
            runs.append(iter(self.buffer))
        carry: Optional[pa.RecordBatch] = None
        for chunk in merge_sorted_batches(runs, list(range(self.num_keys)),
                                          [False] * self.num_keys,
                                          [True] * self.num_keys):
            if carry is not None:
                chunk = pa.Table.from_batches([carry, chunk]) \
                    .combine_chunks().to_batches()[0]
            merged = self._merge_partial_chunk(chunk)
            if merged is None:
                continue
            if merged.num_rows > 1:
                carry = merged.slice(merged.num_rows - 1)
                yield from self._emit([merged.slice(0, merged.num_rows - 1)])
            else:
                carry = merged
        if carry is not None:
            yield from self._emit([carry])
        self.release_spills()

    def _empty_global_accs(self) -> pa.RecordBatch:
        """A global aggregation over empty input still emits one row
        (count 0, NULL sums)."""
        dev = resolve()
        out_arrays: List[pa.Array] = []
        for fn, _mode, _name in self.op._aggs:
            if fn.is_host:
                # group id 1 is past the one segment: an empty fold
                out_arrays.extend(fn.host_update(
                    [pa.nulls(1, c.data_type(self.in_schema).to_arrow())
                     for c in fn.children], np.array([1]), 1))
                continue
            args = []
            for c in fn.children or [None]:
                dt = (c.data_type(self.in_schema).torch_dtype()
                      if c is not None else torch.int64)
                args.append((torch.zeros(1, dtype=dt, device=dev),
                             torch.zeros(1, dtype=torch.bool, device=dev)))
            # group id 1 is past the one segment: every update is empty
            gids = torch.ones(1, dtype=torch.int64, device=dev)
            sink = _ArrowSink()
            for ad, av in fn.partial_update(args, gids, 1):
                sink.add_device(ad, av, 1)
            out_arrays.extend(sink.materialize())
        return pa.RecordBatch.from_arrays(
            out_arrays, schema=self._internal_pa_schema(out_arrays))

    def _emit(self, batches: List[pa.RecordBatch]) -> Iterator[ColumnBatch]:
        """Internal partial batches -> the output schema (final_eval in
        FINAL and COMPLETE modes)."""
        op = self.op
        out_schema = op.schema.to_arrow()
        dev = resolve()
        for rb in batches:
            n = rb.num_rows
            if n == 0:
                continue
            sink = _ArrowSink()
            for a in self._decode_keys(rb):
                sink.add_host(a)
            j = self.num_keys
            for fn, mode, _name in op._aggs:
                fields = fn.acc_fields(self.in_schema)
                if mode in (AggMode.FINAL, AggMode.COMPLETE) and fn.is_host:
                    sink.add_host(fn.host_eval(
                        [rb.column(j + t) for t in range(len(fields))]))
                elif mode in (AggMode.FINAL, AggMode.COMPLETE):
                    cap = bucket_capacity(n)
                    accs = []
                    for t, f in enumerate(fields):
                        dc = DeviceColumn.from_arrow(rb.column(j + t),
                                                     f.data_type, cap, dev)
                        accs.append((dc.data[:n], dc.validity[:n]))
                    sink.add_device(*fn.final_eval(accs), n)
                else:
                    for t in range(len(fields)):
                        sink.add_host(rb.column(j + t))
                j += len(fields)
            arrays = [_cast_output(a, f.type)
                      for a, f in zip(sink.materialize(), out_schema)]
            yield ColumnBatch.from_arrow(
                pa.RecordBatch.from_arrays(arrays, schema=out_schema))


def incremental_dict_codes(arr: pa.Array, global_arr: Optional[pa.Array],
                           cap: int):
    """Dictionary-encode one batch column against an accumulated global
    dictionary (first-seen order, stable across batches).  Shared by the
    generic engine (_AggState._encode_keys) and the fused dict-device lane
    (plan/fused.py _execute_dict_device), so the two never diverge.
    Floating keys normalize (-0.0 -> 0.0, NaN -> one canonical bit
    pattern) before encoding, like Spark's NormalizeFloatingNumbers.
    Returns (codes int64 np[cap], valid np[cap], new_global_dict, grew)."""
    import pyarrow.compute as pc
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_floating(arr.type):
        arr = pc.add(arr, 0.0)  # -0.0 + 0.0 == +0.0
        nan = pa.scalar(float("nan"), type=arr.type)
        arr = pc.if_else(pc.is_nan(arr), nan, arr)
    enc = arr.dictionary_encode()
    if global_arr is None:
        global_arr = pa.array([], type=enc.dictionary.type)
    local = enc.dictionary.cast(global_arr.type)
    base = len(global_arr)
    if base:
        found = pc.index_in(local, value_set=global_arr)
    else:
        found = pa.nulls(len(local), type=pa.int32())
    new_mask = np.asarray(pc.is_null(found))
    grew = bool(new_mask.any())
    if grew:
        new_vals = local.filter(pa.array(new_mask))
        global_arr = pa.concat_arrays(
            [global_arr, new_vals]) if base else new_vals
    # code per local value: existing position, or base + rank-among-new
    new_rank = np.cumsum(new_mask) - 1
    found_np = np.asarray(found.fill_null(0), dtype=np.int64)
    mapping = np.where(new_mask, base + new_rank, found_np)
    idx = enc.indices
    valid = np.zeros(cap, dtype=bool)
    valid[:len(arr)] = np.asarray(idx.is_valid())
    codes = np.zeros(cap, dtype=np.int64)
    codes[:len(arr)][valid[:len(arr)]] = mapping[
        np.asarray(idx.fill_null(0), dtype=np.int64)[valid[:len(arr)]]]
    return codes, valid, global_arr, grew


def _row_order_gids(perm: torch.Tensor, gids: torch.Tensor,
                    num_groups: int, num_rows: int) -> np.ndarray:
    """Group ids in the batch's row order, for the host accumulators:
    `gids` are in sorted order (`perm`); a row in no group gets
    `num_groups`."""
    out = np.full(perm.shape[0], num_groups, dtype=np.int64)
    out[perm.cpu().numpy()] = gids.cpu().numpy()
    return out[:num_rows]


def _agg_arg(fn: AggFunction, cv, cap: int, device: torch.device):
    """One aggregate argument as (data, validity) over `cap` rows on
    `device`.  count over a utf8 column reads only its validity (as int8
    data); a fixed-width host value is uploaded, and a device function
    over a variable-width one raises (ColVal.to_device)."""
    if not cv.is_device and isinstance(fn, CountAgg):
        valid = np.zeros(cap, dtype=bool)
        valid[:len(cv.array)] = np.asarray(cv.array.is_valid())
        v = to_device(valid, device)
        return v.to(torch.int8), v
    cv = cv.to_device(cap, device)
    return cv.data, cv.validity


def _host_copies(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """numpy copies of 1-D tensors; on CUDA all of them come back in one
    device-to-host copy (their bytes packed into one buffer, each part
    padded to 8 bytes so every view stays aligned)."""
    if not tensors:
        return []
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    parts, sizes = [], []
    for t in tensors:
        b = t.contiguous().view(torch.uint8)
        sizes.append(b.numel())
        parts.append(b)
        pad = -b.numel() % 8
        if pad:
            parts.append(b.new_zeros(pad))
    host = torch.cat(parts).cpu().numpy()
    out, off = [], 0
    for t, nb in zip(tensors, sizes):
        out.append(host[off:off + nb].view(TORCH_TO_NP[t.dtype]))
        off += nb + (-nb % 8)
    return out


class _ArrowSink:
    """Collects output columns; device columns come back to the host
    together, in one copy, when materialized."""

    def __init__(self):
        self._items: List = []  # pa.Array | (data, valid, n)

    def add_host(self, arr: pa.Array) -> None:
        self._items.append(arr)

    def add_device(self, data: torch.Tensor, valid: torch.Tensor,
                   n: int) -> None:
        self._items.append((data[:n], valid[:n]))

    def materialize(self) -> List[pa.Array]:
        pending = [t for it in self._items if isinstance(it, tuple)
                   for t in it]
        fetched = iter(_host_copies(pending))
        out: List[pa.Array] = []
        for it in self._items:
            if isinstance(it, tuple):
                d, v = next(fetched), next(fetched)
                out.append(pa.array(d, mask=~v))
            else:
                out.append(it)
        return out


def _cast_output(a: pa.Array, t: pa.DataType) -> pa.Array:
    if a.type.equals(t):
        return a
    if pa.types.is_decimal(t) and pa.types.is_integer(a.type):
        # internal unscaled ints -> decimal at the target scale, rebuilt
        # from the values (an Arrow value cast would rescale)
        valid = np.ones(len(a), dtype=bool) if a.null_count == 0 else \
            np.asarray(a.is_valid())
        return decimal_from_unscaled(
            np.asarray(a.fill_null(0)).astype(np.int64), valid, t)
    return a.cast(t, safe=False)
