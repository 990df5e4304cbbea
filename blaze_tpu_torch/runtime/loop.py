"""Device stage loop (port of blaze_tpu/runtime/loop.py).

The staged executor runs a hash-lane fused aggregation batch by batch: on
a CUDA device each source batch costs some 40 to 140 kernel launches from
the host, and the card idles between them.  This loop folds a CHUNK of
source batches (`auron.tpu.stage.deviceLoop.chunkBatches`, 8) per step.
On a CUDA device a step is ONE replay of a CUDA graph that holds, for
every batch slot of the chunk, the chain, the hashing, the placement
kernel (csrc/hash_update.cu, a cooperative launch captured as a graph
node) and the accumulation (float sums through a stable sort and
csrc/segment_sum.cu's carry form), all in place into the graph's own
carry; the host then reads one small vector back (the overflow flag, the
first overflowing batch and the chunk's source rows): one sync per
chunk.  On the CPU the same fold body runs eagerly with the plain
placement, which is how the tests hold it to the JAX package.

The JAX loop's contract, kept:
  * ATOMIC overflow: a batch that overflows leaves the carry unchanged
    (the placement takes its claims back) and gates every later batch of
    the chunk to a no-op; exact modes double the table, rehash it (eager,
    outside the graph) and resume the SAME chunk at the overflowing batch
    through a device `start` scalar: the staged grow schedule, bit for
    bit.
  * PARTIAL mode keeps its skip semantics by raising StageLoopFallback,
    as does a table past `_MAX_SLOTS`: the loop emits nothing before its
    final drain, so the staged re-run is lossless.
  * Cancellation is checked between chunks.
A capture, build or launch error propagates: it is never a fallback.

The fold cache keeps a few entries, keyed by (program fingerprint, batch
capacity, batch slots, table slots, device).  Each owns its carry, its
input slabs (batch slots x capacity per source column, and the row
masks), its device scalars, its placement scratch and, on a CUDA device,
its graph; a task resets the carry in place, so the tasks of a stage
replay one graph.  A lock covers an entry from the reset through the
drain.  A window of the full chunk runs on an entry of `chunk` slots; the
last, shorter window of a partition on one of the next power of two (the
JAX loop pads it to the full chunk, for one jit signature: the padding
changes no result, and here each padded slot would cost a slot's device
time).  A larger batch capacity, a shorter last window or a regrow moves
the task to another entry, carrying the table across; every move goes up
one order (table slots, then capacity, then fewer batch slots), so two
tasks never wait on each other's entries.

Each window of a partition runs under a `stage_loop_chunk` span that
closes at the read of the step's flags, the sync the loop makes anyway;
a capture emits a `graph_capture` instant and counts in
bridge/device_stats.py `compile_report`, and a finished task in its
stage-loop counters.  A capture holds `device.CAPTURE_LOCK`, so the
scan's prefetch worker makes no CUDA call while it runs (global mode
would fail it).

Not carried over yet, each where it would hook: the `device-loop` fault
site (the JAX loop's chunk boundary, Queue 1 item 16), query degradation
(`capacity_shrink` and `force_agg_passthrough`, item 16) and the
dictionary-key stream guard (item 13).  `auron.tpu.stage.deviceLoop.donate` is not a key of the port:
a graph always updates its own carry in place.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List

import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn
from blaze_tpu_torch.bridge import device_stats, tracing
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.kernels import hash_update as HU
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.parallel.stage import (HashAggCarry, fold_step,
                                            init_hash_carry, rehash_carry,
                                            reset_hash_carry)

# hard ceiling on grow-on-overflow table size: past this the partition is
# cheaper to re-run staged (which streams) than to hold on the device
_MAX_SLOTS = 1 << 24
PROBE_ROUNDS = 16  # hash_agg_step's

#: CUDA graphs captured, the milliseconds their captures took (warm-up
#: included) and their replays, since the process started
graph_stats = {"captures": 0, "capture_ms": 0.0, "replays": 0}


class StageLoopFallback(RuntimeError):
    """The loop declined BEFORE emitting anything; the caller re-runs the
    partition through the staged per-batch executor."""


# -- regrow fences -----------------------------------------------------------
# An overlapped exchange keeps earlier chunks' collectives in flight while
# the loop folds the next chunk; it registers a fence that drains them, and
# the loop runs every fence right before each regrow.

_FENCE_LOCK = threading.Lock()
_FENCES: list = []


@contextmanager
def exchange_fence(fn):
    """Register `fn` to run before every hash-table regrow for the duration
    of the `with` body."""
    with _FENCE_LOCK:
        _FENCES.append(fn)
    try:
        yield
    finally:
        with _FENCE_LOCK:
            _FENCES.remove(fn)


def _run_fences() -> None:
    with _FENCE_LOCK:
        fences = list(_FENCES)
    for fn in fences:
        fn()


def loop_chunk_batches() -> int:
    """Configured chunk width (at least 1)."""
    return max(1, config.STAGE_DEVICE_LOOP_CHUNK.get())


def _carry_tensors(c: HashAggCarry) -> List[torch.Tensor]:
    return [*c.keys, *c.key_valid, *c.accs, *c.acc_valid, c.used, c.limbs]


class _Fold:
    """One fold-cache entry: the static carry, the chunk's input slabs,
    the step's device scalars, the placement scratch and, on a CUDA
    device, the captured graph of one chunk's fold."""

    def __init__(self, program, cap: int, chunk: int, S: int,
                 device: torch.device):
        self.lock = threading.Lock()
        self.cap, self.chunk, self.S = cap, chunk, S
        self.schema = program.source.schema
        self.carry = init_hash_carry(program.key_dtypes, program.kinds,
                                     program.acc_dtypes, S, device)

        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        # (data, validity) slabs per fixed-width source column
        self.slabs = [(zeros(chunk, cap, dtype=f.data_type.torch_dtype()),
                       zeros(chunk, cap, dtype=torch.bool))
                      if f.data_type.is_fixed_width else None
                      for f in self.schema]
        self.masks = zeros(chunk, cap, dtype=torch.bool)
        self.start = zeros(1, dtype=torch.int32)
        self.ovf_seen = zeros(1, dtype=torch.bool)
        self.first_ovf = zeros(1, dtype=torch.int32)
        # [overflowed, first overflowing batch, source rows]: the one
        # device-to-host read of a step
        self.stats = zeros(3, dtype=torch.int64)
        self.scratch = (HU.Scratch(device, S, PROBE_ROUNDS)
                        if device.type == "cuda" else None)
        self.graph = None
        self.placement_nodes = 0
        self.segment_sum_nodes = {}
        self._start_value = 0

    def acquire(self, program) -> bool:
        """Lock the entry; capture its graph on first use on a CUDA device.
        Returns whether it captured."""
        self.lock.acquire()
        if self.scratch is None or self.graph is not None:
            return False
        try:
            self._capture(program)
        except BaseException:
            self.lock.release()
            raise
        return True

    def release(self) -> None:
        self.lock.release()

    def _capture(self, program) -> None:
        """Warm up (one batch slot of the body, eagerly, gated off, so lazy
        initialisation happens outside the capture and the fresh carry
        stays as it is), then capture the body in the default (global)
        error mode, so that any operation that cannot be captured
        raises."""
        from blaze_tpu_torch.device import CAPTURE_LOCK
        with CAPTURE_LOCK:
            self._capture_locked(program)

    def _capture_locked(self, program) -> None:
        t0 = time.perf_counter()
        self._set_start(self.chunk)
        self._body(program, slots=1)
        # capture on a side stream, as torch.cuda.graph does, without its
        # gc.collect() and empty_cache() (which would cost every later
        # allocation a cudaMalloc)
        main = torch.cuda.current_stream(self.start.device)
        side = torch.cuda.Stream(self.start.device)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        before = HU.captured_launches
        sums_before = dict(K.captured_launches)
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="global")
            try:
                self._body(program)
            finally:
                graph.capture_end()
        main.wait_stream(side)
        self.placement_nodes = HU.captured_launches - before
        self.segment_sum_nodes = {f: K.captured_launches[f] - c
                                  for f, c in sums_before.items()}
        self.graph = graph
        self._set_start(0)
        ns = int((time.perf_counter() - t0) * 1e9)
        graph_stats["captures"] += 1
        graph_stats["capture_ms"] += ns / 1e6
        device_stats.note_compile("stage_loop_graph", ns)
        tracing.instant("graph_capture", kernel="stage_loop_graph", ns=ns)

    def _body(self, program, slots: int = 0) -> None:
        """Fold the first `slots` (all) batch slots of the chunk into the
        carry, gated on the device by `live = mask & ~ovf_seen & (b >=
        start)`."""
        agg = program.agg
        self.ovf_seen.zero_()
        self.first_ovf.zero_()
        for b in range(slots or self.chunk):
            cols = [None if sl is None else
                    DeviceColumn(f.data_type, sl[0][b], sl[1][b])
                    for f, sl in zip(self.schema, self.slabs)]
            batch = ColumnBatch(self.schema, cols, self.cap, self.masks[b])
            kd, kv, ad, av, m = agg._device_inputs(batch)
            live = m & ~self.ovf_seen & (self.start <= b)
            specs = list(zip(program.kinds, ad, av))
            hit = fold_step(self.carry, list(zip(kd, kv)), specs, live,
                            PROBE_ROUNDS, self.scratch)
            self.first_ovf.copy_(torch.where(hit & ~self.ovf_seen, b,
                                             self.first_ovf))
            self.ovf_seen.logical_or_(hit)
        self.stats.copy_(torch.cat([self.ovf_seen.long(),
                                    self.first_ovf.long(),
                                    self.masks.sum().reshape(1)]))

    def _set_start(self, start: int) -> None:
        if start != self._start_value:
            self.start.fill_(start)
            self._start_value = start

    def load(self, batches: List[ColumnBatch]) -> None:
        """Copy a chunk's source batches into the slabs: a batch below the
        slab capacity pads with masked lanes, a short chunk with masked
        batches (the JAX package's `_stack_window` and `_pad_chunk`)."""
        for b, batch in enumerate(batches):
            n = batch.capacity
            for sl, col in zip(self.slabs, batch.columns):
                if sl is not None:
                    sl[0][b, :n].copy_(col.data)
                    sl[1][b, :n].copy_(col.validity)
            self.masks[b, :n].copy_(batch.row_mask())
            if n < self.cap:
                self.masks[b, n:] = False
        if len(batches) < self.chunk:
            self.masks[len(batches):] = False

    def run(self, program, start: int):
        """One step over the loaded chunk from batch `start`: a graph
        replay on a CUDA device, the body eagerly on the CPU.  Returns
        (overflowed, first overflowing batch, source rows of the chunk)."""
        self._set_start(start)
        if self.graph is None:
            self._body(program)
        else:
            self.scratch.reserve(self.placement_nodes * (PROBE_ROUNDS + 1))
            self.graph.replay()
            graph_stats["replays"] += 1
            HU.placement_launches += self.placement_nodes
            K.add_replayed(self.segment_sum_nodes)
        ovf, first, rows = self.stats.tolist()
        return bool(ovf), int(first), int(rows)


#: (fingerprint, capacity, chunk, slots, device) -> _Fold, oldest first.
#: Each entry holds device memory (at 2^18 slots and q01's keys, ~13 MB
#: of carry, ~10 MB of slabs and the graph's pool), so there are few.
_FOLDS: Dict[tuple, _Fold] = {}
_FOLD_LIMIT = 8
_FOLDS_LOCK = threading.Lock()


def _fold_for(program, cap: int, chunk: int, S: int,
              device: torch.device) -> _Fold:
    key = (program.fingerprint, cap, chunk, S, str(device))
    with _FOLDS_LOCK:
        fold = _FOLDS.get(key)
        if fold is None:
            if len(_FOLDS) >= _FOLD_LIMIT:
                _FOLDS.pop(next(iter(_FOLDS)))
            fold = _FOLDS[key] = _Fold(program, cap, chunk, S, device)
        return fold


def _move(program, old, cap: int, chunk: int, S: int, device,
          carry=None):
    """Acquire the entry for (cap, chunk, S) and give it the task's table:
    the old entry's carry, `carry` (a regrown table), or a fresh one; then
    release the old entry.  Returns (entry, whether it captured)."""
    fold = _fold_for(program, cap, chunk, S, device)
    captured = fold.acquire(program)
    try:
        src = carry if carry is not None else (old.carry if old else None)
        if src is None:
            reset_hash_carry(fold.carry, program.kinds)
        else:
            for dst, t in zip(_carry_tensors(fold.carry),
                              _carry_tensors(src)):
                dst.copy_(t)
    except BaseException:
        fold.release()
        raise
    if old is not None:
        old.release()
    return fold, captured


@contextmanager
def _folded(program, partition: int, source_stream=None):
    """Fold one partition; yields the final carry with its entry locked
    (the caller drains it inside the `with`).  Raises StageLoopFallback
    before yielding where the JAX loop does."""
    from blaze_tpu_torch.device import resolve
    from blaze_tpu_torch.plan.fused import _batch_windows, _pow2
    task = current_task()
    device = resolve()
    chunk = loop_chunk_batches()
    slots = _pow2(config.ON_DEVICE_AGG_CAPACITY.get())
    stream = (source_stream if source_stream is not None
              else program.source.execute(partition))
    fold = None
    batches = rows = fold_calls = regrows = captures = ci = 0
    try:
        for window in _batch_windows(stream, chunk):
            # chunk boundary: cooperative cancel
            task.check_running()
            with tracing.span("stage_loop_chunk", stage=task.stage_id,
                              partition=partition, chunk=ci,
                              batches=len(window)):
                cap = max([b.capacity for b in window] +
                          [fold.cap if fold is not None else 0])
                width = min(chunk, 1 << (len(window) - 1).bit_length())
                if fold is None or cap > fold.cap or width != fold.chunk:
                    fold, captured = _move(program, fold, cap, width,
                                           slots, device)
                    captures += captured
                fold.load(window)
                start, counted = 0, False
                while True:
                    # the span closes after the step that reads no
                    # overflow: the read of its flags is the sync
                    ovf, first, nrows = fold.run(program, start)
                    fold_calls += 1
                    if not counted:
                        rows += nrows
                        counted = True
                    if not ovf:
                        break
                    if not program.grow:
                        # PARTIAL mode: skip semantics belong to the
                        # staged path; growing here would diverge from
                        # its bits
                        raise StageLoopFallback(
                            "hash table overflow in partial mode")
                    _run_fences()
                    re_ovf = 1
                    while re_ovf > 0:
                        # batches start..first-1 are already in
                        # fold.carry: rare probe clustering doubles and
                        # rehashes that carry again, never replaying the
                        # chunk
                        if slots * 2 > _MAX_SLOTS:
                            raise StageLoopFallback(
                                f"table would exceed {_MAX_SLOTS} slots")
                        slots *= 2
                        bigger, re_ovf, _ = rehash_carry(
                            fold.carry, list(program.kinds), slots)
                    fold, captured = _move(program, fold, fold.cap,
                                           fold.chunk, slots, device,
                                           carry=bigger)
                    captures += captured
                    fold.load(window)
                    regrows += 1
                    start = first
            ci += 1
            batches += len(window)
            task.loop_chunks = ci
        carry = (fold.carry if fold is not None else
                 init_hash_carry(program.key_dtypes, program.kinds,
                                 program.acc_dtypes, slots, device))
        for k, v in (("stage_loop_tasks", 1),
                     ("stage_loop_chunks", fold_calls),
                     ("stage_loop_batches", batches),
                     ("stage_loop_rows", rows),
                     ("stage_loop_regrows", regrows),
                     ("stage_loop_graph_captures", captures),
                     (f"{device.type}_batches", batches)):
            program.agg.metrics.add(k, v)
        device_stats.note_stage_loop_task(
            chunks=fold_calls, batches=batches, rows=rows, regrows=regrows,
            dispatches_avoided=max(0, batches - fold_calls))
        yield carry
    finally:
        if fold is not None:
            fold.release()


def run_partition(program, partition: int, source_stream=None
                  ) -> HashAggCarry:
    """Fold one partition through the stage program; returns a copy of the
    final carry.  Raises StageLoopFallback on a partial-mode overflow or a
    table past `_MAX_SLOTS`; cancellation propagates."""
    with _folded(program, partition, source_stream) as carry:
        return HashAggCarry(*[tuple(t.clone() for t in f)
                              if isinstance(f, tuple) else f.clone()
                              for f in carry])


def execute_loop(program, partition: int):
    """Generator form for FusedPartialAggExec.execute: fold, then drain
    through the shared emission path.  Raises StageLoopFallback only
    before the first yield."""
    with _folded(program, partition) as carry:
        out = list(program.agg._emit_hash(carry))
    yield from out


def drain_device(program, carry: HashAggCarry):
    """Device-to-device drain: the carry's used slots compacted on the
    device and cast to the stage's output dtypes, for an exchange that
    takes device columns.  Returns (datas, valids, n): lists of length-n
    device tensors in output column order."""
    count = int(carry.used.sum())
    if count == 0:
        return [], [], 0
    sel = torch.nonzero(carry.used).squeeze(1)
    fields = list(program.out_schema)
    datas, valids = [], []
    for f, kd, kv in zip(fields, carry.keys, carry.key_valid):
        datas.append(kd.index_select(0, sel).to(f.data_type.torch_dtype()))
        valids.append(kv.index_select(0, sel))
    for f, (_rk, out_kind, _a), acc, av in zip(
            fields[len(carry.keys):], program.agg._specs, carry.accs,
            carry.acc_valid):
        datas.append(acc.index_select(0, sel).to(f.data_type.torch_dtype()))
        valids.append(torch.ones(count, dtype=torch.bool, device=sel.device)
                      if out_kind == "count" else av.index_select(0, sel))
    return datas, valids, count
