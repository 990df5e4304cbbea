"""Whole-chain expression programs: one program per filter/project chain,
cached across batches, partitions and queries (port of
blaze_tpu/exprs/program.py).

The eager evaluator (evaluator.py) issues one launch per torch op, and
on the card the host's dispatch of those launches, not the card, sets a
chain's time.  Here an eligible chain becomes ONE program: the referenced
columns enter as (data, validity) pairs, `PhysicalExpr.evaluate` runs
unchanged over a batch view of them, and three shapes cover the
operators:

  filter          -> the conjuncts' combined mask over the capacity
  project         -> (data, validity) per output column
  filter_project  -> (mask, ((data, validity), ...))

The mask never compacts: callers AND it into the selection as the eager
path does, so the fused and the eager outputs are the same bits.

Where the JAX package traces the chain into an XLA program, the port
captures the eager body's own kernels into a CUDA graph, once per
(program, bucket rung) on a CUDA device, and replays it per batch: the
same kernels on the same inputs, so the bits equal the eager path's by
construction (no compiler may contract or reorder a float operation, as
`torch.compile` could).  A batch costs three launches, whatever the
chain's length: one copy of its referenced columns into the graph's
static input buffer (one `torch.cat`), the replay, and one copy of the
packed outputs out of the graph's buffer (a consumer may keep a
projected column past the next replay: a sort's buffer, a join's build
side).  The graphs of every program share one memory pool per device
(`torch.cuda.graph_pool_handle`); a replay runs under
`device.CAPTURE_LOCK` and waits for the last replay's copy-out, so no two
replays, on any thread or stream, overlap.  A capture holds
`CAPTURE_LOCK` too, on the device's private capture stream
(`device.capture_stream`), in the thread-local error mode: an operation of the
chain that cannot be captured (a sync, a pageable copy) raises; no chain
the whitelist admits falls back to the eager path quietly.  On the CPU
the same body runs eagerly.

A replay's host work (the gather, the input copy, the lock, the event,
the copy out) costs about as much as a few eager launches, so on a CUDA
device a chain of fewer than `GRAPH_MIN_NODES` operator nodes runs the
eager evaluator, counted as eager batches; the break-even comes from
`chip_smoke.py`'s expressions phase, which times chains of 1 to 6 nodes
both ways.  The CPU, which has no graph, runs every eligible chain
through its program.

Programs live in a process-wide bounded LRU keyed by fingerprint (the
expressions' cache keys, the input dtypes, the knobs that change what
the body computes), so every partition's evaluator resolves to the one
program; `bridge/device_stats.py` counts builds, cache hits, evictions,
fused and eager batches, and each capture under the program's name in
`compile_report`.

Eligibility is a strict whitelist: fixed-width non-decimal operands
through BinaryExpr, Not, IsNull, IsNotNull, If, CaseWhen, Coalesce,
InList and Cast, plus the decimal rules of the JAX package (with
`auron.tpu.encoding.decimal.enable`, equal-scale compares and +/- on the
unscaled integers, unequal-scale compares on the limbs).  Host-only
expressions, ANSI mode (its checks sync) and batches whose referenced
columns are not all device columns run the eager evaluator, counted per
batch.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn, bucket_capacity
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.exprs.base import BoundReference, Literal, PhysicalExpr
from blaze_tpu_torch.exprs.binary import (_ARITH, _BOOLEAN, _CMP,
                                          BinaryExpr, _decimal_device_ok,
                                          _decimal_limb_ok, decimal_types)
from blaze_tpu_torch.exprs.cast import Cast, _device_supported
from blaze_tpu_torch.exprs.conditional import (CaseWhen, Coalesce, If,
                                               InList, IsNotNull, IsNull,
                                               Not)
from blaze_tpu_torch.exprs.evaluator import (CachedExprsEvaluator,
                                             split_conjuncts)
from blaze_tpu_torch.schema import DataType, Schema, TypeId


# ---------------------------------------------------------------------------
# traceability
# ---------------------------------------------------------------------------

def _dtype_ok(dt: DataType) -> bool:
    # decimals take the exact host routes; variable-width, nested and
    # null values live on the host
    return dt.is_fixed_width and dt.id != TypeId.DECIMAL


def _ref_dtype_ok(dt: DataType) -> bool:
    """Operand gate for column and binary-operator positions: with the
    decimal-encoding knob on, decimals of precision <= 18 ride the
    integer lanes (the operator checks below still require an exact
    device route)."""
    if dt.id == TypeId.DECIMAL:
        return config.ENCODING_DECIMAL_ENABLE.get() and dt.is_fixed_width
    return _dtype_ok(dt)


def is_traceable(expr: PhysicalExpr, schema: Schema) -> bool:
    """True when `expr` evaluates as device tensor ops over fixed-width
    columns alone, so it can run inside a captured graph."""
    try:
        return _traceable(expr, schema)
    except Exception:
        return False


def _traceable(e: PhysicalExpr, schema: Schema) -> bool:
    if isinstance(e, BoundReference):
        return _ref_dtype_ok(schema[e.index].data_type)
    if isinstance(e, Literal):
        return _dtype_ok(e.dtype)
    if isinstance(e, BinaryExpr):
        op = e.op
        if op not in _ARITH and op not in _CMP and op not in _BOOLEAN \
                and op != "<=>":
            return False
        lt, rt = e.left.data_type(schema), e.right.data_type(schema)
        if not (_ref_dtype_ok(lt) and _ref_dtype_ok(rt)):
            return False
        if TypeId.DECIMAL in (lt.id, rt.id):
            # only the exact device routes trace: equal-scale compares and
            # +/- on the unscaled integers, unequal-scale compares on the
            # limbs; the rest is exact host work
            dec = decimal_types(op, lt, rt)
            if dec is None:
                return False
            is_cmp = op in _CMP or op == "<=>"
            if not (_decimal_device_ok(op, *dec)
                    or (is_cmp and _decimal_limb_ok(*dec))):
                return False
        return _traceable(e.left, schema) and _traceable(e.right, schema)
    if isinstance(e, (Not, IsNull, IsNotNull)):
        return _traceable(e.child, schema)
    if isinstance(e, (If, CaseWhen, Coalesce)):
        if not _dtype_ok(e.data_type(schema)):
            return False
        return all(_traceable(c, schema) for c in e.children())
    if isinstance(e, InList):
        return _dtype_ok(e.child.data_type(schema)) and \
            _traceable(e.child, schema)
    if isinstance(e, Cast):  # TryCast too
        src = e.child.data_type(schema)
        return _dtype_ok(src) and _dtype_ok(e.to) and \
            _device_supported(src, e.to) and _traceable(e.child, schema)
    return False


def eviction_reason(exprs: Sequence[PhysicalExpr], schema: Schema) -> str:
    """Why a chain left the device lanes, by the first referenced column
    the gates reject: 'string', 'decimal' or 'other'."""
    for i in _collect_refs(list(exprs)):
        dt = schema[i].data_type
        if dt.id in (TypeId.UTF8, TypeId.BINARY):
            return "string"
        if dt.id == TypeId.DECIMAL:
            return "decimal"
    return "other"


def _note_host_eviction(exprs: Sequence[PhysicalExpr],
                        schema: Schema) -> None:
    device_stats.note_host_eviction(eviction_reason(exprs, schema))


#: the fewest operator nodes (`op_nodes`) a chain needs on a CUDA device
#: to run as a graph replay rather than eagerly (PERF.md §6, the sweep)
GRAPH_MIN_NODES = 2


def op_nodes(exprs: Sequence[PhysicalExpr]) -> int:
    """The chain's nodes other than column references and literals: a
    count that grows with the eager chain's launches."""
    def walk(e: PhysicalExpr) -> int:
        own = not isinstance(e, (BoundReference, Literal))
        return own + sum(walk(c) for c in e.children())
    return sum(walk(e) for e in exprs)


def _collect_refs(exprs: Sequence[PhysicalExpr]) -> List[int]:
    refs: set = set()

    def walk(e: PhysicalExpr):
        if isinstance(e, BoundReference):
            refs.add(e.index)
        for c in e.children():
            walk(c)

    for e in exprs:
        walk(e)
    return sorted(refs)


# ---------------------------------------------------------------------------
# fingerprinting
# ---------------------------------------------------------------------------

def _schema_sig(schema: Schema) -> tuple:
    return tuple((f.data_type.id.value, f.data_type.precision,
                  f.data_type.scale) for f in schema)


def program_fingerprint(mode: str, filters: Sequence[PhysicalExpr],
                        projections: Sequence[PhysicalExpr],
                        in_schema: Schema) -> tuple:
    """Hashable identity of a program: what it computes (the expressions'
    cache keys), over what (the input dtypes), and under which knobs that
    change the body (the decimal encoding's routes and storage)."""
    return (mode,
            tuple(f.cache_key() for f in filters),
            tuple(p.cache_key() for p in projections),
            _schema_sig(in_schema),
            bool(config.ENCODING_DECIMAL_ENABLE.get()),
            bool(config.ENCODING_DECIMAL_INT32.get()))


# ---------------------------------------------------------------------------
# the packed layout of a program's inputs and outputs
# ---------------------------------------------------------------------------

class _Layout:
    """Tensors of given dtypes and lengths laid end to end in one uint8
    buffer, each at a byte offset that is a multiple of its element size
    (every length is a multiple of the 128-row lane, so each offset is a
    multiple of 128 bytes)."""

    def __init__(self, specs: Sequence[Tuple[torch.dtype, int]]):
        self.specs = list(specs)
        self.offsets, off = [], 0
        for dt, n in self.specs:
            self.offsets.append(off)
            off += n * dt.itemsize
        self.nbytes = off

    @staticmethod
    def of(tensors: Sequence[torch.Tensor]) -> "_Layout":
        return _Layout([(t.dtype, t.shape[0]) for t in tensors])

    def pack(self, tensors: Sequence[torch.Tensor],
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One copy of `tensors` into `out` (a new buffer when None)."""
        parts = [t.contiguous().view(torch.uint8) for t in tensors]
        if out is None:
            return torch.cat(parts)
        return torch.cat(parts, out=out)

    def views(self, buf: torch.Tensor) -> List[torch.Tensor]:
        return [buf[off:off + n * dt.itemsize].view(dt)
                for (dt, n), off in zip(self.specs, self.offsets)]


#: captures, capture ms and replays of every expression graph in the
#: process (the chip phase reads deltas)
graph_stats = {"captures": 0, "capture_ms": 0.0, "replays": 0}

#: one graph memory pool per device, shared by every program's graphs
_pools: Dict[str, object] = {}
#: per device: (stream, event) of the last replay's copy-out
_last_done: Dict[str, tuple] = {}


class _Graph:
    """One program's CUDA graph at one bucket rung: a static input buffer
    (allocated outside the graph's pool), the captured body, and a
    static output buffer the body packs its outputs into."""

    def __init__(self, prog: "ExprProgram", flat: List[torch.Tensor],
                 in_layout: _Layout, cap: int):
        from blaze_tpu_torch.bridge import tracing
        from blaze_tpu_torch.device import capture_stream
        dev = flat[0].device
        t0 = time.perf_counter()
        self.in_layout = in_layout
        self.static_in = in_layout.pack(flat)
        views = in_layout.views(self.static_in)
        # warm up eagerly (lazy initialisation and every constant an
        # expression keeps per device, such as an IN list's members,
        # happen outside the capture), then capture on a side stream
        outs = prog._outputs(prog._body(views, cap))
        self.out_layout = _Layout.of(outs)
        self.static_out = torch.empty(self.out_layout.nbytes,
                                      dtype=torch.uint8, device=dev)
        key = str(dev)
        if key not in _pools:
            _pools[key] = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(dev)
        side = capture_stream(dev)  # private: no query issues on it
        side.wait_stream(main)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin(pool=_pools[key],
                                     capture_error_mode="thread_local")
            try:
                outs = prog._outputs(prog._body(views, cap))
                self.out_layout.pack(outs, self.static_out)
            finally:
                self.graph.capture_end()
        main.wait_stream(side)
        ns = int((time.perf_counter() - t0) * 1e9)
        graph_stats["captures"] += 1
        graph_stats["capture_ms"] += ns / 1e6
        device_stats.note_compile(prog.name, ns)
        tracing.instant("graph_capture", kernel=prog.name, ns=ns)

    def replay(self, flat: List[torch.Tensor]) -> torch.Tensor:
        """The packed outputs for `flat`, copied out of the graph's
        buffer on the current stream."""
        dev = self.static_in.device
        stream = torch.cuda.current_stream(dev)
        last = _last_done.get(str(dev))
        if last is not None and last[0] != stream:
            stream.wait_event(last[1])
        self.in_layout.pack(flat, self.static_in)
        self.graph.replay()
        out = self.static_out.clone()
        event = last[1] if last is not None else torch.cuda.Event()
        event.record(stream)
        _last_done[str(dev)] = (stream, event)
        graph_stats["replays"] += 1
        return out


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

class ExprProgram:
    """One (filters, projections) chain over a fixed input schema, shared
    process-wide through `get_program`; on a CUDA device, one graph per
    bucket rung."""

    def __init__(self, filters: Sequence[PhysicalExpr],
                 projections: Sequence[PhysicalExpr], in_schema: Schema,
                 fingerprint: tuple):
        self.filters = list(filters)
        self.projections = list(projections)
        self.in_schema = in_schema
        self.fingerprint = fingerprint
        self.ref_idx = _collect_refs(self.filters + self.projections)
        self.replays_pay = \
            op_nodes(self.filters + self.projections) >= GRAPH_MIN_NODES
        digest = hashlib.blake2s(repr(fingerprint).encode()).hexdigest()[:12]
        self.name = f"expr_program_{digest}"
        self._graphs: Dict[Tuple[str, int], _Graph] = {}

    # -- the body -----------------------------------------------------------
    def _body(self, flat: Sequence[torch.Tensor], cap: int):
        """(mask or None, [(data, validity)]) over a batch view of `flat`,
        (data, validity) per referenced column in ref_idx order."""
        ref_pos = {idx: 2 * k for k, idx in enumerate(self.ref_idx)}
        cols: List[Optional[DeviceColumn]] = []
        for i, f in enumerate(self.in_schema):
            p = ref_pos.get(i)
            cols.append(None if p is None else
                        DeviceColumn(f.data_type, flat[p], flat[p + 1]))
        batch = ColumnBatch(self.in_schema, cols, cap)
        mask = None
        for f in self.filters:
            m = f.evaluate(batch).as_mask(batch)
            mask = m if mask is None else (mask & m)
        pairs = []
        for p in self.projections:
            v = p.evaluate(batch)
            if not v.is_device:
                raise RuntimeError(
                    f"{self.name}: {p!r} evaluated on the host; "
                    f"is_traceable admitted it")
            pairs.append((v.data, v.validity))
        return mask, pairs

    @staticmethod
    def _outputs(result) -> List[torch.Tensor]:
        mask, pairs = result
        outs = [] if mask is None else [mask]
        for d, v in pairs:
            outs.extend((d, v))
        return outs

    def _unpack(self, outs: List[torch.Tensor]):
        mask = outs.pop(0) if self.filters else None
        return mask, [(outs[2 * k], outs[2 * k + 1])
                      for k in range(len(self.projections))]

    # -- dispatch -----------------------------------------------------------
    def _gather(self, batch: ColumnBatch):
        """The referenced columns' (data, validity), padded onto the
        bucket ladder (one graph per program and rung)."""
        cap = batch.capacity
        pcap = bucket_capacity(cap)
        flat = []
        for i in self.ref_idx:
            col = batch.columns[i]
            for a in (col.data, col.validity):
                if pcap != cap:
                    a = torch.cat([a, a.new_zeros(pcap - cap)])
                flat.append(a)
        return flat, pcap

    def _run(self, batch: ColumnBatch):
        """(mask or None, pairs) over the padded capacity: the graph's
        replay on a CUDA device, the body itself on the CPU."""
        flat, pcap = self._gather(batch)
        dev = flat[0].device
        if dev.type != "cuda":
            return self._body(flat, pcap)
        in_layout = _Layout.of(flat)
        from blaze_tpu_torch.device import CAPTURE_LOCK
        with CAPTURE_LOCK:
            g = self._graphs.get((str(dev), pcap))
            if g is None:
                g = self._graphs[(str(dev), pcap)] = _Graph(
                    self, flat, in_layout, pcap)
            out = g.replay(flat)
        return self._unpack(g.out_layout.views(out))

    def batch_ok(self, batch: ColumnBatch) -> bool:
        """The batch can run through this program: every referenced
        column is a device column, and on a CUDA device the chain is long
        enough for a replay to pay."""
        if not all(isinstance(batch.columns[i], DeviceColumn)
                   for i in self.ref_idx):
            return False
        return self.replays_pay or batch.device.type != "cuda"

    def run_filter(self, batch: ColumnBatch) -> ColumnBatch:
        mask, _ = self._run(batch)
        device_stats.note_expr_dispatch(fused=1)
        return batch.with_selection(mask[:batch.capacity])

    def run_project(self, batch: ColumnBatch, out_schema: Schema
                    ) -> ColumnBatch:
        _, pairs = self._run(batch)
        device_stats.note_expr_dispatch(fused=1)
        return self._assemble(batch, out_schema, pairs, batch.selection)

    def run_filter_project(self, batch: ColumnBatch, out_schema: Schema
                           ) -> ColumnBatch:
        mask, pairs = self._run(batch)
        device_stats.note_expr_dispatch(fused=1)
        sel = _padded(batch.selection, mask.shape[0])
        return self._assemble(batch, out_schema, pairs,
                              mask if sel is None else (sel & mask))

    @staticmethod
    def _assemble(batch: ColumnBatch, out_schema: Schema, pairs,
                  selection) -> ColumnBatch:
        # the outputs are padded to the rung; the batch takes that
        # capacity (a shorter selection pads with False)
        cols = [DeviceColumn(f.data_type, d, v)
                for f, (d, v) in zip(out_schema, pairs)]
        if pairs:
            selection = _padded(selection, pairs[0][0].shape[0])
        return ColumnBatch(out_schema, cols, batch.num_rows, selection)


def _padded(sel: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    if sel is None or sel.shape[0] >= n:
        return sel
    return torch.cat([sel, sel.new_zeros(n - sel.shape[0])])


# ---------------------------------------------------------------------------
# the process-wide program cache
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_programs: "collections.OrderedDict[tuple, ExprProgram]" = \
    collections.OrderedDict()


def get_program(mode: str, filters: Sequence[PhysicalExpr],
                projections: Sequence[PhysicalExpr],
                in_schema: Schema) -> ExprProgram:
    """The shared program of this chain, built on first use.  A bounded
    LRU: an evicted program's graphs go with it (once no evaluator holds
    it)."""
    fp = program_fingerprint(mode, filters, projections, in_schema)
    with _cache_lock:
        prog = _programs.get(fp)
        if prog is not None:
            _programs.move_to_end(fp)
            device_stats.note_expr_program(cache_hit=True)
            return prog
        prog = ExprProgram(filters, projections, in_schema, fp)
        _programs[fp] = prog
        device_stats.note_expr_program(built=True)
        limit = max(1, config.EXPR_CACHE_SIZE.get())
        while len(_programs) > limit:
            _programs.popitem(last=False)
            device_stats.note_expr_program(evicted=True)
        return prog


def program_cache_info() -> dict:
    with _cache_lock:
        return {"size": len(_programs),
                "names": [p.name for p in _programs.values()]}


def clear_program_cache() -> None:
    """Forget every program, and with them the graphs' shared memory
    pool: a graph captured afterwards into the old pool, whose graphs
    are gone, would trip the caching allocator's assert on its use
    count."""
    with _cache_lock:
        _programs.clear()
        _pools.clear()


# ---------------------------------------------------------------------------
# the evaluator the operators use
# ---------------------------------------------------------------------------

def _fusion_on() -> bool:
    return config.EXPR_FUSE.get() and not config.ANSI_ENABLED.get()


class FusedExprsEvaluator:
    """CachedExprsEvaluator's interface: eligible batches through the
    shared program, the rest through the eager evaluator.  Eligibility
    and the program resolve once per operator partition (construction);
    the per-batch checks are cheap."""

    def __init__(self, filters: Sequence[PhysicalExpr] = (),
                 projections: Sequence[PhysicalExpr] = (),
                 in_schema: Optional[Schema] = None):
        # the conjuncts split, as the eager evaluator's do
        self.filters: List[PhysicalExpr] = []
        for f in filters:
            self.filters.extend(split_conjuncts(f))
        self.projections = list(projections)
        self._eager = CachedExprsEvaluator(filters=filters,
                                           projections=projections)
        self._filter_prog: Optional[ExprProgram] = None
        self._project_prog: Optional[ExprProgram] = None
        self._fp_prog: Optional[ExprProgram] = None
        if in_schema is None or not _fusion_on():
            return
        # a literal-only chain references no column: no input carries the
        # batch's capacity, so it stays eager
        filters_ok = bool(self.filters) and all(
            is_traceable(f, in_schema) for f in self.filters) and \
            bool(_collect_refs(self.filters))
        projections_ok = bool(self.projections) and all(
            is_traceable(p, in_schema) for p in self.projections) and \
            bool(_collect_refs(self.projections))
        if (self.filters and not filters_ok) or \
                (self.projections and not projections_ok):
            _note_host_eviction(self.filters + self.projections, in_schema)
        # resolve only the program the operator will run: Filter ->
        # filter, Project -> project, FilterProject -> the combined one
        # (or the filter half when the projections are host-only: a fused
        # mask, then an eager projection)
        if filters_ok and projections_ok:
            self._fp_prog = get_program(
                "filter_project", self.filters, self.projections, in_schema)
        elif filters_ok:
            self._filter_prog = get_program(
                "filter", self.filters, (), in_schema)
        elif projections_ok and not self.filters:
            self._project_prog = get_program(
                "project", (), self.projections, in_schema)

    @staticmethod
    def _usable(prog: Optional[ExprProgram], batch: ColumnBatch) -> bool:
        return prog is not None and _fusion_on() and prog.batch_ok(batch)

    def filter(self, batch: ColumnBatch) -> ColumnBatch:
        if self._usable(self._filter_prog, batch):
            return self._filter_prog.run_filter(batch)
        device_stats.note_expr_dispatch(eager=1)
        return self._eager.filter(batch)

    def project(self, batch: ColumnBatch, out_schema: Schema) -> ColumnBatch:
        if self._usable(self._project_prog, batch):
            return self._project_prog.run_project(batch, out_schema)
        device_stats.note_expr_dispatch(eager=1)
        return self._eager.project(batch, out_schema)

    def filter_project(self, batch: ColumnBatch, out_schema: Schema
                       ) -> ColumnBatch:
        if self._usable(self._fp_prog, batch):
            return self._fp_prog.run_filter_project(batch, out_schema)
        if self._usable(self._filter_prog, batch):
            filtered = self._filter_prog.run_filter(batch)
            return self._eager.project(filtered, out_schema)
        device_stats.note_expr_dispatch(eager=1)
        return self._eager.filter_project(batch, out_schema)


def fused_filter(predicates: Sequence[PhysicalExpr], schema: Schema
                 ) -> Optional[Callable[[ColumnBatch], ColumnBatch]]:
    """The scan's post-decode filter: a callable that ANDs the fused
    predicate mask into a decoded batch, or None when the chain is not
    wholly traceable (the operator above then filters alone).  It runs
    in the scan's prefetch transform, on the worker thread."""
    if not predicates or not _fusion_on():
        return None
    conjuncts: List[PhysicalExpr] = []
    for p in predicates:
        conjuncts.extend(split_conjuncts(p))
    if not all(is_traceable(c, schema) for c in conjuncts) or \
            not _collect_refs(conjuncts):
        return None
    prog = get_program("filter", conjuncts, (), schema)

    def apply(batch: ColumnBatch) -> ColumnBatch:
        if _fusion_on() and prog.batch_ok(batch):
            return prog.run_filter(batch)
        device_stats.note_expr_dispatch(eager=1)
        return batch

    return apply
