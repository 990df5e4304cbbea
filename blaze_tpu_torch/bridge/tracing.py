"""Span tracer for query execution (port of blaze_tpu/bridge/tracing.py,
the in-process half).

Every task, exchange, operator stream and stage-loop chunk can emit a
span carrying the (query, stage, partition) execution context.  Spans
are buffered in memory and optionally streamed to a JSONL file (one JSON
object per line: name, t0/t1 ns, thread, context, attrs).

Tracing is enabled programmatically (`start_tracing()`) or from conf
(`auron.tpu.trace.enable`, probed once lazily).  Disabled tracing costs
one boolean check: operators call `span(...)` unconditionally.  A span
reads the host clock only; nothing here synchronises the device, so on
the card a span ends where its caller already waits (the stage loop's
chunk span closes after the read of its overflow flags).

Every name the runtime emits is registered in SPAN_NAMES; a trailing `*`
marks a prefix family (the operator class names).  The cross-process
half of the reference (`wire_context`, `remote_task_scope`,
`take_buffered`, `ingest`) comes with the worker pool (ROADMAP Queue 1
items 14 and 16).
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_enabled = False
_conf_probed = False
_lock = threading.Lock()
_spans: List[dict] = []
_MAX_SPANS = 100_000
_sink = None  # open JSONL file, when exporting
_tls = threading.local()
_ids = itertools.count(1)

#: every span and instant name the port emits, with its one-line doc
SPAN_NAMES: Dict[str, str] = {
    # -- spans (dur_ns > 0) -------------------------------------------
    "task": "per-partition runtime stream covering one task's operator "
            "chain (bridge/runtime.py; mode=sync)",
    "task_attempt": "one attempt of a task in the wave loop "
                    "(bridge/tasks.py; attrs task/attempt/what)",
    "backoff_wait": "retry backoff sleep between task attempts "
                    "(bridge/tasks.py)",
    "shuffle_exchange": "file-tier shuffle exchange for one stage "
                        "(plan/stages.py)",
    "stage_recovery": "lineage re-run of a poisoned producer map task "
                      "after FetchFailedError (plan/stages.py)",
    "stage_loop_chunk": "one device stage-loop step over a chunk of "
                        "batches: one graph replay on the card, closed "
                        "at the read of its overflow flags "
                        "(runtime/loop.py)",
    "explain_analyze": "whole-query profiled execution (plan/explain.py)",
    "admission_wait": "queue wait from QueryService.submit() to the pool "
                      "slot's pop that starts the query "
                      "(serving/service.py; attrs query/tenant)",
    "query": "one admitted query's execution on its pool slot, after its "
             "admission wait (serving/service.py; attrs query/tenant)",
    "stream_epoch": "one streaming epoch: poll, the plan's run, the window "
                    "fold, the sink attempt and the checkpoint commit "
                    "(streaming/executor.py; attrs epoch/query)",
    "operator:*": "per-operator stream total accumulated across next() "
                  "calls; suffix is the ExecutionPlan class name "
                  "(ops/base.py stream meter)",
    # -- instants (dur_ns == 0) ---------------------------------------
    "task_retry": "a failed attempt was classified retryable and will "
                  "back off and retry (bridge/tasks.py)",
    "kernel_build": "a hand CUDA kernel library was compiled by nvcc, "
                    "attrs kernel/ns (kernels/build.py)",
    "graph_capture": "the stage loop captured a CUDA graph, attrs "
                     "kernel/ns (runtime/loop.py)",
    "stage_loop_fallback": "the stage loop declined; the partition re-ran "
                           "through the staged per-batch path "
                           "(plan/fused.py)",
    "quota_breach": "per-query memory quota breach climbed one degrade "
                    "rung (memory/manager.py; attrs query/used/quota/"
                    "rung)",
    "mem_spill": "a memory consumer spilled under pressure or quota "
                 "shed (memory/manager.py; attrs consumer/bytes/cause/"
                 "query)",
    "aqe_rewrite": "an adaptive-execution rule rewrote a not-yet-"
                   "dispatched consumer stage at the boundary "
                   "(plan/adaptive.py; attrs stage/rule)",
    "aqe_history_seed": "bind-time planning applied statstore-derived "
                        "seeds to the plan (plan/adaptive.py; attrs "
                        "seeds)",
    "stream_recovery": "a streaming query restored its last committed "
                       "checkpoint after a retryable epoch failure "
                       "(streaming/executor.py; attrs resume_epoch/"
                       "replayed_epochs/query)",
    "fault_injected": "the chaos injector fired a scripted fault "
                      "(faults.py; attrs site)",
}


def register_span(name: str, doc: str) -> None:
    """Register a name for an out-of-tree emitter."""
    SPAN_NAMES[name] = doc


def _check_name(name: str) -> None:
    """An unregistered name is a bug (reached only with tracing on)."""
    if name in SPAN_NAMES:
        return
    i = name.find(":")
    if i > 0 and name[:i + 1] + "*" in SPAN_NAMES:
        return
    raise ValueError(f"unregistered span name {name!r}: add it to "
                     "tracing.SPAN_NAMES (or register_span)")


def _probe_conf() -> None:
    global _conf_probed, _enabled
    with _lock:
        if _conf_probed:
            return
        _conf_probed = True
    from blaze_tpu_torch import config
    if config.TRACE_ENABLE.get():
        _enabled = True


def enabled() -> bool:
    if not _conf_probed:
        _probe_conf()
    return _enabled


def _ctx_stack() -> List[Dict[str, Any]]:
    stack = getattr(_tls, "ctx", None)
    if stack is None:
        stack = _tls.ctx = []
    return stack


def _span_stack() -> List[int]:
    stack = getattr(_tls, "span_stack", None)
    if stack is None:
        stack = _tls.span_stack = []
    return stack


def current_context() -> Dict[str, Any]:
    """Innermost query/stage/partition context on this thread."""
    out: Dict[str, Any] = {}
    for frame in _ctx_stack():
        out.update(frame)
    return out


@contextmanager
def execution_context(**fields):
    """Push query/stage/partition (any subset) for spans emitted on this
    thread; nests, inner frames override outer keys."""
    stack = _ctx_stack()
    stack.append({k: v for k, v in fields.items() if v is not None})
    try:
        yield
    finally:
        stack.pop()


def _record(name: str, t0: int, t1: int, sid: int, parent,
            attrs: dict) -> dict:
    r = {"name": name, "t0_ns": t0, "t1_ns": t1, "dur_ns": t1 - t0,
         "sid": sid, "thread": threading.current_thread().name}
    if parent is not None:
        r["parent"] = parent
    ctx = current_context()
    if ctx:
        r["ctx"] = ctx
    if attrs:
        r["attrs"] = attrs
    return r


@contextmanager
def span(name: str, **attrs):
    """One span covering the `with` body; a no-op when disabled."""
    if not _enabled:
        if _conf_probed or not enabled():
            yield
            return
    _check_name(name)
    sid = next(_ids)
    stack = _span_stack()
    parent = stack[-1] if stack else None
    stack.append(sid)
    t0 = time.perf_counter_ns()
    try:
        yield
    finally:
        t1 = time.perf_counter_ns()
        stack.pop()
        _emit(_record(name, t0, t1, sid, parent, attrs))


def emit_span(name: str, dur_ns: int, **attrs) -> None:
    """A span whose duration was measured elsewhere (the operator meter
    sums its time across many next() calls)."""
    if not _enabled:
        if _conf_probed or not enabled():
            return
    _check_name(name)
    t1 = time.perf_counter_ns()
    stack = _span_stack()
    _emit(_record(name, t1 - int(dur_ns), t1, next(_ids),
                  stack[-1] if stack else None, attrs))


def instant(name: str, **attrs) -> None:
    """A zero-duration event (a kernel build, a graph capture)."""
    if not _enabled:
        if _conf_probed or not enabled():
            return
    _check_name(name)
    t = time.perf_counter_ns()
    stack = _span_stack()
    _emit(_record(name, t, t, next(_ids), stack[-1] if stack else None,
                  attrs))


def _emit(record: dict) -> None:
    with _lock:
        _spans.append(record)
        del _spans[:-_MAX_SPANS]
        if _sink is not None:
            _sink.write(json.dumps(record, default=str) + "\n")
            _sink.flush()


def spans_for_query(query_id) -> List[dict]:
    """Every buffered span whose context names this query."""
    with _lock:
        return [r for r in _spans
                if r.get("ctx", {}).get("query") == query_id]


def start_tracing(path: Optional[str] = None) -> None:
    """Enable span collection; `path` also streams JSONL there."""
    global _enabled, _sink, _conf_probed
    with _lock:
        _spans.clear()
        if _sink is not None:
            _sink.close()
            _sink = None
        if path:
            _sink = open(path, "w")
        _conf_probed = True
    _enabled = True


def stop_tracing() -> List[dict]:
    """Disable collection; returns (and keeps) the buffered spans."""
    global _enabled, _sink
    _enabled = False
    with _lock:
        if _sink is not None:
            _sink.close()
            _sink = None
        return list(_spans)


def reset_conf_probe() -> None:
    """Forget the lazy auron.tpu.trace.enable probe (tests)."""
    global _conf_probed, _enabled
    with _lock:
        _conf_probed = False
        _enabled = False


def spans() -> List[dict]:
    with _lock:
        return list(_spans)
