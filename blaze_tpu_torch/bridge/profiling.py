"""Profiling and observability service (port of
blaze_tpu/bridge/profiling.py).

A stdlib HTTP endpoint on localhost:
  /status         engine status: the memory manager's dump and the
                  card's `torch.cuda.memory_stats`
  /metrics        the last collected metric trees (JSON)
  /metrics.prom   Prometheus text exposition: the compile report (nvcc
                  builds, graph captures), every counter family of
                  bridge/device_stats.py (transfers, pipeline, faults,
                  shuffle, stage loop, partial agg, kernel lanes, kernel
                  launches, serving), the latency histograms (per tenant,
                  the query service's completed-query walls), the memory
                  manager's totals and per-operator aggregates
  /profile        the recorded query profiles (id and summary)
  /profile/<qid>  one query's explain_analyze profile (JSON)
  /query/<qid>/timeline   Chrome-trace-event JSON (Perfetto-loadable) of
                  the query's spans, with a resource-attribution block
  /query/<qid>/bottleneck the critical-path report of its spans
  /query/<qid>/progress   the live progress of a query
                  (serving/progress.py; under auron.tpu.stats.enable)
  /progress       every live query's progress and the recent finished
  /serving        stats() of every live QueryService (serving/service.py)
  /serving/cancel?qid=<query id>   cancel a query in any live service
  /trace/start?dir=<path>, /trace/stop   a `torch.profiler` trace of the
                  process (where the reference drives the JAX profiler),
                  written as a Chrome trace under `dir`
  /history*       404: the persistent query history and its flight
                  recorder are not ported (ROADMAP Queue 1 item 16)

The profile store is an LRU of `_MAX_PROFILES` entries.
"""

from __future__ import annotations

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

_lock = threading.Lock()
_recent_metrics: List[dict] = []
_MAX_METRICS = 64
_MAX_PROFILES = 64  # the query-profile store's LRU capacity
_profiles: Dict[str, dict] = {}
_profile_order: List[str] = []


def record_metrics(tree: dict) -> None:
    """The stage scheduler pushes each task's finalized metric tree."""
    with _lock:
        _recent_metrics.append(tree)
        del _recent_metrics[:-_MAX_METRICS]


def recent_metrics() -> List[dict]:
    with _lock:
        return list(_recent_metrics)


def record_profile(query_id: str, profile: dict) -> None:
    """explain_analyze pushes finished query profiles here; an LRU of
    _MAX_PROFILES (record and get both refresh)."""
    with _lock:
        if query_id in _profiles:
            _profile_order.remove(query_id)
        _profile_order.append(query_id)
        _profiles[query_id] = profile
        while len(_profile_order) > _MAX_PROFILES:
            _profiles.pop(_profile_order.pop(0), None)


def get_profile(query_id: str) -> Optional[dict]:
    with _lock:
        p = _profiles.get(query_id)
        if p is not None:  # LRU touch
            _profile_order.remove(query_id)
            _profile_order.append(query_id)
        return p


def list_profiles() -> List[dict]:
    with _lock:
        return [{"query_id": q,
                 "wall_ns": _profiles[q].get("wall_ns"),
                 "output_rows": (_profiles[q].get("tree") or {})
                 .get("values", {}).get("output_rows")}
                for q in _profile_order]


def _prom_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


_FAMILY_HELP = {
    "transfers": "host<->device transfer",
    "pipeline": "batch-shaping / IO-pipeline",
    "faults": "fault-tolerance (retries, lineage recovery)",
    "shuffle": "exchange transport",
    "stage_loop": "device stage loop",
    "agg": "adaptive partial aggregation",
    "scatter_lane": "kernel-lane resolution",
    "exprs": "expression program",
    "stats": "statistics feedback plane",
    "encoding": "host-lane eviction",
    "launches": "hand-kernel wrapper launches",
    "serving": "query service admission and outcome",
    "stream": "streaming runtime",
}


def prometheus_text() -> str:
    """Prometheus text exposition (version 0.0.4) of the engine's
    counters; *_total families are counters, the rest gauges."""
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.memory import MemManager
    lines: List[str] = []
    seen: set = set()  # per scrape: HELP/TYPE once per family

    def emit(name, value, help_=None, labels=None):
        if help_ and name not in seen:
            seen.add(name)
            kind = "counter" if name.endswith("_total") else "gauge"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
        lab = ""
        if labels:
            lab = "{" + ",".join(
                f'{k}="{_prom_escape(str(v))}"'
                for k, v in sorted(labels.items())) + "}"
        lines.append(f"{name}{lab} {int(value)}")

    for kname, e in device_stats.compile_report()["kernels"].items():
        lab = {"kernel": kname}
        emit("blaze_compiles_total", e["compiles"],
             "nvcc builds and CUDA graph captures", lab)
        emit("blaze_compile_cache_hits_total", e["cache_hits"],
             "kernel libraries found built", lab)
        emit("blaze_compile_ns_total", e["compile_ns"],
             "nanoseconds spent compiling", lab)
    families = device_stats.counter_families()
    for fam in sorted(families):
        label = _FAMILY_HELP.get(fam, fam)
        for k in sorted(families[fam]):
            if k.endswith("_last"):  # a point-in-time gauge
                emit(f"blaze_{k[:-5]}", families[fam][k], f"{label} gauge")
            else:
                emit(f"blaze_{k}_total", families[fam][k],
                     f"{label} counter")

    def emit_histogram(name, hist, help_, labels=None):
        if name not in seen:
            seen.add(name)
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
        extra = "".join(f',{k}="{_prom_escape(str(v))}"'
                        for k, v in sorted((labels or {}).items()))
        plain = "{" + extra[1:] + "}" if extra else ""
        for le, count in hist["buckets"]:
            lines.append(f'{name}_bucket{{le="{le}"{extra}}} {count}')
        lines.append(f'{name}_bucket{{le="+Inf"{extra}}} {hist["count"]}')
        lines.append(f"{name}_sum{plain} {hist['sum']:.6f}")
        lines.append(f"{name}_count{plain} {hist['count']}")

    hists = device_stats.latency_histograms()
    emit_histogram("blaze_task_duration_seconds",
                   hists["task_duration_seconds"],
                   "successful task-attempt wall time")
    emit_histogram("blaze_wave_wall_seconds", hists["wave_wall_seconds"],
                   "run_tasks wave wall, first task to last result")
    from blaze_tpu_torch.serving.service import tenant_wall_samples
    for tenant, samples in sorted(tenant_wall_samples().items()):
        emit_histogram(
            "blaze_tenant_query_wall_seconds",
            device_stats._histogram([int(s * 1e9) for s in samples]),
            "per-tenant completed-query wall time", {"tenant": tenant})
    mm = MemManager.get()
    emit("blaze_mem_spill_count_total", mm.total_spill_count,
         "memory-manager spills")
    emit("blaze_mem_spilled_bytes_total", mm.total_spilled_bytes,
         "bytes released by spills")
    emit("blaze_mem_peak_used_bytes", mm.peak_used,
         "peak retained bytes across consumers")

    per_op: Dict[str, Dict[str, int]] = {}

    def fold(node):
        op = node.get("name") or "unknown"
        agg = per_op.setdefault(op, {})
        for k, v in node.get("values", {}).items():
            agg[k] = agg.get(k, 0) + int(v)
        for c in node.get("children", ()):
            fold(c)

    with _lock:
        for tree in _recent_metrics:
            fold(tree)
    for op, vals in sorted(per_op.items()):
        for metric in ("output_rows", "output_batches",
                       "elapsed_compute_ns", "spilled_bytes", "io_bytes"):
            if metric in vals:
                emit(f"blaze_operator_{metric}_total", vals[metric],
                     f"per-operator {metric} over recent metric trees",
                     {"operator": op})
    return "\n".join(lines) + "\n"


def query_timeline(query_id: str) -> Optional[dict]:
    """Chrome-trace-event JSON for one query's spans: complete "X" events
    for spans, instant "i" events for markers, the stage-loop chunks and
    compiles on a "device" track, plus a per-query resource-attribution
    block.  None when no span names the query."""
    from blaze_tpu_torch.bridge import tracing
    spans = tracing.spans_for_query(query_id)
    if not spans:
        return None
    pid = 1
    events: List[dict] = []
    tids: Dict[str, int] = {}

    def tid_for(key: str) -> int:
        t = tids.get(key)
        if t is None:
            t = tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": t,
                           "name": "thread_name", "args": {"name": key}})
        return t

    attribution = {"task_seconds": 0.0, "device_dispatches": 0,
                   "spill_bytes": 0, "compile_seconds": 0.0,
                   "shuffle_bytes_by_tier": {"file": 0}, "span_count": 0}
    profile = get_profile(query_id)
    if profile:
        attribution["shuffle_bytes_by_tier"]["file"] = int(
            (profile.get("counters") or {}).get("shuffle_host_bytes", 0))
    for r in spans:
        name = r.get("name", "?")
        attrs = r.get("attrs") or {}
        if name in ("stage_loop_chunk", "kernel_build", "graph_capture"):
            tid = tid_for("device")
        else:
            tid = tid_for(str(r.get("thread", "main")))
        args = dict(r.get("ctx") or {})
        args.update(attrs)
        for k in ("sid", "parent"):
            if k in r:
                args[k] = r[k]
        ev = {"name": name, "pid": pid, "tid": tid,
              "ts": r.get("t0_ns", 0) / 1e3, "args": args}
        if r.get("dur_ns", 0) > 0:
            ev["ph"] = "X"
            ev["dur"] = r["dur_ns"] / 1e3
        else:
            ev["ph"] = "i"
            ev["s"] = "t"
        events.append(ev)
        attribution["span_count"] += 1
        if name == "task_attempt":
            attribution["task_seconds"] += r.get("dur_ns", 0) / 1e9
        elif name == "stage_loop_chunk":
            attribution["device_dispatches"] += 1
        elif name in ("kernel_build", "graph_capture"):
            attribution["compile_seconds"] += int(attrs.get("ns", 0)) / 1e9
        elif name == "mem_spill":
            attribution["spill_bytes"] += int(attrs.get("bytes", 0) or 0)
    events.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": "engine"}})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "query_id": str(query_id), "attribution": attribution}


def engine_status() -> dict:
    """The memory manager's dump and, on a card, its memory statistics."""
    import torch
    from blaze_tpu_torch.memory import MemManager
    status = {"mem_manager": MemManager.get().dump_status(),
              "device_memory": {}}
    if torch.cuda.is_available():
        status["device_memory"] = {
            k: v for k, v in torch.cuda.memory_stats().items()
            if isinstance(v, (int, float))}
    return status


#: every GET route the service answers (the 404 payload lists them)
ROUTES = ("/status", "/metrics", "/metrics.prom", "/profile",
          "/profile/<qid>", "/query/<qid>/timeline",
          "/query/<qid>/bottleneck", "/query/<qid>/progress", "/progress",
          "/serving", "/serving/cancel", "/trace/start", "/trace/stop",
          "/history", "/history/<qid>", "/history/rollup")

_trace = {"owner": None, "dir": None}


class _Handler(BaseHTTPRequestHandler):

    def log_message(self, *args):
        pass

    def _send(self, code: int, body: str,
              ctype: str = "application/json"):
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj, default=str))

    def do_GET(self):
        parsed = urllib.parse.urlsplit(self.path)
        route = parsed.path
        if route == "/status":
            self._json(200, engine_status())
        elif route == "/metrics":
            self._json(200, recent_metrics())
        elif route == "/metrics.prom":
            self._send(200, prometheus_text(),
                       ctype="text/plain; version=0.0.4")
        elif route == "/profile":
            self._json(200, list_profiles())
        elif route.startswith("/profile/"):
            qid = urllib.parse.unquote(route[len("/profile/"):])
            profile = get_profile(qid)
            if profile is None:
                self._json(404, {"error": f"no profile for {qid!r}",
                                 "known": [p["query_id"]
                                           for p in list_profiles()]})
            else:
                self._json(200, profile)
        elif route.startswith("/query/") and route.endswith("/timeline"):
            qid = urllib.parse.unquote(
                route[len("/query/"):-len("/timeline")])
            timeline = query_timeline(qid)
            if timeline is None:
                self._json(404, {"error": f"no spans recorded for query "
                                          f"{qid!r} (is tracing enabled?)"})
            else:
                self._json(200, timeline)
        elif route.startswith("/query/") and route.endswith("/bottleneck"):
            from blaze_tpu_torch.bridge import critical_path, tracing
            qid = urllib.parse.unquote(
                route[len("/query/"):-len("/bottleneck")])
            spans = tracing.spans_for_query(qid)
            report = critical_path.bottleneck_report(spans) if spans \
                else None
            if report is None:
                self._json(404, {"error": f"no bottleneck report for query "
                                          f"{qid!r} (is tracing enabled?)"})
            else:
                self._send(200, json.dumps(report, sort_keys=True))
        elif route.startswith("/query/") and route.endswith("/progress"):
            from blaze_tpu_torch.serving import progress as progress_mod
            qid = urllib.parse.unquote(
                route[len("/query/"):-len("/progress")])
            p = progress_mod.progress(qid)
            if p is None:
                self._json(404, {"error": f"no progress for query {qid!r} "
                                          f"(is auron.tpu.stats.enable on?)",
                                 "live": progress_mod.live()})
            else:
                self._send(200, json.dumps(p, sort_keys=True))
        elif route == "/progress":
            from blaze_tpu_torch.serving import progress as progress_mod
            self._send(200, json.dumps(progress_mod.snapshot_all(),
                                       sort_keys=True))
        elif route == "/serving":
            from blaze_tpu_torch.serving import serving_stats
            self._json(200, {"services": serving_stats()})
        elif route == "/serving/cancel":
            from blaze_tpu_torch.serving import cancel_query
            params = urllib.parse.parse_qs(parsed.query,
                                           keep_blank_values=True)
            qid = params.get("qid", [""])[0]
            if not qid:
                self._json(400, {"error": "expected ?qid=<query id>"})
                return
            self._json(200, {"query_id": qid,
                             "cancelled": cancel_query(qid)})
        elif route == "/trace/start":
            self._trace_start(parsed)
        elif route == "/trace/stop":
            self._trace_stop()
        elif route == "/history" or route.startswith("/history/"):
            self._json(404, {"error": "the query history is not ported "
                                      "(ROADMAP Queue 1 item 16)"})
        else:
            self._json(404, {"error": "unknown path", "paths": list(ROUTES)})

    def _trace_start(self, parsed) -> None:
        params = urllib.parse.parse_qs(parsed.query, keep_blank_values=True)
        bad_keys = set(params) - {"dir"}
        if bad_keys:
            self._json(400, {"error": f"unknown query params "
                                      f"{sorted(bad_keys)}; expected "
                                      f"?dir=<path>"})
            return
        out = params.get("dir", [""])[0]
        if not out or "\x00" in out or not out.startswith("/"):
            self._json(400, {"error": "trace dir must be an absolute path",
                             "dir": out})
            return
        with _lock:
            if _trace["owner"] is not None:
                self._json(409, {"error": "a trace is already running",
                                 "dir": _trace["dir"]})
                return
            owner = _TraceOwner(out)
            _trace.update(owner=owner, dir=out)
        owner.started.wait()
        self._json(200, {"tracing": True, "dir": out})

    def _trace_stop(self) -> None:
        with _lock:
            owner = _trace["owner"]
            _trace.update(owner=None, dir=None)
        if owner is None:
            self._json(409, {"error": "no trace is running"})
            return
        owner.stop.set()
        owner.join()
        if owner.error is not None:
            self._json(500, {"error": str(owner.error)})
        else:
            self._json(200, {"tracing": False, "trace": owner.path})


class _TraceOwner(threading.Thread):
    """The thread that starts, stops and writes one torch.profiler trace:
    the profiler must be stopped on the thread that started it, and each
    request of the service runs on a thread of its own.  CUDA activity
    is recorded process-wide; host ops on this thread only."""

    def __init__(self, out: str):
        super().__init__(name="blaze-trace", daemon=True)
        import os
        self.path = os.path.join(out, "trace.json")
        self.started = threading.Event()
        self.stop = threading.Event()
        self.error: Optional[BaseException] = None
        self.start()

    def run(self) -> None:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile
        try:
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
        except BaseException as e:
            self.error = e
            self.started.set()
            return
        self.started.set()
        self.stop.wait()
        try:
            prof.stop()
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            prof.export_chrome_trace(self.path)
        except BaseException as e:
            self.error = e


_server: Optional[ThreadingHTTPServer] = None
_thread: Optional[threading.Thread] = None


def start_http_service(port: int = 0) -> int:
    """Start the service on 127.0.0.1; returns the bound port (0 picks a
    free one)."""
    global _server, _thread
    if _server is not None:
        return _server.server_address[1]
    _server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    _thread = threading.Thread(target=_server.serve_forever, daemon=True,
                               name="blaze-http-service")
    _thread.start()
    return _server.server_address[1]


def stop_http_service() -> None:
    """Stop the service and join its thread."""
    global _server, _thread
    if _server is not None:
        _server.shutdown()
        _server.server_close()
        _thread.join(timeout=10)
        _server = _thread = None
