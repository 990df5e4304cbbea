"""Admission-controlled concurrent query service over the port's
DagScheduler (port of blaze_tpu/serving/service.py).

N queries in flight behind a BOUNDED admission queue, per-tenant quotas
and load shedding: the service degrades by rejecting (a typed
`QueryRejected`) under overload, never by wedging.

Admission, under one lock, O(1) a decision:

  1. the `admit` fault site: a chaos rule sheds here (kind="injected");
  2. queue depth against auron.tpu.serving.maxQueue (kind="queue-full");
  3. the tenant's in-flight count against .tenant.maxInflight
     (kind="tenant-quota");
  4. the plan's file-scan bytes against .admitMemBytes (kind="memory"; an
     input that cannot be stat'ed always admits: shedding needs
     evidence);
  and a shut-down service rejects everything (kind="shutdown").

Execution: each admitted query runs on a slot of a pool of
`maxConcurrent` threads, inside `query_scope(ctx)`, so the whole engine
below it (the task waves, the batch probes, the shuffle readers and
writers, the memory manager, the stage loop) sees its QueryContext.  On
the card each running query has a private CUDA stream (device.py
`lease_stream`, made by csrc/streams.cu, not drawn from PyTorch's shared
pool), current for the whole query: the scan's stager, the prefetch
workers and every kernel of the query issue on it, no other query or
graph capture shares it, and no query's synchronisation waits for
another's work.  A cancel, a deadline and a quota kill are observed within one
batch; teardown releases the MemConsumer reservations and deletes the
shuffle files through the scheduler's cleanup, safe from any thread.
Each handle keeps its run's `leak_report` and its scratch directory.

Not ported, each raising NotImplementedError (ROADMAP Queue 1 item 16):
the result cache and single-flight (`auron.tpu.cache.enable`,
`auron.tpu.serving.singleFlight`), the worker-pool route
(`auron.tpu.serving.useWorkerPool`), the history emitters
(`auron.tpu.history.enable`) and the flight recorder's dumps
(`auron.tpu.flightRecorder.enable`): setting one of these keys makes the
service's constructor raise (config.UNPORTED_SCHEDULER_KEYS).
"""

from __future__ import annotations

import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

from blaze_tpu_torch import config, faults
from blaze_tpu_torch.bridge import context as bridge_context
from blaze_tpu_torch.bridge import device_stats, tracing
from blaze_tpu_torch.bridge.context import query_scope
from blaze_tpu_torch.serving.context import QueryCancelled, QueryContext

#: every live service, for the profiling HTTP surface (/serving routes)
_services: "weakref.WeakSet[QueryService]" = weakref.WeakSet()


class QueryRejected(RuntimeError):
    """Load-shed at admission; `kind` names which limit fired:
    queue-full | tenant-quota | memory | injected | shutdown."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"query rejected ({kind})"
                         + (f": {detail}" if detail else ""))
        self.kind = kind


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


class QueryHandle:
    """Caller-side handle: status, result barrier, cancel."""

    def __init__(self, ctx: QueryContext, service: "QueryService"):
        self.ctx = ctx
        self.query_id = ctx.query_id
        self.tenant = ctx.tenant
        self._service = service
        self._done = threading.Event()
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self.status = "queued"  # queued|running|done|failed|cancelled
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        #: DagScheduler.leak_report() of the run, for post-mortem checks
        self.leak_report: Optional[Dict[str, List[str]]] = None
        #: the run's scratch directory (removed by its cleanup)
        self.work_dir: Optional[str] = None

    @property
    def wall_s(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def cancel(self, reason: str = "cancelled by caller") -> bool:
        return self._service.cancel(self.query_id, reason=reason)

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"query {self.query_id} still {self.status} after "
                f"{timeout:g}s")
        if self._error is not None:
            raise self._error
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.query_id} not finished")
        return self._error


def _default_executor(plan: Dict[str, Any], ctx: QueryContext,
                      handle: Optional[QueryHandle] = None) -> Any:
    """Run one plan-IR dict through a fresh DagScheduler bound to the
    query; cleanup is the scheduler's own (safe from any thread, reached
    on every exit path), and the leak report lands on the handle."""
    from blaze_tpu_torch.plan.stages import DagScheduler
    sched = DagScheduler(query_ctx=ctx)
    if handle is not None:
        handle.work_dir = sched.work_dir
    try:
        return sched.run_collect(plan)
    finally:
        sched.cleanup()
        if handle is not None:
            handle.leak_report = sched.leak_report()


class QueryService:
    """Bounded concurrent query executor with admission control.

    `executor(plan, ctx, handle)` is injectable, so tests can drive
    admission and cancellation against synthetic work; the default runs
    the staged DagScheduler, on the configured device (`auron.torch.device`,
    CUDA unless the caller asks for the CPU): constructing the default
    service without a visible card raises.  Where a card is visible every
    executor, injected or not, runs on its slot's leased stream when the
    configured device is CUDA."""

    def __init__(self, max_concurrent: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 tenant_max_inflight: Optional[int] = None,
                 admit_mem_bytes: Optional[int] = None,
                 executor: Optional[Callable] = None):
        from blaze_tpu_torch.plan.stages import _check_ported_branches
        _check_ported_branches()
        self.max_concurrent = max(1, max_concurrent if max_concurrent
                                  is not None
                                  else config.SERVING_MAX_CONCURRENT.get())
        self.max_queue = max(0, max_queue if max_queue is not None
                             else config.SERVING_MAX_QUEUE.get())
        self.tenant_max_inflight = max(
            1, tenant_max_inflight if tenant_max_inflight is not None
            else config.SERVING_TENANT_MAX_INFLIGHT.get())
        self.admit_mem_bytes = (admit_mem_bytes if admit_mem_bytes
                                is not None
                                else config.SERVING_ADMIT_MEM_BYTES.get())
        # the slot's stream rule holds for every executor, the injected
        # ones too (a streaming query's epochs run there); only an
        # injected executor on a host without a card runs bare
        import torch

        from blaze_tpu_torch.device import resolve
        self._device = None
        if executor is None or torch.cuda.is_available():
            self._device = resolve()
        self._executor = executor or _default_executor
        self._pool = ThreadPoolExecutor(
            max_workers=self.max_concurrent,
            thread_name_prefix="blaze-serve")
        self._lock = threading.Lock()
        self._handles: Dict[str, QueryHandle] = {}
        self._queued = 0
        self._running = 0
        self._tenant_inflight: Dict[str, int] = {}
        self._tenant_wall_s: Dict[str, List[float]] = {}
        self._closed = False
        #: the reference's keys; `coalesced` and `cache_hits` stay 0 (the
        #: work-sharing cache and single-flight are not ported)
        self.counters = {"admitted": 0, "completed": 0, "failed": 0,
                         "cancelled": 0, "deadline": 0,
                         "shed_queue_full": 0, "shed_tenant_quota": 0,
                         "shed_memory": 0, "shed_injected": 0,
                         "coalesced": 0, "cache_hits": 0}
        _services.add(self)

    def _count(self, key: str) -> None:
        """One more of `key`, here and in bridge/device_stats.py's
        process-wide `serving` family (under the service lock)."""
        self.counters[key] += 1
        device_stats.note_serving(**{key: 1})

    # -- admission ------------------------------------------------------
    def submit(self, plan: Dict[str, Any], *, tenant: str = "default",
               deadline_ms: Optional[float] = None,
               mem_quota: Optional[int] = None,
               query_id: Optional[str] = None) -> QueryHandle:
        if deadline_ms is None:
            deadline_ms = config.QUERY_DEADLINE_MS.get()
        if mem_quota is None:
            mem_quota = config.QUERY_MEM_QUOTA.get()
        with self._lock:
            if self._closed:
                raise QueryRejected("shutdown", "service is shut down")
            try:
                faults.maybe_fail("admit", tenant=tenant)
            except faults.InjectedFault as e:
                self._count("shed_injected")
                raise QueryRejected("injected", str(e)) from e
            if self._queued >= self.max_queue:
                self._count("shed_queue_full")
                raise QueryRejected(
                    "queue-full",
                    f"{self._queued} queued >= maxQueue={self.max_queue}")
            inflight = self._tenant_inflight.get(tenant, 0)
            if inflight >= self.tenant_max_inflight:
                self._count("shed_tenant_quota")
                raise QueryRejected(
                    "tenant-quota",
                    f"tenant {tenant!r} has {inflight} in flight >= "
                    f"maxInflight={self.tenant_max_inflight}")
            if self.admit_mem_bytes > 0:
                from blaze_tpu_torch.plan.stages import DagScheduler
                est = DagScheduler._scan_input_bytes(plan)
                # the sentinel (an input that cannot be stat'ed) always
                # admits: shedding needs evidence, not its absence
                if est < (1 << 62) and est > self.admit_mem_bytes:
                    self._count("shed_memory")
                    raise QueryRejected(
                        "memory",
                        f"estimated {est}B > admitMemBytes="
                        f"{self.admit_mem_bytes}")
            ctx = QueryContext(query_id, tenant=tenant,
                               deadline_ms=deadline_ms or 0,
                               mem_quota=mem_quota or 0)
            handle = QueryHandle(ctx, self)
            self._handles[ctx.query_id] = handle
            self._queued += 1
            self._tenant_inflight[tenant] = inflight + 1
            self._count("admitted")
        self._pool.submit(self._run, handle, plan)
        return handle

    # -- execution ------------------------------------------------------
    def _run(self, handle: QueryHandle, plan: Dict[str, Any]) -> None:
        ctx = handle.ctx
        queued_s = time.monotonic() - handle.submitted_at
        with self._lock:
            self._queued -= 1
            shed = ctx._cancel_exception() if ctx.cancelled else None
            if shed is None:
                self._running += 1
                handle.status = "running"
                handle.started_at = time.monotonic()
            else:
                # cancelled while queued (a cancel, or a deadline passed
                # in the queue): shed at pop, no work done
                self._finish_locked(handle, error=shed)
        if shed is not None:
            return
        bridge_context.note_query_start(ctx.query_id)
        error: Optional[BaseException] = None
        result: Any = None
        try:
            with query_scope(ctx), \
                    tracing.execution_context(query=ctx.query_id):
                # the queue wait is part of the query's latency: a span
                # on its own trace, from submit to the slot's pop
                tracing.emit_span("admission_wait", int(queued_s * 1e9),
                                  query=ctx.query_id, tenant=ctx.tenant)
                with tracing.span("query", query=ctx.query_id,
                                  tenant=ctx.tenant):
                    ctx.check()  # the deadline may have passed queued
                    if self._device is None or self._device.type != "cuda":
                        result = self._executor(plan, ctx, handle)
                    else:
                        result = self._on_own_stream(plan, ctx, handle)
        except BaseException as e:  # noqa: BLE001 - outcome taxonomy below
            error = e
        with self._lock:
            self._running -= 1
            self._finish_locked(handle, error=error, result=result)

    def _on_own_stream(self, plan, ctx, handle):
        """Run the query on a private CUDA stream leased for it: the
        current stream of its whole run, so the scan's stager, the
        prefetch workers and every kernel issue there, and no other
        query, capture or stager shares it (device.py `lease_stream`)."""
        import torch

        from blaze_tpu_torch.device import lease_stream, release_stream
        stream = lease_stream(self._device)
        try:
            with torch.cuda.stream(stream):
                return self._executor(plan, ctx, handle)
        finally:
            release_stream(stream)

    def _finish_locked(self, handle: QueryHandle,
                       error: Optional[BaseException] = None,
                       result: Any = None) -> None:
        ctx = handle.ctx
        tenant = handle.tenant
        self._tenant_inflight[tenant] = max(
            0, self._tenant_inflight.get(tenant, 1) - 1)
        handle.finished_at = time.monotonic()
        if error is None:
            handle.status = "done"
            handle._result = result
            self._count("completed")
            wall = self._tenant_wall_s.setdefault(tenant, [])
            wall.append(handle.wall_s or 0.0)
            del wall[:-1024]  # bounded history
        elif isinstance(error, QueryCancelled):
            handle.status = "cancelled"
            handle._error = error
            if ctx._cancel_kind == "deadline":
                self._count("deadline")
            else:
                self._count("cancelled")
        else:
            handle.status = "failed"
            handle._error = error
            self._count("failed")
        handle._done.set()

    # -- cancellation ---------------------------------------------------
    def cancel(self, query_id: str,
               reason: str = "cancelled by caller") -> bool:
        """Fire the query's token; True if the query was live to cancel.
        The `cancel-race` fault site widens the cancel-vs-completion
        window, so chaos runs exercise both orders."""
        handle = self._handles.get(query_id)
        if handle is None:
            return False
        if faults.fires("cancel-race", query=query_id):
            time.sleep(0.02)
        if handle._done.is_set():
            return False
        return handle.ctx.cancel(reason=reason)

    def handle(self, query_id: str) -> Optional[QueryHandle]:
        return self._handles.get(query_id)

    # -- observability --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            tenants = {}
            for tenant, walls in sorted(self._tenant_wall_s.items()):
                vals = sorted(walls)
                tenants[tenant] = {
                    "completed": len(vals),
                    "p50_ms": round(_percentile(vals, 0.50) * 1e3, 3),
                    "p99_ms": round(_percentile(vals, 0.99) * 1e3, 3)}
            return {"queue_depth": self._queued,
                    "running": self._running,
                    "max_concurrent": self.max_concurrent,
                    "max_queue": self.max_queue,
                    "counters": dict(self.counters),
                    "tenants": tenants}

    # -- lifecycle ------------------------------------------------------
    def shutdown(self, wait: bool = True,
                 cancel_running: bool = False) -> None:
        with self._lock:
            self._closed = True
            handles = list(self._handles.values())
        if cancel_running:
            for h in handles:
                if not h._done.is_set():
                    h.ctx.cancel(reason="service shutdown")
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "QueryService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True, cancel_running=True)


# -- the process-wide surface of the profiling HTTP endpoints -------------

def serving_stats() -> List[Dict[str, Any]]:
    """stats() of every live QueryService in the process."""
    return [svc.stats() for svc in list(_services)]


def cancel_query(query_id: str) -> bool:
    """Cancel by id across every live service (the /serving/cancel
    endpoint); True if some service had the query live."""
    return any(svc.cancel(query_id, reason="cancelled via HTTP")
               for svc in list(_services))


def tenant_wall_samples() -> Dict[str, List[float]]:
    """tenant -> completed-query wall seconds, merged across every live
    service (the per-tenant latency histogram of /metrics.prom)."""
    merged: Dict[str, List[float]] = {}
    for svc in list(_services):
        with svc._lock:
            for tenant, walls in svc._tenant_wall_s.items():
                merged.setdefault(tenant, []).extend(walls)
    return merged
