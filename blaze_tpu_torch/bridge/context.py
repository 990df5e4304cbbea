"""Per-task and per-query execution context (copy of
blaze_tpu/bridge/context.py; the flight recorder and the host engine's
liveness probe belong to later slices).

`query_scope(ctx)` binds a serving query (serving/context.py
`QueryContext`) to the calling thread; the query service runs each query
on a pool slot inside one, and `NativeExecutionRuntime` hands
`current_query()` to each task's `TaskContext.query`, which rides the
context into the prefetch workers that re-enter it via `task_scope`.
`TaskContext.check_running`, called at every metered batch step, every
shuffle block read and write and every stage-loop chunk, then raises the
query's cancellation, deadline or quota kill there.  `active_query()` is
what the memory manager's quotas and arbitration, the degradation hooks
(ops/base.py `effective_batch_size`, runtime/loop.py, ops/agg/exec.py)
and the scheduler read.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable


@dataclass
class TaskContext:
    stage_id: int = 0
    partition_id: int = 0
    num_partitions: int = 1
    attempt_num: int = 0
    task_attempt_id: int = 0
    # cooperative-cancel probe, polled at batch boundaries
    is_running: Callable[[], bool] = lambda: True
    # chunks the device stage loop has folded for this task
    loop_chunks: int = 0
    # the governing serving query (serving/context.py QueryContext), or
    # None; carried here so prefetch workers re-entering via task_scope()
    # inherit its cancellation token
    query: object = None

    def check_running(self):
        if not self.is_running():
            raise TaskKilledError(
                f"task stage={self.stage_id} partition={self.partition_id} "
                f"killed")
        q = self.query if self.query is not None else current_query()
        if q is not None:
            q.check()


class TaskKilledError(RuntimeError):
    pass


_local = threading.local()


def current_task() -> TaskContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        ctx = TaskContext()
        _local.ctx = ctx
    return ctx


_query_local = threading.local()


def current_query():
    """The serving QueryContext bound to this thread, or None."""
    return getattr(_query_local, "query", None)


def active_query():
    """The query governing the current execution, or None: the current
    TaskContext's `query` (which survives the hand-off to prefetch
    workers), else the thread's `query_scope` binding."""
    ctx = getattr(_local, "ctx", None)
    if ctx is not None and ctx.query is not None:
        return ctx.query
    return current_query()


class query_scope:
    """`with query_scope(qctx):` binds a query to this thread; None binds
    nothing, so call sites can thread an optional query.  Restores the
    previous binding on exit."""

    def __init__(self, query):
        self._query = query
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_query_local, "query", None)
        _query_local.query = self._query
        return self._query

    def __exit__(self, *exc):
        _query_local.query = self._prev
        return False


def note_query_start(query_id) -> None:
    """Called by the query service as a query starts running.  The
    reference snapshots its counters here for the flight recorder's
    post-mortem deltas; the recorder is not ported (ROADMAP Queue 1 item
    16), and the counters are process-wide (a delta would hold every
    query in flight), so nothing is kept yet."""


def set_current_task(ctx) -> None:
    _local.ctx = ctx


class task_scope:
    """`with task_scope(TaskContext(...)):` — restores the previous context."""

    def __init__(self, ctx: TaskContext):
        self._ctx = ctx
        self._prev = None

    def __enter__(self) -> TaskContext:
        self._prev = getattr(_local, "ctx", None)
        _local.ctx = self._ctx
        return self._ctx

    def __exit__(self, *exc):
        _local.ctx = self._prev
        return False
