"""Per-task execution context (copy of the task part of
blaze_tpu/bridge/context.py; the query service and the flight recorder
belong to later slices).  `TaskContext.query` is the serving query that
governs the task, read by `active_query()`; it stays None until the
query service is ported (ROADMAP item 16), and the memory manager's
per-query quotas and cross-query arbitration read it.
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
    # the governing serving query (an object with `query_id`, `mem_quota`
    # and `degrade()`), or None
    query: object = None

    def check_running(self):
        if not self.is_running():
            raise TaskKilledError(
                f"task stage={self.stage_id} partition={self.partition_id} "
                f"killed")


class TaskKilledError(RuntimeError):
    pass


_local = threading.local()


def current_task() -> TaskContext:
    ctx = getattr(_local, "ctx", None)
    if ctx is None:
        ctx = TaskContext()
        _local.ctx = ctx
    return ctx


def active_query():
    """The query governing the current execution, or None: the current
    TaskContext's `query`."""
    ctx = getattr(_local, "ctx", None)
    return None if ctx is None else ctx.query


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
