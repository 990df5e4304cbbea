"""Per-query context: deadline, cancellation token, memory quota,
degradation (the port's copy of blaze_tpu/serving/context.py).

This module is stdlib-only, so the bridge, plan and memory layers can use
it without import cycles: the cancellation token has to be visible from
``bridge/context.py`` (a leaf module) all the way up to
``plan/stages.py``.

Cancellation is *cooperative*: ``QueryContext.check()`` is called at
every task boundary (``bridge/tasks.py``), every metered batch-iterator
step (``ops/base.py``), and every shuffle block read/write.  Cancelling
a query therefore tears it down within one batch, at which point the
normal ``finally`` paths release MemConsumer reservations and the
scheduler's cleanup deletes its shuffle files.

Degradation is a one-way ladder driven by the memory manager when the
query exceeds its quota (see ``memory/manager.py``):

  rung 1  agg-passthrough   force partial-agg pass-through
  rung 2  shrink-capacity   halve the coalesce batch target per rung
  rung 3  kill              cancel the query with QueryMemoryExceeded
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

_query_ids = itertools.count(1)


class QueryCancelled(RuntimeError):
    """The query's cancellation token fired (explicit cancel by default).

    Subclasses refine the reason; ``classify_exception`` in ``faults.py``
    treats RuntimeError as fatal, so a cancelled query is never retried.
    """

    def __init__(self, query_id: str, reason: str = "cancelled"):
        super().__init__(f"query {query_id} {reason}")
        self.query_id = query_id
        self.reason = reason


class DeadlineExceeded(QueryCancelled):
    """The query ran past its deadline."""

    def __init__(self, query_id: str, deadline_ms: float):
        super().__init__(query_id, f"exceeded deadline of {deadline_ms:.0f}ms")
        self.deadline_ms = deadline_ms


class QueryMemoryExceeded(QueryCancelled):
    """The query exhausted its memory quota and the degradation ladder."""

    def __init__(self, query_id: str, quota: int):
        super().__init__(query_id, f"exceeded memory quota of {quota} bytes")
        self.quota = quota


#: degradation rungs, in order; ``degrade()`` returns the rung it entered.
#: Rung 1 also declines the device-resident stage loop (runtime/loop.py
#: checks ``force_agg_passthrough``), and rung 2's capacity shrink halves
#: the loop's chunk width along with the coalesce batch target.
DEGRADE_LADDER = ("agg-passthrough", "shrink-capacity", "kill")


def is_cancellation(exc: BaseException) -> bool:
    """True when ``exc`` means the query is being torn down rather than
    failing: cancellation/deadline/kill must never be swallowed into an
    optimization fallback (the stage loop, an adaptive rewrite)."""
    from blaze_tpu_torch.bridge.context import TaskKilledError
    return isinstance(exc, (QueryCancelled, TaskKilledError))


class QueryContext:
    """Identity + limits for one query running inside the service.

    Thread-safe: the token is a ``threading.Event`` and the first
    ``cancel()`` wins; every later call is a no-op.  ``check()`` is the
    single cooperative cancellation point — it raises the exception class
    matching the recorded cancel kind.
    """

    def __init__(self, query_id: Optional[str] = None, *,
                 tenant: str = "default",
                 deadline_ms: float = 0.0,
                 mem_quota: int = 0):
        self.query_id = query_id or f"q{next(_query_ids)}"
        self.tenant = tenant
        self.deadline_ms = float(deadline_ms)
        #: absolute monotonic deadline, or None
        self.deadline: Optional[float] = (
            time.monotonic() + self.deadline_ms / 1e3
            if self.deadline_ms > 0 else None)
        self.mem_quota = int(mem_quota)
        self._token = threading.Event()
        self._lock = threading.Lock()
        self._cancel_kind: Optional[str] = None  # "cancel"|"deadline"|"mem"
        self._cancel_reason = ""
        self._degrade_level = 0
        self.started_at = time.monotonic()

    # -- cancellation ---------------------------------------------------
    @property
    def cancelled(self) -> bool:
        return self._token.is_set()

    def cancel(self, reason: str = "cancelled", kind: str = "cancel") -> bool:
        """Fire the token.  Returns True if this call won the race."""
        with self._lock:
            if self._token.is_set():
                return False
            self._cancel_kind = kind
            self._cancel_reason = reason
            self._token.set()
            return True

    def wait_cancelled(self, timeout: float) -> bool:
        """Block up to ``timeout`` seconds; True if the token fired."""
        return self._token.wait(timeout)

    def _cancel_exception(self) -> QueryCancelled:
        if self._cancel_kind == "deadline":
            return DeadlineExceeded(self.query_id, self.deadline_ms)
        if self._cancel_kind == "mem":
            return QueryMemoryExceeded(self.query_id, self.mem_quota)
        return QueryCancelled(self.query_id, self._cancel_reason or "cancelled")

    def remaining_ms(self) -> Optional[float]:
        if self.deadline is None:
            return None
        return (self.deadline - time.monotonic()) * 1e3

    def check(self) -> None:
        """Cooperative cancellation point; raises if cancelled or overdue."""
        if not self._token.is_set() and self.deadline is not None \
                and time.monotonic() > self.deadline:
            self.cancel(kind="deadline")
        if self._token.is_set():
            raise self._cancel_exception()

    # -- degradation ladder --------------------------------------------
    @property
    def degrade_level(self) -> int:
        return self._degrade_level

    @property
    def force_agg_passthrough(self) -> bool:
        return self._degrade_level >= 1

    @property
    def capacity_shrink(self) -> int:
        """How many rungs of batch-capacity halving to apply (>= 0)."""
        return max(0, self._degrade_level - 1)

    def degrade(self) -> str:
        """Advance one rung; rung 3+ cancels the query.  Returns the rung."""
        with self._lock:
            self._degrade_level += 1
            level = self._degrade_level
        if level >= len(DEGRADE_LADDER):
            self.cancel(kind="mem")
            return DEGRADE_LADDER[-1]
        return DEGRADE_LADDER[level - 1]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "cancelled" if self.cancelled else "live"
        return (f"QueryContext({self.query_id!r}, tenant={self.tenant!r}, "
                f"{state}, degrade={self._degrade_level})")
