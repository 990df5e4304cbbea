"""The memory manager: one budget, fair consumer caps, spill on pressure
(port of blaze_tpu/memory/manager.py).

Operators whose state grows with their input (the sort's staged rows, the
generic aggregation's buffered partials and dictionaries, the window
buffer, the shuffle writer's staged rows) register a `MemConsumer` per
task and declare the bytes they hold with `update_mem_used`.  The manager
then, synchronously on the declaring thread:

  * honours a pending cross-query release request of the consumer first;
  * enforces the consumer's query quota (`query.mem_quota`): the query's
    own consumers shed, largest first, down to 0.8 of the quota, and its
    degradation ladder (`query.degrade()`) climbs one rung;
  * returns when the pool is within its budget and the consumer holds at
    most twice its fair cap (`total // N` over N registered consumers);
  * otherwise sheds consumers, heaviest query first and within a query
    the biggest consumer first, until the pool holds at most
    `MEM_SPILL_FACTOR` (0.8) of the budget: a consumer's cheaper
    `try_release_pressure` is taken at its word (the partial
    aggregation's skip-on-spill), else it `spill()`s down a tier
    (memory/spill.py); a consumer of another query is only asked to
    release at its own next update, and the walk stops there.

The budget (`default_budget_bytes`) is read at the first `MemManager.get()`
and never at import: on CUDA, the card's memory
(`torch.cuda.mem_get_info`) times `auron.memory.fraction`, the analog of
the JAX device's `bytes_limit`; on the CPU, as in the JAX package,
min(physical memory x `auron.process.vmrss.memoryFraction`, 4 GiB) times
the fraction.

`TaskContext.query` (bridge/context.py `active_query`) is None until the
query service is ported (ROADMAP item 16), so quotas and cross-query
arbitration are reached only by consumers given a query object.  Every
spill emits a `mem_spill` trace instant (its consumer, bytes and cause)
and a quota breach a `quota_breach` one (bridge/tracing.py).  Not
carried over: the `mem-pressure` and `quota-breach` fault sites (item
16).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from blaze_tpu_torch import config
from blaze_tpu_torch.memory.spill import SpillMetrics

MEM_SPILL_FACTOR = 0.8  # the pool must shrink below budget x factor


def _trace_spill(consumer, released: int, cause: str) -> None:
    """The mem_spill trace instant: which consumer shed how much, why,
    and for which query."""
    from blaze_tpu_torch.bridge import tracing
    tracing.instant("mem_spill", consumer=consumer.name, bytes=released,
                    cause=cause,
                    query=getattr(getattr(consumer, "query", None),
                                  "query_id", None))


class MemConsumer:
    """Spillable operator state: subclasses implement `spill()` (move the
    retained state down a tier, return the bytes released) and may offer
    a cheaper `try_release_pressure()`."""

    name: str = "consumer"

    def __init__(self, name: str):
        self.name = name
        self._mem_used = 0
        #: set by cross-query arbitration; honoured on the consumer's own
        #: thread at its next update_mem_used
        self._release_requested = False
        self._manager: Optional[MemManager] = None
        #: the governing query (set_spillable reads active_query()), or
        #: None for a consumer of no query
        self.query = None
        self.spill_metrics = SpillMetrics()
        #: the owning operator's MetricNode, where `mem_used` peaks go
        self.metrics = getattr(self, "metrics", None)

    @property
    def mem_used(self) -> int:
        return self._mem_used

    def set_spillable(self, manager: "MemManager") -> None:
        from blaze_tpu_torch.bridge.context import active_query
        if self.query is None:
            self.query = active_query()
        self._manager = manager
        manager.register_consumer(self)

    def update_mem_used(self, nbytes: int) -> None:
        """Declare the bytes now retained; may spill (this consumer too)."""
        self._mem_used = max(0, int(nbytes))
        if self.metrics is not None:
            self.metrics.set_max("mem_used", self._mem_used)
        if self._manager is not None:
            self._manager.on_mem_updated(self)

    def add_mem_used(self, delta: int) -> None:
        self.update_mem_used(self._mem_used + delta)

    def spill(self) -> int:
        """Release memory down a tier; returns the bytes released."""
        raise NotImplementedError

    def try_release_pressure(self) -> int:
        """A release cheaper than a spill, where the consumer has one;
        returns the bytes released (0: none, spill() follows)."""
        return 0

    def unregister(self) -> None:
        if self._manager is not None:
            self._manager.unregister_consumer(self)
            self._manager = None


class MemManager:
    """The process-wide budget over the registered consumers."""

    _instance: Optional["MemManager"] = None
    _instance_lock = threading.Lock()

    def __init__(self, total_bytes: int):
        self.total = int(total_bytes)
        self._lock = threading.RLock()
        self._consumers: List[MemConsumer] = []
        self.total_spill_count = 0
        self.total_spilled_bytes = 0
        self.total_pressure_releases = 0
        self.total_quota_breaches = 0
        self.peak_used = 0
        #: query_id (or "<solo>") -> bytes shed on its consumers
        self.shed_bytes_by_query: Dict[str, int] = {}
        #: query_id of the first consumer shed under global pressure
        self.first_shed_query: Optional[str] = None
        #: consumer name -> [spills, bytes released by them]
        self.spills_by_consumer: Dict[str, List[int]] = {}

    @classmethod
    def init(cls, total_bytes: Optional[int] = None) -> "MemManager":
        with cls._instance_lock:
            if cls._instance is None or total_bytes is not None:
                if total_bytes is None:
                    total_bytes = default_budget_bytes()
                cls._instance = cls(total_bytes)
            return cls._instance

    @classmethod
    def get(cls) -> "MemManager":
        return cls.init()

    # -- consumer registry -------------------------------------------------
    def register_consumer(self, c: MemConsumer) -> None:
        with self._lock:
            if c not in self._consumers:
                self._consumers.append(c)

    def unregister_consumer(self, c: MemConsumer) -> None:
        with self._lock:
            if c in self._consumers:
                self._consumers.remove(c)

    @property
    def mem_used(self) -> int:
        with self._lock:
            return sum(c.mem_used for c in self._consumers)

    def consumer_cap(self) -> int:
        """The fair per-consumer cap: total // max(1, N)."""
        with self._lock:
            return self.total // max(1, len(self._consumers))

    # -- pressure ----------------------------------------------------------
    def _spill(self, c: MemConsumer, cause: str) -> int:
        released = c.spill()
        self.total_spill_count += 1
        self.total_spilled_bytes += released
        kind = self.spills_by_consumer.setdefault(c.name, [0, 0])
        kind[0] += 1
        kind[1] += released
        _trace_spill(c, released, cause)
        return released

    def _release(self, c: MemConsumer, cause: str) -> int:
        """c's cheaper release where it offers one, else its spill."""
        released = c.try_release_pressure()
        if released > 0:
            self.total_pressure_releases += 1
            return released
        return self._spill(c, cause)

    def on_mem_updated(self, updated: MemConsumer) -> None:
        with self._lock:
            if updated._release_requested and updated.mem_used > 0:
                updated._release_requested = False
                self._attribute_shed(
                    updated, self._release(updated, "cross-query-release"),
                    global_pressure=True)
            used = self.mem_used
            if used > self.peak_used:
                self.peak_used = used
            overflow = used - self.total
            cap = self.consumer_cap()
            self._enforce_query_quota(updated)
            # a consumer far over its fair share spills even without
            # global overflow, so one giant sort cannot starve the rest
            if overflow <= 0 and updated.mem_used <= cap * 2:
                return
            upd_q = updated.query
            for c in self._arbitration_order():
                if self.mem_used <= self.total * MEM_SPILL_FACTOR:
                    break
                if c.mem_used == 0:
                    continue
                if c.query is not None and c.query is not upd_q:
                    c._release_requested = True
                    break
                self._attribute_shed(c, self._release(c, "pool-pressure"),
                                     global_pressure=True)

    def _attribute_shed(self, c: MemConsumer, released: int,
                        global_pressure: bool = False) -> None:
        if released <= 0:
            return
        qid = str(getattr(c.query, "query_id", None) or "<solo>")
        if global_pressure and self.first_shed_query is None:
            self.first_shed_query = qid
        self.shed_bytes_by_query[qid] = (
            self.shed_bytes_by_query.get(qid, 0) + released)

    def _arbitration_order(self) -> List[MemConsumer]:
        """Consumers heaviest query first, then biggest first; a consumer
        of no query is a query of its own."""
        def group(c):
            return id(c.query) if c.query is not None else ("solo", id(c))

        totals: Dict[object, int] = {}
        for c in self._consumers:
            totals[group(c)] = totals.get(group(c), 0) + c.mem_used
        return sorted(self._consumers,
                      key=lambda c: (-totals[group(c)], -c.mem_used))

    def _enforce_query_quota(self, updated: MemConsumer) -> None:
        """A query over its `mem_quota` sheds its own consumers, largest
        first, down to 0.8 of the quota, and climbs one rung of its
        degradation ladder."""
        q = updated.query
        if q is None:
            return
        quota = int(getattr(q, "mem_quota", 0) or 0)
        mine = [c for c in self._consumers if c.query is q]
        used = sum(c.mem_used for c in mine)
        if quota <= 0 or used <= quota:
            return
        self.total_quota_breaches += 1
        rung = q.degrade()
        from blaze_tpu_torch.bridge import tracing
        tracing.instant("quota_breach", query=getattr(q, "query_id", None),
                        used=used, quota=quota, rung=rung)
        target = int(quota * MEM_SPILL_FACTOR)
        for c in sorted(mine, key=lambda c: -c.mem_used):
            if sum(x.mem_used for x in mine) <= target:
                break
            if c.mem_used == 0:
                continue
            self._attribute_shed(c, self._release(c, "query-quota"))

    def dump_status(self) -> str:
        with self._lock:
            lines = [f"MemManager total={self.total} used={self.mem_used} "
                     f"spills={self.total_spill_count} "
                     f"spilled_bytes={self.total_spilled_bytes} "
                     f"pressure_releases={self.total_pressure_releases}"]
            if self.shed_bytes_by_query:
                shed = " ".join(f"{q}={b}" for q, b in
                                sorted(self.shed_bytes_by_query.items()))
                lines.append(f"  shed_by_query: {shed}")
            for c in self._consumers:
                lines.append(f"  {c.name}: used={c.mem_used}")
            return "\n".join(lines)


def default_budget_bytes() -> int:
    """The budget: the card's memory times `auron.memory.fraction` under
    `auron.torch.device=cuda`; on the CPU, min(physical memory x
    `auron.process.vmrss.memoryFraction`, 4 GiB) times the fraction."""
    from blaze_tpu_torch.device import resolve
    frac = config.MEMORY_FRACTION.get()
    dev = resolve()
    if dev.type == "cuda":
        import torch
        return int(torch.cuda.mem_get_info(dev)[1] * frac)
    try:
        phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        phys = 4 << 30
    vmrss = config.PROCESS_VMRSS_MEMORY_FRACTION.get()
    return int(min(phys * vmrss, 4 << 30) * frac)
