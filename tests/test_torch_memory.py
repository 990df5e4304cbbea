"""The port's memory manager (blaze_tpu_torch/memory/manager.py) against
the JAX package's (blaze_tpu/memory/manager.py): the same scripted
sequence of `update_mem_used` calls on stand-in consumers, run through
both managers, gives the same spill and release calls in the same order
and the same totals (`total_spill_count`, `total_spilled_bytes`,
`total_pressure_releases`, `total_quota_breaches`, `peak_used`,
`shed_bytes_by_query`, `first_shed_query`).

The scripts cover the fair cap and its "more than twice the cap" rule
with no global overflow, the spill of the biggest consumer down to 0.8
of the budget, a consumer's cheaper release taken before a spill,
per-query quotas and the degradation rung they climb, cross-query release
requests honoured at the owner's next update, and seeded random mixes of
all of them.  Stand-in queries are plain objects with `query_id`,
`mem_quota` and `degrade()`, since the port's query service is not there
yet.  Exact: every count and byte.

Both managers are process-wide singletons; every test restores both to
4 GiB."""

import numpy as np
import pytest

import blaze_tpu.memory as J
import blaze_tpu_torch.memory as T
from blaze_tpu_torch import config as tconf

BUDGET = 1000


@pytest.fixture(autouse=True)
def restore_managers():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    J.MemManager.init(4 << 30)
    T.MemManager.init(4 << 30)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


class _Query:
    def __init__(self, qid, quota, log):
        self.query_id, self.mem_quota, self._log = qid, quota, log
        self.rung = 0

    def degrade(self):
        self.rung += 1
        self._log.append(("degrade", self.query_id, self.rung))
        return self.rung


def _stand_in(pkg, name, log, keep, cheap):
    """A consumer that logs each spill and release: a spill keeps `keep`
    of its bytes (0 to 1), a cheap release (where `cheap`) frees half
    and is offered only once."""
    class StandIn(pkg.MemConsumer):
        def __init__(self):
            super().__init__(name)
            self.cheap = cheap

        def spill(self):
            released = self._mem_used - int(self._mem_used * keep)
            self._mem_used -= released
            log.append(("spill", name, released))
            return released

        def try_release_pressure(self):
            if not self.cheap or not self._mem_used:
                return 0
            self.cheap = False
            released = self._mem_used // 2
            self._mem_used -= released
            log.append(("release", name, released))
            return released
    return StandIn()


def _run(pkg, consumers, script, budget=BUDGET):
    """consumers: [(name, query id or None, keep, cheap)]; queries share
    one stand-in object per id, with the quota in `quotas`; script:
    [(consumer index, bytes) | ("unregister", index)]."""
    log = []
    mgr = pkg.MemManager.init(budget)
    queries = {}
    cs = []
    for name, (qid, quota), keep, cheap in consumers:
        c = _stand_in(pkg, name, log, keep, cheap)
        if qid is not None:
            if qid not in queries:
                queries[qid] = _Query(qid, quota, log)
            c.query = queries[qid]
        c.set_spillable(mgr)
        cs.append(c)
    for step in script:
        if step[0] == "unregister":
            cs[step[1]].unregister()
            log.append(("unregistered", step[1]))
            continue
        i, nbytes = step
        cs[i].update_mem_used(nbytes)
        log.append(("used", i, cs[i].mem_used, mgr.mem_used))
    return log, {"spills": mgr.total_spill_count,
                 "spilled": mgr.total_spilled_bytes,
                 "releases": mgr.total_pressure_releases,
                 "breaches": mgr.total_quota_breaches,
                 "peak": mgr.peak_used,
                 "shed": dict(mgr.shed_bytes_by_query),
                 "first": mgr.first_shed_query,
                 "cap": mgr.consumer_cap(),
                 "status": mgr.dump_status()}


SOLO = (None, 0)

SCRIPTS = {
    # one consumer past twice its fair cap (1000 // 4) spills with the
    # pool under budget but over 0.8 of it; at twice the cap it does not
    "fair cap": ([("a", SOLO, 0.0, False), ("b", SOLO, 0.0, False),
                  ("c", SOLO, 0.0, False), ("d", SOLO, 0.0, False)],
                 [(1, 350), (0, 500), (0, 501), (2, 100), (3, 10)]),
    # overflow: the biggest consumer spills first, down to 0.8 x budget
    "biggest first": ([("a", SOLO, 0.5, False), ("b", SOLO, 0.0, False),
                       ("c", SOLO, 0.0, False)],
                      [(0, 400), (1, 300), (2, 200), (2, 350), (1, 600),
                       (0, 100), (0, 900)]),
    # a cheaper release is taken at its word before any spill
    "cheap release": ([("a", SOLO, 0.0, True), ("b", SOLO, 0.0, False)],
                      [(0, 300), (1, 400), (0, 700), (1, 500), (0, 800)]),
    # a query over its quota sheds its own consumers, largest first,
    # and degrades one rung per breaching update
    "quota": ([("a", ("q1", 300), 0.0, False),
               ("b", ("q1", 300), 0.25, True),
               ("c", ("q2", 0), 0.0, False)],
              [(0, 100), (1, 150), (0, 200), (2, 300), (1, 250), (0, 50),
               (1, 400)]),
    # the heaviest query pays first; a consumer of another query is
    # asked to release and does so at its own next update
    "cross query": ([("a", ("heavy", 0), 0.0, False),
                     ("b", ("heavy", 0), 0.0, False),
                     ("c", ("light", 0), 0.0, False)],
                    [(0, 400), (1, 350), (2, 200), (2, 300), (0, 400),
                     (1, 10), (2, 100), (0, 5)]),
    # unregistering a consumer raises the others' fair cap
    "unregister": ([("a", SOLO, 0.0, False), ("b", SOLO, 0.0, False),
                    ("c", SOLO, 0.0, False)],
                   [(0, 300), (1, 300), ("unregister", 2), (0, 600),
                    ("unregister", 1), (0, 900), (0, 1001)]),
}


def _random_script(seed):
    rng = np.random.default_rng(seed)
    consumers = []
    for i in range(int(rng.integers(2, 7))):
        q = rng.choice(["solo", "q1", "q2"])
        qid = None if q == "solo" else str(q)
        quota = int(rng.choice([0, 300, 600])) if qid == "q1" else 0
        consumers.append((f"c{i}", (qid, quota), float(rng.choice(
            [0.0, 0.3, 0.7])), bool(rng.random() < 0.3)))
    script = []
    for _ in range(200):
        if rng.random() < 0.03 and len(consumers) > 1:
            script.append(("unregister", int(rng.integers(len(consumers)))))
            continue
        script.append((int(rng.integers(len(consumers))),
                       int(rng.integers(0, 800))))
    return consumers, script


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_sequences_match_the_jax_manager(name):
    consumers, script = SCRIPTS[name]
    want = _run(J, consumers, script)
    got = _run(T, consumers, script)
    assert got == want
    log, totals = got
    assert any(e[0] in ("spill", "release") for e in log)
    if name == "fair cap":
        # the 501-byte update spilled a with 851 bytes in the pool
        assert ("spill", "a", 501) in log and totals["peak"] < BUDGET
        assert not any(e[:2] == ("spill", "c") for e in log)
    if name == "quota":
        assert totals["breaches"] > 0 and totals["shed"].get("q1")
    if name == "cross query":
        # the light query's update asked the heavy query to release,
        # and the light query was never shed
        assert totals["first"] == "heavy" and "light" not in totals["shed"]


@pytest.mark.parametrize("seed", range(8))
def test_random_sequences_match_the_jax_manager(seed):
    consumers, script = _random_script(seed)
    want = _run(J, consumers, script)
    got = _run(T, consumers, script)
    assert got == want


def test_singleton_init_and_get():
    m = T.MemManager.init(12345)
    assert T.MemManager.get() is m and m.total == 12345
    assert T.MemManager.init() is m  # no size: the same instance
    assert T.MemManager.init(54321) is not m


def test_default_budget_on_the_cpu_is_the_jax_formula():
    import os
    phys = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    want = int(min(phys * 0.9, 4 << 30) * 0.6)
    assert T.default_budget_bytes() == want
    tconf.conf.set(tconf.MEMORY_FRACTION.key, 0.5)
    tconf.conf.set(tconf.PROCESS_VMRSS_MEMORY_FRACTION.key, 0.25)
    try:
        assert T.default_budget_bytes() == int(
            min(phys * 0.25, 4 << 30) * 0.5)
    finally:
        tconf.conf.unset(tconf.MEMORY_FRACTION.key)
        tconf.conf.unset(tconf.PROCESS_VMRSS_MEMORY_FRACTION.key)


def test_default_budget_never_touches_cuda_on_the_cpu(monkeypatch):
    import torch

    def boom(*a, **k):
        raise AssertionError("CUDA queried under auron.torch.device=cpu")
    monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
    T.MemManager._instance = None
    assert T.MemManager.get().total > 0


def test_consumer_records_mem_used_on_its_metric_node():
    from blaze_tpu_torch.bridge.metrics import MetricNode
    log = []
    c = _stand_in(T, "x", log, 0.0, False)
    c.metrics = MetricNode("op")
    c.set_spillable(T.MemManager.init(10_000))
    c.update_mem_used(700)
    c.add_mem_used(-200)
    assert c.metrics.get("mem_used") == 700 and c.mem_used == 500
    c.unregister()
    assert T.MemManager.get().mem_used == 0


def test_active_query_is_the_task_contexts():
    from blaze_tpu_torch.bridge.context import (TaskContext, active_query,
                                                task_scope)
    q = _Query("q9", 0, [])
    assert active_query() is None
    with task_scope(TaskContext(query=q)):
        assert active_query() is q
        c = _stand_in(T, "y", [], 0.0, False)
        c.set_spillable(T.MemManager.init(100))
        assert c.query is q
    assert active_query() is None


def test_config_keys_and_alt_key_match_the_jax_package():
    from blaze_tpu import config as jconf
    pairs = [(tconf.MEMORY_FRACTION, jconf.MEMORY_FRACTION),
             (tconf.PROCESS_VMRSS_MEMORY_FRACTION,
              jconf.PROCESS_VMRSS_MEMORY_FRACTION),
             (tconf.ON_HEAP_SPILL_MEMORY_FRACTION,
              jconf.ON_HEAP_SPILL_MEMORY_FRACTION),
             (tconf.PARTIAL_AGG_SKIPPING_ON_SPILL,
              jconf.PARTIAL_AGG_SKIPPING_ON_SPILL),
             (tconf.SUGGESTED_MERGING_BATCH_MEM_SIZE,
              jconf.SUGGESTED_MERGING_BATCH_MEM_SIZE)]
    for t, j in pairs:
        assert (t.key, t.default, t.alt_keys) == (j.key, j.default,
                                                  j.alt_keys)
    alt = tconf.PARTIAL_AGG_SKIPPING_ON_SPILL.alt_keys[0]
    tconf.conf.set(alt, "true")
    try:
        assert tconf.PARTIAL_AGG_SKIPPING_ON_SPILL.get() is True
        assert tconf.conf.is_set(tconf.PARTIAL_AGG_SKIPPING_ON_SPILL)
    finally:
        tconf.conf.unset(alt)
    assert tconf.PARTIAL_AGG_SKIPPING_ON_SPILL.get() is False
