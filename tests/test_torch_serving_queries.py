"""Concurrent TPC-DS queries through the port's query service
(blaze_tpu_torch/serving/service.py) against the JAX package: full q01,
q06 and q95 at scale 0.05 (the fact tables in 2 files each, 2 exchange
partitions), each twice, at `maxConcurrent` 4 through
`itest/serving.py`, give the JAX DagScheduler's serial results (the same
rows in the same order, floats within 1e-9 relative), equal their
pandas oracles and equal the port's own serial runs bit for bit.  Then
the teardown legs on a staged query: a cancel from the progress hook once
the first stage finished, a deadline that expires during the first
stage, and the memory-quota ladder against the JAX package's under the
same quota; after each, no shuffle file, an empty `leak_report`, a
manager that holds nothing for the query, and a rerun that completes.
Last, the live progress snapshots (serving/progress.py) key for key
against the JAX package's, a re-plan under `auron.tpu.aqe.enable`
among them.

The JAX scheduler runs on its device route (tests/test_torch_q17_q18.py
`_jax_run`: `host_resident` patched to False, `auron.tpu.shuffle.device`
off); both run with `auron.tpu.dag.singleTaskBytes` 0.  No test waits on
a wall clock: the cancel and the deadline are made certain by hooks
inside the first stage, and every wait has a timeout of its own."""

import copy
import glob
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import serving as S
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.runner import frame, same_order
from blaze_tpu_torch.memory import MemManager
from blaze_tpu_torch.plan.stages import DagScheduler
from blaze_tpu_torch.serving import (DeadlineExceeded, QueryCancelled,
                                     QueryContext, QueryMemoryExceeded,
                                     QueryService)

from test_torch_q17_q18 import _jax_run

SCALE = 0.05
PARTS = 2
N_FILES = 2
REL = 1e-9
TIMEOUT = 300


@pytest.fixture(autouse=True)
def confs():
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STATS_ENABLE, tconf.STATS_DIR, tconf.AQE_ENABLE):
        tconf.conf.unset(opt.key)
    from blaze_tpu_torch.plan import adaptive, statstore
    statstore.reset_conf_probe()
    adaptive.reset_conf_probe()
    MemManager.init(4 << 30)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = TT.make_tables(SCALE, S.TABLES)
    root = tmp_path_factory.mktemp("serving")
    return tables, TT.write_splits(tables, str(root), N_FILES)


@pytest.fixture(scope="module")
def mix(data):
    tables, paths = data
    return S.tpcds_mix(paths, tables, PARTS, S.MIX)


@pytest.fixture(scope="module")
def served(mix):
    """The port's serial frame of each query, the mix twice at
    maxConcurrent 4, and the JAX scheduler's serial frame of each."""
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    try:
        serial = {n: frame(DagScheduler().run_collect(make()))
                  for n, (make, _want) in mix.items()}
        out = S.run_mix([(n, make) for n, (make, _w) in mix.items()] * 2, 4,
                        timeout_s=TIMEOUT)
    finally:
        tconf.conf.unset(tconf.TORCH_DEVICE.key)
        tconf.conf.unset(tconf.DAG_SINGLE_TASK_BYTES.key)
    jax = {n: _jax_run(make())[0] for n, (make, _w) in mix.items()}
    return serial, out, jax


def test_the_mix_completes_clean_at_concurrency_4(served):
    _serial, out, _jax = served
    assert out["submitted"] == out["completed"] == 6
    assert out["outcomes"] == {"done": 6}
    assert out["leaks"] == {} and out["threads_alive"] == []
    assert out["stats"]["counters"]["admitted"] == 6
    assert out["stats"]["counters"]["completed"] == 6
    assert out["stats"]["running"] == out["stats"]["queue_depth"] == 0
    assert 0 < out["p50_ms"] <= out["p99_ms"]
    for r in out["results"]:
        assert not os.path.exists(r["work_dir"])


@pytest.mark.parametrize("name", S.MIX)
def test_each_result_equals_the_oracle_the_serial_run_and_the_jax_run(
        served, mix, name):
    serial, out, jax = served
    errs = S.check_mix(out, {n: w for n, (_m, w) in mix.items()}, serial)
    runs = [r for r in out["results"] if r["name"] == name]
    assert len(runs) == 2
    for r in runs:
        assert errs[r["query_id"]] is None, errs[r["query_id"]]
        got = frame(r["table"])
        assert len(got) > 0
        assert same_order(got, jax[name], REL) is None


# -- teardown ---------------------------------------------------------------

def two_stage_plan(tmp_path, n=20_000, n_reduce=3, seed=7):
    """tests/test_serving.py's `_two_stage_plan`: a partial sum by key in
    two map tasks, a hash exchange of `n_reduce` partitions, the final
    sum."""
    rng = np.random.default_rng(seed)
    t = pa.table({"k": pa.array(rng.integers(0, 200, n), type=pa.int64()),
                  "v": pa.array(rng.random(n))})
    paths = []
    for i in range(2):
        p = str(tmp_path / f"in-{i}.parquet")
        pq.write_table(t.slice(i * (n // 2), n // 2), p)
        paths.append(p)
    schema = {"fields": [
        {"name": "k", "type": {"id": "int64"}, "nullable": True},
        {"name": "v", "type": {"id": "float64"}, "nullable": True}]}
    return {
        "kind": "hash_agg",
        "groupings": [{"expr": {"kind": "column", "index": 0},
                       "name": "k"}],
        "aggs": [{"fn": "sum", "mode": "final", "name": "s",
                  "args": [{"kind": "column", "index": 1}]}],
        "input": {
            "kind": "local_exchange",
            "partitioning": {"kind": "hash",
                             "exprs": [{"kind": "column", "index": 0}],
                             "num_partitions": n_reduce},
            "input": {
                "kind": "hash_agg",
                "groupings": [{"expr": {"kind": "column", "name": "k"},
                               "name": "k"}],
                "aggs": [{"fn": "sum", "mode": "partial", "name": "s",
                          "args": [{"kind": "column", "name": "v"}]}],
                "input": {"kind": "parquet_scan", "schema": schema,
                          "file_groups": [[paths[0]], [paths[1]]]}}}}


def _clean(h):
    """No shuffle file, resource or scratch dir left, and no consumer of
    the query registered with the manager."""
    assert h.leak_report is not None
    assert all(v == [] for v in h.leak_report.values()), h.leak_report
    assert not os.path.exists(h.work_dir)
    mm = MemManager.get()
    assert sum(c.mem_used for c in mm._consumers if c.query is h.ctx) == 0


def test_cancel_from_the_progress_hook_after_the_first_stage(
        mix, tmp_path, monkeypatch):
    """q95 cancelled as its second stage starts (the progress hook): the
    stage runs no task, QueryCancelled reaches the caller, the run leaves
    nothing behind and a rerun equals the oracle."""
    from blaze_tpu_torch.serving import progress
    tconf.conf.set(tconf.STATS_ENABLE.key, "true")
    tconf.conf.set(tconf.STATS_DIR.key, str(tmp_path / "stats"))
    from blaze_tpu_torch.plan import statstore
    statstore.reset_conf_probe()
    make, want = mix["q95"]
    seen = []
    with QueryService(max_concurrent=2) as svc:
        start = progress.note_stage_start

        def hook(qid, sid, tasks):
            start(qid, sid, tasks)
            seen.append((sid, tasks))
            if sid >= 1:
                svc.cancel(qid, reason="cancelled from the progress hook")
        monkeypatch.setattr(progress, "note_stage_start", hook)
        h = svc.submit(make())
        with pytest.raises(QueryCancelled, match="progress hook"):
            h.result(TIMEOUT)
        monkeypatch.setattr(progress, "note_stage_start", start)
        snap = progress.progress(h.query_id)
        assert snap["status"] == "failed"
        assert snap["stages"]["0"]["tasks_done"] == seen[0][1]
        assert snap["stages"]["1"]["tasks_done"] == 0
        assert h.status == "cancelled"
        assert svc.stats()["counters"]["cancelled"] == 1
        _clean(h)
        again = svc.submit(make())
        got = frame(again.result(TIMEOUT))
        assert same_order(*S.q95_windows.in_plan_order("q95", got, want),
                          REL) is None
        _clean(again)


def test_deadline_during_the_first_stage(mix, monkeypatch):
    """A deadline that expires inside q01's first map task (the task
    waits for it, with a timeout of its own): DeadlineExceeded at the
    next batch, the same clean state, and a rerun completes."""
    make, want = mix["q01"]
    real = DagScheduler._run_map_task
    hit = []

    def slow_first(self, stage, part, m):
        if not hit:
            hit.append(stage.sid)
            q = self._query
            end = time.monotonic() + 30
            while q.remaining_ms() > 0 and time.monotonic() < end:
                q.wait_cancelled(0.01)
            assert q.remaining_ms() <= 0
        return real(self, stage, part, m)
    monkeypatch.setattr(DagScheduler, "_run_map_task", slow_first)
    with QueryService(max_concurrent=1) as svc:
        h = svc.submit(make(), deadline_ms=200)
        with pytest.raises(DeadlineExceeded):
            h.result(TIMEOUT)
        assert hit == [0] and h.status == "cancelled"
        assert svc.stats()["counters"]["deadline"] == 1
        _clean(h)
        monkeypatch.setattr(DagScheduler, "_run_map_task", real)
        got = frame(svc.submit(make()).result(TIMEOUT))
        assert same_order(got, want, REL) is None


def _ladder(pkg, plan, quota):
    """Run `plan` through `pkg`'s DagScheduler under a query of `quota`
    bytes; returns (the rungs its degrade() returned, the exception type
    or None, the result frame or None)."""
    if pkg == "jax":
        import blaze_tpu.bridge.placement as P
        from blaze_tpu import config as jconf
        from blaze_tpu.bridge.context import query_scope
        from blaze_tpu.memory import MemManager as JMem
        from blaze_tpu.plan.stages import DagScheduler as Dag
        from blaze_tpu.serving import QueryContext as Ctx
        JMem.init(4 << 30)
        saved = P.host_resident
        P.host_resident = lambda: False
        jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
        jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    else:
        from blaze_tpu_torch.bridge.context import query_scope
        Dag, Ctx = DagScheduler, QueryContext
        MemManager.init(4 << 30)
    ctx = Ctx("ladder", mem_quota=quota)
    rungs = []
    climb = ctx.degrade

    def degrade():
        rungs.append(climb())
        return rungs[-1]
    ctx.degrade = degrade
    sched = Dag(query_ctx=ctx)
    try:
        with query_scope(ctx):
            out = frame(sched.run_collect(copy.deepcopy(plan)))
        err = None
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        out, err = None, type(e).__name__
    finally:
        if pkg == "jax":
            P.host_resident = saved
            jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
            jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)
    assert not any(sched.leak_report().values())
    return rungs, err, out, sched


@pytest.mark.parametrize("quota,outcome", [
    (1, "QueryMemoryExceeded"),      # every update breaches: kill
    (1 << 40, None)])                # never breached
def test_quota_ladder_equals_the_jax_package(mix, quota, outcome):
    plan = mix["q06"][0]()
    jrungs, jerr, jout, _ = _ladder("jax", plan, quota)
    rungs, err, out, sched = _ladder("port", plan, quota)
    assert err == jerr == outcome
    assert rungs[:3] == jrungs[:3]
    if outcome is None:
        assert rungs == [] and same_order(out, jout, REL) is None
    else:
        assert rungs[:3] == ["agg-passthrough", "shrink-capacity", "kill"]
    mm = MemManager.get()
    assert not [c for c in mm._consumers if c.query is not None]


def test_a_quota_under_the_peak_climbs_without_kill(mix):
    """The shuffle writer's staged rows are q06's largest consumer: a
    quota just under the run's peak breaches at that update, climbs one
    rung (pass-through) and the result still equals the oracle."""
    make, want = mix["q06"]
    peaks = []
    from blaze_tpu_torch.memory.manager import MemManager as M
    real = M._enforce_query_quota

    def record(self, updated):
        q = updated.query
        peaks.append(sum(c.mem_used for c in self._consumers
                         if c.query is q))
        return real(self, updated)
    M._enforce_query_quota = record
    try:
        rungs, err, _out, _ = _ladder("port", make(), 0)
        peak = max(peaks)
        rungs, err, out, _ = _ladder("port", make(), peak - 1)
    finally:
        M._enforce_query_quota = real
    assert err is None and 1 <= len(rungs) < 3 and "kill" not in rungs
    assert same_order(out, want, REL) is None


# -- progress ---------------------------------------------------------------

def _progress_run(pkg, plan, tmp_path, monkeypatch):
    """(a live snapshot after the first finished task, the final one) of
    `plan` run by `pkg`'s scheduler under query "qp", with the statistics
    plane and adaptive execution on."""
    if pkg == "jax":
        import blaze_tpu.bridge.placement as P
        from blaze_tpu import config as conf_mod
        from blaze_tpu.bridge.context import query_scope
        from blaze_tpu.plan import adaptive, statstore
        from blaze_tpu.plan.stages import DagScheduler as Dag
        from blaze_tpu.serving import QueryContext as Ctx
        from blaze_tpu.serving import progress
        monkeypatch.setattr(P, "host_resident", lambda: False)
        conf_mod.conf.set(conf_mod.SHUFFLE_DEVICE.key, "off")
    else:
        from blaze_tpu_torch import config as conf_mod
        from blaze_tpu_torch.bridge.context import query_scope
        from blaze_tpu_torch.plan import adaptive, statstore
        from blaze_tpu_torch.serving import QueryContext as Ctx
        from blaze_tpu_torch.serving import progress
        Dag = DagScheduler
    keys = {"auron.tpu.dag.singleTaskBytes": 0,
            "auron.tpu.stats.enable": "true",
            "auron.tpu.stats.dir": str(tmp_path / f"stats-{pkg}"),
            "auron.tpu.aqe.enable": "true"}
    for k, v in keys.items():
        conf_mod.conf.set(k, v)
    statstore.reset_conf_probe()
    adaptive.reset_conf_probe()
    progress.reset()
    live = []
    done = progress.note_task_done

    def hook(qid, sid):
        done(qid, sid)
        if not live:
            live.append(progress.progress(qid))
    monkeypatch.setattr(progress, "note_task_done", hook)
    try:
        ctx = Ctx("qp")
        sched = Dag(query_ctx=ctx)
        with query_scope(ctx):
            sched.run_collect(plan)
    finally:
        monkeypatch.setattr(progress, "note_task_done", done)
        for k in keys:
            conf_mod.conf.unset(k)
        statstore.reset_conf_probe()
        adaptive.reset_conf_probe()
    return live[0], progress.progress("qp"), sched.aqe_events


def test_progress_snapshots_equal_the_jax_package_key_for_key(
        tmp_path, monkeypatch):
    """A 16-partition reduce stage the coalesce rule re-plans: both
    registries note the re-plan; the live and final snapshots have the
    same keys, stages, task counts, re-plan count and ETA source."""
    plan = two_stage_plan(tmp_path, n_reduce=16)
    jlive, jdone, jev = _progress_run("jax", copy.deepcopy(plan), tmp_path,
                                      monkeypatch)
    live, final, ev = _progress_run("port", copy.deepcopy(plan), tmp_path,
                                    monkeypatch)
    assert [e["rule"] for e in ev] == [e["rule"] for e in jev] == \
        ["coalesce"]
    for got, want in ((live, jlive), (final, jdone)):
        assert set(got) == set(want)
        assert got["stages"].keys() == want["stages"].keys()
        for sid, st in got["stages"].items():
            assert set(st) == set(want["stages"][sid])
            assert (st["tasks_done"], st["tasks_total"]) == \
                (want["stages"][sid]["tasks_done"],
                 want["stages"][sid]["tasks_total"])
        for k in ("query_id", "state", "fingerprint", "tasks_done",
                  "tasks_total", "replans", "eta_source"):
            assert got[k] == want[k], k
    assert final["replans"] == 1 and final["status"] == "finished"
    assert live["state"] == "running"


def test_no_shuffle_file_left_after_the_mix(served):
    _serial, out, _jax = served
    for r in out["results"]:
        assert glob.glob(os.path.join(r["work_dir"], "*")) == []


def test_two_queries_share_no_fold_entry_lock_after_a_cancel(mix):
    """A query cancelled while its stage loop folds releases the fold
    entry, so the next query of that shape runs (on the CPU the loop's
    body runs eagerly under the same entry locks)."""
    from blaze_tpu_torch.runtime import loop
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, "on")
    try:
        make, want = mix["q01"]
        started = threading.Event()
        real = loop._Fold.run

        def run(self, program, start):
            started.set()
            from blaze_tpu_torch.bridge.context import active_query
            active_query().cancel(reason="cancelled inside the loop")
            return real(self, program, start)
        loop._Fold.run = run
        try:
            with QueryService(max_concurrent=1) as svc:
                h = svc.submit(make())
                with pytest.raises(QueryCancelled, match="inside the loop"):
                    h.result(TIMEOUT)
                assert started.is_set()
                _clean(h)
        finally:
            loop._Fold.run = real
        assert all(not f.lock.locked() and f.users == 0
                   for f in loop._FOLDS.values())
        with QueryService(max_concurrent=1) as svc:
            got = frame(svc.submit(make()).result(TIMEOUT))
        assert same_order(got, want, REL) is None
    finally:
        tconf.conf.unset(tconf.STAGE_DEVICE_LOOP_ENABLE.key)


def test_a_rewrite_is_abandoned_when_the_query_is_cancelled(
        tmp_path, monkeypatch):
    """The coalesce rule would re-plan the 16-partition reduce stage; the
    query is cancelled while the rule evaluates, so the rewrite never
    commits: no event, the stage keeps its static plan and task count,
    and the scheduler's next check raises QueryCancelled with nothing
    left behind."""
    from blaze_tpu_torch.bridge.context import query_scope
    from blaze_tpu_torch.plan import adaptive
    tconf.conf.set(tconf.AQE_ENABLE.key, "true")
    adaptive.reset_conf_probe()
    plan = two_stage_plan(tmp_path, n_reduce=16)
    ctx = QueryContext("qa")
    real = adaptive.AqeRuntime._try_coalesce

    def cancelling(self, c, completed):
        ctx.cancel(reason="cancelled while re-planning")
        return real(self, c, completed)
    monkeypatch.setattr(adaptive.AqeRuntime, "_try_coalesce", cancelling)
    sched = DagScheduler(query_ctx=ctx)
    with query_scope(ctx):
        with pytest.raises(QueryCancelled, match="re-planning"):
            sched.run_collect(plan)
    reduce_stage = sched.stages[-1]
    assert sched.aqe_events == [] and reduce_stage.aqe is None
    assert reduce_stage.num_tasks == 16
    assert not any(sched.leak_report().values())
    # the same plan without the cancel is re-planned (the rule fires)
    monkeypatch.setattr(adaptive.AqeRuntime, "_try_coalesce", real)
    sched = DagScheduler()
    frame(sched.run_collect(plan))
    assert [e["rule"] for e in sched.aqe_events] == ["coalesce"]


def test_a_run_removes_the_broadcast_maps_it_built(mix, monkeypatch):
    """full q01 builds its broadcast hash maps into the process-wide
    resource map; its scheduler's cleanup removes every one it added (a
    long-lived service would otherwise keep each query's), and the
    leak report lists none."""
    import blaze_tpu_torch.ops.joins.exec as J
    from blaze_tpu_torch.bridge import resource
    make, want = mix["q01"]
    before = set(resource._map)
    built = []

    def recording(key, factory):
        built.append(key)
        return resource.get_or_create(key, factory)
    monkeypatch.setattr(J, "get_or_create", recording)
    sched = DagScheduler()
    got = frame(sched.run_collect(make()))
    assert same_order(got, want, REL) is None
    assert any(k.startswith("join_map://") for k in built)
    assert set(resource._map) - before == set()
    assert not any(sched.leak_report().values())
