"""The port's statistics feedback plane (blaze_tpu_torch/plan/
fingerprint.py, statstore.py, advisor.py, and the scheduler's ingest in
plan/stages.py) against the JAX package's (blaze_tpu/plan/...):

  * fingerprints of the same plan dicts, string for string;
  * the quantile sketch: adds, merges, quantiles and spreads bit for bit,
    deterministic compression, exact extremes;
  * the store: the same observations ingested by both packages leave
    byte-identical JSONL files (merges, compaction past `_MAX_LINES`), a
    torn trailing line is skipped, retention prunes the oldest
    fingerprints, a fresh process replays a record bit for bit, and
    disabled it writes nothing;
  * the advisor: findings and recommendations equal to the JAX ones for
    the same record;
  * the scheduler's ingest: two staged runs of one plan merge into one
    record whose shuffle boundaries equal the JAX scheduler's.

The JAX scheduler runs on its device route (`host_resident` patched to
False, `auron.tpu.shuffle.device` off).  Both packages' counter
registries and probes are reset around every test, and every store lives
in the test's own directory, so no test depends on what ran before it in
its worker.  Tolerance: exact."""

import copy
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu.bridge import xla_stats
from blaze_tpu.plan import advisor as jadvisor
from blaze_tpu.plan import fingerprint as jfp
from blaze_tpu.plan import statstore as jstore
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.plan import advisor as tadvisor
from blaze_tpu_torch.plan import fingerprint as tfp
from blaze_tpu_torch.plan import statstore as tstore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KEYS = ("auron.tpu.stats.enable", "auron.tpu.stats.dir",
         "auron.tpu.dag.singleTaskBytes", "auron.tpu.shuffle.device")


def _reset():
    for c in (jconf, tconf):
        for k in _KEYS:
            c.conf.unset(k)
    jstore.reset_conf_probe()
    tstore.reset_conf_probe()
    xla_stats.reset()
    device_stats.reset()


@pytest.fixture(autouse=True)
def clean():
    _reset()
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    _reset()
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _stats_on(path):
    """Both packages' stores on, each in its own directory under `path`."""
    dirs = {}
    for name, c, mod in (("jax", jconf, jstore), ("port", tconf, tstore)):
        dirs[name] = str(path / f"stats-{name}")
        c.conf.set("auron.tpu.stats.enable", "on")
        c.conf.set("auron.tpu.stats.dir", dirs[name])
        mod.reset_conf_probe()
    return dirs


def _obs(fp="fp-a", wall=1.0, **over):
    obs = {
        "fingerprint": fp,
        "wall_s": wall,
        "task_ns": [1_000_000, 2_000_000, 4_000_000],
        "counters": {"partial_agg_probe_rows": 100,
                     "partial_agg_probe_groups": 40,
                     "expr_programs_built": 2,
                     "expr_program_cache_hits": 6},
        "fallback_reasons": {},
        "stages": [{"fingerprint": "st-0", "sid": 0, "tasks": 2,
                    "partitions": 4,
                    "partition_bytes": [100, 110, 90, 105],
                    "exchange": "file", "output_rows": 50}],
    }
    obs.update(over)
    return obs


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


# -- fingerprints -----------------------------------------------------------

_SCAN = {"kind": "parquet_scan", "file_groups": [["/d/a.parquet"]],
         "schema": {"fields": [{"name": "k", "type": {"id": "int64"},
                                "nullable": True}]}}
PLANS = {
    "scan": _SCAN,
    "reordered": dict(reversed(list(_SCAN.items()))),
    "agg": {"kind": "hash_agg", "input": _SCAN,
            "groupings": [{"expr": {"kind": "column", "index": 0},
                           "name": "k"}],
            "aggs": [{"fn": "count", "mode": "partial", "name": "n",
                      "args": [{"kind": "column", "index": 0}]}]},
    "literals": {"kind": "filter", "input": _SCAN, "predicates": [
        {"kind": "binary", "op": ">", "l": {"kind": "column", "index": 0},
         "r": {"kind": "literal", "value": 1.5, "type": {"id": "float64"}}},
        {"kind": "literal", "value": "é", "type": {"id": "utf8"}}]},
    "debug": {"kind": "debug"},
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fingerprints_equal_the_jax_ones(name):
    plan = PLANS[name]
    assert tfp.plan_fingerprint(plan) == jfp.plan_fingerprint(plan)
    part = {"kind": "hash", "num_partitions": 8,
            "exprs": [{"kind": "column", "index": 0}]}
    for p, n in ((part, 4), (None, 1)):
        assert tfp.subplan_fingerprint(plan, p, n) == \
            jfp.subplan_fingerprint(plan, p, n)
    base = tfp.plan_fingerprint(plan)
    for rule, params in (("coalesce", {"groups": [[0, 1], [2]]}),
                         ("skew_split", {"hot": 3, "splits": 2}),
                         ("broadcast", {"build_bytes": 9360})):
        assert tfp.derived_fingerprint(base, rule, params) == \
            jfp.derived_fingerprint(base, rule, params)
    # insertion order never matters
    assert tfp.plan_fingerprint(PLANS["reordered"]) == \
        tfp.plan_fingerprint(PLANS["scan"])


def test_derived_fingerprints_deterministic_and_distinct():
    base = tfp.plan_fingerprint({"kind": "debug"})
    a = tfp.derived_fingerprint(base, "coalesce", {"groups": [[0, 1]]})
    b = tfp.derived_fingerprint(base, "coalesce", {"groups": [[0, 1]]})
    c = tfp.derived_fingerprint(base, "coalesce", {"groups": [[0], [1]]})
    d = tfp.derived_fingerprint(base, "skew_split", {"groups": [[0, 1]]})
    assert a == b
    assert len({a, c, d, base}) == 4


# -- the quantile sketch ----------------------------------------------------

SKETCHES = {
    "ramp 32": ([float(i) for i in range(1, 101)], 32),
    "modular 16": ([float((i * 37) % 101) for i in range(200)], 16),
    "normal 8": (list(np.random.default_rng(7).normal(size=500)), 8),
    "ties 4": ([1.0, 1.0, 2.0, 2.0, 2.0, 9.0, 9.0], 4),
    "one": ([42.0], 64),
}


@pytest.mark.parametrize("name", sorted(SKETCHES))
def test_sketch_equals_the_jax_one_bit_for_bit(name):
    vals, budget = SKETCHES[name]
    t = tstore.sketch_add(tstore.sketch_new(), vals, budget=budget)
    j = jstore.sketch_add(jstore.sketch_new(), vals, budget=budget)
    assert t == j
    for q in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
        assert tstore.sketch_quantile(t, q) == jstore.sketch_quantile(j, q)
    assert tstore.sketch_spread(t) == jstore.sketch_spread(j)
    other = [v * 3.0 + 1.0 for v in vals[::3]]
    tm = tstore.sketch_merge(t, tstore.sketch_add(
        tstore.sketch_new(), other, budget=budget), budget=budget)
    jm = jstore.sketch_merge(j, jstore.sketch_add(
        jstore.sketch_new(), other, budget=budget), budget=budget)
    assert tm == jm
    assert tm["count"] == len(vals) + len(other)


def test_sketch_quantiles_and_extremes():
    sk = tstore.sketch_add(tstore.sketch_new(),
                           [float(i) for i in range(1, 101)], budget=32)
    assert sk["count"] == 100
    assert tstore.sketch_quantile(sk, 0.0) == 1.0
    assert tstore.sketch_quantile(sk, 1.0) == 100.0
    assert 45.0 <= tstore.sketch_quantile(sk, 0.5) <= 56.0
    assert tstore.sketch_spread(sk) == pytest.approx(80.0, abs=8.0)
    assert tstore.sketch_quantile(tstore.sketch_new(), 0.5) is None
    assert tstore.sketch_spread(tstore.sketch_new()) is None


# -- the store --------------------------------------------------------------

def _ingest_both(obs_list):
    for obs in obs_list:
        jstore.ingest(copy.deepcopy(obs))
        tstore.ingest(copy.deepcopy(obs))


@pytest.mark.parametrize("runs", [1, 2, jstore._MAX_LINES + 3])
def test_store_files_equal_the_jax_ones(tmp_path, runs):
    """Merges and, past `_MAX_LINES` appended records, compaction: the
    port's files are the JAX package's byte for byte."""
    dirs = _stats_on(tmp_path)
    obs = [_obs(wall=1.0 + i * 0.01) for i in range(runs)]
    obs.append(_obs(fp="fp-b", wall=2.0, fallback_reasons={"stage_loop": 3}))
    _ingest_both(obs)
    assert _files(dirs["port"]) == _files(dirs["jax"])
    rec = tstore.StatStore(dirs["port"]).record("fp-a")
    assert rec["run_count"] == runs
    with open(tstore._fp_path(dirs["port"], "fp-a")) as f:
        assert len(f.read().splitlines()) <= tstore._MAX_LINES
    assert tstore.StatStore(dirs["port"]).fingerprints() == \
        jstore.StatStore(dirs["jax"]).fingerprints() == ["fp-a", "fp-b"]
    assert device_stats.statstore_stats() == xla_stats.statstore_stats()


def test_two_runs_merge_into_one_record(tmp_path):
    _stats_on(tmp_path)
    tstore.ingest(_obs(wall=1.0))
    rec = tstore.ingest(_obs(wall=1.2))
    assert rec["run_count"] == 2
    assert rec["counters"]["partial_agg_probe_rows"] == 200
    assert rec["derived"]["agg_probe_ratio"] == pytest.approx(0.4)
    assert rec["derived"]["expr_cache_hit_rate"] == pytest.approx(0.75)
    assert rec["derived"]["wall_p50_s"] == pytest.approx(1.1)
    st = rec["stages"]["st-0"]
    assert st["run_count"] == 2
    assert st["partition_bytes"]["count"] == 8
    assert st["last_partition_bytes"] == [100, 110, 90, 105]


def test_more_runs_tighten_the_wall_spread(tmp_path):
    _stats_on(tmp_path)
    tstore.ingest(_obs(wall=1.0))
    tstore.ingest(_obs(wall=5.0))
    wide = tstore.prior("fp-a")["derived"]["wall_spread_s"]
    for _ in range(20):
        tstore.ingest(_obs(wall=3.0))
    assert tstore.prior("fp-a")["derived"]["wall_spread_s"] < wide


def test_a_fresh_process_replays_a_jax_record_bit_for_bit(tmp_path):
    """The port's StatStore, in a fresh interpreter, reads the record the
    JAX package wrote and serializes it to the same bytes."""
    dirs = _stats_on(tmp_path)
    jstore.ingest(_obs(wall=1.0))
    rec = jstore.ingest(_obs(wall=1.5))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys\n"
         "from blaze_tpu_torch.plan import statstore\n"
         "r = statstore.StatStore(sys.argv[1]).record('fp-a')\n"
         "sys.stdout.write(statstore._dumps(r))", dirs["jax"]],
        capture_output=True, text=True, check=True, cwd=ROOT, timeout=120)
    assert out.stdout == jstore._dumps(rec)


def test_torn_trailing_line_is_skipped(tmp_path):
    dirs = _stats_on(tmp_path)
    tstore.ingest(_obs(wall=1.0))
    path = tstore._fp_path(dirs["port"], "fp-a")
    with open(path, "a") as f:
        f.write('{"v": 1, "run_cou')  # a crash mid-append
    rec = tstore.StatStore(dirs["port"]).record("fp-a")
    assert rec is not None and rec["run_count"] == 1
    assert tstore.ingest(_obs(wall=2.0))["run_count"] == 2


def test_retention_prunes_oldest_fingerprints(tmp_path, monkeypatch):
    monkeypatch.setattr(tstore, "MAX_FINGERPRINTS", 3)
    dirs = _stats_on(tmp_path)
    for i in range(6):
        tstore.ingest(_obs(fp=f"fp-{i}"))
        path = tstore._fp_path(dirs["port"], f"fp-{i}")
        os.utime(path, (1_000_000 + i, 1_000_000 + i))
    tstore.ingest(_obs(fp="fp-9"))
    fps = tstore.StatStore(dirs["port"]).fingerprints()
    assert len(fps) <= 3 and "fp-9" in fps


def test_disabled_by_default_writes_nothing(tmp_path):
    d = str(tmp_path / "stats")
    tconf.conf.set("auron.tpu.stats.dir", d)  # the dir set, enable not
    tstore.reset_conf_probe()
    assert tstore.enabled() is False
    assert tstore.ingest(_obs()) is None
    assert tstore.prior("fp-a") is None
    assert not os.path.exists(d)


def test_the_default_dir_rides_the_history_dir(tmp_path):
    assert tstore.stats_dir().endswith(os.path.join("blaze_history",
                                                    "stats"))
    tconf.conf.set("auron.tpu.history.dir", str(tmp_path / "h"))
    try:
        assert tstore.stats_dir() == str(tmp_path / "h" / "stats")
    finally:
        tconf.conf.unset("auron.tpu.history.dir")


def test_ingest_counters_are_the_jax_ones():
    assert tstore.INGEST_COUNTERS == jstore.INGEST_COUNTERS
    assert tstore.STATS_SCHEMA_VERSION == jstore.STATS_SCHEMA_VERSION
    # the ones the port has a site for are in its registry; the rest
    # (device exchange, dictionary and decimal tiers, ...) read 0
    snap = device_stats.snapshot()
    present = {k for k in tstore.INGEST_COUNTERS if k in snap}
    assert {"partial_agg_probe_rows", "expr_programs_built",
            "shuffle_host_bytes", "aqe_rewrites", "aqe_history_seeds",
            "host_evictions_string", "stage_loop_fallbacks"} <= present


# -- the advisor ------------------------------------------------------------

def _skewed(obs):
    obs["stages"][0]["partition_bytes"] = [100, 100, 100, 5000]
    return obs


def _high_cardinality(obs):
    obs["counters"]["partial_agg_probe_groups"] = 95
    obs["fallback_reasons"] = {"stage_loop": 3}
    return obs


def _churn(obs):
    obs["counters"]["expr_programs_built"] = 20
    obs["counters"]["expr_program_cache_hits"] = 2
    return obs


def _big(obs):
    obs["stages"][0]["partition_bytes"] = [9 << 20, 9 << 20, 9 << 20, 1]
    return obs


ADVICE = {"small": lambda o: o, "skewed": _skewed,
          "high cardinality": _high_cardinality, "churn": _churn,
          "big": _big}


@pytest.mark.parametrize("name", sorted(ADVICE))
def test_advisor_equals_the_jax_one(name):
    obs = ADVICE[name](_obs(fp="fp-adv"))
    trec = tstore.merge_observation(tstore._new_record("fp-adv"),
                                    copy.deepcopy(obs))
    jrec = jstore.merge_observation(jstore._new_record("fp-adv"),
                                    copy.deepcopy(obs))
    assert trec == jrec
    bn = {"dominant": "exchange_wire", "dominant_fraction": 0.7,
          "wall_s": 2.0, "categories": {"exchange_wire": 1.4}}
    for b in (None, bn):
        assert tadvisor.findings(trec, b) == jadvisor.findings(jrec, b)
    assert tadvisor.recommendations(trec) == jadvisor.recommendations(jrec)
    kinds = {f["kind"] for f in tadvisor.findings(trec, bn)}
    assert "dominant_bottleneck" in kinds
    want = {"small": "broadcast_candidate", "skewed": "skew_partition",
            "high cardinality": "high_cardinality_agg",
            "churn": "low_cache_hit_rate", "big": None}[name]
    assert want is None or want in kinds
    if name == "big":  # 27 MiB does not fit the 8 MiB threshold
        assert "broadcast_candidate" not in kinds


def test_advisor_empty_record_is_quiet():
    assert tadvisor.findings(None) == []
    assert tadvisor.findings(tstore._new_record("fp-x")) == []
    assert tadvisor.broadcast_threshold() == jadvisor.broadcast_threshold()
    assert tadvisor.skew_factor() == jadvisor.skew_factor()


# -- the scheduler's ingest -------------------------------------------------

def _two_stage_plan(tmp_path, n=2_000):
    rng = np.random.default_rng(1)
    t = pa.table({"k": pa.array(rng.integers(0, 50, n), type=pa.int64()),
                  "v": pa.array(rng.random(n))})
    groups = []
    for i in range(2):
        p = str(tmp_path / f"in-{i}.parquet")
        pq.write_table(t.slice(i * n // 2, n // 2), p)
        groups.append([p])
    schema = {"fields": [
        {"name": "k", "type": {"id": "int64"}, "nullable": True},
        {"name": "v", "type": {"id": "float64"}, "nullable": True}]}
    agg = lambda mode, inp: {  # noqa: E731
        "kind": "hash_agg", "input": inp,
        "groupings": [{"expr": {"kind": "column", "index": 0},
                       "name": "k"}],
        "aggs": [{"fn": "sum", "mode": mode, "name": "s",
                  "args": [{"kind": "column", "index": 1}]}]}
    return agg("final", {
        "kind": "local_exchange", "input": agg("partial", {
            "kind": "parquet_scan", "schema": schema,
            "file_groups": groups}),
        "partitioning": {"kind": "hash", "num_partitions": 4,
                         "exprs": [{"kind": "column", "index": 0}]}})


def test_scheduler_ingests_boundaries_like_the_jax_one(tmp_path,
                                                        monkeypatch):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import DagScheduler as JDag
    from blaze_tpu_torch.plan.stages import DagScheduler
    monkeypatch.setattr(P, "host_resident", lambda: False)
    MemManager.init(4 << 30)
    dirs = _stats_on(tmp_path)
    plan = _two_stage_plan(tmp_path)
    for c in (jconf, tconf):
        c.conf.set("auron.tpu.dag.singleTaskBytes", 0)
    jconf.conf.set("auron.tpu.shuffle.device", "off")
    fps = {}
    for name, D, store in (("port", DagScheduler, tstore),
                           ("jax", JDag, jstore)):
        for i in range(2):
            sched = D(work_dir=str(tmp_path / f"{name}{i}"))
            sched.run_collect(copy.deepcopy(plan))
            assert sched.stats_fingerprint
            assert fps.get(name) in (None, sched.stats_fingerprint)
            fps[name] = sched.stats_fingerprint
    assert fps["port"] == fps["jax"]
    trec = tstore.prior(fps["port"])
    jrec = jstore.StatStore(dirs["jax"]).record(fps["jax"])
    assert trec["run_count"] == 2 and trec["wall_s"]["count"] == 2
    assert trec["stages"] and trec["stages"] == jrec["stages"]
    st = next(iter(trec["stages"].values()))
    assert st["run_count"] == 2 and sum(st["last_partition_bytes"]) > 0
    # the task durations of both runs, and a bit-stable replay
    assert trec["task_ms"]["count"] >= 2 * (2 + 4)
    again = tstore.StatStore(dirs["port"]).record(fps["port"])
    assert tstore._dumps(again) == tstore._dumps(trec)
    assert device_stats.statstore_stats()["stats_ingests"] == 2
    assert device_stats.statstore_stats()["stats_runs_merged"] == 1


def test_task_durations_past_the_reservoir_cap(tmp_path):
    """A long-lived process fills the capped task-duration reservoir; a
    run after that still ingests its own tasks' durations (the
    scheduler's sink), and the sink closes with the run."""
    from blaze_tpu_torch.plan.stages import DagScheduler
    for _ in range(device_stats._SAMPLE_CAP):
        device_stats.note_task_duration(1)
    assert len(device_stats.duration_samples()["task_ns"]) == \
        device_stats._SAMPLE_CAP
    _stats_on(tmp_path)
    tconf.conf.set("auron.tpu.dag.singleTaskBytes", 0)
    plan = _two_stage_plan(tmp_path)
    sched = DagScheduler(work_dir=str(tmp_path / "dag"))
    sched.run_collect(copy.deepcopy(plan))
    rec = tstore.prior(sched.stats_fingerprint)
    assert rec["task_ms"]["count"] == 2 + 4  # 2 map tasks, 4 reduce tasks
    assert tstore.sketch_quantile(rec["task_ms"], 0.0) > 1e-6  # not the 1s
    assert device_stats._task_sinks.open == []
