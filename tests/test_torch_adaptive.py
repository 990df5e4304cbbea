"""The port's adaptive execution (blaze_tpu_torch/plan/adaptive.py, the
scheduler's hooks in plan/stages.py, the explain footer) against the JAX
package's (blaze_tpu/plan/adaptive.py) on the same plans and data, at
tests/test_adaptive.py's sizes (a 200-key dim, 40,000 fact rows, 30,000
aggregated rows):

  * each runtime rule (broadcast switch, skew split with its composed
    coalesce, partition coalescing) gives the JAX run's `aqe_events`
    (rule, stage, task count, derived fingerprint and every detail) and
    counter deltas, a result equal to the static run's and the JAX run's,
    and the rewritten stage's map-output bytes equal to the JAX ones (a
    hash exchange above the rewritten node makes it a producer);
  * the disabled path: `seed_plan` returns the same object, no counter
    moves, no event, 3 stages and the JAX map bytes;
  * lineage recovery through a rewritten stage (itest/q01_dag.py
    `CorruptingScheduler` poisons one committed map output): exactly one
    map task runs twice and the result equals the static one;
  * the history seed, cold against warm, equal to the JAX runs (events,
    deltas, the stored boundaries); an empty or corrupted store, or a
    failing prior, falls back to the static plan;
  * the bind-time seeds (unified partitions across a join, the agg skip
    hint) equal the JAX package's seeded plans;
  * the repair of the wire's partial-skip hint: a TaskDefinition with
    `supports_partial_skipping` set writes the JAX map bytes, on the
    generic AggExec (which honours it: one probe-less skip) and on the
    fused lane (which ignores it, as the JAX one does);
  * the counters, span names and explain footer.

The JAX scheduler runs on its device route (`host_resident` patched to
False, `auron.tpu.shuffle.device` off); both schedulers' run ids are
pinned, so their stage resource ids and hence derived fingerprints agree.
Both packages' counter registries and conf probes are reset around every
test and every store lives in the test's own directory, so no test
depends on what ran before it in its worker.  Tolerance: exact."""

import copy
import hashlib
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu.bridge import xla_stats
from blaze_tpu.plan import adaptive as jadaptive
from blaze_tpu.plan import advisor as jadvisor
from blaze_tpu.plan import statstore as jstore
from blaze_tpu.plan.stages import DagScheduler as JDag
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import device_stats, tracing
from blaze_tpu_torch.itest.q01_dag import CorruptingScheduler
from blaze_tpu_torch.plan import adaptive as tadaptive
from blaze_tpu_torch.plan import advisor as tadvisor
from blaze_tpu_torch.plan import statstore as tstore
from blaze_tpu_torch.plan.stages import DagScheduler

BATCH = 4096
RUN_ID = "aqetest01"
_KEYS = ("auron.tpu.aqe.enable", "auron.tpu.aqe.broadcastThreshold",
         "auron.tpu.aqe.coalesceTargetBytes", "auron.tpu.aqe.skewFactor",
         "auron.tpu.aqe.skewMaxSplits", "auron.tpu.aqe.historySeed",
         "auron.tpu.stats.enable", "auron.tpu.stats.dir",
         "auron.tpu.task.backoff")


def _reset():
    for c in (jconf, tconf):
        for k in _KEYS:
            c.conf.unset(k)
    for m in (jadaptive, jstore, tadaptive, tstore):
        m.reset_conf_probe()
    xla_stats.reset()
    device_stats.reset()


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    _reset()
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    for c in (jconf, tconf):
        c.conf.set("auron.tpu.dag.singleTaskBytes", 0)
        c.conf.set("auron.batch.size", BATCH)
    yield
    _reset()
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset("auron.tpu.dag.singleTaskBytes")
        c.conf.unset("auron.batch.size")


def _set(**conf):
    """The same keys in both packages, their probes re-read."""
    for c in (jconf, tconf):
        for k, v in conf.items():
            c.conf.set(k, v)
    for m in (jadaptive, jstore, tadaptive, tstore):
        m.reset_conf_probe()


AQE = {"auron.tpu.aqe.enable": "true"}
SKEW = dict(AQE, **{"auron.tpu.aqe.broadcastThreshold": 0})  # past rule 1
#: the skew tests' factor: the JAX package's key, the port's constant
SKEW_FACTOR = 2.0


def _skew_factor(monkeypatch):
    jconf.conf.set("auron.tpu.aqe.skewFactor", SKEW_FACTOR)
    monkeypatch.setattr(tadvisor, "SKEW_FACTOR", SKEW_FACTOR)


def _stats_conf(tmp_path, tag):
    return {"auron.tpu.stats.enable": "true",
            "auron.tpu.stats.dir": str(tmp_path / f"stats-{tag}"),
            "auron.tpu.aqe.historySeed": "true"}


# -- plans (tests/test_adaptive.py's) ---------------------------------------

_SCHEMA = lambda a, b: {"fields": [  # noqa: E731
    {"name": a, "type": {"id": "int64"}, "nullable": True},
    {"name": b, "type": {"id": "float64"}, "nullable": True}]}


def _write_splits(tmp_path, name, t, nsplit):
    paths = []
    step = -(-t.num_rows // nsplit)
    for i in range(nsplit):
        p = str(tmp_path / f"{name}-{i}.parquet")
        if not os.path.exists(p):
            pq.write_table(t.slice(i * step, step), p)
        paths.append([p])
    return paths


def _exchange(inp, nparts):
    return {"kind": "local_exchange",
            "partitioning": {"kind": "hash",
                             "exprs": [{"kind": "column", "index": 0}],
                             "num_partitions": nparts},
            "input": inp}


def _scan(schema, groups):
    return {"kind": "parquet_scan", "schema": schema, "file_groups": groups}


def _join_plan(tmp_path, nparts=8, skewed=False, seed=3):
    """dim (small, the BUILD side, left) shuffle-joined with fact; with
    `skewed`, ~70% of the fact rows share one key."""
    rng = np.random.default_rng(seed)
    n = 40_000
    if skewed:
        keys = np.where(rng.random(n) < 0.7, 0,
                        rng.integers(1, 200, n)).astype(np.int64)
    else:
        keys = rng.integers(0, 200, n).astype(np.int64)
    fact = pa.table({"k": pa.array(keys), "v": pa.array(rng.random(n))})
    dim = pa.table({"k": pa.array(np.arange(200, dtype=np.int64)),
                    "w": pa.array(rng.random(200))})
    tag = "skew" if skewed else "unif"
    return {"kind": "hash_join", "join_type": "inner",
            "left": _exchange(_scan(_SCHEMA("k", "w"), _write_splits(
                tmp_path, f"dim-{tag}", dim, 2)), nparts),
            "right": _exchange(_scan(_SCHEMA("k", "v"), _write_splits(
                tmp_path, f"fact-{tag}", fact, 4)), nparts),
            "left_keys": [{"kind": "column", "index": 0}],
            "right_keys": [{"kind": "column", "index": 0}],
            "build_side": "left"}


def _agg_plan(tmp_path, nparts=16, seed=5):
    rng = np.random.default_rng(seed)
    n = 30_000
    t = pa.table({"k": pa.array(rng.integers(0, 500, n), type=pa.int64()),
                  "v": pa.array(rng.random(n))})
    return {"kind": "hash_agg",
            "groupings": [{"expr": {"kind": "column", "index": 0},
                           "name": "k"}],
            "aggs": [{"fn": "sum", "mode": "final", "name": "s",
                      "args": [{"kind": "column", "index": 1}]}],
            "input": _exchange({
                "kind": "hash_agg",
                "groupings": [{"expr": {"kind": "column", "name": "k"},
                               "name": "k"}],
                "aggs": [{"fn": "sum", "mode": "partial", "name": "s",
                          "args": [{"kind": "column", "name": "v"}]}],
                "input": _scan(_SCHEMA("k", "v"),
                               _write_splits(tmp_path, "in", t, 2))},
                nparts)}


def _canon(t):
    """Order-insensitive frame: a rewrite changes task counts, and so
    the order rows arrive in."""
    df = t.to_pandas().set_axis(range(t.num_columns), axis=1)
    return df.sort_values(list(df.columns)).reset_index(drop=True)


# -- running one plan in both packages --------------------------------------

def _recording(base):
    """A scheduler that keeps the sha256 of each committed map output."""
    class Recording(base):
        def _run_producer_file(self, stage):
            super()._run_producer_file(stage)
            self.map_bytes = getattr(self, "map_bytes", {})
            self.map_bytes[stage.sid] = [
                hashlib.sha256(open(d, "rb").read()[:int(off[-1])])
                .hexdigest()
                for _m, (d, off) in sorted(
                    self._stage_outputs[stage.sid].items())]
    return Recording


TDag, JRec = _recording(DagScheduler), _recording(JDag)


def _run(D, plan, tmp_path, tag, stats):
    sched = D(work_dir=str(tmp_path / f"dag-{tag}"))
    sched._run_id = RUN_ID
    before = stats.aqe_stats()
    out = sched.run_collect(copy.deepcopy(plan))
    after = stats.aqe_stats()
    return out, sched, {k: after[k] - before[k]
                        for k in after if after[k] != before[k]}


def _port(plan, tmp_path, tag):
    return _run(TDag, plan, tmp_path, f"t-{tag}", device_stats)


def _jax(plan, tmp_path, tag):
    return _run(JRec, plan, tmp_path, f"j-{tag}", xla_stats)


def _both(plan, tmp_path, tag):
    """(port, jax) runs of `plan` under the conf set now."""
    return _port(plan, tmp_path, tag), _jax(plan, tmp_path, tag)


def _over(node):
    """A hash exchange above `node`: the node's stage becomes a producer
    whose map output the tests compare, read back whole by the result."""
    return _exchange(node, 4)


# -- the disabled path ------------------------------------------------------

OPTIONS = ("STATS_ENABLE", "STATS_DIR", "AQE_ENABLE", "AQE_HISTORY_SEED",
           "HISTORY_DIR")


@pytest.mark.parametrize("name", OPTIONS)
def test_knob_equals_the_jax_one(name):
    t, j = getattr(tconf, name), getattr(jconf, name)
    assert (t.key, t.default, t.get()) == (j.key, j.default, j.get())


def test_the_broadcast_threshold_is_the_jax_one():
    """The port's one key holds the default the JAX package's -1
    inherits from its advisor key."""
    t, j = tconf.AQE_BROADCAST_THRESHOLD, jconf.AQE_BROADCAST_THRESHOLD
    assert t.key == j.key and j.default == -1
    assert t.default == jconf.STATS_ADVISOR_BROADCAST_BYTES.default
    assert tadvisor.broadcast_threshold() == jadvisor.broadcast_threshold()


#: the port's fixed thresholds, each the default of the JAX package's key
CONSTANTS = {"coalesce target": (tadaptive, "COALESCE_TARGET_BYTES",
                                 "AQE_COALESCE_TARGET"),
             "skew splits": (tadaptive, "SKEW_MAX_SPLITS",
                             "AQE_SKEW_MAX_SPLITS"),
             "skew factor": (tadvisor, "SKEW_FACTOR",
                             "STATS_ADVISOR_SKEW_FACTOR"),
             "sketch centroids": (tstore, "SKETCH_CENTROIDS",
                                  "STATS_SKETCH_CENTROIDS"),
             "fingerprints kept": (tstore, "MAX_FINGERPRINTS",
                                   "STATS_MAX_FINGERPRINTS")}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_constant_equals_the_jax_default(name):
    mod, attr, key = CONSTANTS[name]
    assert getattr(mod, attr) == getattr(jconf, key).default
    assert getattr(mod, attr) == getattr(jconf, key).get()
    assert not hasattr(tconf, key)  # a constant, no key in the port


def test_knobs_default_off():
    assert not tadaptive.enabled()
    assert not tadaptive.history_seed_enabled()
    assert tadaptive.runtime_for(object()) is None
    assert not tstore.enabled()
    assert "auron.tpu.aqe.enable" not in tconf.UNPORTED_SCHEDULER_KEYS
    assert "auron.tpu.stats.enable" not in tconf.UNPORTED_SCHEDULER_KEYS
    assert "auron.tpu.history.enable" in tconf.UNPORTED_SCHEDULER_KEYS


def test_disabled_path_untouched(tmp_path):
    plan = _join_plan(tmp_path)
    assert tadaptive.seed_plan(plan) is plan  # the same object, no copy
    (got, sched, delta), (jgot, jsched, _) = _both(plan, tmp_path, "off")
    assert delta == {}
    assert device_stats.statstore_stats()["stats_ingests"] == 0
    assert sched.aqe_events == [] and sched.stats_fingerprint is None
    assert all(st.aqe is None for st in sched.stages)
    assert len(sched.stages) == 3  # 2 producers + the result
    assert sched.map_bytes == jsched.map_bytes
    assert _canon(got).equals(_canon(jgot))


# -- the three runtime rules ------------------------------------------------

def _rule_plan(tmp_path, rule):
    if rule == "broadcast":
        return _over(_join_plan(tmp_path)), AQE
    if rule == "skew_split":
        return _over(_join_plan(tmp_path, skewed=True)), SKEW
    return _over(_agg_plan(tmp_path)), AQE


@pytest.mark.parametrize("rule", ["broadcast", "skew_split", "coalesce"])
def test_rule_equals_the_jax_run(tmp_path, monkeypatch, rule):
    plan, conf = _rule_plan(tmp_path, rule)
    static, s0, _ = _port(plan, tmp_path, "static")
    _set(**conf)
    if rule == "skew_split":
        _skew_factor(monkeypatch)
    (got, sched, delta), (jgot, jsched, jdelta) = _both(plan, tmp_path,
                                                        "aqe")
    assert sched.aqe_events == jsched.aqe_events
    assert delta == jdelta
    # the first event rewrote the node under the top exchange (the
    # result stage above it may coalesce the exchange's 4 partitions too)
    ev = sched.aqe_events[0]
    assert ev["rule"] == rule
    c = sched.stages[ev["stage"]]
    assert c.aqe["rule"] == rule and c.aqe["fingerprint"] == ev["fingerprint"]
    assert c.partitioning is not None  # a producer: its bytes compared
    assert sched.map_bytes[c.sid] == jsched.map_bytes[c.sid]
    assert sched.map_bytes == jsched.map_bytes
    assert _canon(got).equals(_canon(static))
    assert _canon(got).equals(_canon(jgot))
    if rule == "broadcast":
        assert delta["aqe_broadcast_switches"] == 1
        assert delta["aqe_stages_elided"] == 1
        assert delta["aqe_bytes_saved"] > 0
        assert ev["elided_stage"] not in sched.map_bytes  # never ran
    elif rule == "skew_split":
        assert delta["aqe_skew_splits"] == 1 and ev["splits"] >= 2
        assert delta["aqe_partitions_coalesced"] > 0
        assert c.num_tasks != s0.stages[c.sid].num_tasks
    else:
        assert ev["partitions"] == 16 and c.num_tasks == 1
    # no scheduler leaks, the derived registrations included
    assert all(not v for v in sched.leak_report().values())


def test_coalesce_of_the_result_stage(tmp_path):
    """tests/test_adaptive.py's shape: the result stage itself coalesced
    into one task (15 partitions folded)."""
    plan = _agg_plan(tmp_path)
    static, _, _ = _port(plan, tmp_path, "static")
    _set(**AQE)
    (got, sched, delta), (_, jsched, jdelta) = _both(plan, tmp_path, "aqe")
    assert delta == jdelta == {"aqe_rewrites": 1,
                               "aqe_partitions_coalesced": 15}
    assert sched.aqe_events == jsched.aqe_events
    assert sched.stages[-1].num_tasks == 1
    assert sched.stages[-1].aqe["rule"] == "coalesce"
    assert _canon(got).equals(_canon(static))


# -- lineage recovery through a rewritten stage -----------------------------

@pytest.mark.parametrize("side", ["build", "probe"])
def test_rewrite_survives_lineage_recovery(tmp_path, monkeypatch, side):
    """One committed map output of the dim (build) or fact (probe) stage
    poisoned: the skew-split consumer's derived readers raise a
    FetchFailedError naming the original producer map task, recovery
    re-runs exactly that task, and the result equals the static one."""
    plan = _join_plan(tmp_path, skewed=True)
    static, _, _ = _port(plan, tmp_path, "static")
    _set(**SKEW, **{"auron.tpu.task.backoff": 1})
    _skew_factor(monkeypatch)
    sid = 0 if side == "build" else 1
    sched = CorruptingScheduler(sid, work_dir=str(tmp_path / "dag-c"))
    got = sched.run_collect(copy.deepcopy(plan))
    assert sched.corrupted_at is not None
    assert any(e["rule"] == "skew_split" for e in sched.aqe_events)
    assert sched.task_runs[(sid, sched.map_id)] == 2
    assert sum(n for n in sched.task_runs.values() if n > 1) == 2
    assert device_stats.snapshot()["stage_recoveries"] == 1
    assert _canon(got).equals(_canon(static))
    assert all(not v for v in sched.leak_report().values())


# -- history-seeded planning ------------------------------------------------

def test_history_seed_cold_vs_warm(tmp_path):
    plan = _join_plan(tmp_path)
    static, _, _ = _port(plan, tmp_path, "static")
    runs = {}
    for name, run, tag in (("port", _port, "t"), ("jax", _jax, "j")):
        _set(**AQE, **_stats_conf(tmp_path, tag))
        # cold: no prior, no seed; the runtime broadcast still fires and
        # the build boundary lands in the store
        cold = run(plan, tmp_path, "cold")
        # warm: the prior pre-broadcasts the build at bind time, both
        # exchanges spliced out
        warm = run(plan, tmp_path, "warm")
        rec = (tstore if name == "port" else jstore).StatStore(
            str(tmp_path / f"stats-{tag}")).record(cold[1].stats_fingerprint)
        runs[name] = (cold, warm, rec)
    (tcold, twarm, trec), (jcold, jwarm, jrec) = runs["port"], runs["jax"]
    assert not any(str(e.get("rule", "")).startswith("seed_")
                   for e in tcold[1].aqe_events)
    assert len(tcold[1].stages) == 3
    seeds = [e for e in twarm[1].aqe_events if e["rule"] == "seed_broadcast"]
    assert len(seeds) == 1 and seeds[0]["stage"] is None
    assert twarm[2].get("aqe_history_seeds") == 1
    assert len(twarm[1].stages) < len(tcold[1].stages)
    for t, j in ((tcold, jcold), (twarm, jwarm)):
        assert t[1].aqe_events == j[1].aqe_events
        assert t[2] == j[2]
        assert t[1].stats_fingerprint == j[1].stats_fingerprint
        assert _canon(t[0]).equals(_canon(static))
        assert _canon(t[0]).equals(_canon(j[0]))
    assert trec["run_count"] == 2
    assert trec["stages"] == jrec["stages"]


def test_empty_and_corrupted_statstore_fall_back(tmp_path):
    plan = _join_plan(tmp_path)
    _set(**AQE, **_stats_conf(tmp_path, "t"))
    got1, s1, _ = _port(plan, tmp_path, "empty")
    assert len(s1.stages) == 3
    sdir = str(tmp_path / "stats-t")
    assert os.listdir(sdir)
    for name in os.listdir(sdir):  # corrupt every record in place
        with open(os.path.join(sdir, name), "w") as f:
            f.write("{not json")
    got2, s2, delta = _port(plan, tmp_path, "corrupt")
    assert not any(str(e.get("rule", "")).startswith("seed_")
                   for e in s2.aqe_events)
    assert "aqe_history_seeds" not in delta
    assert len(s2.stages) == 3
    assert _canon(got2).equals(_canon(got1))


def test_seed_plan_exception_falls_back(tmp_path, monkeypatch):
    _set(**AQE, **_stats_conf(tmp_path, "t"))
    monkeypatch.setattr(tstore, "prior",
                        lambda fp: (_ for _ in ()).throw(RuntimeError()))
    plan = _join_plan(tmp_path)
    assert tadaptive.seed_plan(plan) is plan


def test_seed_partitions_unified_across_join(tmp_path, monkeypatch):
    """History says both join inputs are tiny: both exchanges shrink to
    one unified count, as in the JAX seeded plan."""
    plan = _join_plan(tmp_path, nparts=8)
    _set(**AQE, **_stats_conf(tmp_path, "t"),
         **{"auron.tpu.aqe.broadcastThreshold": 0})
    sfps = [tadaptive._exchange_sfp(plan[s]) for s in ("left", "right")]
    assert sfps == [jadaptive._exchange_sfp(plan[s])
                    for s in ("left", "right")]
    sk = tstore.sketch_add(tstore.sketch_new(), [1 << 20])  # 1 MiB p50
    prior = {"stages": {sfp: {"sid": i, "partitions": 8,
                              "total_bytes": copy.deepcopy(sk)}
                        for i, sfp in enumerate(sfps)}}
    monkeypatch.setattr(tstore, "prior", lambda fp: prior)
    monkeypatch.setattr(jstore, "prior", lambda fp: prior)
    seeded = tadaptive.seed_plan(copy.deepcopy(plan))
    assert seeded == jadaptive.seed_plan(copy.deepcopy(plan))
    assert seeded["left"]["partitioning"]["num_partitions"] == 1
    assert seeded["right"]["partitioning"]["num_partitions"] == 1


def test_seed_agg_skip_threads_the_hint_to_exec(tmp_path, monkeypatch):
    from blaze_tpu_torch.plan import create_plan
    plan = _agg_plan(tmp_path)
    _set(**AQE, **_stats_conf(tmp_path, "t"))
    prior = {"derived": {"agg_probe_ratio": 0.97}}
    monkeypatch.setattr(tstore, "prior", lambda fp: prior)
    monkeypatch.setattr(jstore, "prior", lambda fp: prior)
    seeded = tadaptive.seed_plan(copy.deepcopy(plan))
    assert seeded == jadaptive.seed_plan(copy.deepcopy(plan))
    partial = seeded["input"]["input"]
    assert partial["supports_partial_skipping"] is True
    assert not seeded.get("supports_partial_skipping")  # final mode
    assert create_plan(partial).skip_partial_hint is True
    assert create_plan(plan["input"]["input"]).skip_partial_hint is False


# -- the repair: the wire's partial-skip hint -------------------------------

def _hint_td(tmp_path, fn, hint, n=20_000):
    """One map task over the wire: a partial `fn` by key (200 keys) over
    a scan, through a hash shuffle writer into 4 partitions."""
    rng = np.random.default_rng(9)
    t = pa.table({"k": pa.array(rng.integers(0, 200, n), type=pa.int64()),
                  "v": pa.array(rng.random(n))})
    (path,) = _write_splits(tmp_path, "hint", t, 1)
    agg = {"kind": "hash_agg",
           "groupings": [{"expr": {"kind": "column", "index": 0},
                          "name": "k"}],
           "aggs": [{"fn": fn, "mode": "partial", "name": "a",
                     "args": [{"kind": "column", "index": 1}]}],
           "input": _scan(_SCHEMA("k", "v"), [path])}
    if hint:
        agg["supports_partial_skipping"] = True
    data = str(tmp_path / f"hint-{fn}-{hint}.data")
    return {"stage_id": 0, "partition_id": 0, "num_partitions": 1,
            "task_attempt_id": 0,
            "plan": {"kind": "shuffle_writer", "input": agg,
                     "partitioning": {"kind": "hash", "num_partitions": 4,
                                      "exprs": [{"kind": "column",
                                                 "index": 0}]},
                     "data_file": data, "index_file": data[:-5] + ".index"}}


def _run_td(runtime, td):
    rt = runtime(td).start()
    for _ in rt.batches():
        pass
    return rt.finalize()


def _names_and_values(tree):
    out = [(tree.name, dict(tree.values))]
    for c in tree.children:
        out.extend(_names_and_values(c))
    return out


@pytest.mark.parametrize("fn,route", [("avg", "AggExec"),
                                      ("sum", "FusedPartialAggExec")])
@pytest.mark.parametrize("hint", [False, True])
def test_the_wire_hint_gives_the_jax_map_bytes(tmp_path, fn, route, hint):
    from blaze_tpu.bridge.runtime import NativeExecutionRuntime as JRt
    from blaze_tpu.plan.proto_serde import task_definition_to_bytes as j_enc
    from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime as TRt
    from blaze_tpu_torch.plan.proto_serde import \
        task_definition_to_bytes as t_enc
    td = _hint_td(tmp_path, fn, hint)
    wire = t_enc(td)
    assert wire == j_enc(td)
    files = {}
    for name, rt in (("jax", JRt), ("port", TRt)):
        tree = _run_td(rt, wire)
        data = td["plan"]["data_file"]
        files[name] = (open(data, "rb").read(),
                       open(data[:-5] + ".index", "rb").read())
        if name == "port":
            nodes = _names_and_values(tree)
    assert files["port"] == files["jax"]
    (agg,) = [v for n, v in nodes if n == route]
    if route == "AggExec":
        # honoured: pass-through from the first batch, no probe window
        # (20,000 rows never reach the 50,000-row probe without it)
        assert agg.get("partial_skipped", 0) == int(hint)
    else:
        assert not any(n == "AggExec" for n, _ in nodes)


# -- counters, spans, explain -----------------------------------------------

def test_families_and_snapshot_hold_the_jax_keys():
    fams, jfams = device_stats.counter_families(), xla_stats.counter_families()
    assert fams["aqe"] == jfams["aqe"]
    assert fams["stats"] == jfams["stats"]
    device_stats.note_aqe(rewrites=2, bytes_saved=10, nonsense=3)
    device_stats.note_stats(fingerprints_last=5)
    device_stats.note_stats(fingerprints_last=4)
    snap = device_stats.snapshot()
    assert snap["aqe_rewrites"] == 2 and snap["aqe_bytes_saved"] == 10
    assert snap["stats_fingerprints_last"] == 4  # a gauge: set, not added
    assert "nonsense" not in snap and "aqe_nonsense" not in snap
    from blaze_tpu_torch.bridge import profiling
    body = profiling.prometheus_text()
    assert "blaze_aqe_rewrites_total 2" in body
    assert "blaze_stats_fingerprints 4" in body


FOOTERS = [{}, {"aqe_rewrites": 0, "aqe_history_seeds": 0},
           {"aqe_rewrites": 2, "aqe_skew_splits": 1,
            "aqe_bytes_saved": 2048},
           {"aqe_history_seeds": 1},
           {"aqe_rewrites": 1, "aqe_broadcast_switches": 1,
            "aqe_stages_elided": 1, "aqe_bytes_saved": 3 << 20}]


@pytest.mark.parametrize("i", range(len(FOOTERS)))
def test_aqe_footer_equals_the_jax_one(i):
    from blaze_tpu.plan.explain import format_aqe_footer as jfoot
    from blaze_tpu_torch.plan.explain import format_aqe_footer as tfoot
    assert tfoot(FOOTERS[i]) == jfoot(FOOTERS[i])
    if i == 2:
        line = tfoot(FOOTERS[i])
        assert line.startswith("aqe: rewrites=2")
        assert "skew_splits=1" in line and "saved=2.0KiB" in line


def test_explain_analyze_renders_the_aqe_footer(tmp_path):
    from blaze_tpu_torch.plan.explain import explain_analyze
    plan = _agg_plan(tmp_path)
    _set(**AQE)
    prof = explain_analyze(plan, record=False)
    assert prof.counters["aqe_partitions_coalesced"] == 15
    assert "aqe: rewrites=1 broadcast=0 coalesced=15" in prof.render_text()
    _set(**{"auron.tpu.aqe.enable": "false"})
    assert "aqe:" not in explain_analyze(plan, record=False).render_text()


def test_aqe_instants_when_tracing(tmp_path):
    """A rewrite emits `aqe_rewrite`, a seeded bind `aqe_history_seed`."""
    tracing.start_tracing()
    try:
        _set(**AQE)
        _port(_join_plan(tmp_path), tmp_path, "span-bc")
        rewrites = [s for s in tracing.spans() if s["name"] == "aqe_rewrite"]
        assert rewrites and rewrites[0]["attrs"]["rule"] == "broadcast"
        _set(**_stats_conf(tmp_path, "t"))
        _port(_join_plan(tmp_path), tmp_path, "span-cold")
        _port(_join_plan(tmp_path), tmp_path, "span-warm")
        seeds = [s for s in tracing.spans()
                 if s["name"] == "aqe_history_seed"]
        assert seeds and seeds[0]["attrs"]["seeds"] >= 1
    finally:
        tracing.stop_tracing()
        with tracing._lock:
            tracing._spans.clear()
        tracing.reset_conf_probe()


# -- the chip phase's legs, small -------------------------------------------

@pytest.fixture(scope="module")
def legs_data(tmp_path_factory):
    from blaze_tpu_torch.itest import adaptive as A
    root = tmp_path_factory.mktemp("legs")
    return A.make_data(str(root), rows_log2=14), root


@pytest.mark.parametrize("leg", ["broadcast", "skew", "coalesce", "history"])
def test_the_chip_legs_at_a_small_size(legs_data, tmp_path, leg):
    """itest/adaptive.py's legs at 2^14 fact rows: each adaptive run
    equals its static run and its pandas oracle and moves its counters."""
    from blaze_tpu_torch.itest import adaptive as A
    data, _root = legs_data
    r = A.run_leg(leg, data, str(tmp_path))
    assert r["failures"] == []
    last = r["adaptive"][-1]
    assert sum(last["tasks"].values()) < sum(r["static"]["tasks"].values())
    if leg != "coalesce":
        assert any(f["kind"] == "broadcast_candidate" for f in r["findings"])
    # the traced run's bottleneck report reaches the advisor, whose
    # findings are the JAX advisor's for the same record and report
    from blaze_tpu_torch.bridge import critical_path
    bn = last["bottleneck"]
    assert bn["dominant"] in critical_path.CATEGORIES and bn["wall_s"] > 0
    rec = tstore.StatStore(r["stats_dir"]).record(last["fingerprint"])
    assert r["findings"] == jadvisor.findings(rec, bn)
    big = dict(bn, dominant_fraction=max(bn["dominant_fraction"], 0.5))
    assert any(f["kind"] == "dominant_bottleneck" for f in
               A.findings(r["stats_dir"], last["fingerprint"], big))


def test_a_failing_rule_is_logged_and_fails_the_leg(tmp_path, monkeypatch):
    """A rule that raises leaves the static plan and logs a warning,
    which itest/adaptive.py's run counts as a failure."""
    from blaze_tpu_torch.itest import adaptive as A

    def boom(*_a, **_k):
        raise RuntimeError("rule fault")
    monkeypatch.setattr(tadaptive.AqeRuntime, "_try_broadcast", boom)
    plan = _join_plan(tmp_path)
    static, _, _ = _port(plan, tmp_path, "static")
    r = A.run_plan(plan, AQE, str(tmp_path / "dag-boom"))
    assert r["events"] == [] and r["stages"] == 3
    assert r["warnings"] and "rewrite evaluation failed" in r["warnings"][0]
    assert _canon(r["table"]).equals(_canon(static))
