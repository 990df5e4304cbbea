"""The single-task local mode of the port (blaze_tpu_torch/plan/stages.py
`_scan_input_bytes`, `_run_single_task`, the `exec_mode` switch;
shuffle/exchange.py `LocalShuffleExchange`; the planner's
`local_exchange`) against the JAX package's (blaze_tpu/plan/stages.py,
blaze_tpu/shuffle/exchange.py) on the same plans and data: the queries'
tables at scale 0.01 from the generators, the fact tables in 2 files.
The JAX package runs with `blaze_tpu.bridge.placement.host_resident`
patched to False (its device route) and `auron.tpu.shuffle.device` off.

  * `LocalShuffleExchange` writes the JAX one's `.data`/`.index` bytes
    map task by map task (hash and single partitionings), reads back the
    same rows per reduce partition, and `cleanup()` leaves nothing;
  * `_scan_input_bytes` equals the JAX one on every query's plan;
  * the threshold's edge: scan bytes equal to
    `auron.tpu.dag.singleTaskBytes` run local, one byte more than it
    staged, and both equal the JAX runs in rows and order;
  * under the default settings q01, q42 and the new shapes q05 (Union),
    q93 (Cast) and q90 (the nested-loop join) run local in both
    packages, with the same rows in the same order, and equal their
    pandas oracles; the run's metrics are stage 0's and nothing leaks;
  * a plan the local mode cannot build raises: it never falls back to the
    staged route.

Tolerance: rows in order, floats within 1e-9 relative; bytes exact."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.breadth import LATER
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.runner import compare_frames, frame, same_order
from blaze_tpu_torch.plan.stages import DagScheduler
from blaze_tpu_torch.shuffle import LocalShuffleExchange

SCALE = 0.01
PARTS = 2
REL = 1e-9
LOCAL = ["q01", "q42", "q05", "q93", "q90"]


@pytest.fixture(autouse=True)
def confs():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


def _jax(fn, single_task_bytes=None):
    """fn(JAX DagScheduler class) on the JAX device route, with
    `auron.tpu.dag.singleTaskBytes` at its default (None) or the value
    given."""
    import blaze_tpu.bridge.placement as P
    from blaze_tpu import config as jconf
    from blaze_tpu.plan.stages import DagScheduler as JDag
    saved = P.host_resident
    P.host_resident = lambda: False
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    if single_task_bytes is not None:
        jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, single_task_bytes)
    try:
        return fn(JDag)
    finally:
        P.host_resident = saved
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
        jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)


def _jax_run(plan, single_task_bytes=None):
    """The JAX scheduler's frame and its exec_mode."""
    def go(JDag):
        sched = JDag()
        return frame(sched.run_collect(plan)), sched.exec_mode
    return _jax(go, single_task_bytes)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    names = sorted({t for q in TQ.QUERIES.values() for t in q[1]})
    tables = {n: getattr(TT, "gen_" + n)(SCALE) for n in names}
    root = tmp_path_factory.mktemp("local_mode")
    return tables, TT.write_parquet_splits(tables, str(root), PARTS)


def _plan(data, name):
    tables, paths = data
    return TQ.QUERIES[name][0](paths, tables, PARTS)


# ---------------------------------------------------------------------------
# LocalShuffleExchange
# ---------------------------------------------------------------------------

def _exchange_input(tmp_path):
    rng = np.random.default_rng(11)
    n = 3000
    t = pa.table({"k": pa.array(rng.integers(0, 50, n),
                                mask=rng.random(n) < 0.05),
                  "x": pa.array(np.round(rng.normal(size=n), 3)),
                  "s": pa.array([f"s{v}" for v in rng.integers(0, 9, n)])})
    groups = []
    for i in range(3):
        p = str(tmp_path / f"ex-{i}.parquet")
        pq.write_table(t.slice(i * 1000, 1000), p)
        groups.append([p])
    scan = {"kind": "parquet_scan", "file_groups": groups,
            "schema": {"fields": [
                {"name": "k", "type": {"id": "int64"}, "nullable": True},
                {"name": "x", "type": {"id": "float64"}, "nullable": True},
                {"name": "s", "type": {"id": "utf8"}, "nullable": True}]}}
    # a count per key: a non-null field through the exchange
    return {"kind": "hash_agg", "input": scan,
            "groupings": [{"expr": {"kind": "column", "index": 0},
                           "name": "k"}],
            "aggs": [{"fn": "count", "mode": "partial", "name": "n",
                      "args": [{"kind": "column", "index": 1}]}]}


def _partitions(ex):
    """(partition, whether it holds rows) of an exchange's output."""
    return [(p, any(b.num_rows for b in ex.arrow_batches(p)))
            for p in range(ex.num_partitions)]


@pytest.mark.parametrize("part", [
    {"kind": "hash", "exprs": [{"kind": "column", "index": 0}],
     "num_partitions": 4},
    {"kind": "single"}])
def test_local_exchange_writes_the_jax_bytes(tmp_path, part):
    from blaze_tpu.plan import create_plan as j_create
    from blaze_tpu_torch.plan import create_plan as t_create
    d = {"kind": "local_exchange", "partitioning": part,
         "input": _exchange_input(tmp_path)}
    outs = {}
    for pkg, create in (("torch", t_create), ("jax", j_create)):
        ex = create(d) if pkg == "torch" else _jax(lambda _J: create(d))
        rows = [pa.Table.from_batches(list(ex.arrow_batches(p)) or [],
                                      schema=None if p_has else
                                      ex.schema.to_arrow())
                for p, p_has in _partitions(ex)]
        files = []
        for data, _offsets in ex._map_outputs:
            with open(data, "rb") as f, \
                    open(data[:-5] + ".index", "rb") as g:
                files.append((f.read(), g.read()))
        outs[pkg] = (ex, rows, files)
    (tex, trows, tfiles), (jex, jrows, jfiles) = outs["torch"], outs["jax"]
    assert isinstance(tex, LocalShuffleExchange)
    assert len(tfiles) == 3 and tfiles == jfiles
    for got, want in zip(trows, jrows):
        assert got.num_rows == want.num_rows
        assert got.equals(want)
    assert sum(t.num_rows for t in trows) == 153  # 3 maps x (50 keys, null)
    kept = [p for d_, _ in tex._map_outputs for p in (d_, d_[:-5] +
                                                      ".index")]
    tex.cleanup()
    jex.cleanup()
    assert not any(os.path.exists(p) for p in kept)
    assert tex._dir is None and not tex._map_outputs


# ---------------------------------------------------------------------------
# the switch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TQ.QUERIES))
def test_scan_input_bytes_equal_the_jax_ones(data, name):
    from blaze_tpu.plan.stages import DagScheduler as JDag
    plan, _ = _plan(data, name)
    got = DagScheduler._scan_input_bytes(plan)
    assert got == JDag._scan_input_bytes(plan)
    assert 0 < got < 64 << 20


def test_the_threshold_edge(data):
    plan, oracle = _plan(data, "q42")
    b = DagScheduler._scan_input_bytes(plan)
    runs = {}
    for threshold, mode in ((b, "local"), (b - 1, "staged")):
        tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, threshold)
        sched = DagScheduler()
        got = frame(sched.run_collect(_plan(data, "q42")[0]))
        want, jmode = _jax_run(_plan(data, "q42")[0], threshold)
        assert sched.exec_mode == jmode == mode
        assert same_order(got, want, REL) is None
        runs[mode] = got
    assert same_order(runs["local"], runs["staged"], REL) is None
    assert compare_frames(runs["local"], oracle(), REL) is None


@pytest.mark.parametrize("name", LOCAL)
def test_default_settings_equal_the_jax_local_mode(data, name):
    plan, oracle = _plan(data, name)
    want, jmode = _jax_run(_plan(data, name)[0])
    sched = DagScheduler()
    got = frame(sched.run_collect(plan))
    assert sched.exec_mode == jmode == "local"
    assert sched.stages == [] and list(sched.stage_metrics) == [0]
    assert len(got) > 0
    assert same_order(got, want, REL) is None
    assert compare_frames(got, oracle(), REL) is None
    counters = stage_counters(sched, ("cpu_batches", "io_bytes"))[0]
    assert counters["cpu_batches"] > 0 and counters["io_bytes"] > 0
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def test_local_and_staged_give_the_same_rows(data):
    """q05's union and the exchanges around it, the same query both ways
    in the port."""
    local = frame(DagScheduler().run_collect(_plan(data, "q05")[0]))
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = DagScheduler()
    staged = frame(sched.run_collect(_plan(data, "q05")[0]))
    assert sched.exec_mode == "staged" and len(sched.stages) > 1
    assert same_order(local, staged, REL) is None


@pytest.mark.parametrize("name", sorted(LATER))
def test_the_local_mode_never_falls_back(data, name):
    sched = DagScheduler()
    with pytest.raises(NotImplementedError, match=LATER[name]):
        sched.run_collect(_plan(data, name)[0])
    assert sched.exec_mode == "local" and sched.stages == []
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}
