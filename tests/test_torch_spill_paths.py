"""The port's spilling operators and paths against the JAX package's
under the same memory budgets (the JAX tests' budgets): rows, order,
spill counts and shuffle bytes.

  * `SortExec` at 200,000 bytes (test_ops_basic.py), without and with a
    fetch: the same rows in the same order and the same `spill_count`;
  * the generic `AggExec` at 150,000 bytes (test_agg.py) and utf8 keys
    at 512 KiB (its dictionaries charged, through `create_plan` over a
    parquet file); skip-on-spill on, off, and interleaved with the
    cardinality probe (test_partial_agg_skip.py);
  * the window buffer at 64 KiB (test_window_generate.py): the buffer's
    own `spill_count` equals the JAX buffer's and is not zero;
  * `ShuffleWriterExec` at 200,000 bytes (test_shuffle.py): `.data` and
    `.index` equal the JAX writer's byte for byte, one partition streams
    and never spills, and `close()` leaves no spill file, also when the
    child fails after a spill;
  * full TPC-DS q01 through `DagScheduler` at scale 0.2 at 256 KiB
    (test_integration_tpcds.py), where nothing spills, and at 64 KiB,
    where the writers and the sort do: every map output's bytes and the
    managers' totals equal the JAX run's, and the rows equal the oracle;
  * q95 and q51 at scale 0.02 under 32 KiB, where both spill: rows equal
    the JAX run and the pandas frame, and map bytes and totals the JAX
    run's;
  * `itest/breadth.py --budget-mb 0` reports each query's spills, by
    consumer, counted from zero per query.

The JAX package is deterministic under a budget only when it runs
serially and synchronously, so its side runs with the device route
pinned (`blaze_tpu.bridge.placement.host_resident` patched to False),
`blaze_tpu.bridge.tasks.default_task_parallelism` patched to return 1
and `auron.tpu.io.prefetch` false: its ShuffleWriterExec would otherwise
pull its child on a prefetch thread, and its device route gives each task
its own thread.  All three are patches of the test; the port runs a
wave's tasks one at a time and has no prefetcher.

Both managers are process-wide singletons; every test restores both to
4 GiB.  Tolerance: exact, but floats of q95/q51 within 1e-9 relative."""

import contextlib
import glob
import os
import tempfile

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.memory import MemManager as JManager
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.memory import MemManager as TManager

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    JManager.init(4 << 30)
    TManager.init(4 << 30)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        for k in (c.BATCH_SIZE.key, c.DAG_SINGLE_TASK_BYTES.key,
                  "auron.tpu.partialAgg.skipping.onSpill",
                  "auron.tpu.partialAgg.skipping.ratio",
                  "auron.tpu.partialAgg.skipping.minRows",
                  "auron.tpu.partialAgg.skipping.enable"):
            c.conf.unset(k)


@contextlib.contextmanager
def jax_serial():
    """The JAX package serial and synchronous: device route, one task at
    a time, no prefetch thread."""
    import blaze_tpu.bridge.placement as P
    import blaze_tpu.bridge.tasks as JT
    saved = P.host_resident, JT.default_task_parallelism
    P.host_resident = lambda: False
    JT.default_task_parallelism = lambda n: 1
    jconf.conf.set("auron.tpu.io.prefetch", "false")
    try:
        yield
    finally:
        P.host_resident, JT.default_task_parallelism = saved
        jconf.conf.unset("auron.tpu.io.prefetch")


def _budget(nbytes):
    JManager.init(nbytes)
    TManager.init(nbytes)


def _set(**kv):
    for c in (jconf, tconf):
        for k, v in kv.items():
            c.conf.set(k, v)


def _totals(m):
    return (m.total_spill_count, m.total_spilled_bytes,
            m.total_pressure_releases, m.peak_used)


def _scans(t, batch_rows):
    from blaze_tpu.ops.scan import MemoryScanExec as JScan
    from blaze_tpu_torch.ops.scan import MemoryScanExec as TScan
    return (JScan.from_arrow(t, batch_rows=batch_rows),
            TScan.from_arrow(t, batch_rows=batch_rows))


def _collect(plan, pkg):
    batches = [b.compact().to_arrow() for b in plan.execute(0)]
    return pa.Table.from_batches(batches) if batches else None


def _same_rows(got: pa.Table, want: pa.Table):
    assert got.num_rows == want.num_rows > 0
    for a, b in zip(got.columns, want.columns):
        assert a.to_pylist() == b.to_pylist()


# -- sort ----------------------------------------------------------------------

@pytest.mark.parametrize("fetch", [None, 5000])
def test_sort_spills_as_the_jax_sort(fetch):
    from blaze_tpu.exprs import col as jcol
    from blaze_tpu.ops.sort import SortExec as JSort
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.sort import SortExec as TSort
    rng = np.random.default_rng(3)
    n = 20000
    t = pa.table({"a": pa.array(rng.integers(0, 10000, n)),
                  "p": pa.array(rng.random(n))})
    js, ts = _scans(t, 2048)
    _budget(200_000)
    with jax_serial():
        jp = JSort(js, [(jcol(0), False, True)], fetch=fetch)
        want = _collect(jp, "jax")
    tp = TSort(ts, [(BoundReference(0), False, True)], fetch=fetch)
    got = _collect(tp, "torch")
    _same_rows(got, want)
    assert got.num_rows == (fetch or n)
    assert tp.metrics.get("spill_count") == jp.metrics.get("spill_count") \
        >= 2
    assert tp.metrics.get("spilled_bytes") == jp.metrics.get(
        "spilled_bytes")
    assert _totals(TManager.get()) == _totals(JManager.get())
    assert TManager.get().spills_by_consumer["sort"][0] \
        == tp.metrics.get("spill_count")
    assert TManager.get().mem_used == 0


# -- aggregation ---------------------------------------------------------------

def _aggs(t, aggs, mode, batch_rows, keys=("k",)):
    """The same AggExec over `t` in both packages."""
    from blaze_tpu import schema as JSch
    from blaze_tpu.exprs import col as jcol
    from blaze_tpu.ops.agg import exec as JA
    from blaze_tpu.ops.agg.functions import make_agg as jmake
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.agg import exec as TA
    from blaze_tpu_torch.ops.agg.functions import make_agg as tmake
    js, ts = _scans(t, batch_rows)
    idx = JSch.Schema.from_arrow(t.schema).index_of
    jp = JA.AggExec(js, [(jcol(idx(k), k), k) for k in keys],
                    [(jmake(f, [jcol(idx(c), c)]), getattr(JA.AggMode, mode),
                      o) for f, c, o in aggs])
    tp = TA.AggExec(ts, [(BoundReference(idx(k)), k) for k in keys],
                    [(tmake(f, [BoundReference(idx(c))]),
                      getattr(TA.AggMode, mode), o) for f, c, o in aggs])
    return jp, tp


def _run_both(jp, tp):
    with jax_serial():
        want = _collect(jp, "jax")
    got = _collect(tp, "torch")
    return got, want


def test_agg_spills_as_the_jax_agg():
    rng = np.random.default_rng(2)
    n = 50000
    t = pa.table({"k": pa.array(rng.integers(0, 5000, n)),
                  "v": pa.array(np.ones(n, dtype=np.int64))})
    _budget(150_000)
    jp, tp = _aggs(t, [("count", "v", "c"), ("sum", "v", "s")], "PARTIAL",
                   4096)
    got, want = _run_both(jp, tp)
    _same_rows(got, want)
    assert tp.metrics.get("spill_count") == jp.metrics.get("spill_count") \
        >= 1
    assert _totals(TManager.get()) == _totals(JManager.get())
    assert got.num_rows == len(np.unique(t.column("k").to_numpy()))


def test_agg_complete_mode_merges_spilled_runs():
    """COMPLETE mode over spilled runs: final values out of the merge,
    groups carried across chunk boundaries."""
    rng = np.random.default_rng(12)
    n = 30000
    t = pa.table({"k": pa.array(rng.integers(0, 12000, n),
                                mask=rng.random(n) < 0.01),
                  "v": pa.array(rng.normal(size=n))})
    _budget(100_000)
    jp, tp = _aggs(t, [("sum", "v", "s"), ("avg", "v", "a"),
                       ("max", "v", "m")], "COMPLETE", 4096)
    got, want = _run_both(jp, tp)
    _same_rows(got, want)
    assert tp.metrics.get("spill_count") == jp.metrics.get("spill_count") \
        >= 2


def test_utf8_keys_charge_their_dictionaries(tmp_path):
    from blaze_tpu.plan import create_plan as jcreate
    from blaze_tpu_torch.plan.planner import create_plan as tcreate
    rng = np.random.default_rng(42)
    n = 60_000
    keys = [f"customer_{i:08d}" for i in rng.integers(0, 30_000, n)]
    t = pa.table({"k": pa.array(keys), "v": pa.array(rng.random(n))})
    src = str(tmp_path / "hc.parquet")
    pq.write_table(t, src)
    ir = {"kind": "hash_agg",
          "groupings": [{"expr": {"kind": "column", "name": "k"},
                         "name": "k"}],
          "aggs": [{"fn": "sum", "mode": "complete", "name": "s",
                    "args": [{"kind": "column", "name": "v"}]}],
          "input": {"kind": "parquet_scan",
                    "schema": {"fields": [
                        {"name": "k", "type": {"id": "utf8"},
                         "nullable": True},
                        {"name": "v", "type": {"id": "float64"},
                         "nullable": True}]},
                    "file_groups": [[src]]}}
    _budget(512 << 10)
    jp, tp = jcreate(ir), tcreate(ir)
    got, want = _run_both(jp, tp)
    _same_rows(got, want)
    assert got.num_rows == len(set(keys))
    assert tp.metrics.get("spill_count") == jp.metrics.get("spill_count") \
        >= 1
    assert _totals(TManager.get()) == _totals(JManager.get())


SKIP_CASES = {
    # skip-on-spill on: pressure switches to pass-through, no spill
    "on": (150_000, 4096, 5000, {
        "auron.tpu.partialAgg.skipping.onSpill": "true",
        "auron.tpu.partialAgg.skipping.ratio": "1.1"}),
    # off: the same pressure spills
    "off": (150_000, 4096, 5000, {
        "auron.tpu.partialAgg.skipping.ratio": "1.1"}),
    # spills during the probe window, then the probe switches (the JAX
    # test's 400,000 bytes never spill before its probe: 200,000 do; the
    # probe counts only the groups buffered since the spill, hence 0.25)
    "interleaved": (200_000, 2048, 320_000, {
        "auron.tpu.partialAgg.skipping.minRows": "20000",
        "auron.tpu.partialAgg.skipping.ratio": "0.25"}),
}


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_skip_on_spill_as_the_jax_agg(case):
    budget, batch_rows, ndv, conf = SKIP_CASES[case]
    rng = np.random.default_rng(2 if case != "interleaved" else 9)
    n = 50000 if case != "interleaved" else 40000
    t = pa.table({"k": pa.array(rng.integers(0, ndv, n)),
                  "v": pa.array(np.ones(n, dtype=np.int64))})
    _set(**conf)
    _budget(budget)
    jp, tp = _aggs(t, [("count", "v", "c")], "PARTIAL", batch_rows)
    got, want = _run_both(jp, tp)
    _same_rows(got, want)
    for m in ("spill_count", "partial_skipped", "passthrough_rows"):
        assert tp.metrics.get(m) == jp.metrics.get(m), m
    assert _totals(TManager.get()) == _totals(JManager.get())
    spills = tp.metrics.get("spill_count")
    skipped = tp.metrics.get("partial_skipped")
    if case == "on":
        assert spills == 0 and skipped == 1
        assert TManager.get().total_pressure_releases >= 1
    elif case == "off":
        assert spills >= 1 and skipped == 0
    else:
        assert spills >= 1 and skipped == 1
    totals = {}
    for k, c in zip(got.column("k").to_pylist(),
                    got.column("c.count").to_pylist()):
        totals[k] = totals.get(k, 0) + c
    ks, cs = np.unique(t.column("k").to_numpy(), return_counts=True)
    assert totals == dict(zip(ks.tolist(), cs.tolist()))


# -- window buffer ---------------------------------------------------------------

def test_window_buffer_spills_as_the_jax_buffer():
    from blaze_tpu.exprs import col as jcol
    from blaze_tpu.ops import make_agg as jmake
    from blaze_tpu.ops import window as JW
    from blaze_tpu.ops.sort import SortExec as JSort
    from blaze_tpu_torch.exprs import BoundReference as R
    from blaze_tpu_torch.ops import window as TW
    from blaze_tpu_torch.ops.agg import make_agg as tmake
    from blaze_tpu_torch.ops.sort import SortExec as TSort
    # the JAX test's 3,000 rows at a batch size of 128 flush the buffer
    # at 512 rows, far below 64 KiB: there only the sort under it
    # spills.  12,000 rows at 1,024 let the buffer pass twice its cap
    rng = np.random.default_rng(5)
    n = 12000
    t = pa.table({"g": pa.array(np.sort(rng.integers(0, 50, n))),
                  "v": pa.array(np.arange(n))})
    _set(**{jconf.BATCH_SIZE.key: 1024})
    js, ts = _scans(t, 256)
    jw = JW.WindowExec(
        JSort(js, [(jcol(0), False, True), (jcol(1), False, True)]),
        [JW.WindowAggFunc("s", jmake("sum", [jcol(1)]), running=True)],
        [jcol(0)], [(jcol(1), False, True)])
    tw = TW.WindowExec(
        TSort(ts, [(R(0), False, True), (R(1), False, True)]),
        [TW.WindowAggFunc("s", tmake("sum", [R(1)]), running=True)],
        [R(0)], [(R(1), False, True)])
    _budget(64 << 10)
    got, want = _run_both(jw, tw)
    _same_rows(got, want)
    assert tw.metrics.get("spill_count") == jw.metrics.get("spill_count") \
        >= 1
    assert tw.metrics.get("spilled_bytes") == jw.metrics.get(
        "spilled_bytes")
    assert TManager.get().spills_by_consumer["WindowExec.buffer"][0] \
        == tw.metrics.get("spill_count")
    assert _totals(TManager.get()) == _totals(JManager.get())
    df = got.to_pandas()
    assert (df.s.to_numpy() == df.groupby("g").v.cumsum().to_numpy()).all()


# -- shuffle writer --------------------------------------------------------------

def _writers(t, parts, batch_rows, tmp_path, tag):
    from blaze_tpu.exprs import col as jcol
    from blaze_tpu.shuffle.partitioning import HashPartitioning as JHash
    from blaze_tpu.shuffle.writer import ShuffleWriterExec as JWriter
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.shuffle.partitioning import HashPartitioning as THash
    from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec as TWriter
    js, ts = _scans(t, batch_rows)
    files = {side: (str(tmp_path / f"{tag}{side}.data"),
                    str(tmp_path / f"{tag}{side}.index"))
             for side in ("j", "t")}
    jw = JWriter(js, JHash([jcol(0)], parts), *files["j"])
    tw = TWriter(ts, THash([BoundReference(0)], parts), *files["t"])
    return jw, tw, files


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture
def spill_dir(tmp_path, monkeypatch):
    """Temporary files (the spills) go to a directory of their own."""
    d = tmp_path / "spills"
    d.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(d))
    return d


@pytest.mark.parametrize("parts", [4, 1])
def test_shuffle_writer_bytes_equal_the_jax_writer(parts, tmp_path,
                                                   spill_dir):
    rng = np.random.default_rng(1)
    n = 40000
    t = pa.table({"k": pa.array(rng.integers(0, 100, n)),
                  "v": pa.array(rng.random(n))})
    jw, tw, files = _writers(t, parts, 4096, tmp_path, "s")
    _budget(200_000)
    with jax_serial():
        list(jw.execute(0))
    list(tw.execute(0))
    for j, p in zip(files["j"], files["t"]):
        assert _read(p) == _read(j)
    assert tw.partition_lengths == jw.partition_lengths
    assert tw.metrics.get("spill_count") == jw.metrics.get("spill_count")
    assert _totals(TManager.get()) == _totals(JManager.get())
    if parts == 4:
        assert tw.metrics.get("spill_count") >= 1
        assert TManager.get().spills_by_consumer["shuffle"][0] \
            == tw.metrics.get("spill_count")
    else:  # streamed: nothing staged, charged or spilled
        assert tw.metrics.get("spill_count") == 0
        assert TManager.get().peak_used == 0
    assert os.listdir(spill_dir) == []


def test_abandoned_write_leaves_no_spill_file(tmp_path, spill_dir):
    """A child that fails after the writer spilled: close() removes the
    spill files, and no .data or temporary file is left."""
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.base import ExecutionPlan
    from blaze_tpu_torch.shuffle.partitioning import HashPartitioning
    from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec
    rng = np.random.default_rng(4)
    t = pa.table({"k": pa.array(rng.integers(0, 100, 20000)),
                  "v": pa.array(rng.random(20000))})
    _js, ts = _scans(t, 2048)
    seen = []

    class Failing(ExecutionPlan):
        schema = ts.schema

        def execute(self, partition):
            for b in ts.execute(partition):
                yield b
            seen.append(sorted(os.listdir(spill_dir)))
            raise RuntimeError("the child failed")

    data = str(tmp_path / "x.data")
    w = ShuffleWriterExec(Failing(), HashPartitioning([BoundReference(0)], 4),
                          data, str(tmp_path / "x.index"))
    _budget(100_000)
    with pytest.raises(RuntimeError, match="the child failed"):
        list(w.execute(0))
    assert w.metrics.get("spill_count") >= 1 and seen[0]
    assert os.listdir(spill_dir) == []
    assert glob.glob(str(tmp_path / "x.*")) == []
    assert TManager.get().mem_used == 0


# -- the DAG paths ---------------------------------------------------------------

def _jax_dag_run(plan):
    """The JAX DagScheduler's frame and scheduler (map outputs recorded),
    serial and synchronous, device route, `auron.tpu.shuffle.device`
    off."""
    from blaze_tpu.plan.stages import DagScheduler as JDag
    from blaze_tpu_torch.itest.runner import frame
    from test_torch_q17_q18 import _recording
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    try:
        with jax_serial():
            sched = _recording(JDag)()
            return frame(sched.run_collect(plan)), sched
    finally:
        jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)


def _port_dag_run(plan):
    from blaze_tpu_torch.itest.runner import frame
    from blaze_tpu_torch.plan.stages import DagScheduler
    from test_torch_q17_q18 import _recording
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = _recording(DagScheduler)()
    return frame(sched.run_collect(plan)), sched


@pytest.fixture(scope="module")
def q01_plan(tmp_path_factory):
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest import queries as TQ
    from blaze_tpu_torch.itest.tpcds_data import (make_tables,
                                                  write_parquet_splits)
    tables = make_tables(0.2, QD.TABLES)
    paths = write_parquet_splits(
        tables, str(tmp_path_factory.mktemp("q01")), 2)
    plan, oracle = TQ.q01(paths, tables, partitions=2)
    return plan, oracle()


@pytest.mark.parametrize("budget", [256 << 10, 64 << 10])
def test_q01_map_outputs_and_totals_equal_the_jax_run(q01_plan, budget):
    """At 256 KiB (the JAX test's budget) nothing spills through the
    scheduler: the fused lanes hold q01's sums outside the manager, and
    the peak is the writers' and the sort's ~209,000 bytes.  At 64 KiB
    the shuffle writers and the sort spill."""
    from blaze_tpu_torch.itest.runner import compare_frames, same_order
    plan, want = q01_plan
    _budget(budget)
    jax, jsched = _jax_dag_run(plan)
    jtot = _totals(JManager.get())
    got, sched = _port_dag_run(plan)
    assert len(got) == 100
    assert compare_frames(got, want) is None
    assert same_order(got, jax) is None
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    for key, data in sched.outputs.items():
        assert data == jsched.outputs[key], key
    assert _totals(TManager.get()) == jtot
    kinds = TManager.get().spills_by_consumer
    if budget == 64 << 10:
        assert kinds["shuffle"][0] > 0 and kinds["sort"][0] > 0
    else:
        assert jtot[0] == 0 and 0 < jtot[3] < budget
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


@pytest.fixture(scope="module")
def q95_q51(tmp_path_factory):
    from blaze_tpu_torch.itest import q95_windows as D
    from blaze_tpu_torch.itest import queries as TQ
    from blaze_tpu_torch.itest import tpcds_data as TT
    tables = TT.make_tables(0.02, D.TABLES)
    paths = TT.write_splits(tables, str(tmp_path_factory.mktemp("q95")), 2)
    return TQ.plans(paths, tables, 2, ["q95", "q51"])


@pytest.mark.parametrize("name", ["q95", "q51"])
def test_q95_and_q51_under_a_spilling_budget(name, q95_q51):
    """At 32 KiB q95's writers spill, and q51's writers, sorts and
    window buffers."""
    from blaze_tpu_torch.itest import q95_windows as D
    from blaze_tpu_torch.itest.runner import same_order
    plan, oracle = q95_q51[name]
    want = oracle()
    _budget(32 << 10)
    jax, jsched = _jax_dag_run(plan)
    jtot = _totals(JManager.get())
    got, sched = _port_dag_run(plan)
    assert len(got) > 0
    assert same_order(*D.in_plan_order(name, got, want), 1e-9) is None
    assert same_order(got, jax, 1e-9) is None
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    for key, data in sched.outputs.items():
        assert data == jsched.outputs[key], key
    assert _totals(TManager.get()) == jtot
    kinds = TManager.get().spills_by_consumer
    assert kinds["shuffle"][0] > 0
    if name == "q51":
        assert kinds["sort"][0] > 0 and kinds["WindowExec.buffer"][0] > 0


def test_breadth_budget_flag_reports_spills_per_query(capsys):
    """`itest/breadth.py --budget-mb 0`: every query spills, each one's
    numbers counted from zero, and the rows still equal the oracle."""
    import json
    from blaze_tpu_torch.itest import breadth
    rc = breadth.main(["--scale", "0.01", "--device", "cpu", "--queries",
                       "q51,q95", "--budget-mb", "0",
                       "--single-task-bytes", "0"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and out["budget_bytes"] == 0
    mem = {q["query"]: q["memory"] for q in out["queries"]}
    assert all(q["met"] for q in out["queries"])
    assert mem["q51"]["spills_by_consumer"]["WindowExec.buffer"][0] > 0
    for m in mem.values():
        assert m["spill_count"] == sum(c for c, _ in
                                       m["spills_by_consumer"].values()) > 0
        assert m["operator_peaks"]["ShuffleWriterExec"] > 0
