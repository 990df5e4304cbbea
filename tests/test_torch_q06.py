"""TPC-DS q06 and the brand-revenue queries q03, q42, q52 and q55
(blaze_tpu_torch/itest/queries.py, itest/q06.py) through the port's stage
DAG (plan/stages.py DagScheduler) against their pandas oracles and the JAX
package's DagScheduler on the same plan and data: scale 0.2, store_sales
in 2 files, item and date_dim in one each, 2 exchange partitions.

Every one of them groups by a utf8 key: q06 averages the price by
category on the generic engine, the brand-revenue queries sum revenue by
brand (or category) on the fused dict-device lane in both the partial and
the final stage.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0 (both
would otherwise run so small a query as one local task; the two-file
q06 case runs the local mode of each too), and the JAX package with
`blaze_tpu.bridge.placement.host_resident` patched to False: the route it
takes on a device (its dict-device lane, not its host Arrow lane).  The
port runs with the stage loop `off`, `auto` (on the CPU: no loop) and
`on` (the loop forced, as `auto` runs it on a card).

Tolerance: keys, counts and row order exact against the JAX run; float
cells within 1e-6 (compare_frames' cell rule) against both."""

import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q06 as D
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.runner import (QueryResult, compare_frames,
                                          run_query, same_order)
from blaze_tpu_torch.plan.stages import DagScheduler

SCALE = 0.2
PARTS = 2
NAMES = ["q06", "q03", "q42", "q52", "q55"]


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STAGE_DEVICE_LOOP_ENABLE):
        tconf.conf.unset(opt.key)


def _frame(t: pa.Table) -> pd.DataFrame:
    return t.to_pandas() if t.num_rows else pd.DataFrame(
        {n: [] for n in t.schema.names})


def _jax_run(plan, single_task_bytes=0):
    """The JAX DagScheduler's frame, on its device route."""
    import blaze_tpu.bridge.placement as P
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import DagScheduler as JDag
    MemManager.init(4 << 30)
    saved = P.host_resident
    P.host_resident = lambda: False
    if single_task_bytes is not None:
        jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, single_task_bytes)
    try:
        return _frame(JDag().run_collect(plan))
    finally:
        P.host_resident = saved
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = TT.make_tables(SCALE, D.TABLES)
    paths = TT.write_splits(tables, str(tmp_path_factory.mktemp("q06")),
                           PARTS)
    return tables, paths


@pytest.fixture(scope="module")
def runs(data):
    """name -> (plan, the oracle's frame, the JAX DagScheduler's frame)."""
    tables, paths = data
    out = {}
    for name, (plan, oracle) in TQ.plans(paths, tables, PARTS,
                                        NAMES).items():
        out[name] = (plan, oracle(), _jax_run(plan))
    return out


@pytest.mark.parametrize("name", ["store_sales", "item"])
def test_generators_equal_the_jax_package(name):
    from blaze_tpu.itest import tpcds_data as JT
    fn = "gen_" + name
    assert getattr(TT, fn)(SCALE).equals(getattr(JT, fn)(SCALE))
    assert TT.SF1_ROWS[name] == JT.SF1_ROWS[name]


def test_splits_keep_the_dimensions_in_one_file(data):
    _tables, paths = data
    assert len(paths["store_sales"]) == PARTS
    assert len(paths["item"]) == len(paths["date_dim"]) == 1


def test_query_map_equals_the_jax_package():
    from blaze_tpu.itest.queries import QUERIES as JQ
    for name, (_fn, tables) in TQ.QUERIES.items():
        assert tables == JQ[name][1], name


@pytest.mark.parametrize("loop", ["off", "auto", "on"])
@pytest.mark.parametrize("name", NAMES)
def test_query_equals_the_oracle_and_the_jax_scheduler(runs, name, loop):
    plan, oracle, jax = runs[name]
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, loop)
    sched = DagScheduler()
    got = _frame(sched.run_collect(plan))
    assert len(got) == len(oracle) > 0
    assert compare_frames(got, oracle) is None
    assert same_order(got, oracle) is None
    assert same_order(got, jax) is None
    assert len(sched.stages) == 3
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    assert all(c["dict_device_fallback"] == 0 for c in counters.values())
    if name == "q06":
        # the count by store: the hash lane (and the loop where it runs)
        assert counters[0]["dict_device_batches"] == 0
        assert (counters[0]["stage_loop_tasks"] > 0) == (loop == "on")
    else:
        # the partial and the final revenue by brand: the dict lane
        assert counters[0]["dict_device_batches"] > 0
        assert counters[1]["dict_device_batches"] > 0
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def _q06_with_item_in_two_files(tmp_path):
    """q06 at scale 0.1 with item written as two files of half each."""
    tables = TT.make_tables(0.1, ["store_sales", "item"])
    paths = TT.write_splits(tables, str(tmp_path), PARTS)
    item, half = tables["item"], tables["item"].num_rows // 2
    files = []
    for i, part in enumerate((item.slice(0, half), item.slice(half))):
        p = str(tmp_path / f"item-{i}.parquet")
        pq.write_table(part, p)
        files.append([p])
    paths["item"] = files
    return paths, tables


def test_q06_with_item_in_two_files(tmp_path):
    """The reference's q06 averages by category as a partial avg directly
    under a final one (blaze_tpu/itest/queries.py:217-221).  In the
    single-task local mode each item file is a partition that averages on
    its own, so the broadcast build holds a row per category and file,
    and the counts double (19,059 against 9,537 in the first cell).
    Through the stage DAG a broadcast build reads every file in one
    partition, and both packages equal the oracle.  The fault lives in
    the reference itest's plan, not in the engine: the port's local mode
    runs the same plan to the same doubled counts, with the same rows in
    the same order as the JAX local mode."""
    paths, tables = _q06_with_item_in_two_files(tmp_path)
    plan, oracle = TQ.q06(paths, tables, PARTS)
    want = oracle()
    # fresh plans (new broadcast ids): a cached build would mask the run
    local = _jax_run(TQ.q06(paths, tables, PARTS)[0],
                     single_task_bytes=None)
    assert compare_frames(local, want) is not None
    # the rows of item matching twice: nearly every count doubles
    assert (local.cnt > 1.9 * want.cnt).all()
    dag = _jax_run(TQ.q06(paths, tables, PARTS)[0])
    got = _frame(DagScheduler().run_collect(plan))
    assert compare_frames(dag, want) is None
    assert same_order(got, dag) is None
    tconf.conf.unset(tconf.DAG_SINGLE_TASK_BYTES.key)  # the default
    sched = DagScheduler()
    port_local = _frame(sched.run_collect(TQ.q06(paths, tables, PARTS)[0]))
    assert sched.exec_mode == "local"
    assert same_order(port_local, local) is None
    assert (port_local.cnt > 1.9 * want.cnt).all()


def test_run_query_behaves_as_the_jax_runner(runs, data):
    """QueryResult and run_query: the port runs the plan dict through its
    DagScheduler, the JAX runner a planned tree's execute_collect; both
    pass on the oracle and fail on a changed one with the same detail."""
    from blaze_tpu.itest.runner import QueryResult as JResult
    from blaze_tpu.itest.runner import run_query as j_run_query
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan import create_plan
    from blaze_tpu.plan.fused import fuse_plan
    import blaze_tpu.bridge.placement as P
    tables, paths = data
    plan, oracle = TQ.q42(paths, tables, PARTS)
    want = oracle()
    changed = want.copy()
    changed.iloc[3, -1] += 1.0

    def jax(o):
        MemManager.init(4 << 30)
        saved, P.host_resident = P.host_resident, (lambda: False)
        try:
            return j_run_query("q42", fuse_plan(create_plan(plan)), o)
        finally:
            P.host_resident = saved

    for o in (lambda: want, lambda: changed):
        got, ref = run_query("q42", plan, o), jax(o)
        assert isinstance(got, QueryResult)
        assert (got.name, got.rows, got.passed, got.detail) == \
            (ref.name, ref.rows, ref.passed, ref.detail)
        assert got.engine_seconds > 0 and got.oracle_seconds >= 0
        assert got.speedup == got.oracle_seconds / got.engine_seconds
    assert [f.name for f in QueryResult.__dataclass_fields__.values()] == \
        [f.name for f in JResult.__dataclass_fields__.values()]
    assert got.passed is False and "cell mismatch" in got.detail
