"""TPC-DS q95 (BASELINE config #4) and the window queries q12, q20, q98,
q51 and q67 (blaze_tpu_torch/itest/queries.py, itest/q95_windows.py)
through the port's stage DAG against their pandas frames and the JAX
package's DagScheduler on the same plan and data: scale 0.1, the fact
tables in 4 files each, every dimension in one, 2 exchange partitions.

  * q95: EXISTS as a shuffled left semi join whose `!=` filter reads both
    sides, NOT EXISTS as a shuffled left anti join, a per-order sum under
    a final one in one stage, and one global row; at this scale each of
    the two joins removes rows and keeps some;
  * q12, q20, q98: revenue by item over its class total, a whole-partition
    window sum over a utf8 partition key;
  * q51: running window sums of two daily streams joined by a full outer
    sort-merge join on two keys;
  * q67: rank() within the category over ROLLUP totals, the null category
    among them;
  * the `.data` and `.index` bytes of every map output equal the JAX
    run's, and the two generators equal the JAX package's.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0 and the JAX
package with `blaze_tpu.bridge.placement.host_resident` patched to False
(its device route) and `auron.tpu.shuffle.device` off, as
tests/test_torch_q17_q18.py runs them.  One exception: the JAX device
route walks q51's full outer join one key run at a time, one device
dispatch after another, which would take longer than the rest of this
file, so whole q51 is held to the JAX package's host route (its Arrow
join), and q51's two window streams, the
join's children, which hold all of q51's map outputs, to its device
route.  The port runs with the stage loop `off` and `auto`.

Tolerance: keys, counts, ranks, nulls and row order exact; floats within
1e-9 relative (absolute below 1) against both the JAX run and the pandas
frame (the oracle's rows put in the plan's order by
`q95_windows.in_plan_order`)."""

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q95_windows as D
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.q06 import operator_counters
from blaze_tpu_torch.itest.runner import frame, same_order
from blaze_tpu_torch.plan.stages import DagScheduler

from test_torch_q17_q18 import _jax_run, _recording

SCALE = 0.1
PARTS = 2
N_FILES = 4
REL = 1e-9


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STAGE_DEVICE_LOOP_ENABLE):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = TT.make_tables(SCALE, D.TABLES)
    root = tmp_path_factory.mktemp("q95_windows")
    return tables, TT.write_splits(tables, str(root), N_FILES)


def _jax_host_run(plan):
    """The JAX DagScheduler's frame and scheduler on its host route (its
    default on the CPU)."""
    from blaze_tpu import config as jconf
    from blaze_tpu.plan.stages import DagScheduler as JDag
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    try:
        sched = JDag()
        return frame(sched.run_collect(plan)), sched
    finally:
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)


def _q51_streams(plan):
    """q51's two window streams, web and store: its sort-merge join's
    children."""
    smj = plan["input"]["input"]["input"]
    assert smj["kind"] == "sort_merge_join"
    return {"q51 web": smj["left"], "q51 store": smj["right"]}


@pytest.fixture(scope="module")
def runs(data):
    """name -> (plan, the pandas frame or None, the JAX run's frame, the
    JAX scheduler), for each query and q51's two streams."""
    tables, paths = data
    out = {}
    for name in D.QUERIES:
        plan, oracle = TQ.plans(paths, tables, PARTS, [name])[name]
        if name == "q51":
            out[name] = (plan, oracle()) + _jax_host_run(plan)
            for stream, sub in _q51_streams(plan).items():
                out[stream] = (sub, None) + _jax_run(sub)
        else:
            out[name] = (plan, oracle()) + _jax_run(plan)
    return out


@pytest.mark.parametrize("name", ["web_sales", "web_returns"])
def test_generators_equal_the_jax_package(name):
    from blaze_tpu.itest import tpcds_data as JT
    fn = "gen_" + name
    assert getattr(TT, fn)(SCALE).equals(getattr(JT, fn)(SCALE))
    assert TT.SF1_ROWS[name] == JT.SF1_ROWS[name]
    assert name in TT.FACTS


def test_splits(data):
    """A fact table goes into N_FILES files once it has more than 10,000
    rows (web_returns has 7,176 at this scale), a dimension into one."""
    tables, paths = data
    for n in ("web_sales", "web_returns", "store_sales", "catalog_sales"):
        assert len(paths[n]) == (N_FILES if tables[n].num_rows > 10_000
                                 else 1)
    assert len(paths["web_sales"]) == N_FILES
    for n in ("customer_address", "item", "date_dim"):
        assert len(paths[n]) == 1


@pytest.mark.parametrize("loop", ["off", "auto"])
@pytest.mark.parametrize("name", D.QUERIES)
def test_query_equals_the_oracle_and_the_jax_scheduler(runs, name, loop):
    plan, want, jax, jsched = runs[name]
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, loop)
    sched = DagScheduler()
    got = frame(sched.run_collect(plan))
    assert len(sched.stages) == len(jsched.stages) == D.STAGES[name]
    assert len(got) > 0
    assert same_order(*D.in_plan_order(name, got, want), REL) is None
    assert same_order(got, jax, REL) is None
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    assert all(c["cuda_batches"] == 0 for c in counters.values())
    if name != "q95":
        windows = operator_counters(sched, "WindowExec",
                                    ("cpu_batches", "output_rows"))
        assert sum(c["cpu_batches"] for c in windows.values()) \
            == (2 if name == "q51" else 1)
        assert sum(c["output_rows"] for c in windows.values()) > 0
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


@pytest.mark.parametrize("name", ["q51 web", "q51 store"])
def test_q51_streams_equal_the_jax_device_route(runs, name):
    """Each running window sum of q51, rows in order, every row of the
    stream (item_sk, date_sk, rev, cume)."""
    plan, _none, jax, jsched = runs[name]
    sched = DagScheduler()
    got = frame(sched.run_collect(plan))
    assert len(sched.stages) == len(jsched.stages) == 3
    assert len(got) > 1000
    assert same_order(got, jax, REL) is None


@pytest.mark.parametrize("name", ["q95", "q12", "q20", "q98", "q51 web",
                                  "q51 store", "q67"])
def test_map_outputs_are_the_jax_bytes(runs, name):
    plan, _want, _jax, jsched = runs[name]
    sched = _recording(DagScheduler)()
    sched.run_collect(plan)
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    for key, data in sched.outputs.items():
        assert data == jsched.outputs[key], key
    assert any(len(v) > 8 for v in sched.outputs.values())


def test_q95_joins_each_remove_rows_and_keep_some(runs, data):
    """The rows after the IL broadcast, the EXISTS semi join and the NOT
    EXISTS anti join equal pandas' counts, and each join cuts."""
    tables, _paths = data
    plan, want, _jax, _ = runs["q95"]
    sched = DagScheduler()
    sched.run_collect(plan)
    rows = D.q95_join_rows(sched)
    ws = tables["web_sales"].to_pandas()
    ca = tables["customer_address"].to_pandas()
    wr = tables["web_returns"].to_pandas()
    lo, hi = TQ.Q95_WINDOW
    f = ws[(ws.ws_ship_date_sk >= lo) & (ws.ws_ship_date_sk <= hi)
           & (ws.ws_web_site_sk <= 2)]
    f = f[f.ws_ship_addr_sk.isin(ca[ca.ca_state == "IL"].ca_address_sk)]
    whs = ws.groupby("ws_order_number").ws_warehouse_sk.nunique()
    exists = f[whs.reindex(f.ws_order_number).to_numpy() > 1]
    not_exists = exists[~exists.ws_order_number.isin(wr.wr_order_number)]
    assert rows == {"ws1": len(f), "exists": len(exists),
                    "not_exists": len(not_exists)}
    assert D.joins_cut(rows), rows
    assert want["order_count"][0] == not_exists.ws_order_number.nunique()
