"""TPC-DS q19, q07 and the Generate-bearing gq1 (blaze_tpu_torch/itest/
queries.py, itest/q19_q07_gq1.py) through the port's stage DAG against
their pandas frames and the JAX package's DagScheduler on the same plan
and data: scale 0.05, store_sales in 4 files, web_clickstreams (2,500
sessions) and every dimension in one, 2 exchange partitions.

  * q19: two broadcasts, a shuffled hash join on the customer, two more
    broadcasts, revenue by brand sorted by its sum descending;
  * q07: four broadcasts (two of them filtered by utf8 equality) and four
    averages by item id on the generic engine;
  * gq1: posexplode of a list<int64> column on the host, the generated
    columns renamed, a broadcast join to item and a count by category;
  * the rows after each join and after the generator equal pandas'
    counts; every map output's `.data` and `.index` bytes equal the JAX
    run's; the two new generators equal the JAX package's.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0 and the JAX
package with `blaze_tpu.bridge.placement.host_resident` patched to False
(its device route) and `auron.tpu.shuffle.device` off, as
tests/test_torch_q17_q18.py runs them; both prune and collapse each
task's plan (their defaults).  The port runs with the stage loop `off`
and `auto`.

Tolerance: keys, counts and row order exact; float sums and averages
within 1e-9 relative (absolute below 1) against both the JAX run and the
pandas frame (under the plan's column names, `q19_q07_gq1.in_plan_order`).
"""

import pandas as pd
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q19_q07_gq1 as D
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.runner import frame, same_order
from blaze_tpu_torch.plan.stages import DagScheduler

from test_torch_q17_q18 import _jax_run, _recording

SCALE = 0.05
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
    root = tmp_path_factory.mktemp("q19_q07_gq1")
    return tables, TT.write_splits(tables, str(root), N_FILES)


@pytest.fixture(scope="module")
def runs(data):
    """name -> (plan, the pandas frame, the JAX run's frame, the JAX
    scheduler)."""
    tables, paths = data
    out = {}
    for name in D.QUERIES:
        plan, oracle = TQ.plans(paths, tables, PARTS, [name])[name]
        out[name] = (plan, oracle()) + _jax_run(plan)
    return out


@pytest.mark.parametrize("name", ["promotion", "web_clickstreams"])
def test_generators_equal_the_jax_package(name):
    from blaze_tpu.itest import tpcds_data as JT
    fn = "gen_" + name
    for scale in (SCALE, 1.0):
        assert getattr(TT, fn)(scale).equals(getattr(JT, fn)(scale))
    assert TT.SF1_ROWS[name] == JT.SF1_ROWS[name]
    assert TT.make_tables(SCALE, [name])[name].equals(
        getattr(JT, fn)(SCALE))


def test_splits_and_scale(data):
    """web_clickstreams is a fact table, in N_FILES files from 10,000
    sessions on (2,500 here, 500,000 at SF10); promotion is a dimension
    of 300 rows at every scale, in one file."""
    tables, paths = data
    assert "web_clickstreams" in TT.FACTS
    assert len(paths["web_clickstreams"]) == 1
    assert len(paths["store_sales"]) == N_FILES
    assert len(paths["promotion"]) == 1
    assert tables["promotion"].num_rows == 300
    assert tables["web_clickstreams"].num_rows == int(50_000 * SCALE)
    assert TT.make_tables(10.0, ["promotion"])["promotion"].num_rows == 300


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
    assert sum(c["io_bytes"] for c in counters.values()) > 0
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


@pytest.mark.parametrize("name", D.QUERIES)
def test_map_outputs_are_the_jax_bytes(runs, name):
    plan, _want, _jax, jsched = runs[name]
    sched = _recording(DagScheduler)()
    sched.run_collect(plan)
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    for key, raw in sched.outputs.items():
        assert raw == jsched.outputs[key], key
    assert any(len(v) > 8 for v in sched.outputs.values())


def _pandas_rows(name, tables):
    """The rows after each join and generator, in `operator_rows`' order,
    from pandas merges."""
    t = {n: tables[n].to_pandas() for n in D.TABLES if n in tables}

    def m(left, right, lk, rk):
        return left.merge(right, left_on=lk, right_on=rk)
    if name == "gq1":
        wc = t["web_clickstreams"]
        clicks = pd.DataFrame({"item_sk": [i for items in
                                           wc.wc_clicked_items
                                           if items is not None
                                           for i in items]})
        joined = m(clicks, t["item"], "item_sk", "i_item_sk")
        return {"GenerateExec": [len(clicks)],
                "BroadcastJoinExec": [len(joined)]}
    dd = t["date_dim"]
    if name == "q19":
        nov = dd[(dd.d_year == 1999) & (dd.d_moy == 11)]
        j_dd = m(t["store_sales"], nov, "ss_sold_date_sk", "d_date_sk")
        j_it = m(j_dd, t["item"], "ss_item_sk", "i_item_sk")
        j_cu = m(j_it, t["customer"], "ss_customer_sk", "c_customer_sk")
        j_ca = m(j_cu, t["customer_address"], "c_current_addr_sk",
                 "ca_address_sk")
        j_st = m(j_ca, t["store"], "ss_store_sk", "s_store_sk")
        return {"BroadcastJoinExec": [len(j_it), len(j_dd), len(j_st),
                                      len(j_ca)],
                "ShuffledHashJoinExec": [len(j_cu)]}
    cd, pr = t["customer_demographics"], t["promotion"]
    j_cd = m(t["store_sales"], cd[(cd.cd_gender == "M") &
                                  (cd.cd_education_status == "College")],
             "ss_cdemo_sk", "cd_demo_sk")
    j_dd = m(j_cd, dd[dd.d_year == 2000], "ss_sold_date_sk", "d_date_sk")
    j_pr = m(j_dd, pr[pr.p_channel_email == "N"], "ss_promo_sk",
             "p_promo_sk")
    j_it = m(j_pr, t["item"], "ss_item_sk", "i_item_sk")
    return {"BroadcastJoinExec": [len(j_it), len(j_pr), len(j_dd),
                                  len(j_cd)]}


@pytest.mark.parametrize("name", D.QUERIES)
def test_join_and_generate_rows_equal_pandas(runs, data, name):
    tables, _paths = data
    plan = runs[name][0]
    sched = DagScheduler()
    sched.run_collect(plan)
    rows = D.operator_rows(sched)
    assert rows == _pandas_rows(name, tables)
    assert all(r > 0 for v in rows.values() for r in v)
