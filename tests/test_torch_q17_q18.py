"""TPC-DS q17 and q18 (BASELINE config #3; blaze_tpu_torch/itest/queries.py,
itest/q17_q18.py) through the port's stage DAG against their pandas
frames and the JAX package's DagScheduler on the same plan and data:
scale 0.05, store_sales, store_returns and catalog_sales in 4 files each,
every dimension in one, 2 exchange partitions.

  * q18: catalog_sales joined to demographics (broadcast), customer (a
    shuffled hash join), the addresses IN ('TX', 'OH', 'IL') and item,
    averaged over ROLLUP(i_item_id, ca_country, ca_state, ca_county)
    through an Expand: its top 100, and its plan cut above the sort over
    all five grouping sets (`q18_all_sets`);
  * q17: two shuffled hash joins on two-column keys, the second over the
    first's output exchanged again, on the generator's tables (empty, as
    the oracle) and on `q17_linked`'s copy (non-empty);
  * the `.data` and `.index` bytes of every map output of q18 (its
    partial stage, whose rows hash by five keys with null utf8 among
    them, included) and of q17 on the linked tables equal the JAX run's;
  * the generators equal the JAX package's, and the two faults of the
    reference's itest stay pinned: q17 is empty on the generator's
    tables, and q18's top 100 hold no rolled-up row.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0 and the JAX
package with `blaze_tpu.bridge.placement.host_resident` patched to False
(its device route) and `auron.tpu.shuffle.device` off: with the eight
JAX-CPU devices of the test process it would otherwise exchange the
fixed-width stages over its mesh collectives, which the port has not
(ROADMAP Queue 1 item 14), and write no shuffle files to compare.  The
port runs with the stage loop `off`, `auto` and `on`.

Tolerance: keys, counts, nulls and row order exact; float averages
within 1e-9 relative (absolute below 1) against both; the all-sets run,
which has no sort, against the pandas frame as a set and against the JAX
run in order."""

import pandas as pd
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q17_q18 as D
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.runner import compare_frames, frame, same_order
from blaze_tpu_torch.plan.stages import DagScheduler

SCALE = 0.05
PARTS = 2
N_FILES = 4
REL = 1e-9
SEED = 7
STAGES = {"q18": 5, "q18 all sets": 5, "q17": 7, "q17 linked": 7}


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STAGE_DEVICE_LOOP_ENABLE):
        tconf.conf.unset(opt.key)


def _recording(base):
    """`base` (either package's DagScheduler) keeping the bytes of every
    committed map output, by (stage, map task, file suffix)."""
    class Recording(base):
        def __init__(self):
            super().__init__()
            self.outputs = {}

        def _run_map_task(self, stage, part, m):
            super()._run_map_task(stage, part, m)
            data = self._map_data_path(stage.sid, m)
            for suffix, path in (("data", data),
                                 ("index", data[:-5] + ".index")):
                with open(path, "rb") as f:
                    self.outputs[(stage.sid, m, suffix)] = f.read()
    return Recording


def _jax_run(plan):
    """The JAX DagScheduler's frame and scheduler, on its device route."""
    import blaze_tpu.bridge.placement as P
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import DagScheduler as JDag
    MemManager.init(4 << 30)
    saved = P.host_resident
    P.host_resident = lambda: False
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    try:
        sched = _recording(JDag)()
        return frame(sched.run_collect(plan)), sched
    finally:
        P.host_resident = saved
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
        jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tables = TT.make_tables(SCALE, D.TABLES)
    root = tmp_path_factory.mktemp("q17_q18")
    paths = TT.write_splits(tables, str(root / "base"), N_FILES)
    linked, k = D.q17_linked(tables, SEED)
    lpaths = dict(paths)
    lpaths.update(TT.write_splits(
        {n: linked[n] for n in ("store_returns", "catalog_sales")},
        str(root / "linked"), N_FILES))
    return tables, paths, linked, lpaths, k


@pytest.fixture(scope="module")
def runs(data):
    """name -> (plan, the pandas frame, the JAX run's frame, the JAX
    scheduler)."""
    tables, paths, linked, lpaths, _k = data
    cases = {"q18": TQ.q18(paths, tables, PARTS),
             "q18 all sets": D.q18_all_sets(paths, tables, PARTS),
             "q17": TQ.q17(paths, tables, PARTS),
             "q17 linked": TQ.q17(lpaths, linked, PARTS)}
    out = {}
    for name, (plan, oracle) in cases.items():
        out[name] = (plan, oracle()) + _jax_run(plan)
    return out


@pytest.mark.parametrize("name", ["catalog_sales", "customer_demographics",
                                  "customer_address", "store_returns",
                                  "store_sales", "store", "item",
                                  "customer", "date_dim"])
def test_generators_equal_the_jax_package(name):
    from blaze_tpu.itest import tpcds_data as JT
    fn = "gen_" + name
    assert getattr(TT, fn)(SCALE).equals(getattr(JT, fn)(SCALE))
    assert TT.SF1_ROWS[name] == JT.SF1_ROWS[name]


def test_splits_and_the_linked_copy(data):
    tables, paths, linked, lpaths, k = data
    for n in set(TT.FACTS) & set(D.TABLES):
        assert len(paths[n]) == N_FILES
    for n in ("store", "item", "customer", "customer_demographics",
              "customer_address"):
        assert len(paths[n]) == 1
    # 1% of the returns in their window, and only the linked columns move
    sr = tables["store_returns"].column("sr_returned_date_sk").to_numpy()
    in_window = ((sr >= TQ.SR_CS_WINDOW[0]) & (sr <= TQ.SR_CS_WINDOW[1]))
    assert k == int(in_window.sum()) // 100 > 0
    for n, cols in (("store_returns", {"sr_ticket_number", "sr_item_sk",
                                       "sr_customer_sk"}),
                    ("catalog_sales", {"cs_bill_customer_sk",
                                       "cs_item_sk"})):
        for c in tables[n].schema.names:
            same = linked[n].column(c).equals(tables[n].column(c))
            assert same == (c not in cols), (n, c)
    assert linked["store_sales"] is tables["store_sales"]
    again, k2 = D.q17_linked(tables, SEED)
    assert k2 == k and again["catalog_sales"].equals(linked["catalog_sales"])


@pytest.mark.parametrize("loop", ["off", "auto", "on"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_query_equals_the_oracle_and_the_jax_scheduler(runs, name, loop):
    plan, want, jax, jsched = runs[name]
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, loop)
    sched = DagScheduler()
    got = frame(sched.run_collect(plan))
    assert len(sched.stages) == len(jsched.stages) == STAGES[name]
    if name == "q18 all sets":  # no sort: the pandas frame as a set
        assert list(got.columns) == list(want.columns)
        assert compare_frames(got, want, REL) is None
    else:
        assert same_order(got, want, REL) is None
    assert same_order(got, jax, REL) is None
    assert (len(got) == 0) == (name == "q17")
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    assert sum(c["probe_batches"] for c in counters.values()) > 0
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


@pytest.mark.parametrize("name", ["q18", "q17 linked"])
def test_map_outputs_are_the_jax_bytes(runs, name):
    plan, _want, _jax, jsched = runs[name]
    sched = _recording(DagScheduler)()
    sched.run_collect(plan)
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    for key, data in sched.outputs.items():
        assert data == jsched.outputs[key], key
    if name == "q18":
        # the partial stage: hashed by the five group keys
        partial = [st.sid for st in sched.stages if st.partitioning
                   and len(st.partitioning.get("exprs", ())) == 5]
        assert len(partial) == 1
        assert any(len(v) > 8 for (sid, _m, s), v in sched.outputs.items()
                   if sid == partial[0] and s == "data")


def test_all_sets_hold_every_grouping_id(runs):
    _plan, want, jax, _ = runs["q18 all sets"]
    assert sorted(set(jax["g_id"])) == list(D.Q18_GIDS)
    for kept, gid in zip((4, 3, 2, 1, 0), D.Q18_GIDS):
        rows = jax[jax["g_id"] == gid]
        for i, col in enumerate(TQ.Q18_COLS):
            assert rows[col].isna().all() == (i >= kept), (gid, col)
            assert not rows[col].isna().any() or i >= kept
    assert len(jax) == len(want)


def test_the_reference_itest_faults_stay_pinned(runs, data):
    """The reference's q17 finds no row on its generator's tables (the
    returns' tickets are drawn apart from the sales'), and q18's top 100,
    sorted by g_id first, hold only g_id 0: the rolled-up rows never
    reach the compared output.  ROADMAP Queue 3 records both."""
    assert len(runs["q17"][1]) == 0 and len(runs["q17"][2]) == 0
    assert len(runs["q17 linked"][1]) == min(100, data[4])
    top = runs["q18"][1]
    assert len(top) == 100 and set(top["g_id"]) == {0}
    assert top[TQ.Q18_COLS].notna().all().all()
    sets = runs["q18 all sets"][1]
    assert len(sets[sets["g_id"] == 0]) > 100
    assert isinstance(sets, pd.DataFrame)


@pytest.mark.parametrize("a, b, equal", [
    (1.0, 1.0 + 5e-10, True),
    (1.0, 1.0 + 5e-9, False),
    (3e9, 3e9 + 2.0, True),
    (1e-12, 5e-10, True),
    (float("inf"), float("inf"), True),
    (float("inf"), 1e308, False),
    (float("-inf"), float("inf"), False),
    (float("nan"), float("nan"), True),
    (float("nan"), 0.0, False),
    (None, None, True),
    ("TX", None, False),
    ("TX", "TX", True),
])
def test_frame_comparators_follow_the_cell_rule(a, b, equal):
    """same_order and compare_frames hold a column of cells (floats
    compared as arrays, other cells one by one) to _cell_equal's rule at
    the tolerance given: an infinity equals only itself, a null only a
    null."""
    from blaze_tpu_torch.itest.runner import _cell_equal
    assert _cell_equal(a, b, REL) == equal
    got = pd.DataFrame({"k": [0, 1], "v": [0.5, a]})
    want = pd.DataFrame({"k": [0, 1], "v": [0.5, b]})
    assert (same_order(got, want, REL) is None) == equal
    assert (compare_frames(got, want, REL) is None) == equal
    assert same_order(got, want.rename(columns={"v": "w"}), REL) \
        is not None
