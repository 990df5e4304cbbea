"""BASELINE config #5's breadth: the 83 query functions of
blaze_tpu_torch/itest/queries_ext.py and queries_ext2.py (copies of the
JAX package's) through the port's stage DAG, against their pandas
oracles and the JAX package's DagScheduler on the same plans and data;
and the planned trees of every query against the JAX package's goldens.

The 81 runnable queries are split over this file and
test_torch_breadth_b.py to _f.py (`GROUPS`, balanced by the JAX side's
time, so that tier-1's `--dist loadfile` spreads them); this file also
holds the shared helpers.  For each query of a group:

  * the port's query function gives the reference's plan dict (up to
    the random ids each build draws: exchange `stage_id`s and
    `broadcast_id`s);
  * the port's run equals the pandas oracle (as a set) and the JAX run
    (rows in order), and every map output's `.data`/`.index` bytes equal
    the JAX run's.  q79 is the one exception to the bytes: its partial
    aggregation groups by two int64 keys and a utf8 one, the dict-device
    lane falls back in both packages, and the JAX package then takes its
    host Arrow lane, which the port does not have (ROADMAP Queue 1 item
    6, "Decisions kept"); the generic engine emits the same groups in
    another order, so those outputs are compared as sets of rows;
  * q97 (the full-outer customer-item matrix) equals its oracle at scale
    0.01, and the JAX run at scale 0.001, where the JAX run takes seconds
    (its sort-merge cursor walks one key run a step: 218 s at 0.01).

This file also holds:
  * every query's `fuse_plan(create_plan(...))` tree, normalized, equal
    to tests/goldens/<q>.plan.txt (the 17 queries of itest/queries.py
    included);
  * q08 and q45 (a utf8 `<` and `substring`, ROADMAP item 13) marked
    xfail(strict=True): they raise NotImplementedError naming item 13;
  * the six generators the new queries need, equal to the JAX package's;
  * a fault of the reference's q49 oracle (ROADMAP Queue 3): an order
    whose sales sum to zero has an infinite return ratio in pandas, which
    the oracle counts, where the engine divides as Spark does (NULL) in
    both packages; `itest/breadth.py` holds q49 to `q49_frame`.

Data: the queries' tables at scale 0.01 from the generators, written
with `write_parquet_splits` in 2 files per table above 10,000 rows, 2
exchange partitions.  Both schedulers run staged
(`auron.tpu.dag.singleTaskBytes` = 0); the JAX package on its device
route (`host_resident` patched False, `auron.tpu.shuffle.device` off;
test_torch_q17_q18.py `_jax_run`).

Tolerance: rows in order and keys exact against the JAX run; floats
within 1e-9 relative against both; bytes exact."""

import os

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.breadth import LATER, q49_frame
from blaze_tpu_torch.itest.runner import (check_plan_stability,
                                          compare_frames, frame, same_order)
from blaze_tpu_torch.plan.stages import DagScheduler
from test_torch_q17_q18 import _jax_run, _recording

SCALE = 0.01
Q97_JAX_SCALE = 0.001
PARTS = 2
REL = 1e-9
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")

#: the runnable new queries, split by the JAX side's time (~75 s a file)
GROUPS = {
    "a": ["q11", "q39", "q41", "q49", "q66", "q73", "q76", "q80", "q83",
          "q90", "q96"],
    "b": ["q13", "q15", "q26", "q35", "q36", "q47", "q56", "q57", "q59",
          "q62", "q63", "q74", "q99"],
    "c": ["q21", "q25", "q28", "q43", "q46", "q58", "q61", "q64", "q70",
          "q78", "q79", "q81", "q87", "q97"],
    "d": ["q10", "q27", "q32", "q33", "q34", "q44", "q50", "q60", "q68",
          "q72", "q75", "q77", "q84", "q85"],
    "e": ["q05", "q22", "q23", "q24", "q48", "q53", "q54", "q65", "q69",
          "q71", "q82", "q88", "q89", "q93"],
    "f": ["q02", "q04", "q09", "q14", "q16", "q29", "q30", "q31", "q37",
          "q38", "q40", "q86", "q91", "q92", "q94"],
}

#: map outputs compared as sets of rows, not bytes (see the docstring)
ROWS_NOT_BYTES = {"q79"}


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


def _write(tables_of, names, root, scale):
    needed = sorted({t for n in names for t in TQ.QUERIES[n][1]})
    tables = {t: tables_of(t, scale) for t in needed}
    return tables, TT.write_parquet_splits(tables, root, PARTS)


def breadth_data(tmp_path_factory, names):
    """(tables, paths) at SCALE for `names`, and at Q97_JAX_SCALE for q97
    where it is among them (keyed by scale)."""
    root = tmp_path_factory.mktemp("breadth")
    out = {SCALE: _write(lambda t, s: getattr(TT, "gen_" + t)(s), names,
                         str(root / "base"), SCALE)}
    if "q97" in names:
        out[Q97_JAX_SCALE] = _write(
            lambda t, s: getattr(TT, "gen_" + t)(s), ["q97"],
            str(root / "q97"), Q97_JAX_SCALE)
    return out


def _plan(data, name, scale=SCALE):
    tables, paths = data[scale]
    return TQ.QUERIES[name][0](paths, tables, PARTS)


def breadth_runs(data, names):
    """name -> (scale, the pandas frame, the JAX run's frame, the JAX
    scheduler with its map outputs), at the scale the JAX run takes."""
    out = {}
    for name in names:
        scale = Q97_JAX_SCALE if name == "q97" else SCALE
        plan, oracle = _plan(data, name, scale)
        out[name] = (scale, oracle()) + _jax_run(plan)
    return out


def _masked(d):
    """The plan dict with its random ids (each exchange's `stage_id`, each
    broadcast's `broadcast_id`: uuids drawn per build) masked."""
    if isinstance(d, dict):
        return {k: "<id>" if k in ("stage_id", "broadcast_id")
                else _masked(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_masked(v) for v in d]
    return d


def check_plan_dict(data, name):
    import blaze_tpu.itest  # noqa: F401  (registers the JAX breadth)
    from blaze_tpu.itest.queries import QUERIES as JQ
    tables, paths = data[SCALE]
    plan, _ = TQ.QUERIES[name][0](paths, tables, PARTS)
    want, _ = JQ[name][0](paths, tables, PARTS)
    assert _masked(plan) == _masked(want)
    assert TQ.QUERIES[name][1] == JQ[name][1]


def check_query(data, runs, name):
    scale, want, jax, jsched = runs[name]
    if name == "q97":  # the pandas oracle at the larger scale too
        plan, oracle = _plan(data, name)
        got = frame(DagScheduler().run_collect(plan))
        assert len(got) and compare_frames(got, oracle(), REL) is None
    sched = DagScheduler()
    got = frame(sched.run_collect(_plan(data, name, scale)[0]))
    assert sched.exec_mode == "staged"
    assert len(sched.stages) == len(jsched.stages)
    assert compare_frames(got, want, REL) is None
    assert same_order(got, jax, REL) is None
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def _rows(raw: bytes, tmp_path) -> list:
    """The rows of one map output's `.data`, sorted."""
    from blaze_tpu_torch.shuffle.reader import FileSegmentBlock, read_block
    p = str(tmp_path / "block.data")
    with open(p, "wb") as f:
        f.write(raw)
    rows = []
    if raw:
        for rb in read_block(FileSegmentBlock(p, 0, len(raw))):
            rows += list(zip(*[c.to_pylist() for c in rb.columns]))
    return sorted(rows, key=repr)


def check_map_bytes(data, runs, name, tmp_path):
    scale, _want, _jax, jsched = runs[name]
    sched = _recording(DagScheduler)()
    sched.run_collect(_plan(data, name, scale)[0])
    assert sorted(sched.outputs) == sorted(jsched.outputs)
    assert len(sched.outputs) > 0
    for key, raw in sched.outputs.items():
        want = jsched.outputs[key]
        if raw != want and name in ROWS_NOT_BYTES and key[2] == "data":
            assert _rows(raw, tmp_path) == _rows(want, tmp_path), key
            continue
        assert raw == want, key


# ---------------------------------------------------------------------------
# this file's group
# ---------------------------------------------------------------------------

NAMES = GROUPS["a"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return breadth_data(tmp_path_factory, NAMES)


@pytest.fixture(scope="module")
def runs(data):
    return breadth_runs(data, NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_plan_dict_is_the_reference_one(data, name):
    check_plan_dict(data, name)


@pytest.mark.parametrize("name", NAMES)
def test_query_equals_the_oracle_and_the_jax_scheduler(data, runs, name):
    check_query(data, runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_map_outputs_are_the_jax_bytes(data, runs, name, tmp_path):
    check_map_bytes(data, runs, name, tmp_path)


# ---------------------------------------------------------------------------
# every query: the groups cover the breadth, the goldens, item 13
# ---------------------------------------------------------------------------

def test_the_groups_cover_every_new_query():
    from blaze_tpu_torch.itest import queries_ext, queries_ext2
    new = {n for n, (fn, _t) in TQ.QUERIES.items()
           if fn.__module__ in (queries_ext.__name__, queries_ext2.__name__)}
    grouped = [n for g in GROUPS.values() for n in g]
    assert len(grouped) == len(set(grouped)) == 81
    assert set(grouped) | set(LATER) == new and len(new) == 83
    assert len(TQ.QUERIES) == 100


@pytest.fixture(scope="module")
def every_query(tmp_path_factory):
    return breadth_data(tmp_path_factory, sorted(TQ.QUERIES))


def _golden_params():
    for name in sorted(TQ.QUERIES):
        if name in LATER and name == "q45":  # plans `substring`
            yield pytest.param(name, marks=pytest.mark.xfail(
                strict=True, raises=NotImplementedError,
                reason="substring: ROADMAP item 13"))
        else:
            yield name


@pytest.mark.parametrize("name", list(_golden_params()))
def test_planned_tree_matches_its_golden(every_query, name):
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.fused import fuse_plan
    plan = fuse_plan(create_plan(_plan(every_query, name)[0]))
    diff = check_plan_stability(
        plan, os.path.join(GOLDENS, f"{name}.plan.txt"))
    assert diff is None, diff


def test_a_missing_golden_is_a_failure(tmp_path):
    from blaze_tpu_torch.ops.basic import UnionExec
    plan = UnionExec([])
    path = str(tmp_path / "none.plan.txt")
    assert "no golden" in check_plan_stability(plan, path)
    assert not os.path.exists(path)


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.xfail(
        strict=True, raises=NotImplementedError,
        reason=f"ROADMAP {LATER[n]}")) for n in sorted(LATER)])
def test_later_query_equals_its_oracle(every_query, name):
    plan, oracle = _plan(every_query, name)
    got = frame(DagScheduler().run_collect(plan))
    assert compare_frames(got, oracle(), REL) is None


@pytest.mark.parametrize("name", sorted(LATER))
def test_later_query_raises_naming_its_item(every_query, name):
    with pytest.raises(NotImplementedError, match=LATER[name]):
        DagScheduler().run_collect(_plan(every_query, name)[0])


@pytest.mark.parametrize("name", ["catalog_returns", "inventory",
                                  "warehouse", "household_demographics",
                                  "time_dim", "reason"])
def test_generators_equal_the_jax_package(name):
    from blaze_tpu.itest import tpcds_data as JT
    for scale in (0.01, 0.05):
        got = getattr(TT, "gen_" + name)(scale)
        assert got.equals(getattr(JT, "gen_" + name)(scale))
    if name != "catalog_returns":  # its row count is in its generator
        assert TT.SF1_ROWS[name] == JT.SF1_ROWS[name]
        assert TT._rows(name, 0.5) == JT._rows(name, 0.5)
    assert got.num_rows > 0


def test_q49_oracle_counts_a_division_by_zero(tmp_path):
    """One store order with returns gets zero sales: the port and the JAX
    package drop its NULL ratio alike, the reference's oracle counts its
    infinite one, and `q49_frame` equals both engines."""
    import numpy as np
    import pyarrow as pa
    tables = {t: getattr(TT, "gen_" + t)(SCALE)
              for t in TQ.QUERIES["q49"][1]}
    ss = tables["store_sales"]
    price = ss.column("ss_ext_sales_price").to_numpy().copy()
    price[ss.column("ss_ticket_number").to_numpy() == 7] = 0.0
    tables["store_sales"] = ss.set_column(
        ss.schema.get_field_index("ss_ext_sales_price"),
        "ss_ext_sales_price", pa.array(price))
    assert 7 in set(tables["store_returns"].column(
        "sr_ticket_number").to_pylist())
    paths = TT.write_parquet_splits(tables, str(tmp_path), PARTS)
    plan, oracle = TQ.QUERIES["q49"][0](paths, tables, PARTS)
    got = frame(DagScheduler().run_collect(plan))
    jax, _sched = _jax_run(TQ.QUERIES["q49"][0](paths, tables, PARTS)[0])
    assert same_order(got, jax, REL) is None
    assert compare_frames(got, q49_frame(tables), REL) is None
    want = oracle()
    store = want.channel == "store"
    assert int(want.bad_orders[store].iloc[0]) == \
        int(got.bad_orders[got.channel == "store"].iloc[0]) + 1
    assert np.isinf(want.avg_ratio[store].iloc[0])
