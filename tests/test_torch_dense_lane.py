"""The dense aggregation lanes of the port (plan/fused.py: the window-table
lane and the scatter dense lane) against the JAX package, over parquet
files, so that the key and value bounds come from file statistics as on
the wire.  The same plan dict goes through both packages' planners and
`fuse_plan`; each partial aggregation runs on the CPU (the port on the
plain versions of its kernels, the JAX package on its scatter reference).

Keys and counts must be exact and in the same order; sums exact on the
window-table lane (an exact int64 total divided once by the scale) and
within rel 1e-12 on the scatter lane (float64 accumulation order)."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu_torch import config as tconf

N, BATCH = 6000, 1024
SCHEMA_D = {"fields": [
    {"name": "date", "type": {"id": "int64"}, "nullable": True},
    {"name": "cust", "type": {"id": "int64"}, "nullable": True},
    {"name": "store", "type": {"id": "int64"}, "nullable": True},
    {"name": "amt", "type": {"id": "float64"}, "nullable": True},
    {"name": "qty", "type": {"id": "int64"}, "nullable": True},
]}
# io.prefetch off: a JAX lane that falls back mid-stream abandons its scan,
# whose prefetch thread then blocks for the rest of the process (and
# tests/test_prefetch.py, run later in the same worker, counts the live
# prefetch threads)
JAX_ONLY = {"auron.tpu.fused.hostVectorized": False,
            "auron.tpu.stage.deviceLoop.enable": "off",
            "auron.tpu.kernels.pallas": "off",
            "auron.tpu.io.prefetch": False}
FORCE = "auron.tpu.mxuAgg.force"


@pytest.fixture
def confs():
    def set_both(k, v):
        jconf.conf.set(k, v)
        tconf.conf.set(k, v)
        keys.add(k)

    keys = set()
    for k, v in JAX_ONLY.items():
        jconf.conf.set(k, v)
    set_both("auron.batch.size", BATCH)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield set_both
    for k in JAX_ONLY:
        jconf.conf.unset(k)
    for k in keys:
        jconf.conf.unset(k)
        tconf.conf.unset(k)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _files(root, dirty=False):
    rng = np.random.default_rng(11)
    amt = np.round(rng.random(N) * 500 - 100, 2)
    if dirty:
        amt[::97] = 1.234567891  # not two-decimal fixed point
    cust = rng.integers(1, 200, N)
    amt_null = rng.random(N) < 0.03
    amt_null |= cust == 7  # one group whose amounts are all NULL
    t = pa.table({
        "date": pa.array(rng.integers(100, 200, N)),
        "cust": pa.array(np.where(rng.random(N) < 0.05, None, cust).tolist(),
                         type=pa.int64()),
        "store": pa.array(rng.integers(1, 13, N)),
        "amt": pa.array(np.where(amt_null, None, amt).tolist(),
                        type=pa.float64()),
        "qty": pa.array(rng.integers(-50, 1000, N)),
    })
    paths = []
    for i in range(2):
        p = str(root / f"part{i}.parquet")
        pq.write_table(t.slice(i * N // 2, N // 2), p, row_group_size=1500)
        paths.append(p)
    return paths


def _col(name):
    return {"kind": "column", "name": name}


AGGS = [("sum", "amt", "amt_sum"), ("sum", "qty", "qty_sum"),
        ("count", "amt", "cnt"), ("count", None, "cnt_star"),
        ("min", "qty", "qty_min"), ("max", "amt", "amt_max")]


def _plan_dict(paths, date_gt=150, keys=("cust", "store"), aggs=AGGS,
               schema=SCHEMA_D):
    return {
        "kind": "hash_agg",
        "groupings": [{"expr": _col(k), "name": k} for k in keys],
        "aggs": [{"fn": fn, "mode": "partial", "name": name,
                  "args": [] if arg is None else [_col(arg)]}
                 for fn, arg, name in aggs],
        "input": {
            "kind": "filter",
            "predicates": [{"kind": "binary", "op": ">", "l": _col("date"),
                            "r": {"kind": "literal", "value": date_gt,
                                  "type": {"id": "int64"}}}],
            "input": {"kind": "parquet_scan", "schema": schema,
                      "file_groups": [paths]}}}


def _run_jax(plan_d):
    from blaze_tpu.plan.fused import FusedPartialAggExec, fuse_plan
    from blaze_tpu.plan.planner import create_plan
    plan = fuse_plan(create_plan(plan_d))
    assert isinstance(plan, FusedPartialAggExec) and plan.fused_mode == "dense"
    rbs = [b.compact().to_arrow() for b in plan.execute(0)]
    return [rb for rb in rbs if rb.num_rows], plan


def _run_torch(plan_d):
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec, fuse_plan
    plan = fuse_plan(create_plan(plan_d))
    assert isinstance(plan, FusedPartialAggExec) and plan.fused_mode == "dense"
    rbs = [b.to_arrow() for b in plan.execute(0)]
    return [rb for rb in rbs if rb.num_rows], plan


def _compare(t_rbs, j_rbs, exact_sums):
    assert [rb.num_rows for rb in t_rbs] == [rb.num_rows for rb in j_rbs]
    if not j_rbs:
        return
    a = pa.Table.from_batches(t_rbs).combine_chunks()
    b = pa.Table.from_batches(j_rbs).combine_chunks()
    assert a.column_names == b.column_names
    for name in a.column_names:
        x, y = a[name], b[name]
        assert x.is_null().equals(y.is_null()), name
        if not name.endswith(".sum") or pa.types.is_integer(y.type) \
                or exact_sums:
            assert x.equals(y), name
        else:
            ok = ~np.asarray(y.is_null())
            np.testing.assert_allclose(np.asarray(x.fill_null(0))[ok],
                                       np.asarray(y.fill_null(0))[ok],
                                       rtol=1e-12, atol=0, err_msg=name)


def _metric(plan, name):
    return int(plan.metrics.get(name) or 0)


@pytest.mark.parametrize("lane", ["window_table", "scatter"])
def test_dense_lanes_match_jax(tmp_path, confs, lane):
    if lane == "window_table":
        confs(FORCE, True)
    plan_d = _plan_dict(_files(tmp_path))
    j_rbs, jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    assert tp._mxu_meta is not None and jp._mxu_meta is not None
    assert tuple(tp._mxu_meta.layout) == tuple(jp._mxu_meta.layout)
    assert [tuple(s) for s in tp._mxu_meta.specs] == \
        [tuple(s) for s in jp._mxu_meta.specs]
    rows = _metric(jp, "mxu_rows")
    assert _metric(tp, "mxu_rows") == rows
    assert (rows > 0) == (lane == "window_table")
    assert _metric(tp, "mxu_verify_fallback") == 0
    _compare(t_rbs, j_rbs, exact_sums=lane == "window_table")
    # the all-NULL-amount group: sum NULL, count 0, in both
    t = pa.Table.from_batches(t_rbs)
    grp = t.filter(pa.compute.equal(t["cust"], 7))
    assert grp.num_rows > 0
    assert grp["amt_sum.sum"].null_count == grp.num_rows
    assert set(grp["cnt.count"].to_pylist()) == {0}


def test_verify_fallback_on_dirty_amounts(tmp_path, confs):
    confs(FORCE, True)
    plan_d = _plan_dict(_files(tmp_path, dirty=True))
    j_rbs, jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    assert _metric(jp, "mxu_verify_fallback") == 1
    assert _metric(tp, "mxu_verify_fallback") == 1
    _compare(t_rbs, j_rbs, exact_sums=False)


@pytest.mark.parametrize("max_rows", ["batch", 1])
def test_drain_bound(tmp_path, confs, monkeypatch, max_rows):
    """MAX_ROWS_PER_TABLE at one batch's capacity drains the table before
    every batch after the first; at 1 a single batch already exceeds it,
    so both packages re-run on the scatter dense lane."""
    from blaze_tpu.kernels import mxu_agg
    from blaze_tpu_torch.kernels import window_table as WT
    confs(FORCE, True)
    limit = BATCH if max_rows == "batch" else 1
    monkeypatch.setattr(mxu_agg, "MAX_ROWS_PER_TABLE", limit)
    monkeypatch.setattr(WT, "MAX_ROWS_PER_TABLE", limit)
    drains = []
    split = WT.split_blocks
    monkeypatch.setattr(WT, "split_blocks",
                        lambda t, lay: drains.append(1) or split(t, lay))
    plan_d = _plan_dict(_files(tmp_path))
    j_rbs, jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    fell_back = 1 if max_rows == 1 else 0
    assert _metric(jp, "mxu_verify_fallback") == fell_back
    assert _metric(tp, "mxu_verify_fallback") == fell_back
    if fell_back:
        assert drains == []
    else:
        assert len(drains) == _metric(tp, "cpu_batches") > 1
    _compare(t_rbs, j_rbs, exact_sums=not fell_back)


@pytest.mark.parametrize("lane", ["window_table", "scatter"])
def test_all_rows_filtered(tmp_path, confs, lane):
    if lane == "window_table":
        confs(FORCE, True)
    plan_d = _plan_dict(_files(tmp_path), date_gt=999)
    j_rbs, _jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    assert j_rbs == [] and t_rbs == []
    assert _metric(tp, "mxu_rows") == 0


NARROW = {"fields": [
    {"name": "date", "type": {"id": "int64"}, "nullable": True},
    {"name": "k8", "type": {"id": "int8"}, "nullable": True},
    {"name": "k16", "type": {"id": "int16"}, "nullable": True},
    {"name": "k32", "type": {"id": "int32"}, "nullable": True},
    {"name": "store", "type": {"id": "int64"}, "nullable": True},
    {"name": "k64", "type": {"id": "int64"}, "nullable": True},
    {"name": "amt", "type": {"id": "float64"}, "nullable": True},
    {"name": "qty", "type": {"id": "int16"}, "nullable": True},
]}


def _narrow_files(root):
    """Keys of every integer width with small ranges (some NULL), an int16
    quantity and a two-decimal amount."""
    rng = np.random.default_rng(12)

    def ints(lo, hi, typ, nulls=0.0):
        v = rng.integers(lo, hi + 1, N)
        return pa.array(np.where(rng.random(N) < nulls, None, v).tolist(),
                        type=typ)
    t = pa.table({
        "date": ints(100, 199, pa.int64()),
        "k8": ints(-3, 4, pa.int8(), 0.05),
        "k16": ints(-2, 2, pa.int16()),
        "k32": ints(10, 12, pa.int32(), 0.02),
        "store": ints(1, 12, pa.int64()),
        "k64": ints(0, 1, pa.int64()),
        "amt": pa.array(np.round(rng.random(N) * 500 - 100, 2)),
        "qty": ints(-50, 1000, pa.int16(), 0.03),
    })
    paths = []
    for i in range(2):
        p = str(root / f"narrow{i}.parquet")
        pq.write_table(t.slice(i * N // 2, N // 2), p, row_group_size=1500)
        paths.append(p)
    return paths


@pytest.mark.parametrize("keys", [("k16", "store"),
                                  ("k8", "k16", "k32", "store", "k64")],
                         ids=["int16 key", "five keys"])
def test_narrow_and_many_keys_on_the_forced_lane(tmp_path, confs, keys):
    """int8 and int16 keys and five keys plan the window-table lane in
    both packages (the step kernel takes them) and agree exactly."""
    confs(FORCE, True)
    plan_d = _plan_dict(_narrow_files(tmp_path), keys=keys, schema=NARROW)
    j_rbs, jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    assert tp._mxu_meta is not None and jp._mxu_meta is not None
    assert tuple(tp._mxu_meta.layout) == tuple(jp._mxu_meta.layout)
    rows = _metric(jp, "mxu_rows")
    assert rows > 0 and _metric(tp, "mxu_rows") == rows
    assert _metric(tp, "mxu_verify_fallback") == 0
    _compare(t_rbs, j_rbs, exact_sums=True)


def test_more_aggregates_than_the_step_takes_keep_the_scatter_lane(
        tmp_path, confs):
    """17 aggregates (none adds a value array, so the JAX package still
    plans the window-table lane): the port plans the scatter dense lane,
    and both give the same groups, counts, minima and maxima."""
    from blaze_tpu_torch.kernels import window_table as WT
    confs(FORCE, True)
    aggs = ([("count", None, f"c{i}") for i in range(8)] +
            [("min", "qty", f"mn{i}") for i in range(5)] +
            [("max", "qty", f"mx{i}") for i in range(4)])
    assert len(aggs) == WT.MAX_SPECS + 1
    plan_d = _plan_dict(_files(tmp_path), aggs=aggs)
    j_rbs, jp = _run_jax(plan_d)
    t_rbs, tp = _run_torch(plan_d)
    assert jp._mxu_meta is not None and tp._mxu_meta is None
    assert _metric(jp, "mxu_rows") > 0 and _metric(tp, "mxu_rows") == 0
    _compare(t_rbs, j_rbs, exact_sums=True)
