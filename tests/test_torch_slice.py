"""The port's paths end to end, as TaskDefinition bytes through both
packages' runtimes (the JAX package on its scatter lanes, the port on the
CPU with the plain versions of its kernels), 2 maps x 4 reduces, over a
small q01-shaped dataset.

TPC-DS q01's inner two-stage query:

Customers span 1..100,000, so the key ranges drop to the hash lane as at
SF10, and the table capacity is small enough that the map side overflows
into partial skipping and the reduce side grows its table.  The `.index`
files must be byte-identical; the decoded `.data` frames and the reduce
outputs must have the same rows in the same order, keys exact and float64
sums within rel 1e-12 (summation order); both must equal a pyarrow
group-by.

The store-by-day returns rollup (itest/rollup.py): each map file's
statistics bound (store, date) to some 11,900 slots, so the map side plans
the dense lane, forced onto the window-table lane in both packages or left
on the scatter dense lane, as each package picks it on the CPU; the reduce
side runs the hash lane.  The same checks hold, with counts exact; on the
window-table lane the map-side sums are exact in both packages.

q01's avg-by-store and top-returns branches over four stages
(itest/q01_branches.py): the map and reduce stages above, the reduce
output re-exchanged by store, then the generic aggregation engine with
avg and the projected `avg_return * 1.2` (stage 3a) and a sort with fetch
(stage 3b), each into one partition, then a sort with fetch and a limit
over each (stages 4a and 4b).  Every stage that writes a shuffle must
write byte-identical `.index` files in both packages, stages 4a and 4b
must give the same rows in the same order (keys exact, floats within rel
1e-12), and both must equal the pyarrow oracle and a pandas one
(averages and totals within rel 1e-9).

Each path runs again with the device stage loop forced on in both
packages (`auron.tpu.stage.deviceLoop.enable=on`): the q01 map tasks fold
through the loop until their partial table overflows, then fall back to
the staged path (`stage_loop_fallback` = `partial_skipped`); every reduce
task of both paths folds through the loop, regrowing its table; the
rollup's dense map side is not eligible.  The same checks hold.
"""

import io
import os

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu import config as jconf
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q01
from blaze_tpu_torch.itest.tpcds_data import gen_date_dim

N_ROWS = 20_000
N_MAPS, N_REDUCES = 2, 4
CAPACITY = 512
BATCH = 4096

CONFS = {"auron.tpu.agg.table.capacity": CAPACITY,
         "auron.batch.size": BATCH}
LOOP = "auron.tpu.stage.deviceLoop.enable"
JAX_ONLY = {"auron.tpu.fused.hostVectorized": False,
            "auron.tpu.stage.deviceLoop.enable": "off",
            "auron.tpu.kernels.pallas": "off"}


@pytest.fixture
def confs():
    for k, v in {**CONFS, **JAX_ONLY}.items():
        jconf.conf.set(k, v)
    for k, v in CONFS.items():
        tconf.conf.set(k, v)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for k in {**CONFS, **JAX_ONLY}:
        jconf.conf.unset(k)
    for k in (*CONFS, LOOP):
        tconf.conf.unset(k)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _dataset(root):
    rng = np.random.default_rng(2026)
    n = N_ROWS
    sr = pa.table({
        "sr_returned_date_sk": pa.array(np.sort(
            rng.integers(2450815, 2450815 + 1826, n))),
        "sr_customer_sk": pa.array(rng.integers(1, 100_001, n),
                                   mask=rng.random(n) < 0.02),
        "sr_store_sk": pa.array(rng.integers(1, 13, n)),
        "sr_return_amt": pa.array(np.round(rng.random(n) * 500, 2)),
        "sr_ticket_number": pa.array(np.arange(1, n + 1)),
    })
    return q01.write_dataset(root, sr, gen_date_dim(1.0), N_MAPS)


def _run_jax(map_td, reduce_td, resource, tmpdir):
    """The map tasks `map_td(m)`, then the reduce tasks `reduce_td(r)`,
    through the JAX package's runtime.  Returns the reduce outputs and the
    map-side metric values summed over the tasks' metric trees."""
    from blaze_tpu.bridge.resource import put_resource, remove_resource
    from blaze_tpu.bridge.runtime import NativeExecutionRuntime
    from blaze_tpu.plan.proto_serde import task_definition_to_bytes
    from blaze_tpu.shuffle.exchange import read_index_file
    from blaze_tpu.shuffle.reader import FileSegmentBlock
    map_metrics = {}

    def add(node):
        for k, v in node.values.items():
            map_metrics[k] = map_metrics.get(k, 0) + v
        for c in node.children:
            add(c)

    for m in range(N_MAPS):
        rt = NativeExecutionRuntime(task_definition_to_bytes(
            map_td(m))).start()
        try:
            for _ in rt.batches():
                pass
        finally:
            add(rt.finalize())
    offs = [read_index_file(os.path.join(tmpdir, f"shuffle_{m}.index"),
                            N_REDUCES) for m in range(N_MAPS)]

    def blocks_for(r):
        return [FileSegmentBlock(os.path.join(tmpdir, f"shuffle_{m}.data"),
                                 o[r], o[r + 1] - o[r])
                for m, o in enumerate(offs) if o[r + 1] > o[r]]

    put_resource(resource, blocks_for)
    outs = []
    try:
        for r in range(N_REDUCES):
            rt = NativeExecutionRuntime(task_definition_to_bytes(
                reduce_td(r))).start()
            try:
                outs.append(list(rt.batches()))
            finally:
                rt.finalize()
    finally:
        remove_resource(resource)
    return outs, map_metrics


def _table(batches, schema=None):
    return pa.Table.from_batches(batches, schema=schema).combine_chunks()


def _assert_same_rows(a: pa.Table, b: pa.Table, keys, value, exact=()):
    assert a.num_rows == b.num_rows
    assert a.select(keys).equals(b.select(keys))
    for name in exact:
        assert a[name].equals(b[name]), name
    x = np.asarray(a[value].fill_null(np.nan))
    y = np.asarray(b[value].fill_null(np.nan))
    assert np.array_equal(np.isnan(x), np.isnan(y))
    ok = ~np.isnan(y)
    np.testing.assert_allclose(x[ok], y[ok], rtol=1e-12, atol=0)


def _segments(tmpdir, reader):
    """Per (map, reduce) the decoded frames of one package's output."""
    from blaze_tpu_torch.shuffle import read_index_file
    out = {}
    for m in range(N_MAPS):
        data = os.path.join(tmpdir, f"shuffle_{m}.data")
        offs = read_index_file(os.path.join(tmpdir, f"shuffle_{m}.index"))
        for r in range(N_REDUCES):
            with open(data, "rb") as f:
                f.seek(offs[r])
                buf = f.read(offs[r + 1] - offs[r])
            out[m, r] = list(reader(buf))
    return out


def _loop_on():
    for c in (jconf, tconf):
        c.conf.set(LOOP, "on")


def _jax_loop_delta(run):
    """run() and the JAX package's stage-loop counters it moved."""
    from blaze_tpu.bridge import xla_stats
    before = xla_stats.snapshot()
    out = run()
    d = xla_stats.delta(before)
    return out, {k: d[k] for k in ("stage_loop_tasks", "stage_loop_regrows",
                                   "stage_loop_fallbacks")}


def test_q01_two_stage_matches_jax_and_oracle(tmp_path, confs):
    c, _m, _l = _check_q01(tmp_path)
    assert c["reduce"]["table_grown"] >= 1


def test_q01_two_stage_stage_loop_matches_jax_and_oracle(tmp_path, confs):
    _loop_on()
    c, j_map, j_loop = _check_q01(tmp_path)
    # the partial maps fold through the loop until their table overflows,
    # then re-run staged, in both packages
    assert c["map"]["stage_loop_fallback"] >= 1
    assert (c["map"]["stage_loop_fallback"] == c["map"]["partial_skipped"]
            == j_map["stage_loop_fallback"] == j_loop["stage_loop_fallbacks"])
    assert c["map"]["stage_loop_tasks"] == N_MAPS - c["map"][
        "stage_loop_fallback"]
    # every reduce task folds through the loop and regrows its table
    assert c["reduce"]["stage_loop_tasks"] == N_REDUCES
    assert c["reduce"]["table_grown"] == 0
    assert c["reduce"]["stage_loop_regrows"] >= 1
    assert c["reduce"]["stage_loop_batches"] == c["reduce"]["cpu_batches"]
    assert j_loop["stage_loop_tasks"] == (c["map"]["stage_loop_tasks"]
                                          + c["reduce"]["stage_loop_tasks"])
    assert j_loop["stage_loop_regrows"] == (
        c["map"]["stage_loop_regrows"] + c["reduce"]["stage_loop_regrows"])


def _check_q01(tmp_path):
    """q01 through both packages: every check of the module docstring.
    Returns the port's stage counters, the JAX map-side metrics and the
    JAX stage-loop counters."""
    from blaze_tpu.shuffle.ipc import read_batches_from_bytes
    from blaze_tpu_torch.kernels import hash_update, radix
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionReader

    sr_paths, dd_path = _dataset(str(tmp_path / "data"))
    lo, hi = q01.date_sk_range(dd_path)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()

    (j_out, j_map), j_loop = _jax_loop_delta(lambda: _run_jax(
        lambda m: q01.stage1_td(sr_paths, lo, hi, m, str(jdir), N_MAPS,
                                N_REDUCES),
        lambda r: q01.stage2_td(r, N_REDUCES), q01.SHUFFLE_RESOURCE,
        str(jdir)))
    res = q01.run_q01(sr_paths, lo, hi, str(tdir), N_MAPS, N_REDUCES)
    t_out = res["reduce_outputs"]
    c = res["counters"]
    assert c["map"]["cpu_batches"] > N_MAPS and not c["map"]["cuda_batches"]
    assert c["map"]["partial_skipped"] >= 1
    assert hash_update.placement_launches == 0
    assert radix.partition_launches == 0

    # map side: byte-identical offsets, the same rows in the same order
    for m in range(N_MAPS):
        with open(jdir / f"shuffle_{m}.index", "rb") as f:
            j_index = f.read()
        with open(tdir / f"shuffle_{m}.index", "rb") as f:
            assert f.read() == j_index
    j_seg = _segments(str(jdir), read_batches_from_bytes)
    t_seg = _segments(str(tdir), lambda b: IpcCompressionReader(
        io.BytesIO(b)).read_batches())
    keys = ["ctr_customer_sk", "ctr_store_sk"]
    rows = 0
    for k in j_seg:
        assert len(j_seg[k]) == len(t_seg[k])
        if j_seg[k]:
            rows += _table(j_seg[k]).num_rows
            _assert_same_rows(_table(t_seg[k]), _table(j_seg[k]), keys,
                              "ctr_total_return.sum")
    # partial skipping emitted rows that the reduce side re-merged
    total_groups = sum(_table(b).num_rows for b in j_out if b)
    assert rows > total_groups

    # reduce side: the same rows in the same order in every partition
    for jb, tb in zip(j_out, t_out):
        assert bool(jb) == bool(tb)
        if jb:
            _assert_same_rows(_table(tb), _table(jb), keys,
                              "ctr_total_return")

    # both equal the oracle
    order = [(k, "ascending") for k in keys]
    ora = q01.oracle(sr_paths, lo, hi).sort_by(order)
    for outs in (j_out, t_out):
        got = pa.concat_tables([_table(b) for b in outs if b]).sort_by(order)
        _assert_same_rows(got.select(ora.column_names), ora, keys,
                          "ctr_total_return")
    return c, j_map, j_loop


@pytest.mark.parametrize("lane", ["window_table", "scatter"])
def test_rollup_two_stage_matches_jax_and_oracle(tmp_path, confs, lane):
    _check_rollup(tmp_path, lane)


@pytest.mark.parametrize("lane", ["window_table", "scatter"])
def test_rollup_two_stage_stage_loop_matches_jax_and_oracle(tmp_path, confs,
                                                            lane):
    _loop_on()
    c, j_loop = _check_rollup(tmp_path, lane)
    # the dense map side is not eligible; every reduce task folds
    assert c["map"]["stage_loop_tasks"] == c["map"]["stage_loop_fallback"] \
        == 0
    assert c["reduce"]["stage_loop_tasks"] == N_REDUCES
    assert c["reduce"]["stage_loop_fallback"] == 0
    assert c["reduce"]["stage_loop_batches"] == c["reduce"]["cpu_batches"]
    assert j_loop == {"stage_loop_tasks": N_REDUCES,
                      "stage_loop_regrows": c["reduce"]["stage_loop_regrows"],
                      "stage_loop_fallbacks": 0}


def _check_rollup(tmp_path, lane):
    """The rollup through both packages: every check of the module
    docstring.  Returns the port's stage counters and the JAX stage-loop
    counters."""
    from blaze_tpu.shuffle.ipc import read_batches_from_bytes
    from blaze_tpu_torch.itest import rollup
    from blaze_tpu_torch.kernels import window_table
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionReader

    if lane == "window_table":
        for c in (jconf, tconf):
            c.conf.set("auron.tpu.mxuAgg.force", True)
    try:
        sr_paths, dd_path = _dataset(str(tmp_path / "data"))
        lo, hi = q01.date_sk_range(dd_path)
        jdir, tdir = tmp_path / "jax", tmp_path / "torch"
        jdir.mkdir()
        tdir.mkdir()
        (j_out, j_map), j_loop = _jax_loop_delta(lambda: _run_jax(
            lambda m: rollup.stage1_td(sr_paths, lo, hi, m, str(jdir),
                                       N_MAPS, N_REDUCES),
            lambda r: rollup.stage2_td(r, N_REDUCES),
            rollup.SHUFFLE_RESOURCE, str(jdir)))
        res = rollup.run_rollup(sr_paths, lo, hi, str(tdir), N_MAPS,
                                N_REDUCES)
    finally:
        for c in (jconf, tconf):
            c.conf.unset("auron.tpu.mxuAgg.force")
    t_out = res["reduce_outputs"]
    c = res["counters"]
    filtered = rollup.filtered_rows(sr_paths, lo, hi)
    assert filtered > 0
    mxu_rows = filtered if lane == "window_table" else 0
    assert c["map"]["mxu_rows"] == j_map.get("mxu_rows", 0) == mxu_rows
    assert c["map"]["mxu_verify_fallback"] == 0
    assert j_map.get("mxu_verify_fallback", 0) == 0
    assert c["map"]["cpu_batches"] >= N_MAPS and not c["map"]["cuda_batches"]
    assert window_table.window_step_launches == 0

    # map side: byte-identical offsets, the same rows in the same order
    for m in range(N_MAPS):
        with open(jdir / f"shuffle_{m}.index", "rb") as f:
            j_index = f.read()
        with open(tdir / f"shuffle_{m}.index", "rb") as f:
            assert f.read() == j_index
    j_seg = _segments(str(jdir), read_batches_from_bytes)
    t_seg = _segments(str(tdir), lambda b: IpcCompressionReader(
        io.BytesIO(b)).read_batches())
    keys = ["store", "d"]
    exact = ["cnt.count"] + (["amt.sum"] if lane == "window_table" else [])
    for k in j_seg:
        assert len(j_seg[k]) == len(t_seg[k])
        if j_seg[k]:
            _assert_same_rows(_table(t_seg[k]), _table(j_seg[k]), keys,
                              "amt.sum", exact)

    # reduce side: the same rows in the same order in every partition
    for jb, tb in zip(j_out, t_out):
        assert bool(jb) == bool(tb)
        if jb:
            _assert_same_rows(_table(tb), _table(jb), keys, "amt", ["cnt"])

    # both equal the oracle
    order = [(k, "ascending") for k in keys]
    ora = rollup.oracle(sr_paths, lo, hi).sort_by(order)
    assert pa.compute.sum(ora["cnt"]).as_py() == filtered
    for outs in (j_out, t_out):
        got = pa.concat_tables([_table(b) for b in outs if b]).sort_by(order)
        _assert_same_rows(got.select(ora.column_names), ora, keys, "amt",
                          ["cnt"])
    return c, j_loop


def _run_jax_stages(stages):
    """itest/q01.py `run_stages` through the JAX package's runtime: each
    stage's task outputs, by stage name."""
    from blaze_tpu.bridge.resource import put_resource, remove_resource
    from blaze_tpu.bridge.runtime import NativeExecutionRuntime
    from blaze_tpu.plan.proto_serde import task_definition_to_bytes
    from blaze_tpu.shuffle.exchange import read_index_file
    from blaze_tpu.shuffle.reader import FileSegmentBlock
    outputs, written = {}, {}
    try:
        for st in stages:
            if st.reads is not None:
                files = written[st.reads]

                def blocks_for(r, files=files):
                    return [FileSegmentBlock(d, o[r], o[r + 1] - o[r])
                            for d, o in files if o[r + 1] > o[r]]
                put_resource(st.resource, blocks_for)
            outs = []
            for t in range(st.n_tasks):
                rt = NativeExecutionRuntime(task_definition_to_bytes(
                    st.task_td(t))).start()
                try:
                    outs.append(list(rt.batches()))
                finally:
                    rt.finalize()
            outputs[st.name] = outs
            if st.out_dir is not None:
                written[st.name] = [
                    (os.path.join(st.out_dir, f"shuffle_{t}.data"),
                     read_index_file(os.path.join(
                         st.out_dir, f"shuffle_{t}.index"),
                         st.out_partitions))
                    for t in range(st.n_tasks)]
    finally:
        for st in stages:
            if st.resource is not None:
                remove_resource(st.resource)
    return outputs


@pytest.mark.parametrize("loop", ["off", "on"])
def test_q01_branches_match_jax_and_oracle(tmp_path, confs, loop):
    from blaze_tpu_torch.itest import q01_branches as QB
    from blaze_tpu_torch.kernels import hash_update, radix

    if loop == "on":
        _loop_on()
    sr_paths, dd_path = _dataset(str(tmp_path / "data"))
    lo, hi = q01.date_sk_range(dd_path)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    j_out = _run_jax_stages(QB.stages(sr_paths, lo, hi, str(jdir), N_MAPS,
                                      N_REDUCES))
    res = QB.run_branches(sr_paths, lo, hi, str(tdir), N_MAPS, N_REDUCES)
    assert hash_update.placement_launches == 0
    assert radix.partition_launches == 0

    # every shuffle-writing stage: byte-identical .index files
    n_tasks = {"map": N_MAPS, "ctr": N_REDUCES, "avg": N_REDUCES,
               "top": N_REDUCES}
    for name, d in QB.stage_dirs(str(jdir)).items():
        for t in range(n_tasks[name]):
            with open(os.path.join(d, f"shuffle_{t}.index"), "rb") as f:
                j_index = f.read()
            with open(tdir / name / f"shuffle_{t}.index", "rb") as f:
                assert f.read() == j_index, (name, t)

    # the generic engine ran every stage-3a batch, on the CPU here
    c = res["avg"]["counters"]
    assert c["cpu_batches"] > 0 and c["cuda_batches"] == 0
    want, ran = QB.device_sorts(res)
    assert ran == want

    # stages 4a and 4b: the same rows in the same order
    ctr = q01.oracle(sr_paths, lo, hi)
    avg_j = QB.table(j_out["avg_limit"][0])
    avg_t = QB.table(res["avg_limit"]["outputs"][0])
    assert avg_t.num_rows == 12
    _assert_same_rows(avg_t, avg_j, ["avg_store_sk"], "avg_return")
    _assert_same_rows(avg_t, avg_j, ["avg_store_sk"], "threshold")
    top_j = QB.table(j_out["top_limit"][0])
    top_t = QB.table(res["top_limit"]["outputs"][0])
    assert top_t.num_rows == QB.LIMIT
    _assert_same_rows(top_t, top_j, ["ctr_customer_sk", "ctr_store_sk"],
                      "ctr_total_return")

    # both equal the pyarrow oracle and the pandas one
    pd_avg, pd_top = _pandas_branches(sr_paths, lo, hi)
    for avg, top in ((avg_j, top_j), (avg_t, top_t)):
        QB.check_avg(avg, QB.avg_oracle(ctr), 1e-9)
        QB.check_top(top, QB.top_oracle(ctr), 1e-9)
        QB.check_avg(avg, pd_avg, 1e-9)
        QB.check_top(top, pd_top, 1e-9)


def _pandas_branches(sr_paths, lo, hi):
    """The two branches in pandas over the same parquet files: avg of the
    ctr totals by store, sorted by store; every ctr row ordered by total
    (desc), customer (asc, NULL first) and store (asc)."""
    import pandas as pd
    import pyarrow.parquet as pq
    from blaze_tpu_torch.itest import q01_branches as QB
    df = pd.concat([pq.read_table(p).to_pandas() for p in sr_paths])
    df = df[(df.sr_returned_date_sk >= lo) & (df.sr_returned_date_sk <= hi)]
    ctr = (df.groupby(["sr_customer_sk", "sr_store_sk"], dropna=False,
                      as_index=False).sr_return_amt.sum()
           .rename(columns={"sr_customer_sk": "ctr_customer_sk",
                            "sr_store_sk": "ctr_store_sk",
                            "sr_return_amt": "ctr_total_return"}))
    ctr["ctr_customer_sk"] = ctr["ctr_customer_sk"].astype("Int64")
    avg = (ctr.groupby("ctr_store_sk", as_index=False).ctr_total_return
           .mean().sort_values("ctr_store_sk")
           .rename(columns={"ctr_store_sk": "avg_store_sk",
                            "ctr_total_return": "avg_return"}))
    top = ctr.sort_values(["ctr_total_return", "ctr_customer_sk",
                           "ctr_store_sk"], ascending=[False, True, True],
                          na_position="first", kind="stable")
    return (pa.Table.from_pandas(avg.head(QB.LIMIT), preserve_index=False),
            pa.Table.from_pandas(top, preserve_index=False))
