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
