"""The runtime-filter path (blaze_tpu_torch/itest/runtime_filter.py) on
the CPU against the JAX package: date_dim's bloom filter, built by the
`bloom_filter` aggregate of each package's planner over the same plan,
serializes to the same bytes; q01's inner map stage with
`bloom_filter_might_contain` beside its range filter, as TaskDefinition
bytes through both runtimes (2 maps x 4 reduces, the stage loop off and
forced on), writes byte-identical `.index` files and the same reduce
rows, equal to q01's pyarrow oracle; no key in the range fails the probe
and the out-of-range share stays under Spark's fpp plus three standard
deviations.  The JAX filter's device words are made before its map
stage runs: a first probe inside the JAX fused aggregation's trace
caches a tracer (a fault of the reference, ROADMAP Queue 3).

Tolerance: exact for bytes, keys and probe counts; float64 sums within
rel 1e-12 of the JAX ones (summation order) and 1e-9 of the oracle."""

import pyarrow as pa
import pytest

from blaze_tpu import config as jconf
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q01
from blaze_tpu_torch.itest import runtime_filter as RF

from test_torch_slice import (LOOP, N_MAPS, N_REDUCES, _assert_same_rows,
                              _dataset, _run_jax, _table, confs)  # noqa


def _jax_filter(dd_path, lo, hi):
    from blaze_tpu.kernels.bloom import SparkBloomFilter
    from blaze_tpu.plan import create_plan
    plan = create_plan(RF.build_plan(dd_path, lo, hi))
    out = [b.to_arrow() for b in plan.execute(0)]
    return SparkBloomFilter.from_bytes(
        pa.Table.from_batches(out).column("bloom")[0].as_py())


@pytest.mark.parametrize("loop", ["off", "on"])
def test_runtime_filter_path_matches_jax_and_oracle(tmp_path, confs, loop):
    from blaze_tpu.bridge.resource import put_resource, remove_resource
    for c in (jconf, tconf):
        c.conf.set(LOOP, loop)
    sr_paths, dd_path = _dataset(str(tmp_path / "data"))
    lo, hi = q01.date_sk_range(dd_path)
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jdir.mkdir()
    tdir.mkdir()
    jf = _jax_filter(dd_path, lo, hi)
    assert RF.build_filter(dd_path, lo, hi).to_bytes() == jf.to_bytes()
    # the JAX filter caches its device words on first use; a first use
    # inside the fused aggregation's trace would cache a tracer (ROADMAP
    # Queue 3), so it is made here
    jf.device_words()
    put_resource(RF.UUID, jf)
    try:
        j_out, _m = _run_jax(
            lambda m: RF.map_td(sr_paths, lo, hi, m, str(jdir), N_MAPS,
                                N_REDUCES),
            lambda r: q01.stage2_td(r, N_REDUCES), q01.SHUFFLE_RESOURCE,
            str(jdir))
    finally:
        remove_resource(RF.UUID)
    res = RF.run_runtime_filter(sr_paths, dd_path, lo, hi, str(tdir),
                                N_MAPS, N_REDUCES)
    for m in range(N_MAPS):
        with open(jdir / f"shuffle_{m}.index", "rb") as f:
            j_index = f.read()
        with open(tdir / f"shuffle_{m}.index", "rb") as f:
            assert f.read() == j_index
    keys = ["ctr_customer_sk", "ctr_store_sk"]
    for jb, tb in zip(j_out, res["reduce_outputs"]):
        assert bool(jb) == bool(tb)
        if jb:
            _assert_same_rows(_table(tb), _table(jb), keys,
                              "ctr_total_return")
    assert RF.same_as_oracle(res, sr_paths, lo, hi)
    assert RF.check(res["probe"]) == []
    p = res["probe"]
    assert p["rows_in_range"] > 0 and p["keys_out_of_range_passed"] > 0
    if loop == "on":
        assert res["counters"]["reduce"]["stage_loop_tasks"] == N_REDUCES


def test_a_rebuilt_filter_under_the_same_uuid_keys_its_own_program(
        tmp_path, confs):
    """Two runs in one process under the one uuid, the second with a
    filter over half the range: each equals the oracle of its own filter,
    and the stage loop's fold cache holds the two map programs apart, each
    keyed on its own filter (on the card each captures its own graph, the
    words of the first never replayed for the second: chip_smoke.py's
    expressions phase (c))."""
    from blaze_tpu_torch.runtime import loop
    tconf.conf.set(LOOP, "on")
    # a table that holds a map task's groups: the map stage folds whole
    # (the fixture's 512 slots overflow it into the staged path)
    tconf.conf.set("auron.tpu.agg.table.capacity", 1 << 16)
    sr_paths, dd_path = _dataset(str(tmp_path / "data"))
    lo, hi = q01.date_sk_range(dd_path)
    runs = []
    for n, build in enumerate(((lo, hi), (lo, lo + (hi - lo) // 2))):
        d = tmp_path / f"run{n}"
        d.mkdir()
        res = RF.run_runtime_filter(sr_paths, dd_path, lo, hi, str(d),
                                    N_MAPS, N_REDUCES, build=build)
        assert RF.same_as_oracle(res, sr_paths, lo, hi)
        assert RF.check(res["probe"]) == []
        assert res["counters"]["map"]["stage_loop_tasks"] == N_MAPS
        runs.append(res)
    rows = [sum(b.num_rows for bs in r["reduce_outputs"] for b in bs)
            for r in runs]
    assert 0 < rows[1] < rows[0]
    keyed = [r[1] for key in loop._FOLDS for r in key[0][-1]
             if r[0] == RF.UUID]
    assert any(f is runs[0]["bloom"] for f in keyed)
    assert any(f is runs[1]["bloom"] for f in keyed)
