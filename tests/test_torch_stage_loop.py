"""The device stage loop (blaze_tpu_torch/runtime/loop.py,
plan/stage_compiler.py) against the JAX package's
(blaze_tpu/runtime/loop.py, plan/stage_compiler.py), both forced on
(`auron.tpu.stage.deviceLoop.enable=on`) on the CPU.

The JAX loop runs once with `auron.tpu.kernels.pallas=on` (its Pallas
placement in interpret mode inside the fold) and once with `off` (its
scatter lane); the port folds the same eager body it captures on a CUDA
device, with its plain placement.  The same parquet data (made from a
numpy seed) goes through both packages' planners; the final carries must
be bit-identical (used, keys, key validity, accumulators and their
validity) over padded chunks, padded tails, regrow-and-resume, empty and
all-masked partitions, NULL keys, float keys with -0.0 and NaN patterns,
int8 to int64 keys and sum/count/min/max.  A partial-mode overflow raises
StageLoopFallback in both, and the operator's output then equals the
staged output.  The eligibility verdicts carry the JAX package's reasons.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.bridge import xla_stats
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import interop

LOOP = "auron.tpu.stage.deviceLoop.enable"
CHUNK = "auron.tpu.stage.deviceLoop.chunkBatches"
BATCH = "auron.batch.size"
CAPACITY = "auron.tpu.agg.table.capacity"


@pytest.fixture
def loop_on():
    jconf.conf.set("auron.tpu.fused.hostVectorized", False)
    # io.prefetch off: the JAX loop's fallback abandons its scan, whose
    # prefetch thread then blocks for the rest of the process (and
    # tests/test_prefetch.py, run later in the same worker, counts the
    # live prefetch threads)
    jconf.conf.set("auron.tpu.io.prefetch", False)
    for c in (jconf, tconf):
        c.conf.set(LOOP, "on")
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for k in ("auron.tpu.fused.hostVectorized", "auron.tpu.kernels.pallas",
              "auron.tpu.io.prefetch", LOOP, CHUNK, BATCH, CAPACITY):
        jconf.conf.unset(k)
    for k in (LOOP, CHUNK, BATCH, CAPACITY, tconf.TORCH_DEVICE.key):
        tconf.conf.unset(k)


def _set(**kv):
    """The same overrides in both packages."""
    for k, v in kv.items():
        for c in (jconf, tconf):
            c.conf.set(k, v)


# ---------------------------------------------------------------------------
# data and plans
# ---------------------------------------------------------------------------

def _table(rng, n, distinct=40):
    """Keys of every fixed width with ~10% NULLs; float keys mixing 0.0,
    -0.0 and two NaN bit patterns; float64 and int64 values with NULLs."""
    pick = rng.integers(0, distinct, n)

    def nulls(p=0.1):
        return rng.random(n) < p

    f = np.array([0.0, -0.0, 1.5, -2.25, 3.0, 7e30], np.float64)[pick % 6]
    nan2 = np.frombuffer(np.uint64(0x7FF8000000000123).tobytes(),
                         np.float64)[0]
    f = np.where(pick % 11 == 3, np.nan, f)
    f = np.where(pick % 13 == 5, nan2, f)
    return pa.table({
        "k8": pa.array((pick % 100 - 50).astype(np.int8), mask=nulls()),
        "k16": pa.array((pick * 301 - 3000).astype(np.int16),
                        mask=nulls()),
        "k32": pa.array((pick * 70001).astype(np.int32), mask=nulls()),
        "k64": pa.array(pick.astype(np.int64) * 1_000_003 + 17,
                        mask=nulls(0.05)),
        "kf64": pa.array(f, mask=nulls()),
        "kf32": pa.array(f.astype(np.float32), mask=nulls()),
        "v": pa.array(rng.random(n) * 100 - 30, mask=nulls(0.2)),
        "q": pa.array(rng.integers(-1000, 1000, n), mask=nulls(0.2)),
        "d": pa.array(rng.integers(0, 10, n)),
    })


def _write(tmp_path, table, name="in"):
    """Parquet without statistics, so integer keys stay on the hash lane in
    both packages."""
    path = str(tmp_path / f"{name}.parquet")
    pq.write_table(table, path, write_statistics=False,
                   row_group_size=1 << 20)
    return path


def _schema_d(table):
    ids = {pa.int8(): "int8", pa.int16(): "int16", pa.int32(): "int32",
           pa.int64(): "int64", pa.float32(): "float32",
           pa.float64(): "float64"}
    return {"fields": [{"name": f.name, "type": {"id": ids[f.type]},
                        "nullable": True} for f in table.schema]}


def _col(name):
    return {"kind": "column", "name": name}


AGGS = [("sum", "v"), ("count", "v"), ("min", "v"), ("max", "v"),
        ("sum", "q"), ("min", "q"), ("max", "q"), ("count", "q")]


def _plan(path, table, keys, mode="complete", aggs=AGGS, keep_d=None):
    """hash_agg(keys; aggs) over a parquet scan, behind a filter on `d` when
    keep_d = (lo, hi)."""
    scan = {"kind": "parquet_scan", "schema": _schema_d(table),
            "file_groups": [[path]]}
    if keep_d is not None:
        lit = {"kind": "literal", "type": {"id": "int64"}}
        scan = {"kind": "filter", "input": scan, "predicates": [
            {"kind": "binary", "op": ">=", "l": _col("d"),
             "r": dict(lit, value=keep_d[0])},
            {"kind": "binary", "op": "<=", "l": _col("d"),
             "r": dict(lit, value=keep_d[1])}]}
    return {"kind": "hash_agg",
            "groupings": [{"expr": _col(k), "name": k} for k in keys],
            "aggs": [{"fn": fn, "mode": mode, "name": f"{fn}_{c}_{i}",
                      "args": [_col(c)]} for i, (fn, c) in enumerate(aggs)],
            "input": scan}


def _jax_plan(plan_d):
    from blaze_tpu.plan.column_pruning import prune_columns
    from blaze_tpu.plan.fused import fuse_plan
    from blaze_tpu.plan.planner import collapse_filter_project, create_plan
    return fuse_plan(prune_columns(collapse_filter_project(
        create_plan(plan_d))))


def _torch_plan(plan_d):
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.fused import fuse_plan
    return fuse_plan(create_plan(plan_d))


def _jax_carry(plan_d, pallas):
    from blaze_tpu.plan import stage_compiler
    from blaze_tpu.runtime import loop
    jconf.conf.set("auron.tpu.kernels.pallas", pallas)
    prog = stage_compiler.compile_task_plan(_jax_plan(plan_d))
    assert prog is not None
    before = xla_stats.snapshot()
    carry = loop.run_partition(prog, 0)
    d = xla_stats.delta(before)
    leaves = {"keys": [np.asarray(a) for a in carry.keys],
              "key_valid": [np.asarray(a) for a in carry.key_valid],
              "accs": [np.asarray(a) for a in carry.accs],
              "acc_valid": [np.asarray(a) for a in carry.acc_valid],
              "used": np.asarray(carry.used)}
    return leaves, d


def _torch_carry(plan_d):
    from blaze_tpu_torch.plan import stage_compiler
    from blaze_tpu_torch.runtime import loop
    agg = _torch_plan(plan_d)
    prog = stage_compiler.compile_task_plan(agg)
    assert prog is not None
    carry = loop.run_partition(prog, 0)
    return carry, agg.metrics.values


def _same(a, b):
    for field in interop.CARRY_FIELDS:
        xs, ys = a[field], b[field]
        if field == "used":
            xs, ys = [xs], [ys]
        assert len(xs) == len(ys), field
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert x.tobytes() == y.tobytes(), field


def _check_limbs(carry):
    from blaze_tpu_torch.kernels.hash_update import encode_limbs
    want = encode_limbs(list(zip(carry.keys, carry.key_valid)))
    assert torch.equal(carry.limbs, want * carry.used.to(torch.int32))


def _parity(plan_d):
    """The port's final carry against both JAX lanes; returns the port's
    carry, its metrics and the JAX loop counters."""
    carry, metrics = _torch_carry(plan_d)
    got = interop.carry_to_numpy(carry)
    _check_limbs(carry)
    deltas = []
    for pallas, lane in (("on", "interpret"), ("off", "scatter")):
        want, d = _jax_carry(plan_d, pallas)
        _same(got, want)
        assert d[f"scatter_lane_hash_{lane}"] > 0
        deltas.append(d)
    return carry, metrics, deltas


# ---------------------------------------------------------------------------
# parity of the final carry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("keys,n,batch,chunk", [
    (["k64"], 3 * 256 - 40, 256, 8),            # one chunk of 3, padded
    (["k64", "k8"], 5 * 128 - 7, 128, 2),       # a tail of one batch
    (["k64", "k32"], 7 * 128 - 100, 128, 4),    # padded tail chunk
    (["k8", "k16", "k32", "k64"], 700, 256, 3),
    (["kf64", "kf32"], 600, 256, 2),           # -0.0, NaN patterns, NULL
    (["k16", "kf64"], 300, 128, 8),
])
def test_final_carry_matches_jax(tmp_path, loop_on, keys, n, batch, chunk):
    rng = np.random.default_rng(11 + n)
    table = _table(rng, n)
    path = _write(tmp_path, table)
    _set(**{BATCH: batch, CHUNK: chunk, CAPACITY: 1024})
    carry, m, deltas = _parity(_plan(path, table, keys))
    batches = -(-n // batch)
    assert m["stage_loop_tasks"] == 1
    assert m["stage_loop_batches"] == batches
    assert m["stage_loop_chunks"] == -(-batches // chunk)
    assert m["stage_loop_rows"] == n
    assert m["cpu_batches"] == batches
    for d in deltas:
        assert d["stage_loop_batches"] == batches
        assert d["stage_loop_rows"] == n
        assert d["stage_loop_calls"] >= 0
    assert int(carry.used.sum()) > 0


def test_last_window_takes_a_smaller_graph(tmp_path, loop_on):
    """11 batches in chunks of 8: the full window on the 8-slot entry, the
    last 3 batches on the 4-slot entry, the table carried across."""
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(4)
    table = _table(rng, 11 * 128 - 5, distinct=300)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 8, CAPACITY: 1024})
    plan_d = _plan(path, table, ["k64", "k16"])
    _carry, m, _d = _parity(plan_d)
    assert m["stage_loop_chunks"] == 2 and m["stage_loop_regrows"] == 0
    fp = tsc.compile_task_plan(_torch_plan(plan_d)).fingerprint
    widths = {k[2] for k in tloop._FOLDS if k[0] == fp}
    assert {8, 4} <= widths


def test_an_entry_in_use_is_never_evicted(tmp_path, loop_on, monkeypatch):
    """A full fold cache evicts only entries no task holds (another
    stream's work may still be queued on one in use), grows past its
    limit while every entry is held, and shrinks back once they are
    released; each entry counts its users from lookup to release."""
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(6)
    table = _table(rng, 300)
    plan_d = _plan(_write(tmp_path, table), table, ["k64"])
    prog = tsc.compile_task_plan(_torch_plan(plan_d))
    monkeypatch.setattr(tloop, "_FOLDS", {})
    monkeypatch.setattr(tloop, "_FOLD_LIMIT", 2)
    dev = torch.device("cpu")
    held = [tloop._move(prog, None, 128, 8, S, dev)[0] for S in (64, 128)]
    third, _ = tloop._move(prog, None, 128, 8, 256, dev)
    assert len(tloop._FOLDS) == 3  # both held: nothing evicted
    assert [f.users for f in tloop._FOLDS.values()] == [1, 1, 1]
    held[0].release()
    third.release()
    fourth, _ = tloop._move(prog, None, 128, 8, 512, dev)
    # the two idle entries went, oldest first; the held one stayed
    assert list(tloop._FOLDS.values()) == [held[1], fourth]
    for f in (held[1], fourth):
        f.release()
    assert [f.users for f in tloop._FOLDS.values()] == [0, 0]
    assert not any(f.lock.locked() for f in tloop._FOLDS.values())


def test_regrow_resumes_mid_chunk(tmp_path, loop_on, monkeypatch):
    """An exact-mode table of 64 slots regrows more than once, each time
    resuming its chunk at the overflowing batch."""
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(5)
    table = _table(rng, 1500, distinct=700)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 4, CAPACITY: 64})
    steps = []
    run = tloop._Fold.run

    def spy(fold, program, start):
        out = run(fold, program, start)
        steps.append((fold.S, start, out))
        return out

    monkeypatch.setattr(tloop._Fold, "run", spy)
    carry, m, deltas = _parity(_plan(path, table, ["k64", "k16"]))
    assert m["stage_loop_regrows"] >= 2
    # each overflow is followed by a step on a doubled table that starts
    # at the overflowing batch, and some resume mid-chunk
    resumed = 0
    for (S0, _s, (ovf, first, _r)), (S1, start, _o) in zip(steps, steps[1:]):
        if ovf:
            assert S1 == 2 * S0 and start == first
            resumed += first > 0
    assert resumed >= 1
    assert carry.used.shape[0] >= 256
    for d in deltas:
        assert d["stage_loop_regrows"] == m["stage_loop_regrows"]
        assert d["stage_loop_chunks"] == m["stage_loop_chunks"]


def test_all_masked_batches(tmp_path, loop_on):
    """A filter that keeps no row: the loop folds every batch and the
    table stays empty."""
    rng = np.random.default_rng(6)
    table = _table(rng, 500)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 3, CAPACITY: 256})
    carry, m, _ = _parity(_plan(path, table, ["k64"], keep_d=(50, 60)))
    assert not carry.used.any()
    assert m["stage_loop_batches"] == 4 and m["stage_loop_rows"] == 500


def test_empty_partition(tmp_path, loop_on):
    table = _table(np.random.default_rng(7), 0)
    path = _write(tmp_path, table, "empty")
    _set(**{BATCH: 128, CHUNK: 3, CAPACITY: 256})
    carry, m, _ = _parity(_plan(path, table, ["k64", "kf32"]))
    assert not carry.used.any() and carry.used.shape[0] == 256
    assert m["stage_loop_tasks"] == 1 and m["stage_loop_batches"] == 0


def test_partial_overflow_falls_back_to_staged(tmp_path, loop_on):
    """PARTIAL mode: an overflow raises StageLoopFallback in both packages
    (nothing emitted), and the operator's output is then the staged
    output, batch for batch."""
    from blaze_tpu.plan import stage_compiler as jsc
    from blaze_tpu.runtime import loop as jloop
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(8)
    table = _table(rng, 1200, distinct=500)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 4, CAPACITY: 64})
    plan_d = _plan(path, table, ["k64"], mode="partial",
                   aggs=[("sum", "v"), ("count", "v")])
    with pytest.raises(jloop.StageLoopFallback, match="partial mode"):
        jloop.run_partition(jsc.compile_task_plan(_jax_plan(plan_d)), 0)
    with pytest.raises(tloop.StageLoopFallback, match="partial mode"):
        tloop.run_partition(tsc.compile_task_plan(_torch_plan(plan_d)), 0)

    agg = _torch_plan(plan_d)
    looped = [b.to_arrow() for b in agg.execute(0)]
    assert agg.metrics.get("stage_loop_fallback") == 1
    assert agg.metrics.get("partial_skipped") == 1
    assert agg.metrics.get("stage_loop_tasks") == 0
    _set(**{LOOP: "off"})
    staged = [b.to_arrow() for b in _torch_plan(plan_d).execute(0)]
    assert len(looped) == len(staged)
    for a, b in zip(looped, staged):
        assert a.equals(b)


def test_loop_execute_equals_staged_and_jax(tmp_path, loop_on):
    """FusedPartialAggExec.execute through the loop emits the same batches
    as the staged executor and as the JAX package's loop."""
    rng = np.random.default_rng(9)
    table = _table(rng, 900, distinct=300)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 4, CAPACITY: 64})
    plan_d = _plan(path, table, ["k64", "kf64"], keep_d=(1, 8))
    agg = _torch_plan(plan_d)
    looped = [b.to_arrow() for b in agg.execute(0)]
    assert agg.metrics.get("stage_loop_tasks") == 1
    assert agg.metrics.get("stage_loop_regrows") >= 1
    jagg = _jax_plan(plan_d)
    jout = [b.to_arrow() for b in jagg.execute(0)]
    _set(**{LOOP: "off"})
    staged = [b.to_arrow() for b in _torch_plan(plan_d).execute(0)]
    for other in (staged, jout):
        _same_output(looped, other)


def _same_output(got, want):
    """Two operators' outputs, byte for byte, row order included."""
    got, want = pa.Table.from_batches(got), pa.Table.from_batches(want)
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        x = got[name].combine_chunks()
        y = want[name].combine_chunks()
        assert x.is_valid().equals(y.is_valid()), name
        xv = np.asarray(x.fill_null(0)).view(np.uint8)
        yv = np.asarray(y.fill_null(0)).view(np.uint8)
        assert xv.tobytes() == yv.tobytes(), name


def test_rehash_overflow_doubles_again_without_replay(tmp_path, loop_on,
                                                      monkeypatch):
    """A regrow whose rehash reports overflow (probe clustering) doubles
    and rehashes the same carry again, then resumes at the overflowing
    batch: the batches already folded are not folded twice.  Both the loop
    and the staged executor see one such overflow on their first regrow;
    their outputs stay equal byte for byte."""
    from blaze_tpu_torch.plan import fused as tfused
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(17)
    table = _table(rng, 900, distinct=300)
    path = _write(tmp_path, table)
    _set(**{BATCH: 32, CHUNK: 8, CAPACITY: 64})
    plan_d = _plan(path, table, ["k64", "k16"], keep_d=(1, 8))
    firsts = []
    run = tloop._Fold.run

    def spy(fold, program, start):
        out = run(fold, program, start)
        if out[0]:
            firsts.append(out[1])
        return out

    monkeypatch.setattr(tloop._Fold, "run", spy)

    def once_overflowing(module):
        real, calls = module.rehash_carry, []

        def rehash(carry, kinds, slots):
            calls.append(slots)
            bigger, ovf, ng = real(carry, kinds, slots)
            return bigger, (1 if len(calls) == 1 else ovf), ng

        monkeypatch.setattr(module, "rehash_carry", rehash)
        return calls

    loop_calls = once_overflowing(tloop)
    staged_calls = once_overflowing(tfused)
    agg = _torch_plan(plan_d)
    looped = [b.to_arrow() for b in agg.execute(0)]
    assert agg.metrics.get("stage_loop_tasks") == 1
    assert agg.metrics.get("stage_loop_regrows") >= 1
    # the first overflow came mid-chunk, after batches already folded, and
    # its regrow rehashed twice, at 2x and at 4x the table
    assert firsts[0] > 0
    assert loop_calls[:2] == [128, 256]
    _set(**{LOOP: "off"})
    staged = [b.to_arrow() for b in _torch_plan(plan_d).execute(0)]
    assert staged_calls == loop_calls
    _same_output(looped, staged)


# ---------------------------------------------------------------------------
# eligibility, scopes, fences and the drain
# ---------------------------------------------------------------------------

def _verdict(compile_fn, ineligible, node):
    try:
        compile_fn(node)
    except ineligible as e:
        return str(e)
    return None


def test_ineligibility_reasons_match_jax(tmp_path, loop_on):
    from blaze_tpu.plan import stage_compiler as jsc
    from blaze_tpu_torch.plan import stage_compiler as tsc
    rng = np.random.default_rng(10)
    table = _table(rng, 300)
    plain = _write(tmp_path, table)
    # the dense lane: integer keys bounded by the file's statistics
    stats = str(tmp_path / "stats.parquet")
    pq.write_table(table, stats)
    cases = {
        "dense": _plan(stats, table, ["k8"]),
        "hash": _plan(plain, table, ["k64"]),
    }
    got = {}
    for name, plan_d in cases.items():
        got[name] = (
            _verdict(jsc.compile_fused_agg, jsc.StageLoopIneligible,
                     _jax_plan(plan_d)),
            _verdict(tsc.compile_fused_agg, tsc.StageLoopIneligible,
                     _torch_plan(plan_d)))
    assert got["dense"][0] == got["dense"][1] == \
        "dense lane has its own windowed fold"
    assert got["hash"] == (None, None)
    # a stage root that is not a fused aggregation
    scan = {"kind": "parquet_scan", "schema": _schema_d(table),
            "file_groups": [[plain]]}
    from blaze_tpu.plan.planner import create_plan as jcreate
    from blaze_tpu_torch.plan import create_plan as tcreate
    assert (_verdict(jsc.compile_fused_agg, jsc.StageLoopIneligible,
                     jcreate(scan)) ==
            _verdict(tsc.compile_fused_agg, tsc.StageLoopIneligible,
                     tcreate(scan)) ==
            "stage root ParquetScanExec is not a fused partial agg")


def _reason_after(mutate, tmp_path):
    """The port's verdict on a compiled hash-lane stage after `mutate`."""
    from blaze_tpu_torch.plan import stage_compiler as tsc
    rng = np.random.default_rng(12)
    table = _table(rng, 100)
    agg = _torch_plan(_plan(_write(tmp_path, table), table, ["k64"],
                            keep_d=(0, 5)))
    mutate(agg)
    return _verdict(tsc.compile_fused_agg, tsc.StageLoopIneligible, agg)


def test_ineligibility_no_keys_and_one_shot_source(tmp_path, loop_on,
                                                   monkeypatch):
    """The JAX reasons for a stage without group keys and for a source
    that cannot be re-executed (the port's file-backed sources can)."""
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import INT64, Field, Schema
    assert ParquetScanExec(Schema([Field("x", INT64)]), []).reexecutable

    def no_keys(agg):
        agg._group_exprs = []

    def one_shot(agg):
        monkeypatch.setattr(type(agg._source), "reexecutable",
                            property(lambda self: False), raising=False)

    assert _reason_after(no_keys, tmp_path) == "no group keys"
    assert _reason_after(one_shot, tmp_path) == (
        "source is not re-executable: wholesale fallback could not re-run "
        "the partition")


def test_ineligibility_host_column_in_chain(tmp_path, loop_on):
    """A filter over a variable-width column is not a device expression:
    the JAX package's "chain did not trace"."""
    from blaze_tpu_torch.exprs import BinaryExpr, BoundReference, Literal
    from blaze_tpu_torch.schema import UTF8, Field, Schema

    def utf8_filter(agg):
        src = agg._source
        src._schema = Schema(list(src._schema) + [Field("s", UTF8)])
        pred = BinaryExpr(">=", BoundReference(len(src._schema) - 1, "s"),
                          Literal("a", UTF8))
        agg._chain = [("filter", [pred], None, None)] + agg._chain

    assert (_reason_after(utf8_filter, tmp_path) ==
            "filter/project chain did not trace")


def test_decline_scope_and_modes(loop_on):
    from blaze_tpu_torch.plan import stage_compiler as tsc
    assert tsc.stage_loop_active()
    with tsc.decline_loop_scope():
        assert not tsc.stage_loop_active()
        with tsc.decline_loop_scope():
            assert not tsc.stage_loop_active()
        assert not tsc.stage_loop_active()
    assert tsc.stage_loop_active()
    tconf.conf.set(LOOP, "off")
    assert not tsc.stage_loop_active()
    tconf.conf.set(LOOP, "auto")
    assert not tsc.stage_loop_active()  # the port's device is the CPU here
    assert tsc.compile_task_plan(None) is None


def test_fence_runs_before_every_regrow(tmp_path, loop_on, monkeypatch):
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(13)
    table = _table(rng, 1500, distinct=700)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 4, CAPACITY: 64})
    events = []
    real = tloop.rehash_carry

    def rehash(carry, kinds, slots):
        events.append(("rehash", slots))
        return real(carry, kinds, slots)

    monkeypatch.setattr(tloop, "rehash_carry", rehash)
    with tloop.exchange_fence(lambda: events.append(("fence", None))):
        carry, m = _torch_carry(_plan(path, table, ["k64"]))
    assert m["stage_loop_regrows"] >= 2
    assert events and events[0][0] == "fence"
    for i, (kind, _s) in enumerate(events):
        if kind == "rehash":
            assert events[i - 1][0] == "fence"
    assert tloop._FENCES == []


def test_drain_device_matches_jax(tmp_path, loop_on):
    from blaze_tpu.plan import stage_compiler as jsc
    from blaze_tpu.runtime import loop as jloop
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(14)
    table = _table(rng, 600, distinct=200)
    path = _write(tmp_path, table)
    _set(**{BATCH: 256, CHUNK: 2, CAPACITY: 512})
    jconf.conf.set("auron.tpu.kernels.pallas", "off")
    plan_d = _plan(path, table, ["k32", "kf64"],
                   aggs=[("sum", "v"), ("count", "q"), ("max", "q")])
    jprog = jsc.compile_task_plan(_jax_plan(plan_d))
    tprog = tsc.compile_task_plan(_torch_plan(plan_d))
    jd, jv, jn = jloop.drain_device(jprog, jloop.run_partition(jprog, 0))
    td, tv, tn = tloop.drain_device(tprog, tloop.run_partition(tprog, 0))
    assert jn == tn > 0
    for a, b in zip(jd + jv, td + tv):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    empty = tloop.drain_device(tprog, tloop.run_partition(
        tprog, 0, source_stream=iter(())))
    assert empty == ([], [], 0)


def test_cancel_noticed_at_chunk_boundary(tmp_path, loop_on):
    """The task's cancel probe stops the loop at the next chunk boundary."""
    from blaze_tpu_torch.bridge.context import (TaskContext,
                                                TaskKilledError, task_scope)
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(15)
    table = _table(rng, 1200)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 2, CAPACITY: 1024})
    prog = tsc.compile_task_plan(_torch_plan(_plan(path, table, ["k64"])))
    running = [True]
    task = TaskContext(is_running=lambda: running[0])

    def stream():
        for i, b in enumerate(prog.source.execute(0)):
            if i == 2:  # one full chunk delivered; cancel before the next
                running[0] = False
            yield b

    with task_scope(task):
        with pytest.raises(TaskKilledError):
            tloop.run_partition(prog, 0, source_stream=stream())
    assert task.loop_chunks == 1


def test_threads_share_the_fold_cache(tmp_path, loop_on):
    """More threads than cores fold the same stage at once (one cache
    entry, its lock held from the reset through the drain, and regrows
    moving between entries): every thread gets the single-threaded carry,
    and the entries are free afterwards."""
    import os
    import sys
    import threading
    from blaze_tpu_torch.plan import stage_compiler as tsc
    from blaze_tpu_torch.runtime import loop as tloop
    rng = np.random.default_rng(16)
    table = _table(rng, 900, distinct=400)
    path = _write(tmp_path, table)
    _set(**{BATCH: 128, CHUNK: 4, CAPACITY: 64})
    plan_d = _plan(path, table, ["k64"])
    want = interop.carry_to_numpy(_torch_carry(plan_d)[0])
    n = 2 * (os.cpu_count() or 1) + 2
    results, errors = [None] * n, []

    def work(i):
        try:
            prog = tsc.compile_task_plan(_torch_plan(plan_d))
            results[i] = interop.carry_to_numpy(tloop.run_partition(prog, 0))
        except BaseException as e:  # reported below
            errors.append(e)
            raise

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=240)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    for got in results:
        _same(got, want)
    assert all(not f.lock.locked() for f in tloop._FOLDS.values())
