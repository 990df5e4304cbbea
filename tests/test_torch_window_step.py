"""One batch of the port's window-table lane
(blaze_tpu_torch/kernels/window_table.py `window_step_plain`, the
arithmetic the CUDA `blaze_window_step` kernel runs in one launch) against
the JAX package's loop body of `_mxu_fold_factory`
(blaze_tpu/plan/fused.py), run on the same batch with use_pallas=False.

The inputs come from a numpy seed: dense keys (int8 to int64, one to
five of them, NULLs, values outside the planned range, which both
packages clamp), a row mask, and count(*), count, sum, min and max over
int16, int32, int64 and float64 arguments.  The table and the min/max accumulators must be bit-identical
and `ok` equal; where a float64 value fails the fixed-point verify only
`ok` is compared, since the lane then re-runs the partition."""

import ctypes
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import mxu_agg as J
from blaze_tpu.plan import fused as JF
from blaze_tpu_torch.kernels import window_table as WT

N = 2000
SCALE = 100


def _meta(num_slots, aggs):
    """An MxuMeta as plan/fused.py `_plan_mxu_meta` builds it: aggs are
    (kind, column, lo, hi, is_float); validity blocks are shared by the
    aggregates of one column."""
    arrays, bits, specs, scatter, valid_of = [], [], [], [], {}

    def valid_block(si, col):
        if col not in valid_of:
            arrays.append(("valid", si))
            bits.append(1)
            valid_of[col] = len(arrays) - 1
        return valid_of[col]

    for si, (kind, col, lo, hi, is_float) in enumerate(aggs):
        if kind == "count_star":
            specs.append(WT.MxuSpec("count_star", -1, -1, -1, 0, 1, False))
            continue
        vi = valid_block(si, col)
        if kind == "count":
            specs.append(WT.MxuSpec("count", vi, -1, -1, 0, 1, False))
            continue
        if is_float:
            clo = int(math.floor(lo * SCALE)) - 1
            chi = int(math.ceil(hi * SCALE)) + 1
            scale = SCALE
        else:
            clo, chi, scale = lo, hi, 1
        if kind == "sum":
            arrays.append(("cents", si))
            bits.append(WT.limb_bits_for(clo, chi))
            specs.append(WT.MxuSpec("sum", vi, len(arrays) - 1, -1, clo,
                                    scale, is_float))
        else:
            scatter.append((kind == "min", si))
            specs.append(WT.MxuSpec(kind, vi, -1, len(scatter) - 1, clo,
                                    scale, is_float))
    layout = WT.plan_layout(num_slots, bits)
    assert layout is not None
    return WT.MxuMeta(layout, tuple(specs), tuple(arrays), tuple(scatter))


def _batch(seed, ranges, key_dtypes, aggs, dirty=False):
    """Keys, aggregate columns and mask as numpy arrays."""
    rng = np.random.default_rng(seed)
    kd, kv = [], []
    for (lo, hi), dt in zip(ranges, key_dtypes):
        # a few values outside [lo, hi]: both packages clamp them
        kd.append(rng.integers(lo - 2, hi + 3, N).astype(dt))
        kv.append(rng.random(N) >= 0.1)
    cols = {}
    ad, av = [], []
    for kind, col, lo, hi, is_float in aggs:
        if kind == "count_star":
            ad.append(None)
            av.append(None)
            continue
        if col not in cols:
            if is_float:
                d = np.round(rng.uniform(lo, hi, N) * SCALE) / SCALE
            else:
                d = rng.integers(lo, hi + 1, N).astype(col[1])
            cols[col] = (d, rng.random(N) >= 0.05)
        ad.append(cols[col][0])
        av.append(cols[col][1])
    m = rng.random(N) >= 0.3
    if dirty:
        for d, v, (_k, _c, _lo, _hi, is_float) in zip(ad, av, aggs):
            if is_float:  # a kept, valid amount off the cents grid
                d[np.flatnonzero(m & v)[7]] = 1.234567891
    return kd, kv, ad, av, m


def _torch_step(meta, ranges, batch):
    kd, kv, ad, av, m = batch
    t = [None if a is None else torch.from_numpy(a) for a in ad]
    tv = [None if a is None else torch.from_numpy(a) for a in av]
    lay = meta.layout
    carry = (torch.zeros(lay.sh, lay.sl * lay.n_blocks, dtype=torch.int32),
             [torch.full((lay.num_slots + 1,), WT.MM_IDENT[is_min],
                         dtype=torch.int32) for is_min, _si in meta.scatter],
             torch.ones((), dtype=torch.bool))
    before = WT.window_step_launches
    out = WT.window_step(meta, ranges, [torch.from_numpy(d) for d in kd],
                         [torch.from_numpy(v) for v in kv], t, tv,
                         torch.from_numpy(m), carry)
    assert WT.window_step_launches == before  # the CPU takes the plain one
    table, mm, ok = out
    return table.numpy(), [a.numpy()[:lay.num_slots] for a in mm], bool(ok)


def _jax_step(meta, ranges, batch, tag):
    kd, kv, ad, av, m = batch
    k = len(kd)
    lay = meta.layout
    jmeta = JF._MxuMeta(J.MxuAggLayout(lay.sh, lay.sl, lay.limbs,
                                       lay.presence),
                        tuple(JF._MxuSpec(*sp) for sp in meta.specs),
                        meta.arrays, meta.scatter)

    def prepare(cols_b, m_b):
        keys, aggs = cols_b[:k], cols_b[k:]
        return ([c[0] for c in keys], [c[1] for c in keys],
                [None if c is None else c[0] for c in aggs],
                [None if c is None else c[1] for c in aggs], m_b)

    fold = JF._mxu_fold_factory(("torch-port-window-step", tag), prepare,
                                tuple(ranges), jmeta, False)
    cols = tuple((jnp.asarray(d)[None], jnp.asarray(v)[None])
                 for d, v in zip(kd, kv))
    cols += tuple(None if d is None else
                  (jnp.asarray(d)[None], jnp.asarray(v)[None])
                  for d, v in zip(ad, av))
    S = lay.num_slots
    carry = (jnp.zeros((lay.sh, lay.sl * lay.n_blocks), jnp.int32),
             tuple(jnp.full(S, WT.MM_IDENT[is_min], dtype=jnp.int32)
                   for is_min, _si in meta.scatter),
             jnp.asarray(True))
    table, mm, ok = fold(carry, cols, jnp.asarray(m)[None])
    return np.asarray(table), [np.asarray(a) for a in mm], bool(ok)


I8, I16, I32, I64 = np.int8, np.int16, np.int32, np.int64
CASES = {
    "count_star, one int64 key": (
        [(1, 12)], [I64], [("count_star", None, 0, 0, False)]),
    "the rollup: sum and count of a float64, two int64 keys": (
        [(1, 12), (2450815, 2451270)], [I64, I64],
        [("sum", ("amt", None), -100.0, 400.0, True),
         ("count", ("amt", None), 0, 0, False)]),
    "int32 sum, int64 min and max, int32 and int64 keys": (
        [(-5, 5), (100, 130)], [I32, I64],
        [("sum", ("q", I32), -50, 1000, False),
         ("min", ("r", I64), -(1 << 29), 1 << 20, False),
         ("max", ("r", I64), -(1 << 29), 1 << 20, False),
         ("count_star", None, 0, 0, False)]),
    "float64 min and max, int64 sum, one int32 key": (
        [(0, 400)], [I32],
        [("min", ("amt", None), -3.5, 80.25, True),
         ("max", ("amt", None), -3.5, 80.25, True),
         ("sum", ("q", I64), 7, 70000, False),
         ("count", ("q", I64), 0, 0, False)]),
    "int8 and int16 keys, int16 sum and min": (
        [(-3, 4), (100, 140)], [I8, I16],
        [("sum", ("s", I16), -300, 300, False),
         ("min", ("s", I16), -300, 300, False),
         ("count_star", None, 0, 0, False)]),
    "five keys of every width": (
        [(0, 2), (1, 3), (-1, 1), (0, 1), (5, 7)], [I8, I16, I32, I64, I16],
        [("count", ("q", I32), 0, 0, False),
         ("max", ("q", I32), -7, 900, False),
         ("sum", ("amt", None), -10.0, 90.0, True)]),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_window_step_plain_matches_jax_fold_body(case, seed):
    ranges, key_dtypes, aggs = CASES[case]
    total = 1
    for lo, hi in ranges:
        total *= hi - lo + 2
    meta = _meta(total, aggs)
    batch = _batch(seed, ranges, key_dtypes, aggs)
    got = _torch_step(meta, ranges, batch)
    want = _jax_step(meta, ranges, batch, case)
    assert got[2] is True and want[2] is True
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[0].any()


@pytest.mark.parametrize("case", [c for c in CASES if "float64" in c])
def test_failed_verify_clears_ok_in_both(case):
    ranges, key_dtypes, aggs = CASES[case]
    total = 1
    for lo, hi in ranges:
        total *= hi - lo + 2
    meta = _meta(total, aggs)
    batch = _batch(5, ranges, key_dtypes, aggs, dirty=True)
    assert _torch_step(meta, ranges, batch)[2] is False
    assert _jax_step(meta, ranges, batch, case + " dirty")[2] is False


def test_step_parameters_mirror_the_kernel():
    """The ctypes mirror of StepParams has the C layout (every field 8
    bytes), and a plan's parameter block carries the plan: strides,
    layout, offsets, arrays and min/max entries, with a pointer slot per
    input column; keys and aggregates the kernel does not take raise."""
    assert ctypes.sizeof(WT._StepParams) == (
        13 * 8 + WT.MAX_KEYS * 48 + WT.MAX_SPECS * (40 + 24 + 24))
    ranges, key_dtypes, aggs = CASES[
        "int32 sum, int64 min and max, int32 and int64 keys"]
    meta = _meta(11 * 33, aggs)
    kd, kv, ad, av, m = [
        [None if a is None else torch.from_numpy(a) for a in part]
        if isinstance(part, list) else torch.from_numpy(part)
        for part in _batch(0, ranges, key_dtypes, aggs)]
    ins = WT._step_inputs(WT._spec_inputs(meta), kd, kv, ad, av, m)
    # mask, 2 x (key, validity), then validity and data of sum, min, max
    assert len(ins) == 1 + 4 + 6 and ins[0] is m and ins[-1] is ad[2]
    plan = WT._step_plan(meta, ranges, ins)
    p = WT._StepParams.from_buffer_copy(plan.template)
    lay = meta.layout
    assert (p.sh, p.nb, p.sentinel, 1 << p.lo_bits) == (
        lay.sh, lay.n_blocks, lay.num_slots, lay.sl)
    assert [(p.keys[k].lo, p.keys[k].span, p.keys[k].stride, p.keys[k].bytes)
            for k in range(2)] == [(-5, 10, 1, 4), (100, 30, 12, 8)]
    assert [p.specs[s].dtype for s in range(4)] == [4, 8, 8, 0]
    assert [(p.arrays[a].spec, p.arrays[a].is_valid, p.arrays[a].limbs)
            for a in range(p.n_arrays)] == [
        (si, int(kind == "valid"), nl)
        for (kind, si), nl in zip(meta.arrays, lay.limbs)]
    assert [(p.mm[j].spec, p.mm[j].is_min) for j in range(p.n_mm)] == [
        (1, 1), (2, 0)]
    # every pointer slot is distinct and lies in the block
    slots = plan.in_slots + plan.mm_slots + (WT._TABLE, WT._OK)
    assert len(set(slots)) == len(slots) and max(slots) < WT._WORDS
    assert plan.in_dtypes == tuple(t.dtype for t in ins)
    narrow = WT._step_plan(meta, ranges, WT._step_inputs(
        plan.spec_inputs, [kd[0].to(torch.int8), kd[1].to(torch.int16)],
        kv, ad, av, m))
    q = WT._StepParams.from_buffer_copy(narrow.template)
    assert (q.keys[0].bytes, q.keys[1].bytes) == (1, 2)
    for bad in (torch.bool, torch.float64):
        with pytest.raises(ValueError, match="int8, int16, int32 or int64"):
            WT._step_plan(meta, ranges, WT._step_inputs(
                plan.spec_inputs, [kd[0].to(bad)] + kd[1:], kv, ad, av, m))
    with pytest.raises(ValueError, match="keys"):
        WT._step_plan(meta, ranges * 9, WT._step_inputs(
            plan.spec_inputs, kd * 9, kv * 9, ad, av, m))
    with pytest.raises(ValueError, match="bool"):
        WT._step_plan(meta, ranges, WT._step_inputs(
            plan.spec_inputs, kd, kv, ad, av, m.to(torch.int32)))
    with pytest.raises(ValueError, match="over"):
        WT._step_plan(meta, ranges, WT._step_inputs(
            plan.spec_inputs, kd, kv, [ad[0].double()] + ad[1:], av, m))


def test_cuda_route_rejects_columns_off_the_card():
    """The CUDA route checks every column before it builds or launches
    anything: CPU tensors, a short column or a wrong carry raise."""
    ranges, key_dtypes, aggs = CASES["five keys of every width"]
    meta = _meta(768, aggs)
    kd, kv, ad, av, m = [
        [None if a is None else torch.from_numpy(a) for a in part]
        if isinstance(part, list) else torch.from_numpy(part)
        for part in _batch(0, ranges, key_dtypes, aggs)]
    lay = meta.layout
    carry = (torch.zeros(lay.sh, lay.sl * lay.n_blocks, dtype=torch.int32),
             [torch.full((lay.num_slots + 1,), WT.MM_IDENT[False],
                         dtype=torch.int32)],
             torch.ones((), dtype=torch.bool))
    before = WT.window_step_launches
    for args in ((kd, kv, ad, av, m),
                 (kd, kv, ad, av, m[:-1])):
        with pytest.raises(ValueError, match="on the card"):
            WT._window_step_cuda(meta, ranges, *args, carry)
    assert WT.window_step_launches == before


def test_narrow_key_wider_than_its_type_packs_as_the_scatter_lane():
    """An int8 key whose planned span (200) exceeds int8: the lane's ids
    equal the scatter dense lane's int64 ids (the shift runs in int32)."""
    from blaze_tpu_torch.parallel import stage as TS
    rng = np.random.default_rng(3)
    ranges = [(-100, 100), (0, 3)]
    cols = [(torch.from_numpy(rng.integers(-100, 101, N).astype(I8)),
             torch.from_numpy(rng.random(N) >= 0.1)),
            (torch.from_numpy(rng.integers(0, 4, N).astype(I16)),
             torch.from_numpy(rng.random(N) >= 0.1))]
    g32, total = TS.pack_dense_keys_i32(cols, ranges)
    g64, total64 = TS.pack_dense_keys(cols, ranges)
    assert total == total64 == 202 * 5
    np.testing.assert_array_equal(g32.numpy(), g64.numpy())
