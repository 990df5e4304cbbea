"""The port's window-table module (blaze_tpu_torch/kernels/window_table.py)
and dense group ids (parallel/stage.py) against the JAX package: the plain
version of the table is bit-identical to the interpret-mode Pallas kernel
and to the scatter reference `_window_table_ref`; the layout planning,
block recombination and dense key packing agree exactly, including the
None cases of `plan_layout`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import mxu_agg as J
from blaze_tpu.parallel import stage as JS
from blaze_tpu_torch.kernels import window_table as WT
from blaze_tpu_torch.parallel import stage as TS


def _case(rows, num_slots, bits, presence, seed=0, sentinel_frac=0.2):
    rng = np.random.default_rng(seed)
    layout = WT.plan_layout(num_slots, bits, presence)
    assert layout is not None
    gid = rng.integers(0, num_slots, rows).astype(np.int32)
    gid[rng.random(rows) < sentinel_frac] = layout.num_slots
    arrays = [rng.integers(0, (1 << min(31, 8 * nl)) - 1, rows,
                           endpoint=True).astype(np.int32)
              for nl in layout.limbs]
    return layout, gid, arrays


def _jax_layout(layout):
    return J.MxuAggLayout(layout.sh, layout.sl, layout.limbs,
                          layout.presence)


def _plain(layout, gid, arrays):
    return WT.window_table_plain(torch.from_numpy(gid),
                                 [torch.from_numpy(a) for a in arrays],
                                 layout).numpy()


# sl 128 (<= 16,384 slots) and 256; 1-4 limbs per array and a mix; with and
# without the presence block; 20% sentinel rows
@pytest.mark.parametrize("slots", [1000, 20000])
@pytest.mark.parametrize("bits", [[8], [16], [24], [31], [1, 16, 31]])
@pytest.mark.parametrize("presence", [True, False])
def test_plain_matches_pallas_interpret_and_ref(slots, bits, presence):
    layout, gid, arrays = _case(3000, slots, bits, presence)
    assert layout.sl == (128 if slots <= 1 << 14 else 256)
    got = _plain(layout, gid, arrays)
    jl = _jax_layout(layout)
    jg, ja = jnp.asarray(gid), [jnp.asarray(a) for a in arrays]
    pallas = np.asarray(J.window_table(jg, ja, jl, interpret=True))
    ref = np.asarray(J._window_table_ref(jg, ja, jl))
    assert got.dtype == np.int32 and got.shape == pallas.shape
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("presence", [True, False])
def test_empty_batch_and_all_sentinel(presence):
    layout = WT.plan_layout(500, [16, 8], presence)
    jl = _jax_layout(layout)
    empty = np.zeros(0, np.int32)
    got = _plain(layout, empty, [empty, empty])
    want = np.asarray(J._window_table_ref(jnp.asarray(empty),
                                          [jnp.asarray(empty)] * 2, jl))
    np.testing.assert_array_equal(got, want)
    assert not got.any()
    sentinel = np.full(700, layout.num_slots, np.int32)
    vals = np.full(700, 255, np.int32)
    got = _plain(layout, sentinel, [vals, vals])
    want = np.asarray(J.window_table(jnp.asarray(sentinel),
                                     [jnp.asarray(vals)] * 2, jl,
                                     interpret=True))
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_wrapper_routes_cpu_and_accumulates_into_out():
    """Tables add: the lane accumulates one window's batches into one
    table, so two halves' tables sum to the whole's."""
    layout, gid, arrays = _case(2000, 900, [16], True, seed=3)
    half = 1000
    out = _plain(layout, gid[:half], [a[:half] for a in arrays])
    out += _plain(layout, gid[half:], [a[half:] for a in arrays])
    np.testing.assert_array_equal(out, _plain(layout, gid, arrays))


@pytest.mark.parametrize("num_slots,bits,presence", [
    (1, [1], True), (5954, [1, 16], True), (16384, [8], False),
    (16385, [8], True), (131072, [16], True), (131072, [32], True),
    (512 * 128, [8], True), (512 * 256, [8], True), (512 * 256 + 1, [8], True),
    (20000, [31, 31, 31], True), (20000, [31, 31, 24], False),
    (4000, [33], True), (4000, [], True)])
def test_plan_layout_matches_jax(num_slots, bits, presence):
    got = WT.plan_layout(num_slots, bits, presence)
    want = J.plan_layout(num_slots, bits, presence)
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got) == tuple(want)
        assert got.num_slots == want.num_slots
        assert got.n_blocks == want.n_blocks


@pytest.mark.parametrize("lo,hi", [(0, 0), (5, 3), (-1, 50001), (0, 255),
                                   (0, 256), (-(1 << 40), 1 << 40)])
def test_limb_bits_for_matches_jax(lo, hi):
    assert WT.limb_bits_for(lo, hi) == J.limb_bits_for(lo, hi)


@pytest.mark.parametrize("presence", [True, False])
def test_split_blocks_matches_jax(presence):
    layout = WT.plan_layout(3000, [8, 31, 16], presence)
    rng = np.random.default_rng(5)
    table = rng.integers(0, 1 << 31, (layout.sh, layout.sl *
                                      layout.n_blocks)).astype(np.int32)
    p, vals = WT.split_blocks(torch.from_numpy(table), layout)
    jp, jvals = J.split_blocks(table, _jax_layout(layout))
    assert (p is None) == (jp is None)
    if p is not None:
        np.testing.assert_array_equal(p.numpy(), jp)
    assert len(vals) == len(jvals)
    for a, b in zip(vals, jvals):
        assert a.dtype == torch.int64
        np.testing.assert_array_equal(a.numpy(), b)


def _keys(rng, n, ranges, dtype):
    cols = []
    for lo, hi in ranges:
        # out-of-range values clip, as in both packages
        d = rng.integers(lo - 3, hi + 4, n).astype(dtype)
        cols.append((d, rng.random(n) > 0.1))
    return cols


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ranges", [[(1, 12)], [(1, 12), (2450815, 2451270)],
                                    [(-5, 5), (0, 0), (100, 130)]])
def test_dense_keys_match_jax(dtype, ranges):
    rng = np.random.default_rng(7)
    cols = _keys(rng, 4000, ranges, dtype)
    jcols = [(jnp.asarray(d), jnp.asarray(v)) for d, v in cols]
    tcols = [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in cols]
    jg, jt = JS.pack_dense_keys(jcols, ranges)
    tg, tt = TS.pack_dense_keys(tcols, ranges)
    assert jt == tt and tg.dtype == torch.int64
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    jg32, _ = JS.pack_dense_keys_i32(jcols, ranges)
    tg32, _ = TS.pack_dense_keys_i32(tcols, ranges)
    assert tg32.dtype == torch.int32
    np.testing.assert_array_equal(tg32.numpy(), np.asarray(jg32))
    np.testing.assert_array_equal(tg32.numpy(), tg.numpy())
    # the inverse, on torch tensors and on numpy arrays
    slots = np.unique(np.asarray(jg))
    want = JS.unpack_dense_keys(slots, ranges, xp=np)
    for got in (TS.unpack_dense_keys(torch.from_numpy(slots), ranges),
                TS.unpack_dense_keys(slots, ranges)):
        for (gk, gv), (wk, wv) in zip(got, want):
            np.testing.assert_array_equal(np.asarray(gk), wk)
            np.testing.assert_array_equal(np.asarray(gv), wv)


def test_cuda_wrapper_rejects_bad_operands():
    """Layouts outside the step kernel's contract raise once, when a plan
    is built; `window_step`'s own operand checks are in
    tests/test_torch_window_step.py."""
    layout = WT.plan_layout(900, [16, 8])
    WT._checked_layout(layout)
    for bad in (layout._replace(sl=96), layout._replace(limbs=(5, 1)),
                layout._replace(sl=2048),
                layout._replace(limbs=(1,) * (WT.MAX_SPECS + 1)),
                layout._replace(sh=1 << 22)):
        with pytest.raises(ValueError):
            WT._checked_layout(bad)
