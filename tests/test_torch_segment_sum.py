"""`kernels/sort.py` `segment_sum` adds floats in row order.

On the CPU `segment_sum` is one `index_add_`; these tests hold it, bit for
bit, to a sequential float loop over each segment's rows in row order
starting from +0.0: `np.cumsum` over the segment with a leading 0.0, its
last element (not `np.add.reduce`, which adds pairwise and differs in the
last bits).  That row-order sum is what the card's kernel
(csrc/segment_sum.cu) must give too; `chip_smoke.py` holds the kernel to
this CPU result on the card, where `index_add_` adds with atomics in no
fixed order.  Cases: segments contiguous (the generic engine's, after its
lexsort) and scattered (the dict-device lane's dense tables,
parallel/stage.py `dense_partial_agg`, whose float sums go through
`segment_sum` too), NaN, +-inf and -0.0 among the values, empty segments,
ids out of range (dropped), rows masked by `valid`, float32 and float64.
Tolerance: none (bits equal; NaN where the loop gives NaN).
"""

import numpy as np
import pytest
import torch

from blaze_tpu_torch.kernels import sort as K

SEED = 70


def _row_order(values, gids, num_segments, valid=None):
    """Each segment's sequential sum in row order from +0.0, in the
    values' type."""
    dt = values.dtype
    keep = np.ones(len(values), bool) if valid is None else valid
    out = np.zeros(num_segments, dt)
    for s in range(num_segments):
        rows = values[(gids == s) & keep]
        with np.errstate(invalid="ignore"):  # inf - inf is NaN, as wanted
            out[s] = np.cumsum(np.concatenate([np.zeros(1, dt), rows]),
                               dtype=dt)[-1]
    return out


def _same_bits(got, want):
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    w = got.dtype.itemsize * 8
    view = {32: np.int32, 64: np.int64}[w]
    assert np.array_equal(got[~nan].view(view), want[~nan].view(view))


def _values(rng, n, dtype, specials):
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 9, n)).astype(dtype)
    if specials:
        at = rng.choice(n, size=min(n, 12), replace=False)
        v[at[:3]] = np.nan
        v[at[3:6]] = np.inf
        v[at[6:9]] = -np.inf
        v[at[9:]] = -0.0
    return v


CASES = {
    # name: (rows, segments, contiguous ids, specials, masked)
    "contiguous": (40_000, 37, True, False, False),
    "contiguous with masked rows": (40_000, 37, True, False, True),
    "one long segment": (1 << 17, 1, True, False, False),
    "scattered": (20_000, 500, False, False, False),
    "scattered with masked rows": (20_000, 500, False, False, True),
    "nan and infinities": (5_000, 40, True, True, False),
    "nan and infinities scattered": (5_000, 40, False, True, True),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sum_is_the_row_order_sum(case, dtype):
    n, S, contiguous, specials, masked = CASES[case]
    rng = np.random.default_rng(SEED)
    v = _values(rng, n, dtype, specials)
    if contiguous:
        # sorted ids, every third segment empty, the tail out of range as
        # the engine's masked rows are (capacity - 1, past the groups)
        live = np.array([s for s in range(S) if s % 3 != 1 or S == 1])
        g = np.sort(rng.choice(live, n))
        g[-n // 50:] = n - 1
    else:
        g = rng.integers(-2, S + 3, n)
    valid = rng.random(n) > 0.2 if masked else None
    got = K.segment_sum(torch.from_numpy(v), torch.from_numpy(g), S,
                        None if valid is None else torch.from_numpy(valid),
                        contiguous=contiguous).numpy()
    want = _row_order(v, g, S, valid)
    _same_bits(got, want)
    if contiguous and not specials:
        # the pairwise sum differs: the test can tell the orders apart
        keep = np.ones(n, bool) if valid is None else valid
        pairwise = np.array([np.add.reduce(v[(g == s) & keep])
                             for s in range(S)], dtype)
        assert not np.array_equal(pairwise, want)


def test_negative_zero_sums_to_positive_zero():
    v = torch.tensor([-0.0, -0.0, 1.0, -1.0], dtype=torch.float64)
    g = torch.tensor([0, 0, 1, 1])
    got = K.segment_sum(v, g, 3).numpy()
    assert np.array_equal(np.signbit(got), [False, False, False])


def test_empty_input_gives_zeros():
    v = torch.zeros(0, dtype=torch.float64)
    got = K.segment_sum(v, torch.zeros(0, dtype=torch.int64), 4)
    assert got.tolist() == [0.0] * 4


def test_the_card_route_takes_only_float32_and_float64():
    """A half-precision tensor has no row-order kernel: the card's route
    raises (it is never handed to index_add_), before any build."""
    v = torch.zeros(4, dtype=torch.float16)
    with pytest.raises(TypeError, match="no row-order kernel"):
        K._segment_sum_cuda(v, torch.zeros(4, dtype=torch.int64), 2, None,
                            True)


def test_the_dense_tables_float_sums_are_the_row_order_sums():
    """The dict-device lane's batch table (q70's ROLLUP runs there) sums
    floats through segment_sum: row order, masked rows dropped."""
    from blaze_tpu_torch.parallel.stage import dense_partial_agg
    rng = np.random.default_rng(SEED)
    n, S = 30_000, 9
    v = _values(rng, n, np.float64, False)
    g = rng.integers(0, S, n)
    mask = rng.random(n) > 0.1
    vvalid = rng.random(n) > 0.1
    accs, avalid, _occ = dense_partial_agg(
        torch.from_numpy(g), S,
        [("sum", torch.from_numpy(v), torch.from_numpy(vvalid))],
        torch.from_numpy(mask))
    _same_bits(accs[0].numpy(), _row_order(v, g, S, mask & vvalid))
