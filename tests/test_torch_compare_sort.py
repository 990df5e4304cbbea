"""The port's order keys, lexsort, group ids and segmented reductions
(blaze_tpu_torch/kernels/compare.py, kernels/sort.py) against the JAX
package's (blaze_tpu/kernels/compare.py, kernels/sort.py, on JAX-CPU),
over the same numpy-seeded columns: int8-int64, float32/64 with NaN,
-0.0, infinities and nulls, ascending and descending, nulls first and
last, with masked rows.

Tolerances: buckets, keys, permutations, group ids, counts, integer
results and min/max/first are exact (float min/max bit for bit, NaN
where NaN); float sums within 1e-12 relative (the same row order on both
CPUs, so they come out equal in practice).  The port keeps integer order
keys in int64 where the JAX package sign-biases them into uint64: its key
is the JAX key with the bias taken off, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import compare as JC
from blaze_tpu.kernels import sort as JK
from blaze_tpu.schema import DataType as JDataType
from blaze_tpu.schema import TypeId as JTypeId
from blaze_tpu_torch.kernels import compare as TC
from blaze_tpu_torch.kernels import sort as TK
from blaze_tpu_torch.schema import DataType, TypeId

DTYPES = ["int8", "int16", "int32", "int64", "float32", "float64"]
N = 1000
BIAS = np.uint64(1 << 63)


def _column(rng, dtype, n=N, distinct=40):
    """Values with many duplicates; floats with NaN, -0.0, 0.0 and
    infinities; a validity mask with ~10% nulls."""
    if dtype.startswith("float"):
        d = (rng.integers(0, distinct, n) - distinct // 2).astype(dtype)
        d /= 4
        special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf], dtype=dtype)
        pick = rng.random(n) < 0.15
        d[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
    else:
        info = np.iinfo(dtype)
        pool = np.concatenate([
            rng.integers(info.min, info.max, distinct // 2, dtype=dtype,
                         endpoint=True),
            np.array([info.min, info.max, 0, -1, 1], dtype=dtype)])
        d = pool[rng.integers(0, len(pool), n)]
    return d, rng.random(n) > 0.1


def _types(dtype):
    return JDataType(JTypeId(dtype)), DataType(TypeId(dtype))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype.kind == "f":
        return np.array_equal(a.view(f"u{a.itemsize}"),
                              b.view(f"u{b.itemsize}"))
    return np.array_equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_order_key_matches_jax(dtype, descending, nulls_first):
    rng = np.random.default_rng(7)
    d, v = _column(rng, dtype)
    jt, tt = _types(dtype)
    jb, jk = JC.order_key(jnp.asarray(d), jnp.asarray(v), jt, descending,
                          nulls_first)
    tb, tk = TC.order_key(_t(d), _t(v), tt, descending, nulls_first)
    assert np.array_equal(np.asarray(jb), tb.numpy())
    jk = np.asarray(jk)
    if dtype.startswith("float"):
        assert _bits_equal(jk, tk.numpy())
        # -0.0 and NaN are normalised away
        assert not np.signbit(tk.numpy()[tk.numpy() == 0]).any()
        assert not np.isnan(tk.numpy()).any()
    else:
        assert np.array_equal((jk ^ BIAS).view(np.int64), tk.numpy())


@pytest.mark.parametrize("dtypes", [("int64",), ("float64",), ("int8",),
                                    ("float32", "int16"),
                                    ("int32", "float64", "int64")])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_sort_indices_matches_jax(dtypes, descending, nulls_first, masked):
    rng = np.random.default_rng(len(dtypes) * 11 + descending)
    cols = [_column(rng, dt, distinct=8) for dt in dtypes]
    mask = rng.random(N) > 0.25 if masked else None
    desc = [descending ^ (i % 2 == 1) for i in range(len(dtypes))]
    nf = [nulls_first ^ (i % 2 == 1) for i in range(len(dtypes))]
    jperm = JK.sort_indices(
        [(jnp.asarray(d), jnp.asarray(v), _types(dt)[0])
         for (d, v), dt in zip(cols, dtypes)], desc, nf,
        None if mask is None else jnp.asarray(mask))
    tperm = TK.sort_indices(
        [(_t(d), _t(v), _types(dt)[1]) for (d, v), dt in zip(cols, dtypes)],
        desc, nf, None if mask is None else _t(mask))
    assert tperm.dtype == torch.int64
    assert np.array_equal(np.asarray(jperm), tperm.numpy())


def test_lexsort_ties_keep_input_order():
    keys = [_t(np.array([1, 0, 1, 0, 1], dtype=np.int64))]
    assert TC.lexsort_indices(keys).tolist() == [1, 3, 0, 2, 4]
    mask = _t(np.array([True, True, False, True, True]))
    assert TC.lexsort_indices(keys, mask).tolist() == [1, 3, 0, 4, 2]


def _sorted_operands(rng, dtypes, masked):
    """Both packages' order operands of the same columns, each sorted by
    its own permutation (equal, by test_sort_indices_matches_jax), and the
    sorted mask."""
    cols = [_column(rng, dt, distinct=6) for dt in dtypes]
    mask = rng.random(N) > 0.3 if masked else np.ones(N, dtype=bool)
    jops = JC.order_keys([(jnp.asarray(d), jnp.asarray(v), _types(dt)[0])
                          for (d, v), dt in zip(cols, dtypes)],
                         [False] * len(dtypes), [True] * len(dtypes))
    tops = TC.order_keys([(_t(d), _t(v), _types(dt)[1])
                          for (d, v), dt in zip(cols, dtypes)],
                         [False] * len(dtypes), [True] * len(dtypes))
    perm = np.asarray(JC.lexsort_indices(jops, jnp.asarray(mask)))
    return ([jnp.asarray(np.asarray(o)[perm]) for o in jops],
            [o[_t(perm.astype(np.int64))] for o in tops],
            mask[perm], cols, perm)


@pytest.mark.parametrize("dtypes", [("int64",), ("float32",),
                                    ("int8", "float64")])
@pytest.mark.parametrize("masked", [False, True])
def test_group_ids_from_sorted_matches_jax(dtypes, masked):
    rng = np.random.default_rng(3)
    jops, tops, smask, _cols, _perm = _sorted_operands(rng, dtypes, masked)
    jg, jn = JK.group_ids_from_sorted(jops, jnp.asarray(smask))
    tg, tn = TK.group_ids_from_sorted(tops, _t(smask))
    assert int(jn) == int(tn)
    assert np.array_equal(np.asarray(jg).astype(np.int64), tg.numpy())
    # a masked row 0 does not keep the first valid row from opening a group
    if masked:
        assert int(tn) > 0


def test_group_ids_first_valid_row_opens_a_group():
    ops = [_t(np.zeros(4, dtype=np.int64))]
    mask = np.array([False, True, True, False])
    tg, tn = TK.group_ids_from_sorted(ops, _t(mask))
    jg, jn = JK.group_ids_from_sorted([jnp.zeros(4, jnp.int64)],
                                      jnp.asarray(mask))
    assert int(tn) == int(jn) == 1
    assert tg.tolist() == np.asarray(jg).tolist() == [3, 0, 0, 3]


def _gids(rng, n_seg, n=N):
    """Group ids in [0, n_seg + 3): some out of range, as masked rows'."""
    return rng.integers(0, n_seg + 3, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_valid", [False, True])
def test_segment_reductions_match_jax(dtype, with_valid):
    rng = np.random.default_rng(DTYPES.index(dtype) * 2 + with_valid)
    n_seg = 37
    d, v = _column(rng, dtype, distinct=500)
    g = _gids(rng, n_seg)
    # leave two segments empty
    g[(g == 5) | (g == 11)] = n_seg + 1
    jv = jnp.asarray(v) if with_valid else None
    tv = _t(v) if with_valid else None
    jd, td, jg, tg = jnp.asarray(d), _t(d), jnp.asarray(g), _t(g)

    js = np.asarray(JK.segment_sum(jd, jg, n_seg, jv))
    ts = TK.segment_sum(td, tg, n_seg, tv).numpy()
    assert js.dtype == ts.dtype
    if dtype.startswith("float"):
        ok = np.isfinite(js)
        assert np.array_equal(np.isnan(js), np.isnan(ts))
        assert np.array_equal(js[np.isinf(js)], ts[np.isinf(js)])
        np.testing.assert_allclose(ts[ok], js[ok], rtol=1e-12, atol=0)
    else:
        assert np.array_equal(js, ts)
    assert np.array_equal(np.asarray(JK.segment_count(jnp.asarray(v), jg,
                                                      n_seg)),
                          TK.segment_count(_t(v), tg, n_seg).numpy())
    for jf, tf in ((JK.segment_min, TK.segment_min),
                   (JK.segment_max, TK.segment_max)):
        assert _bits_equal(np.asarray(jf(jd, jg, n_seg, jv)),
                           tf(td, tg, n_seg, tv).numpy())
    for jf, tf in ((JK.segment_first, TK.segment_first),
                   (JK.segment_first_ignores_null,
                    TK.segment_first_ignores_null)):
        jx, jxv = jf(jd, jnp.asarray(v), jg, n_seg)
        tx, txv = tf(td, _t(v), tg, n_seg)
        assert np.array_equal(np.asarray(jxv), txv.numpy())
        assert _bits_equal(np.asarray(jx), tx.numpy())


def test_segment_min_max_propagate_nan_and_fill_empty_segments():
    d = np.array([1.0, np.nan, 3.0, -2.0], dtype=np.float64)
    g = np.array([0, 0, 1, 9])
    for jf, tf in ((JK.segment_min, TK.segment_min),
                   (JK.segment_max, TK.segment_max)):
        want = np.asarray(jf(jnp.asarray(d), jnp.asarray(g), 3))
        got = tf(_t(d), _t(g), 3).numpy()
        assert np.array_equal(want, got, equal_nan=True)
        assert np.isnan(got[0]) and np.isinf(got[2])
    for dtype in ("int8", "int64"):
        x = np.array([5, -3], dtype=dtype)
        gg = np.array([0, 0])
        for jf, tf in ((JK.segment_min, TK.segment_min),
                       (JK.segment_max, TK.segment_max)):
            assert np.array_equal(np.asarray(jf(jnp.asarray(x),
                                                jnp.asarray(gg), 2)),
                                  tf(_t(x), _t(gg), 2).numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_segment_boundaries_to_offsets_matches_jax(masked):
    rng = np.random.default_rng(5)
    _jops, tops, smask, _c, _p = _sorted_operands(rng, ("int16",), masked)
    tg, tn = TK.group_ids_from_sorted(tops, _t(smask))
    want = np.asarray(JK.segment_boundaries_to_offsets(
        jnp.asarray(tg.numpy()), jnp.asarray(int(tn)), N))
    got = TK.segment_boundaries_to_offsets(tg, tn, N).numpy()
    assert np.array_equal(want.astype(np.int64), got)


def test_null_aware_eq_and_rows_differ_match_jax():
    a = np.array([1.0, np.nan, 2.0, 0.0, 5.0])
    b = np.array([1.0, np.nan, 3.0, -0.0, 5.0])
    av = np.array([True, True, True, True, False])
    bv = np.array([True, True, True, True, False])
    want = np.asarray(JC.null_aware_eq(jnp.asarray(a), jnp.asarray(av),
                                       jnp.asarray(b), jnp.asarray(bv)))
    got = TC.null_aware_eq(_t(a), _t(av), _t(b), _t(bv)).numpy()
    assert np.array_equal(want, got)
    assert got.tolist() == [True, True, False, True, True]
    k = np.array([3, 3, 4, 4, 4, 7], dtype=np.int64)
    assert np.array_equal(
        np.asarray(JC.rows_differ_from_prev([jnp.asarray(k)])),
        TC.rows_differ_from_prev([_t(k)]).numpy())
