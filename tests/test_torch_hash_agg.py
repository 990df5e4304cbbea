"""Port group table (blaze_tpu_torch/parallel/stage.py) against the JAX
package's scatter lane: the same carry, brought across with
blaze_tpu_torch.interop, goes one batch further in both packages, and
every leaf must be bit-identical, including the atomic overflow case and
the grow path (rehash_carry)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu import config as jconf
from blaze_tpu.parallel import stage as JS
from blaze_tpu_torch import interop
from blaze_tpu_torch.parallel import stage as TS

CPU = torch.device("cpu")
NAN_PATTERNS = np.array([0x7FF8000000000000, 0x7FF8000000000001,
                         0xFFF8000000000099], dtype=np.uint64)


@pytest.fixture(autouse=True)
def _jax_scatter_lane():
    jconf.conf.set("auron.tpu.kernels.pallas", "off")
    yield
    jconf.conf.unset("auron.tpu.kernels.pallas")


def _keys(rng, n, dtype, distinct):
    if np.issubdtype(dtype, np.floating):
        d = (rng.integers(0, distinct, n) - distinct // 2).astype(dtype)
        d[rng.random(n) < 0.08] = -0.0
        nan = rng.random(n) < 0.08
        if dtype == np.float64:
            d[nan] = NAN_PATTERNS[rng.integers(0, 3, int(nan.sum()))].view(
                np.float64)
        else:
            d[nan] = np.float32(np.nan)
    else:
        d = rng.integers(0, distinct, n).astype(dtype)
    return d, rng.random(n) > 0.1


def _batch(rng, n, key_dtypes, distinct):
    keys = [_keys(rng, n, dt, distinct) for dt in key_dtypes]
    vals = rng.random(n) * 100
    av = rng.random(n) > 0.2
    cnt = rng.integers(0, 5, n).astype(np.int64)
    mask = rng.random(n) > 0.2
    specs = [("sum", vals, av), ("min", vals, av), ("max", vals, av),
             ("count", cnt, av)]
    return keys, specs, mask


KINDS = ["sum", "min", "max", "count"]
ACC_DTYPES = (np.float64, np.float64, np.float64, np.int64)


def _jax_step(carry, keys, specs, mask):
    return JS.hash_agg_step(
        carry, [(jnp.asarray(d), jnp.asarray(v)) for d, v in keys],
        [(k, jnp.asarray(d), jnp.asarray(v)) for k, d, v in specs],
        jnp.asarray(mask), lane="scatter")


def _torch_step(carry, keys, specs, mask):
    return TS.hash_agg_step(
        carry, [(torch.from_numpy(d), torch.from_numpy(v)) for d, v in keys],
        [(k, torch.from_numpy(d), torch.from_numpy(v)) for k, d, v in specs],
        torch.from_numpy(mask))


def _leaves(jax_carry):
    return {"keys": [np.asarray(a) for a in jax_carry.keys],
            "key_valid": [np.asarray(a) for a in jax_carry.key_valid],
            "accs": [np.asarray(a) for a in jax_carry.accs],
            "acc_valid": [np.asarray(a) for a in jax_carry.acc_valid],
            "used": np.asarray(jax_carry.used)}


def _assert_bit_identical(a, b):
    for field in interop.CARRY_FIELDS:
        xs, ys = a[field], b[field]
        if field == "used":
            xs, ys = [xs], [ys]
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.shape == y.shape, field
            assert x.tobytes() == y.tobytes(), field


def _seeded(key_dtypes, S, rng, n, distinct):
    """A JAX carry after one batch, and the same carry in the port."""
    empty = JS.init_hash_carry([jnp.dtype(d) for d in key_dtypes], KINDS,
                               [jnp.dtype(d) for d in ACC_DTYPES], S)
    jc, ovf, _ = _jax_step(empty, *_batch(rng, n, key_dtypes, distinct))
    assert int(ovf) == 0
    leaves = _leaves(jc)
    return jc, interop.carry_from_numpy(leaves, CPU), leaves


@pytest.mark.parametrize("key_dtypes,n,S,distinct", [
    ((np.int64,), 1024, 1 << 12, 300), ((np.int32,), 1024, 1 << 12, 300),
    ((np.float64,), 1024, 1 << 12, 300), ((np.float32,), 1024, 1 << 12, 300),
    ((np.int64, np.int64), 1024, 1 << 12, 300),
    ((np.int64, np.float64), 1024, 1 << 12, 300),
    ((np.int64, np.int64), 4096, 1 << 15, 3000)])
def test_step_from_shared_carry_bit_identical(key_dtypes, n, S, distinct):
    rng = np.random.default_rng(len(key_dtypes) * 31 + n +
                                np.dtype(key_dtypes[0]).itemsize)
    jc, tc, leaves = _seeded(key_dtypes, S, rng, n, distinct=distinct)
    _assert_bit_identical(interop.carry_to_numpy(tc), leaves)
    batch = _batch(rng, n, key_dtypes, distinct=distinct)
    jn, jovf, jng = _jax_step(jc, *batch)
    tn, tovf, tng = _torch_step(tc, *batch)
    assert int(jovf) == tovf == 0 and int(jng) == int(tng)
    _assert_bit_identical(interop.carry_to_numpy(tn), _leaves(jn))


def test_overflow_is_atomic_in_both():
    rng = np.random.default_rng(9)
    n, S = 512, 64
    jc, tc, leaves = _seeded((np.int64,), S, rng, 40, distinct=30)
    batch = _batch(rng, n, (np.int64,), distinct=400)
    jn, jovf, _ = _jax_step(jc, *batch)
    tn, tovf, _ = _torch_step(tc, *batch)
    assert int(jovf) == tovf > 0
    # the step returns the carry it was given
    _assert_bit_identical(interop.carry_to_numpy(tn), leaves)
    _assert_bit_identical(_leaves(jn), leaves)


def test_rehash_carry_bit_identical():
    rng = np.random.default_rng(21)
    n, S = 1024, 1 << 11
    jc, tc, _ = _seeded((np.int64, np.float64), S, rng, n, distinct=500)
    jg, jovf, jng = JS.rehash_carry(jc, KINDS, 4 * S, lane="scatter")
    tg, tovf, tng = TS.rehash_carry(tc, KINDS, 4 * S)
    assert int(jovf) == tovf == 0 and int(jng) == int(tng)
    _assert_bit_identical(interop.carry_to_numpy(tg), _leaves(jg))


def test_interop_round_trips_batches():
    from blaze_tpu_torch.schema import FLOAT64, INT64, Field, Schema
    rng = np.random.default_rng(2)
    cols = [(rng.integers(0, 9, 256), rng.random(256) > 0.3),
            (rng.random(256), np.ones(256, bool))]
    schema = Schema([Field("k", INT64), Field("v", FLOAT64)])
    sel = rng.random(256) > 0.5
    b = interop.batch_from_numpy(schema, cols, 200, CPU, selection=sel)
    out = interop.batch_to_numpy(b)
    assert out["num_rows"] == 200
    np.testing.assert_array_equal(out["selection"], sel)
    for (d, v), (d2, v2) in zip(cols, out["columns"]):
        np.testing.assert_array_equal(d, d2)
        np.testing.assert_array_equal(v, v2)
