"""Port hashing (blaze_tpu_torch/kernels/hashing.py) against the JAX
package's numpy lane and Spark's own vectors: murmur3, xxhash64, pmod and
partition ids, bit for bit, including NULLs, +-0.0 and several NaN bit
patterns."""

import numpy as np
import pytest
import torch

from blaze_tpu.kernels import hashing as JH
from blaze_tpu_torch.kernels import hashing as TH

NAN_PATTERNS = np.array([0x7FF8000000000000, 0x7FF8000000000001,
                         0xFFF8000000000099, 0x7FF0000000000001],
                        dtype=np.uint64)


def _column(rng, tid, n):
    if tid == "bool":
        return rng.random(n) < 0.5
    if tid in ("int8", "int16", "int32", "date32"):
        dt = {"int8": np.int8, "int16": np.int16}.get(tid, np.int32)
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, endpoint=True).astype(dt)
    if tid in ("int64", "timestamp_us"):
        return rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                            n, endpoint=True, dtype=np.int64)
    if tid == "float64":
        d = rng.normal(size=n) * 1e6
        d[rng.random(n) < 0.1] = 0.0
        d[rng.random(n) < 0.1] = -0.0
        nan = rng.random(n) < 0.15
        d[nan] = NAN_PATTERNS[rng.integers(0, 4, int(nan.sum()))].view(
            np.float64)
        return d
    d = (rng.normal(size=n) * 1e3).astype(np.float32)
    d[rng.random(n) < 0.1] = np.float32(-0.0)
    nan = rng.random(n) < 0.15
    d[nan] = np.array([0x7FC00000, 0x7FC00001, 0xFFC00007],
                      dtype=np.uint32)[rng.integers(0, 3, int(nan.sum()))
                                       ].view(np.float32)
    return d


TIDS = ["bool", "int8", "int16", "int32", "date32", "int64", "timestamp_us",
        "float32", "float64"]


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("tid", TIDS)
def test_hash_columns_match_jax(tid, algo):
    rng = np.random.default_rng(abs(hash((tid, algo))) % 2**32)
    n = 2000
    vals = _column(rng, tid, n)
    valid = rng.random(n) > 0.2
    want = JH.hash_columns([(vals, valid, tid)], seed=42, xp=np, algo=algo)
    got = TH.hash_columns([(torch.from_numpy(vals), torch.from_numpy(valid),
                            tid)], seed=42, algo=algo)
    assert got.dtype == (torch.int32 if algo == "murmur3" else torch.int64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
def test_multi_column_chain_matches_jax(algo):
    rng = np.random.default_rng(7)
    n = 3000
    cols = [(_column(rng, t, n), rng.random(n) > 0.1, t)
            for t in ("int64", "int32", "float64", "bool")]
    want = JH.hash_columns(cols, seed=42, xp=np, algo=algo)
    got = TH.hash_columns([(torch.from_numpy(v), torch.from_numpy(m), t)
                           for v, m, t in cols], seed=42, algo=algo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_spark_vectors():
    i32 = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    assert TH.hash_columns([(i32, None, "int32")]).tolist() == [
        -559580957, 1765031574, -1823081949, -397064898]
    i64 = torch.tensor([1, 0, -1, 2**63 - 1, -2**63], dtype=torch.int64)
    want = np.array([0x99F0149D, 0x9C67B85D, 0xC8008529, 0xA05B5D7B,
                     0xCD1E64FB], dtype=np.uint32).view(np.int32)
    np.testing.assert_array_equal(
        TH.hash_columns([(i64, None, "int64")]).numpy(), want)
    np.testing.assert_array_equal(
        TH.hash_columns([(i64, None, "int64")], algo="xxhash64").numpy(),
        [-7001672635703045582, -5252525462095825812, 3858142552250413010,
         -3246596055638297850, -8619748838626508300])
    nulls = TH.hash_columns([(torch.tensor([1, 1], dtype=torch.int32),
                              torch.tensor([True, False]), "int32")])
    assert nulls.tolist() == [-559580957, 42]


@pytest.mark.parametrize("n_parts", [1, 16, 200])
def test_pmod_and_partition_ids_match_jax(n_parts):
    rng = np.random.default_rng(n_parts)
    h = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    np.testing.assert_array_equal(
        TH.pmod(torch.from_numpy(h), n_parts).numpy(),
        np.asarray(JH.pmod(h, n_parts, xp=np)))
    n = 4000
    flat = [(_column(rng, "int64", n), rng.random(n) > 0.1),
            (_column(rng, "float64", n), rng.random(n) > 0.1),
            (_column(rng, "float32", n), rng.random(n) > 0.1)]
    tids = ["int64", "float64", "float32"]
    want = JH.spark_partition_ids(flat, tids, n_parts, xp=np)
    got = TH.spark_partition_ids(
        [(torch.from_numpy(v), torch.from_numpy(m)) for v, m in flat],
        tids, n_parts)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_norm_float_keys_unify_zero_and_nan_patterns():
    d = np.array([0.0, -0.0, *NAN_PATTERNS.view(np.float64), 1.5])
    v = np.ones(len(d), dtype=bool)
    (got, _), = TH.norm_float_keys([(torch.from_numpy(d),
                                     torch.from_numpy(v))], ["float64"])
    (want, _), = JH.norm_float_keys([(d, v)], ["float64"], np)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    h = TH.hash_columns([(got, None, "float64")], algo="xxhash64")
    assert h[0] == h[1] and len(set(h[2:6].tolist())) == 1
