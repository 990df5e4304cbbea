"""Spark-compatible murmur3 (seed 42) and xxhash64 over torch tensors (port
of the fixed-width part of blaze_tpu/kernels/hashing.py).

These are plain elementwise tensor code in both packages.  torch has no
full uint32/uint64 arithmetic, so:

  * murmur3's 32-bit lanes live in int64 holding values in [0, 2**32):
    every product and shift is masked back with `& 0xFFFFFFFF`;
  * xxhash64's 64-bit lanes live in int64, where addition and
    multiplication wrap modulo 2**64 exactly as uint64 does; every right
    shift is made logical by masking off the sign-extended high bits.

Hash chaining across columns matches Spark: the running hash of row i is
the seed for the next column; NULL leaves the running hash unchanged.

utf8/binary values hash as the JAX package hashes them: a padded
(rows, max_len) uint8 byte matrix with per-row lengths
(`string_column_to_padded_bytes`, offsets resolved on the host), hashed
word by word across all rows at once on the matrix's device (Spark's
hashUnsafeBytes for murmur3, XXH64's stripes, longs, int and bytes for
xxhash64).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593


def _s64(c: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


# ---------------------------------------------------------------------------
# murmur3_x86_32 (Spark Murmur3_x86_32) in int64-held uint32 lanes
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    return (x * c) & _M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    return _mul32(_rotl32(_mul32(k1, _C1), 15), _C2)


def _mix_h1(h1, k1):
    return (_mul32(_rotl32(h1 ^ k1, 13), 5) + 0xE6546B64) & _M32


def _fmix(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, 0x85EBCA6B)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def _as_u32(values: torch.Tensor) -> torch.Tensor:
    """int32-like values -> their uint32 bits, held in int64."""
    return values.to(torch.int32).to(torch.int64) & _M32


def murmur3_hash_int(values: torch.Tensor, seeds: torch.Tensor):
    """Spark Murmur3_x86_32.hashInt: values int32-like, seeds uint32 bits
    held in int64."""
    return _fmix(_mix_h1(seeds, _mix_k1(_as_u32(values))), 4)


def murmur3_hash_long(values: torch.Tensor, seeds: torch.Tensor):
    """Spark Murmur3_x86_32.hashLong: low 32-bit word then high word."""
    v = values.to(torch.int64)
    lo = v & _M32
    hi = (v >> 32) & _M32
    h1 = _mix_h1(seeds, _mix_k1(lo))
    h1 = _mix_h1(h1, _mix_k1(hi))
    return _fmix(h1, 8)


def murmur3_hash_bytes(byte_mat: torch.Tensor, lengths: torch.Tensor,
                       seeds: torch.Tensor) -> torch.Tensor:
    """Spark Murmur3_x86_32.hashUnsafeBytes over padded byte rows:
    little-endian 4-byte words over the aligned prefix, then each tail
    byte mixed as a SIGNED byte (Spark's getByte).  byte_mat (rows,
    max_len) uint8, lengths (rows,) int, seeds uint32 bits in int64."""
    rows, max_len = byte_mat.shape
    pad = (-max_len) % 4
    b = byte_mat.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(rows, pad)], dim=1)
    words = b.reshape(rows, -1, 4)
    w = (words[:, :, 0] | (words[:, :, 1] << 8) | (words[:, :, 2] << 16)
         | (words[:, :, 3] << 24))
    lengths = lengths.to(torch.int64)
    aligned_words = lengths // 4
    h1 = seeds
    for j in range(w.shape[1]):
        mixed = _mix_h1(h1, _mix_k1(w[:, j]))
        h1 = torch.where(j < aligned_words, mixed, h1)
    tail_start = aligned_words * 4
    for t in range(3):
        idx = tail_start + t
        g = torch.gather(b, 1, idx.clamp(0, b.shape[1] - 1)[:, None])[:, 0]
        signed = torch.where(g >= 128, g - 256, g) & _M32
        h1 = torch.where(idx < lengths, _mix_h1(h1, _mix_k1(signed)), h1)
    return _fmix(h1, lengths & _M32)


# ---------------------------------------------------------------------------
# xxhash64 (Spark XXH64) in wrapping int64 lanes
# ---------------------------------------------------------------------------

def _srl(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64-held uint64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _srl(x, 64 - r)


def _fmix64(h):
    h = h ^ _srl(h, 33)
    h = h * _P2
    h = h ^ _srl(h, 29)
    h = h * _P3
    return h ^ _srl(h, 32)


def xxhash64_long(values: torch.Tensor, seeds: torch.Tensor):
    """Spark XXH64.hashLong (8-byte input); seeds int64-held uint64."""
    v = values.to(torch.int64)
    h = seeds + _P5 + 8
    k1 = _rotl64(v * _P2, 31) * _P1
    h = h ^ k1
    h = _rotl64(h, 27) * _P1 + _P4
    return _fmix64(h)


def xxhash64_int(values: torch.Tensor, seeds: torch.Tensor):
    """Spark XXH64.hashInt (4-byte input, zero-extended)."""
    v = _as_u32(values)
    h = seeds + _P5 + 4
    h = h ^ (v * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _fmix64(h)


def _round64(v, k):
    return _rotl64(v + k * _P2, 31) * _P1


def xxhash64_bytes(byte_mat: torch.Tensor, lengths: torch.Tensor,
                   seeds: torch.Tensor) -> torch.Tensor:
    """Spark XXH64.hashUnsafeBytes over padded byte rows: 32-byte
    stripes, then 8-byte longs, one 4-byte int and single bytes, each
    step masked per row by its length.  seeds int64-held uint64."""
    rows, max_len = byte_mat.shape
    pad = (-max_len) % 32
    b = byte_mat.to(torch.int64)
    if pad:
        b = torch.cat([b, b.new_zeros(rows, pad)], dim=1)
    padded_len = b.shape[1]
    lengths = lengths.to(torch.int64)
    w64 = b.reshape(rows, -1, 8)
    longs = w64[:, :, 0]
    for i in range(1, 8):
        longs = longs | (w64[:, :, i] << (8 * i))
    w32 = b.reshape(rows, -1, 4)
    ints = w32[:, :, 0]
    for i in range(1, 4):
        ints = ints | (w32[:, :, i] << (8 * i))

    n_stripes = lengths // 32
    v1 = seeds + _P1 + _P2
    v2 = seeds + _P2
    v3 = seeds
    v4 = seeds - _P1
    for st in range(padded_len // 32):
        active = st < n_stripes
        base = 4 * st
        v1 = torch.where(active, _round64(v1, longs[:, base + 0]), v1)
        v2 = torch.where(active, _round64(v2, longs[:, base + 1]), v2)
        v3 = torch.where(active, _round64(v3, longs[:, base + 2]), v3)
        v4 = torch.where(active, _round64(v4, longs[:, base + 3]), v4)
    merged = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12)
              + _rotl64(v4, 18))
    for v in (v1, v2, v3, v4):
        merged = merged ^ (_rotl64(v * _P2, 31) * _P1)
        merged = merged * _P1 + _P4
    h = torch.where(lengths >= 32, merged, seeds + _P5)
    h = h + lengths

    offset = n_stripes * 32
    n_longs = lengths // 8
    for j in range(padded_len // 8):
        active = (j * 8 >= offset) & (j < n_longs)
        k1 = _rotl64(longs[:, j] * _P2, 31) * _P1
        h = torch.where(active, _rotl64(h ^ k1, 27) * _P1 + _P4, h)
    offset = n_longs * 8

    has_int = (lengths - offset) >= 4
    k = torch.gather(ints, 1, (offset // 4).clamp(
        0, ints.shape[1] - 1)[:, None])[:, 0]
    h = torch.where(has_int, _rotl64(h ^ (k * _P1), 23) * _P2 + _P3, h)
    offset = offset + torch.where(has_int, 4, 0)

    for t in range(7):
        idx = offset + t
        g = torch.gather(b, 1, idx.clamp(0, padded_len - 1)[:, None])[:, 0]
        h = torch.where(idx < lengths, _rotl64(h ^ (g * _P5), 11) * _P1, h)
    return _fmix64(h)


def string_column_to_padded_bytes(arr) -> Tuple:
    """pyarrow string/binary array -> ((byte_mat uint8 (n, max_len),
    lengths int32), valid bool), numpy: the pointer-free form, offsets
    resolved on the host (a copy of the JAX package's function)."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_large_string(arr.type) or \
            pa.types.is_large_binary(arr.type):
        arr = arr.cast(pa.binary())
    n = len(arr)
    if n == 0:
        return ((np.zeros((0, 4), dtype=np.uint8),
                 np.zeros(0, dtype=np.int32)), np.ones(0, dtype=bool))
    validity_buf = arr.buffers()[0]
    if validity_buf is None or arr.null_count == 0:
        valid = np.ones(n, dtype=bool)
    else:
        bits = np.unpackbits(np.frombuffer(validity_buf, dtype=np.uint8),
                             bitorder="little")
        valid = bits[arr.offset:arr.offset + n].astype(bool)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32)[
        arr.offset:arr.offset + n + 1].astype(np.int64)
    data_buf = arr.buffers()[2]
    data = (np.frombuffer(data_buf, dtype=np.uint8) if data_buf is not None
            else np.zeros(0, dtype=np.uint8))
    lengths = np.diff(offsets).astype(np.int32)
    max_len = max(int(lengths.max()), 4)
    if len(data) == 0:
        mat = np.zeros((n, max_len), dtype=np.uint8)
    else:
        idx = offsets[:-1, None] + np.arange(max_len)[None, :]
        in_range = np.arange(max_len)[None, :] < lengths[:, None]
        mat = np.where(in_range, data[np.clip(idx, 0, len(data) - 1)],
                       np.uint8(0))
    lengths = np.where(valid, lengths, 0).astype(np.int32)
    return (mat, lengths), valid


def padded_string_key(arr, capacity: int, device: torch.device):
    """A utf8 key column as hash operands on `device`: ((byte_mat,
    lengths), valid), rows padded to `capacity` and the width to a power
    of two of at least 4 bytes, as the JAX package pads them."""
    (mat, lengths), valid = string_column_to_padded_bytes(arr)
    w = max(4, 1 << (mat.shape[1] - 1).bit_length()) if mat.shape[1] else 4
    full = np.zeros((capacity, w), dtype=np.uint8)
    full[:mat.shape[0], :mat.shape[1]] = mat
    full_len = np.zeros(capacity, dtype=np.int32)
    full_len[:len(lengths)] = lengths
    full_valid = np.zeros(capacity, dtype=bool)
    full_valid[:len(valid)] = valid
    from blaze_tpu_torch.batch import to_device
    return ((to_device(full, device), to_device(full_len, device)),
            to_device(full_valid, device))


# ---------------------------------------------------------------------------
# column-level drivers (null skipping + cross-column chaining, Spark style)
# ---------------------------------------------------------------------------

def _hash_fixed_column(values, validity, dtype_id: str, seeds, algo: str):
    """One column's contribution; NULL rows keep their incoming seed."""
    int_fn = murmur3_hash_int if algo == "murmur3" else xxhash64_int
    long_fn = murmur3_hash_long if algo == "murmur3" else xxhash64_long
    if dtype_id in ("bool", "int8", "int16", "int32", "date32"):
        h = int_fn(values.to(torch.int32), seeds)
    elif dtype_id in ("int64", "timestamp_us", "decimal"):
        # a decimal of precision <= 18 hashes as its unscaled long
        h = long_fn(values.to(torch.int64), seeds)
    elif dtype_id == "float32":
        f = values.to(torch.float32)
        # Spark: hashInt(floatToIntBits(f)); Java canonicalizes NaN
        bits = torch.where(torch.isnan(f),
                           torch.full_like(f.view(torch.int32), 0x7FC00000),
                           f.view(torch.int32))
        h = int_fn(bits, seeds)
    elif dtype_id == "float64":
        f = values.to(torch.float64)
        bits = torch.where(torch.isnan(f),
                           torch.full_like(f.view(torch.int64),
                                           0x7FF8000000000000),
                           f.view(torch.int64))
        h = long_fn(bits, seeds)
    elif dtype_id in ("utf8", "binary"):
        byte_mat, lengths = values
        fn = murmur3_hash_bytes if algo == "murmur3" else xxhash64_bytes
        h = fn(byte_mat, lengths, seeds)
    else:
        raise TypeError(f"unsupported fixed-width type for hashing: {dtype_id}")
    if validity is None:
        return h
    return torch.where(validity, h, seeds)


def hash_columns(columns: Sequence[Tuple], seed: int = 42,
                 algo: str = "murmur3", num_rows: Optional[int] = None):
    """Spark-chained multi-column hash over (values, validity_or_None,
    type_id_str) triples; utf8/binary values are (byte_mat, lengths)
    pairs.  Returns int32 (murmur3) or int64 (xxhash64)."""
    if not columns:
        raise ValueError("need at least one column")
    first = columns[0][0]
    if isinstance(first, tuple):
        first = first[0]
    if num_rows is None:
        num_rows = first.shape[0]
    seeds = torch.full((num_rows,), seed, dtype=torch.int64,
                       device=first.device)
    for values, validity, tid in columns:
        seeds = _hash_fixed_column(values, validity, tid, seeds, algo)
    if algo == "murmur3":
        return u32_to_i32(seeds)
    return seeds


def u32_to_i32(h: torch.Tensor) -> torch.Tensor:
    """uint32 bits held in int64 -> the int32 with the same bits."""
    return torch.where(h >= (1 << 31), h - (1 << 32), h).to(torch.int32)


def wide_decimal_key(arr, capacity: int, device: torch.device):
    """A precision > 18 decimal host column as a hash operand: Spark hashes
    it as the bytes of its unscaled BigInteger (toByteArray, the minimal
    big-endian two's complement), so it chains as a "binary" column of
    those bytes (kernels/decimal128.py `minimal_be_bytes`)."""
    from blaze_tpu_torch.batch import to_device
    from blaze_tpu_torch.kernels.decimal128 import (int128_limbs,
                                                    minimal_be_bytes)
    hi, lo = int128_limbs(arr)
    mat, lengths = minimal_be_bytes(hi, lo)
    n = len(arr)
    full = np.zeros((capacity, 16), dtype=np.uint8)
    full[:n] = mat
    full_len = np.zeros(capacity, dtype=np.int32)
    full_len[:n] = lengths
    valid = np.zeros(capacity, dtype=bool)
    valid[:n] = np.ones(n, dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    return ((to_device(full, device), to_device(full_len, device)),
            to_device(valid, device))


def norm_float_keys(flat_cols, tids):
    """Normalize -0.0 -> 0.0 and NaN -> one canonical pattern in float key
    columns before hashing (Spark's NormalizeFloatingNumbers)."""
    out = []
    for (v, val), tid in zip(flat_cols, tids):
        if tid in ("float32", "float64"):
            v = torch.where(v == 0, v.abs(), v)
            v = torch.where(torch.isnan(v),
                            torch.full_like(v, float("nan")), v)
        out.append((v, val))
    return out


def pmod(hashes: torch.Tensor, n: int) -> torch.Tensor:
    """Spark's non-negative modulo for partition ids."""
    h = hashes.to(torch.int32)
    m = torch.remainder(h, n)
    return torch.where(m < 0, m + n, m).to(torch.int32)


def spark_partition_ids(flat_cols, tids, num_partitions: int):
    """pmod(murmur3(normalize(keys), seed=42), P): the one partition id
    definition (normalization included)."""
    flat_cols = norm_float_keys(flat_cols, tids)
    cols = [(v, val, tid) for (v, val), tid in zip(flat_cols, tids)]
    h = hash_columns(cols, seed=42, algo="murmur3")
    return pmod(h, num_partitions)
