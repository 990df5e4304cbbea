"""Spark-compatible bloom filter (port of blaze_tpu/kernels/bloom.py,
plain `jnp` there, no Pallas kernel).

Spark's `org.apache.spark.util.sketch.BloomFilterImpl` over longs:
  * two 32-bit murmur3 hashes of the long, h1 = hashLong(v, 0) and
    h2 = hashLong(v, h1); hash i (1..k) is the int32 h1 + i * h2, its bits
    flipped when negative, modulo the bit count;
  * the bits are int64 words; the serialized form is int32 version (1),
    int32 numHashFunctions, int32 numWords, then the words, all
    big-endian.

The filter is built on the host in numpy (the bloom_filter aggregate's
update and merge) and probed on the batch's device as torch ops
(`might_contain_longs`, the runtime filter of `BloomFilterMightContain`):
the words are copied to each device once and kept there.
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np
import torch

from blaze_tpu_torch.kernels import hashing

_I32 = 1 << 32


def optimal_num_bits(expected_items: int, fpp: float) -> int:
    n = max(expected_items, 1)
    bits = int(-n * np.log(fpp) / (np.log(2.0) ** 2))
    return max(64, bits)


def optimal_num_hashes(expected_items: int, num_bits: int) -> int:
    n = max(expected_items, 1)
    k = int(round(num_bits / n * np.log(2.0)))
    return max(1, k)


def _h1_h2_long(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h1, h2) of int64 values as int32 bits held in int64."""
    h1 = hashing.murmur3_hash_long(values, torch.zeros_like(values))
    h2 = hashing.murmur3_hash_long(values, h1)
    return _wrap32(h1), _wrap32(h2)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> the int32 of their low 32 bits, held in int64."""
    return ((x + (1 << 31)) & (_I32 - 1)) - (1 << 31)


def _bit_indexes(h1: torch.Tensor, h2: torch.Tensor, i: int,
                 num_bits: int) -> torch.Tensor:
    """Hash i's bit of each value: Java's int h1 + i * h2, ~ when
    negative, % the bit count."""
    combined = _wrap32(h1 + i * h2)
    combined = torch.where(combined < 0, ~combined, combined)
    return combined % num_bits


class SparkBloomFilter:
    """Bit array as int64 words; host build, device probe."""

    def __init__(self, num_bits: int, num_hashes: int):
        self.num_bits = (num_bits + 63) // 64 * 64
        self.num_hashes = num_hashes
        self.words = np.zeros(self.num_bits // 64, dtype=np.int64)
        self._device_words: dict = {}

    # -- build (host) -------------------------------------------------------
    def put_longs(self, values: np.ndarray) -> None:
        values = np.ascontiguousarray(values, dtype=np.int64)
        if values.size == 0:
            return
        h1, h2 = _h1_h2_long(torch.from_numpy(values))
        for i in range(1, self.num_hashes + 1):
            bit = _bit_indexes(h1, h2, i, self.num_bits).numpy()
            np.bitwise_or.at(self.words, bit // 64,
                             np.left_shift(np.int64(1), bit % 64))
        self._device_words = {}

    # -- probe (device) -----------------------------------------------------
    def device_words(self, device: torch.device) -> torch.Tensor:
        """The words on `device`, copied there once."""
        key = str(device)
        w = self._device_words.get(key)
        if w is None:
            from blaze_tpu_torch.batch import to_device
            w = self._device_words[key] = to_device(self.words, device)
        return w

    def might_contain_longs(self, values: torch.Tensor,
                            valid: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """Per value: False where it surely was never put, True where it
        may have been; a row with `valid` False passes (the expression
        nulls it)."""
        values = values.to(torch.int64)
        words = self.device_words(values.device)
        h1, h2 = _h1_h2_long(values)
        out = torch.ones(values.shape[0], dtype=torch.bool,
                         device=values.device)
        for i in range(1, self.num_hashes + 1):
            bit = _bit_indexes(h1, h2, i, self.num_bits)
            w = words.index_select(0, bit // 64)
            out = out & (((w >> (bit % 64)) & 1) != 0)
        if valid is not None:
            out = out | ~valid
        return out

    # -- merge / serde ------------------------------------------------------
    def merge(self, other: "SparkBloomFilter") -> None:
        if (self.num_bits, self.num_hashes) != (other.num_bits,
                                                other.num_hashes):
            raise ValueError(
                f"cannot merge a bloom filter of {other.num_bits} bits and "
                f"{other.num_hashes} hashes into one of {self.num_bits} "
                f"bits and {self.num_hashes} hashes")
        self.words |= other.words
        self._device_words = {}

    def to_bytes(self) -> bytes:
        header = struct.pack(">iii", 1, self.num_hashes, len(self.words))
        return header + self.words.astype(">i8").tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "SparkBloomFilter":
        version, k, n_words = struct.unpack_from(">iii", data, 0)
        if version != 1:
            raise ValueError(f"unsupported bloom filter version {version}")
        words = np.frombuffer(data, dtype=">i8", count=n_words, offset=12)
        f = SparkBloomFilter(n_words * 64, k)
        f.words = words.astype(np.int64)
        return f
