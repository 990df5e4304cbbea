"""String kernels over the pointer-free (byte_mat, lengths) form, as
torch ops (port of blaze_tpu/kernels/strings.py).

`hashing.string_column_to_padded_bytes` gives a (rows, width) uint8
matrix and int32 byte lengths.  Predicates with a constant pattern
compare against it column by column.  In the JAX package these are plain
jnp functions (no Pallas kernel), and no query path calls them: the
string expressions run on the host over Arrow.  They are kept for the
device form and held to the JAX functions by the tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _pattern(pattern: bytes, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.frombuffer(pattern, dtype=np.uint8).copy()
                            ).to(device)


def starts_with(byte_mat: torch.Tensor, lengths: torch.Tensor,
                pattern: bytes) -> torch.Tensor:
    m = len(pattern)
    n = byte_mat.shape[0]
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=byte_mat.device)
    if m > byte_mat.shape[1]:
        return torch.zeros(n, dtype=torch.bool, device=byte_mat.device)
    pat = _pattern(pattern, byte_mat.device)
    eq = (byte_mat[:, :m] == pat[None, :]).all(dim=1)
    return eq & (lengths >= m)


def ends_with(byte_mat: torch.Tensor, lengths: torch.Tensor,
              pattern: bytes) -> torch.Tensor:
    m = len(pattern)
    n, width = byte_mat.shape
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=byte_mat.device)
    if m > width:
        return torch.zeros(n, dtype=torch.bool, device=byte_mat.device)
    pat = _pattern(pattern, byte_mat.device)
    start = (lengths.to(torch.int64) - m).clamp(0, width - m)
    # the m-wide window that ends at each row's length
    idx = start[:, None] + torch.arange(m, device=byte_mat.device)[None, :]
    window = torch.gather(byte_mat, 1, idx)
    return (window == pat[None, :]).all(dim=1) & (lengths >= m)


def contains(byte_mat: torch.Tensor, lengths: torch.Tensor,
             pattern: bytes) -> torch.Tensor:
    """Every window position at once, one pattern byte at a time
    (O(width * m) compares; m is short)."""
    m = len(pattern)
    n, width = byte_mat.shape
    dev = byte_mat.device
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=dev)
    if m > width:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    acc = torch.ones((n, width - m + 1), dtype=torch.bool, device=dev)
    for j, byte in enumerate(pattern):
        acc &= byte_mat[:, j:j + width - m + 1] == byte
    pos_ok = (torch.arange(width - m + 1, device=dev)[None, :] + m) \
        <= lengths[:, None]
    return (acc & pos_ok).any(dim=1)


def length_utf8_chars(byte_mat: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Spark's length(): UTF-8 code points, the bytes that are not
    continuation bytes (0b10xxxxxx)."""
    width = byte_mat.shape[1]
    in_range = torch.arange(width, device=byte_mat.device)[None, :] \
        < lengths[:, None]
    not_cont = (byte_mat & 0xC0) != 0x80
    return (in_range & not_cont).sum(dim=1, dtype=torch.int32)


def upper_ascii(byte_mat: torch.Tensor) -> torch.Tensor:
    is_lower = (byte_mat >= ord("a")) & (byte_mat <= ord("z"))
    return torch.where(is_lower, byte_mat - 32, byte_mat)


def lower_ascii(byte_mat: torch.Tensor) -> torch.Tensor:
    is_upper = (byte_mat >= ord("A")) & (byte_mat <= ord("Z"))
    return torch.where(is_upper, byte_mat + 32, byte_mat)


def substring_fixed(byte_mat: torch.Tensor, lengths: torch.Tensor,
                    start: int, sub_len: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SQL substring with a constant 1-based start and length, over
    bytes (so the same as code points only for ASCII text)."""
    n, width = byte_mat.shape
    dev = byte_mat.device
    lengths = lengths.to(torch.int32)
    if start >= 0:
        # Spark takes start 0 as 1 (the first character)
        begin_raw = torch.full((n,), max(start - 1, 0), dtype=torch.int32,
                               device=dev)
    else:  # a negative start counts from the end (and may pass the front)
        begin_raw = lengths + start
    # UTF8String.substringSQL: the window's end comes from the unclamped
    # start, then [max(start, 0), min(end, len)) is taken, so a negative
    # start past the front shrinks the output instead of shifting it
    end = begin_raw + sub_len
    begin = begin_raw.clamp(min=0)
    out_len = (torch.minimum(end, lengths) - begin).clamp(0, sub_len)
    cols = torch.arange(max(sub_len, 1), device=dev)
    idx = (begin.to(torch.int64)[:, None] + cols[None, :]).clamp(0, width - 1)
    out = torch.gather(byte_mat, 1, idx)
    keep = cols[None, :] < out_len[:, None]
    return torch.where(keep, out, torch.zeros_like(out)), \
        out_len.to(torch.int32)


def eq_const(byte_mat: torch.Tensor, lengths: torch.Tensor,
             pattern: bytes) -> torch.Tensor:
    """Equality with a constant string."""
    if len(pattern) > byte_mat.shape[1]:
        return torch.zeros(byte_mat.shape[0], dtype=torch.bool,
                           device=byte_mat.device)
    return starts_with(byte_mat, lengths, pattern) & \
        (lengths == len(pattern))
