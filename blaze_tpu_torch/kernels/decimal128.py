"""Two-limb int128 arithmetic for decimals (port of
blaze_tpu/kernels/decimal128.py, plain element-wise `xp` code with no
Pallas kernel, so torch ops on the tensors' device here).

Decimals of precision <= 18 ride as unscaled int64 (int32 under the
narrow tier).  Same-scale compares and +/- are exact on those integers;
an UNEQUAL-scale compare rescales one side by 10^(scale delta), which can
overflow int64 (10^18 * 10^2 > 2^63), so both sides widen to an int128
pair (hi int64, lo int64 read as unsigned) first.  10^18 * 10^20 < 2^127,
so a rescaled compare never overflows the pair.

PyTorch has no usable uint64 arithmetic on CUDA, so the unsigned low limb
uses the reference's signed-int tricks:

  * unsigned compare: u_lt(a, b) == (a ^ INT64_MIN) < (b ^ INT64_MIN);
  * add carry-out: carry = u_lt(a + b, a);
  * 64x32 multiply: the low limb splits into 32-bit halves, every partial
    product fits a signed int64.

`>>` on int64 tensors is arithmetic on the CPU and on CUDA.  A `<<` that
would carry into the sign bit is avoided: `_shl32` sets bit 63 by a
select instead, so no shift overflows a signed value on either device.

`minimal_be_bytes` and `spark_decimal128_hash` stay host numpy, as in
the reference: Spark hashes a precision > 18 decimal as murmur3 over the
minimal big-endian two's-complement bytes of its unscaled value.
"""

from __future__ import annotations

import numpy as np
import torch

from blaze_tpu_torch.schema import BOOL, DataType

_MIN64 = -0x8000000000000000  # 1 << 63 as a signed int64 bit pattern
_MASK32 = 0xFFFFFFFF


def u_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned < over int64 bit patterns."""
    return (a ^ _MIN64) < (b ^ _MIN64)


def from_int64(v: torch.Tensor):
    """Sign-extend an int64 vector to an (hi, lo) int128 pair."""
    v = v.to(torch.int64)
    return v >> 63, v  # arithmetic shift: hi is 0 or -1


def add128(ah, al, bh, bl):
    """(ah, al) + (bh, bl) with the carry between limbs (wrapping int128)."""
    rl = al + bl  # the int64 wrap is the unsigned low-limb add
    carry = u_lt(rl, al).to(torch.int64)
    return ah + bh + carry, rl


def neg128(h, l):
    """Two's-complement negate."""
    return ~h + (l == 0).to(torch.int64), -l


def sub128(ah, al, bh, bl):
    nh, nl = neg128(bh, bl)
    return add128(ah, al, nh, nl)


def _shl32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of `x` moved to the high half of an int64, bit 31
    landing on the sign bit by a select (no signed shift overflow)."""
    low31 = (x & 0x7FFFFFFF) << 32
    top = ((x >> 31) & 1) == 1
    return torch.where(top, low31 | _MIN64, low31)


def mul_small(h, l, m: int):
    """(h, l) * m for a static 0 <= m < 2^31; every partial product fits a
    signed int64.  Wrapping int128 (callers keep |result| inside int128:
    10^18 * 10^20 < 2^127)."""
    assert 0 <= m < (1 << 31)
    l0 = l & _MASK32            # unsigned low 32 of the low limb
    l1 = (l >> 32) & _MASK32    # unsigned high 32 of the low limb
    p0 = l0 * m                 # < 2^63, non-negative
    p1 = l1 * m + ((p0 >> 32) & _MASK32)
    rl = _shl32(p1) | (p0 & _MASK32)
    carry = (p1 >> 32) & _MASK32
    return h * m + carry, rl


def mul_pow10(h, l, k: int):
    """(h, l) * 10^k for a static k >= 0, in steps of at most 10^9."""
    assert k >= 0
    while k > 0:
        step = min(k, 9)
        h, l = mul_small(h, l, 10 ** step)
        k -= step
    return h, l


def eq128(ah, al, bh, bl):
    return (ah == bh) & (al == bl)


def lt128(ah, al, bh, bl):
    """Signed int128 <: signed on the high limb, unsigned on the low."""
    return (ah < bh) | ((ah == bh) & u_lt(al, bl))


def fits_int64(h, l):
    """True where the pair is exactly a sign-extended int64."""
    return h == (l >> 63)


def add_overflows(ah, bh, rh):
    """Signed int128 add overflow: the operands share a sign the result
    lost."""
    return ((ah < 0) == (bh < 0)) & ((rh < 0) != (ah < 0))


def rescaled_pair(values: torch.Tensor, scale: int, target_scale: int):
    """Unscaled decimal values at `scale` -> an int128 pair at
    `target_scale` (>= scale)."""
    h, l = from_int64(values)
    return mul_pow10(h, l, target_scale - scale)


def compare_colvals(op: str, a, b, ldt: DataType, rdt: DataType):
    """Comparison of two device decimal ColVals of unequal scales through
    the int128 rescale; a BOOL ColVal with Spark's null semantics (<=> is
    null-safe)."""
    from blaze_tpu_torch.exprs.base import ColVal  # exprs imports this
    target = max(ldt.scale, rdt.scale)
    xh, xl = rescaled_pair(a.data, ldt.scale, target)
    yh, yl = rescaled_pair(b.data, rdt.scale, target)
    eq = eq128(xh, xl, yh, yl)
    lt = lt128(xh, xl, yh, yl)
    if op == "<=>":
        data = (eq & a.validity & b.validity) | (~a.validity & ~b.validity)
        return ColVal.device(BOOL, data)
    valid = a.validity & b.validity
    data = {"==": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
            ">": ~(lt | eq), ">=": ~lt}[op]
    return ColVal(BOOL, data & valid, valid)


# ---------------------------------------------------------------------------
# Spark's hash of wide decimals (p > 18), on the host
# ---------------------------------------------------------------------------

def minimal_be_bytes(hi: np.ndarray, lo: np.ndarray):
    """(byte matrix uint8 (n, 16), lengths int32): the minimal big-endian
    two's-complement bytes of each int128 (java BigInteger.toByteArray),
    left-aligned in the matrix: leading 0x00 bytes go while the next
    byte's high bit is clear, leading 0xFF bytes while it is set, and at
    least one byte stays."""
    hi = np.asarray(hi, dtype=np.int64)
    lo = np.asarray(lo, dtype=np.int64)
    n = hi.shape[0]
    be = np.zeros((n, 16), dtype=np.uint8)
    for i in range(8):
        be[:, 7 - i] = ((hi >> (8 * i)) & 0xFF).astype(np.uint8)
        be[:, 15 - i] = ((lo >> (8 * i)) & 0xFF).astype(np.uint8)
    sign_byte = np.where(hi < 0, 0xFF, 0x00).astype(np.uint8)
    redundant = np.zeros(n, dtype=np.int64)
    still = np.ones(n, dtype=bool)
    for j in range(15):  # the last byte always stays
        hi_bit_next = (be[:, j + 1] & 0x80) != 0
        strip = still & (be[:, j] == sign_byte) & \
            (hi_bit_next == (sign_byte == 0xFF))
        redundant += strip
        still = strip
    lengths = (16 - redundant).astype(np.int32)
    idx = np.clip(redundant[:, None] + np.arange(16)[None, :], 0, 15)
    mat = np.take_along_axis(be, idx, axis=1)
    mat = np.where(np.arange(16)[None, :] < lengths[:, None], mat,
                   np.uint8(0))
    return mat, lengths


def spark_decimal128_hash(hi, lo, seeds=None, seed: int = 42) -> np.ndarray:
    """Spark's murmur3 of wide-decimal unscaled int128s (uint32 numpy):
    the hash of BigInteger.toByteArray's bytes, the wide counterpart of a
    p <= 18 decimal's hash as a long."""
    from blaze_tpu_torch.kernels.hashing import murmur3_hash_bytes
    mat, lengths = minimal_be_bytes(hi, lo)
    if seeds is None:
        seeds = np.full(mat.shape[0], seed, dtype=np.uint32)
    h = murmur3_hash_bytes(torch.from_numpy(mat),
                           torch.from_numpy(lengths.astype(np.int64)),
                           torch.from_numpy(np.asarray(seeds)
                                            .astype(np.int64)))
    return h.numpy().astype(np.uint32)


def int128_limbs(arr) -> tuple:
    """(hi, lo) int64 numpy limbs of a decimal128 Arrow array's unscaled
    values (nulls read as 0)."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    pairs = np.frombuffer(arr.buffers()[1], dtype=np.int64).reshape(-1, 2)
    pairs = pairs[arr.offset:arr.offset + len(arr)]
    valid = np.ones(len(arr), dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    return (np.where(valid, pairs[:, 1], 0), np.where(valid, pairs[:, 0], 0))
