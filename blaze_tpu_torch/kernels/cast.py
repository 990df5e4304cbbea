"""Spark-semantics casts of fixed-width columns (port of
blaze_tpu/kernels/cast.py, which is plain `jnp`, no Pallas kernel).

The casts run as torch ops on the column's device.  Non-ANSI (default)
Spark semantics, as in the reference:
  * int -> narrower int: two's-complement wraparound (Java semantics);
  * float/double -> integral: truncate toward zero; NaN -> 0; +-inf and
    overflow saturate to the type's min/max (Java `(int)d` semantics);
  * numeric -> boolean: value != 0; boolean -> numeric: 0/1;
  * date32 <-> timestamp_us: days * 86_400_000_000; numeric <->
    timestamp scales by seconds;
  * numeric <-> decimal(p <= 18) on the unscaled int64s: scale by 10^s,
    HALF_UP on the magnitude, overflow -> NULL; decimal -> integral
    truncates toward zero; decimal -> float divides by 10^s in float64.

Every multiplication by a power of ten is guarded first, so no int64
wrap can land back inside the precision.  Decimals of precision > 18
and string casts run at the host boundary (exprs/cast.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from blaze_tpu_torch.schema import DataType, TypeId

_US_PER_DAY = 86_400_000_000


def _int_bounds(tid: TypeId):
    return {
        TypeId.INT8: (-128, 127),
        TypeId.INT16: (-(1 << 15), (1 << 15) - 1),
        TypeId.INT32: (-(1 << 31), (1 << 31) - 1),
        TypeId.DATE32: (-(1 << 31), (1 << 31) - 1),
        TypeId.INT64: (-(1 << 63), (1 << 63) - 1),
        TypeId.TIMESTAMP_MICROS: (-(1 << 63), (1 << 63) - 1),
    }[tid]


def cast_column(data: torch.Tensor, validity: Optional[torch.Tensor],
                src: DataType, dst: DataType
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cast one column on its device; returns (data, validity).  Validity
    may gain nulls (a float too large for a timestamp)."""
    if src.id == dst.id and (src.id != TypeId.DECIMAL or (
            src.precision, src.scale) == (dst.precision, dst.scale)):
        return data, validity

    s, d = src.id, dst.id
    v = validity
    out_dt = dst.torch_dtype()

    # --- decimal source: exact integers, float64 for floats ---------------
    if s == TypeId.DECIMAL:
        data = data.to(torch.int64)
        if d == TypeId.DECIMAL:
            return _rescale_decimal(data, v, src, dst)
        if dst.is_integer and d not in (TypeId.DATE32,
                                         TypeId.TIMESTAMP_MICROS):
            # truncate toward zero (BigDecimal.toBigInteger), overflow NULL
            i = torch.div(data, 10 ** src.scale, rounding_mode="trunc")
            lo, hi = _int_bounds(d)
            ok = (i >= lo) & (i <= hi)
            nv = ok if v is None else (v & ok)
            return torch.where(ok, i, 0).to(out_dt), nv
        return cast_column(decimal_to_double(data, src.scale), v,
                           DataType(TypeId.FLOAT64), dst)

    # --- decimal destination ---------------------------------------------
    if d == TypeId.DECIMAL:
        limit = 10 ** min(dst.precision, 18)
        if src.is_floating:
            scaled = data.to(torch.float64) * float(10 ** dst.scale)
            # HALF_UP on the magnitude (BigDecimal.setScale HALF_UP)
            rounded = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                                  torch.ceil(scaled - 0.5))
            ok = torch.isfinite(scaled) & (rounded.abs() < float(limit))
            nv = ok if v is None else (v & ok)
            return torch.where(ok, rounded, 0.0).to(torch.int64), nv
        # the range check comes BEFORE the multiplication: a wrapped
        # product could land back inside the precision
        max_unscaled = (limit - 1) // 10 ** dst.scale
        i = data.to(torch.int64)
        ok = (i >= -max_unscaled) & (i <= max_unscaled)
        nv = ok if v is None else (v & ok)
        return torch.where(ok, i, 0) * 10 ** dst.scale, nv

    # --- boolean ----------------------------------------------------------
    if d == TypeId.BOOL:
        return data != 0, v
    if s == TypeId.BOOL:
        return data.to(out_dt), v

    # --- date/timestamp ---------------------------------------------------
    if s == TypeId.DATE32 and d == TypeId.TIMESTAMP_MICROS:
        return data.to(torch.int64) * _US_PER_DAY, v
    if s == TypeId.TIMESTAMP_MICROS and d == TypeId.DATE32:
        return torch.div(data, _US_PER_DAY,
                         rounding_mode="floor").to(torch.int32), v

    # --- numeric <-> timestamp: Spark scales by SECONDS -------------------
    if d == TypeId.TIMESTAMP_MICROS:
        if src.is_floating:
            us = data.to(torch.float64) * 1e6
            ok = torch.isfinite(us) & (us.abs() < 2.0 ** 63)
            nv = ok if v is None else (v & ok)
            return torch.where(ok, us, 0.0).to(torch.int64), nv
        if s != TypeId.DATE32:
            return data.to(torch.int64) * 1_000_000, v
    if s == TypeId.TIMESTAMP_MICROS:
        if dst.is_floating:
            return (data.to(torch.float64) / 1e6).to(out_dt), v
        if d != TypeId.DATE32:
            # Math.floorDiv, as Spark's MICROSECONDS.toSeconds
            secs = torch.div(data, 1_000_000, rounding_mode="floor")
            return secs.to(out_dt), v
    if (s == TypeId.DATE32) != (d == TypeId.DATE32):
        # Spark has no numeric <-> date cast (AnalysisException)
        raise TypeError(f"unsupported cast {src} -> {dst}")

    # --- float -> integral: truncate, NaN -> 0, saturate ------------------
    if src.is_floating and dst.is_integer:
        lo, hi = _int_bounds(d)
        f = data.to(torch.float64)
        t = torch.trunc(f)
        nan = torch.isnan(f)
        # saturate by comparisons and an integer-domain clamp: float
        # arithmetic near 2^63 is inexact; 2^63 is exactly representable,
        # so >= catches exactly the values int64 cannot hold
        big = t >= 2.0 ** 63
        small = t < -(2.0 ** 63)
        i = torch.where(nan | big | small, 0.0, t).to(torch.int64)
        i = torch.clamp(i, lo, hi)
        i = torch.where(big, hi, torch.where(small, lo, i))
        i = torch.where(nan, 0, i)
        return i.to(out_dt), v

    # --- integral -> integral: wraparound ---------------------------------
    if src.is_integer and dst.is_integer:
        return data.to(out_dt), v

    # --- anything numeric -> float ---------------------------------------
    if dst.is_floating:
        return data.to(out_dt), v

    raise TypeError(f"unsupported cast {src} -> {dst}")


def decimal_to_double(unscaled: torch.Tensor, scale: int) -> torch.Tensor:
    """Unscaled decimals -> float64 as Spark's cast: unscaled / 10^scale,
    a correctly rounded division (exact at a short scale).  The divisor is
    a 0-dim tensor on the values' device: CUDA turns a division by a
    Python scalar into a multiplication by its reciprocal, which differs
    from the division in the last bit."""
    return unscaled.to(torch.float64) / torch.tensor(
        10.0 ** scale, dtype=torch.float64, device=unscaled.device)


def _rescale_decimal(data: torch.Tensor, validity, src: DataType,
                     dst: DataType):
    """decimal(p1, s1) -> decimal(p2, s2) on unscaled int64s: a wider
    scale multiplies (range-checked first), a narrower one rounds HALF_UP
    on the magnitude; past the target precision is NULL."""
    diff = dst.scale - src.scale
    limit = 10 ** min(dst.precision, 18)
    if diff >= 0:
        max_in = (limit - 1) // 10 ** diff
        ok = (data >= -max_in) & (data <= max_in)
        nv = ok if validity is None else (validity & ok)
        return torch.where(ok, data, 0) * 10 ** diff, nv
    q = 10 ** -diff
    mag = torch.div(data.abs() + q // 2, q, rounding_mode="floor")
    out = torch.where(data < 0, -mag, mag)
    ok = out.abs() < limit
    nv = ok if validity is None else (validity & ok)
    return torch.where(ok, out, 0), nv
