"""Spark-semantics casts of fixed-width columns (port of
blaze_tpu/kernels/cast.py, which is plain `jnp`, no Pallas kernel).

The casts run as torch ops on the column's device.  Non-ANSI (default)
Spark semantics, as in the reference:
  * int -> narrower int: two's-complement wraparound (Java semantics);
  * float/double -> integral: truncate toward zero; NaN -> 0; +-inf and
    overflow saturate to the type's min/max (Java `(int)d` semantics);
  * numeric -> boolean: value != 0; boolean -> numeric: 0/1;
  * date32 <-> timestamp_us: days * 86_400_000_000; numeric <->
    timestamp scales by seconds.

Decimal columns belong to the strings/decimals slice (ROADMAP Queue 1
item 13): a cast from or to a decimal raises, as a decimal column does at
`batch.py`.  String casts run at the host boundary (exprs/cast.py).
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
    if TypeId.DECIMAL in (src.id, dst.id):
        raise NotImplementedError(
            f"cast {src} -> {dst}: decimal casts belong to the "
            f"strings/decimals slice of the PyTorch port (ROADMAP Queue 1 "
            f"item 13)")
    if src.id == dst.id:
        return data, validity

    s, d = src.id, dst.id
    v = validity
    out_dt = dst.torch_dtype()

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
