"""Math functions as torch ops on the batch's device (port of
blaze_tpu/funcs/math.py): the float family, the log family (NULL at or
below the asymptote), abs, negative, signum, ceil, floor, pow, atan2,
isnan, nanvl, round (HALF_UP), bround (HALF_EVEN), greatest and least.

Where the JAX package departs from Spark, this port keeps Spark's rule:
  * signum keeps NaN and the sign of a zero (torch.sign maps NaN to 0);
  * greatest and least order NaN above every number, so greatest(2.0,
    NaN) is NaN and least(NaN, 2.0) is 2.0 whatever the argument order
    (the JAX package compares with `>` and `<`, which a NaN never
    satisfies: greatest(2.0, NaN) is 2.0 there).
"""

from __future__ import annotations

import torch

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import const_arg, dev as _dev
from blaze_tpu_torch.schema import BOOL, FLOAT64, INT64, TypeId


def _f64(v: ColVal) -> torch.Tensor:
    return v.data.to(torch.float64)


def _ftype(ts):
    return FLOAT64


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root: a signed power, then one Newton step (the power
    alone is a few ulps off exact cubes)."""
    r = torch.sign(x) * x.abs().pow(1.0 / 3.0)
    safe = torch.where(r == 0, torch.ones_like(r), r)
    step = r - (r * r * r - x) / (3.0 * safe * safe)
    return torch.where((r == 0) | ~torch.isfinite(r), r, step)


def _unary(math_fn):
    def impl(args, batch, out_type):
        (v,) = _dev(args, batch)
        return ColVal(out_type, math_fn(_f64(v)), v.validity)
    return impl


for _name, _fn in {
    "sqrt": torch.sqrt, "exp": torch.exp, "sin": torch.sin,
    "cos": torch.cos, "tan": torch.tan, "asin": torch.asin,
    "acos": torch.acos, "atan": torch.atan, "sinh": torch.sinh,
    "cosh": torch.cosh, "tanh": torch.tanh, "cbrt": _cbrt,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "expm1": torch.expm1,
}.items():
    register(_name, _ftype)(_unary(_fn))


def _log_family(math_fn, lower_bound):
    """NULL at or below the asymptote (ln/log10/log2: x <= 0; log1p:
    x <= -1), as Spark's UnaryLogExpression; a NaN stays NaN."""
    def impl(args, batch, out_type):
        (v,) = _dev(args, batch)
        data = _f64(v)
        ok = v.validity & ~(data <= lower_bound)
        out = math_fn(torch.where(ok, data,
                                  torch.full_like(data, lower_bound + 2.0)))
        return ColVal(out_type, out, ok)
    return impl


for _name, _fn, _lo in (("ln", torch.log, 0.0), ("log10", torch.log10, 0.0),
                        ("log2", torch.log2, 0.0),
                        ("log1p", torch.log1p, -1.0)):
    register(_name, _ftype)(_log_family(_fn, _lo))


@register("abs")
def _abs(args, batch, out_type):
    (v,) = _dev(args, batch)
    return ColVal(out_type, v.data.abs(), v.validity)


@register("negative")
def _negative(args, batch, out_type):
    (v,) = _dev(args, batch)
    return ColVal(out_type, -v.data, v.validity)


@register("signum", _ftype)
def _signum(args, batch, out_type):
    (v,) = _dev(args, batch)
    x = _f64(v)
    keep = (x == 0) | torch.isnan(x)
    return ColVal(out_type, torch.where(keep, x, torch.sign(x)), v.validity)


def _java_long(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 as Java's (long) cast: NaN is 0, and values past
    either end saturate (a plain .to() is undefined there)."""
    hi = x >= 9.223372036854775807e18
    lo = x <= -9.223372036854775808e18
    safe = torch.where(hi | lo | torch.isnan(x), torch.zeros_like(x), x)
    out = safe.to(torch.int64)
    out = torch.where(hi, torch.full_like(out, (1 << 63) - 1), out)
    return torch.where(lo, torch.full_like(out, -(1 << 63)), out)


def _rounding(torch_fn):
    def impl(args, batch, out_type):
        (v,) = _dev(args, batch)
        if v.dtype.id == TypeId.DECIMAL:
            # the integral value at the input's type (the JAX package's
            # result type; it keeps the fraction: ROADMAP Queue 3)
            q = 10 ** v.dtype.scale
            whole = torch.div(v.data.to(torch.int64), q,
                              rounding_mode="floor")
            if torch_fn is torch.ceil:
                whole = whole + (whole * q != v.data).to(torch.int64)
            return ColVal(out_type, whole * q, v.validity)
        if v.dtype.is_integer:
            return ColVal(out_type, v.data.to(torch.int64), v.validity)
        return ColVal(out_type, _java_long(torch_fn(_f64(v))), v.validity)
    return impl


register("ceil", lambda ts: INT64 if ts[0].id != TypeId.DECIMAL
         else ts[0])(_rounding(torch.ceil))
register("floor", lambda ts: INT64 if ts[0].id != TypeId.DECIMAL
         else ts[0])(_rounding(torch.floor))


@register("pow", _ftype)
def _pow(args, batch, out_type):
    a, b = _dev(args, batch)
    return ColVal(out_type, torch.pow(_f64(a), _f64(b)),
                  a.validity & b.validity)


@register("atan2", _ftype)
def _atan2(args, batch, out_type):
    a, b = _dev(args, batch)
    return ColVal(out_type, torch.atan2(_f64(a), _f64(b)),
                  a.validity & b.validity)


@register("isnan", lambda ts: BOOL)
def _isnan(args, batch, out_type):
    (v,) = _dev(args, batch)
    out = torch.isnan(_f64(v)) & v.validity
    return ColVal.device(BOOL, out)


@register("nanvl")
def _nanvl(args, batch, out_type):
    a, b = _dev(args, batch)
    nan = torch.isnan(_f64(a))
    data = torch.where(nan, b.data.to(a.data.dtype), a.data)
    valid = torch.where(nan, b.validity, a.validity)
    return ColVal(out_type, data, valid)


def _round_impl(half_even: bool):
    """Spark round (HALF_UP) and bround (HALF_EVEN) with a literal
    integer scale."""
    def impl(args, batch, out_type):
        (v,) = _dev(args[:1], batch)
        scale = 0
        if len(args) > 1:
            scale = int(const_arg(args[1], batch, "round") or 0)
        if v.dtype.id == TypeId.DECIMAL:
            return ColVal(v.dtype, _round_unscaled(
                v.data.to(torch.int64), 10 ** max(v.dtype.scale - scale, 0),
                half_even), v.validity)
        if v.dtype.is_integer:
            if scale >= 0:
                return v
            q = 10 ** (-scale)
            data = v.data.to(torch.int64)
            adj = torch.where(data >= 0, data + q // 2, data - q // 2)
            out = torch.sign(adj) * torch.div(adj.abs(), q,
                                              rounding_mode="floor") * q
            return ColVal(v.dtype, out.to(v.data.dtype), v.validity)
        f = _f64(v)
        m = 10.0 ** scale
        scaled = f * m
        if half_even:
            out = torch.round(scaled) / m
        else:
            out = torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                              torch.ceil(scaled - 0.5)) / m
        out = torch.where(torch.isfinite(f), out, f)
        return ColVal(v.dtype, out.to(v.data.dtype), v.validity)
    return impl


def _round_unscaled(data: torch.Tensor, q: int,
                    half_even: bool) -> torch.Tensor:
    """Unscaled decimals rounded to a multiple of `q`, exactly: HALF_UP
    on the magnitude, or HALF_EVEN (ties to the even quotient)."""
    if q == 1:
        return data
    mag = data.abs()
    quot = torch.div(mag, q, rounding_mode="floor")
    rem = mag - quot * q
    up = rem * 2 > q if half_even else rem * 2 >= q
    if half_even:
        up = up | ((rem * 2 == q) & (quot % 2 == 1))
    quot = quot + up.to(torch.int64)
    return torch.where(data < 0, -quot, quot) * q


register("round")(_round_impl(half_even=False))
register("bround")(_round_impl(half_even=True))


def _extreme(largest: bool):
    """greatest / least: NULLs skipped, NaN above every number."""
    def impl(args, batch, out_type):
        vs = _dev(args, batch)
        data, valid = vs[0].data, vs[0].validity
        for v in vs[1:]:
            x = v.data.to(data.dtype)
            if data.dtype.is_floating_point:
                xn, dn = torch.isnan(x), torch.isnan(data)
                beats = ((x > data) | (xn & ~dn)) if largest \
                    else ((x < data) | (dn & ~xn))
            else:
                beats = (x > data) if largest else (x < data)
            take = v.validity & (~valid | beats)
            data = torch.where(take, x, data)
            valid = valid | v.validity
        return ColVal(out_type, data, valid)
    return impl


register("greatest")(_extreme(largest=True))
register("least")(_extreme(largest=False))
