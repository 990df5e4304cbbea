"""Spark decimal binary arithmetic and comparison, exact (port of
blaze_tpu/exprs/decimal_arith.py).

Result types follow Catalyst's DecimalPrecision rules, as the reference:

  add/sub : s = max(s1,s2);           p = max(p1-s1, p2-s2) + s + 1
  mul     : s = s1+s2;                p = p1+p2+1
  div     : s = max(6, s1+p2+1);      p = p1-s1+s2+s
  mod     : s = max(s1,s2);           p = min(p1-s1, p2-s2) + s
  capped at 38 with allowPrecisionLoss's scale reduction (minScale 6).

Values are computed exactly on the host.  Comparisons, `+`, `-` and `*`
run as Python integers over the unscaled values, vectorised through
numpy object arrays (a product of two decimal(38) values has at most 76
digits, the reference's `ctx.prec`, so its Decimal arithmetic is exact
there too and both round the same way: HALF_UP on the magnitude).  `/`,
`%` and pmod go through `decimal.Decimal` at precision 76 row by row, as
the reference does.  A zero divisor gives NULL and a result past the
capped precision NULL (CheckOverflow); under ANSI a selected row raises
instead.  `HOST_STATS` counts the calls, rows and host seconds spent
here.
"""

from __future__ import annotations

import decimal as pydec
import time
from typing import Optional

import numpy as np
import pyarrow as pa

from blaze_tpu_torch import config
from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.kernels.decimal128 import int128_limbs
from blaze_tpu_torch.schema import BOOL, DataType, TypeId

_MAX_PRECISION = 38
_MIN_DIVISION_SCALE = 6
_CMP = ("==", "!=", "<", "<=", ">", ">=", "<=>")

#: integral operand widths as decimals (Spark's DecimalType.forType, which
#: has no entry for dates)
_INT_AS_DECIMAL = {"int8": (3, 0), "int16": (5, 0), "int32": (10, 0),
                   "int64": (20, 0), "bool": (1, 0)}

#: calls, rows and host seconds of `evaluate`
HOST_STATS = {"calls": 0, "rows": 0, "seconds": 0.0}


def as_decimal_type(t: DataType) -> Optional[DataType]:
    if t.id == TypeId.DECIMAL:
        return t
    ps = _INT_AS_DECIMAL.get(t.id.value)
    if ps is None:
        return None
    return DataType(TypeId.DECIMAL, ps[0], ps[1])


def _adjust(p: int, s: int) -> DataType:
    """DecimalPrecision.adjustPrecisionScale (allowPrecisionLoss, Spark's
    default): precision capped at 38, giving up scale down to min(s, 6)."""
    if p <= _MAX_PRECISION:
        return DataType(TypeId.DECIMAL, max(p, 1), s)
    min_scale = min(s, _MIN_DIVISION_SCALE)
    adj_scale = max(_MAX_PRECISION - (p - s), min_scale)
    return DataType(TypeId.DECIMAL, _MAX_PRECISION, adj_scale)


def result_type(op: str, lt: DataType, rt: DataType) -> DataType:
    p1, s1 = lt.precision, lt.scale
    p2, s2 = rt.precision, rt.scale
    if op in ("+", "-"):
        s = max(s1, s2)
        p = max(p1 - s1, p2 - s2) + s + 1
    elif op == "*":
        s = s1 + s2
        p = p1 + p2 + 1
    elif op == "/":
        s = max(_MIN_DIVISION_SCALE, s1 + p2 + 1)
        p = p1 - s1 + s2 + s
    elif op in ("%", "pmod"):
        s = max(s1, s2)
        p = min(p1 - s1, p2 - s2) + s
    else:
        raise TypeError(f"unsupported decimal op {op!r}")
    return _adjust(p, s)


def unscaled_ints(cv, n: int):
    """(object array of Python-int unscaled values, bool validity) of the
    first `n` rows of a decimal or integral ColVal, device or host form
    (nulls read as 0)."""
    if cv.is_device:
        data = cv.data[:n].cpu().numpy()
        valid = cv.validity[:n].cpu().numpy()
        vals = data.astype(np.int64).astype(object)
        return np.where(valid, vals, 0), valid
    arr = cv.to_host(n)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    valid = np.ones(len(arr), dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    if pa.types.is_decimal(arr.type):
        hi, lo = int128_limbs(arr)
        vals = hi.astype(object) * (1 << 64) + \
            lo.view(np.uint64).astype(object)
        return vals, valid
    vals = np.asarray(arr.fill_null(0)).astype(np.int64).astype(object)
    return vals, valid


def decimal_from_ints(vals: np.ndarray, valid: np.ndarray,
                      t: DataType) -> pa.Array:
    """A decimal128 Arrow array of type `t` from Python-int unscaled
    values (each within 38 digits) and a validity mask."""
    v = np.where(valid, vals, 0)
    lo = (v & ((1 << 64) - 1)).astype(np.uint64).view(np.int64)
    hi = (v >> 64).astype(np.int64)
    limbs = np.empty((len(v), 2), dtype=np.int64)
    limbs[:, 0], limbs[:, 1] = lo, hi
    if bool(valid.all()):
        vbuf, nulls = None, 0
    else:
        vbuf = pa.py_buffer(np.packbits(valid.astype(np.uint8),
                                        bitorder="little").tobytes())
        nulls = int((~valid).sum())
    return pa.Array.from_buffers(t.to_arrow(), len(v),
                                 [vbuf, pa.py_buffer(limbs.tobytes())],
                                 null_count=nulls)


def _half_up(vals: np.ndarray, k: int) -> np.ndarray:
    """Python-int unscaled values with `k` >= 0 fewer fractional digits,
    HALF_UP on the magnitude (BigDecimal.setScale)."""
    if k == 0:
        return vals
    q = 10 ** k
    mag = (np.abs(vals) + q // 2) // q
    return np.where(vals < 0, -mag, mag)


def _selected(batch, n: int) -> np.ndarray:
    return batch.row_mask()[:n].cpu().numpy()


def _overflow_error(t: DataType) -> ValueError:
    return ValueError(f"[NUMERIC_VALUE_OUT_OF_RANGE] decimal overflow at "
                      f"{t.precision},{t.scale} (ANSI mode)")


def evaluate(op: str, a_cv, b_cv, lt: DataType, rt: DataType, batch,
             ansi: Optional[bool] = None):
    """Exact decimal arithmetic or comparison of two ColVals whose types
    are `lt` and `rt` as decimals: a host ColVal of the Spark result type
    (arithmetic) or of BOOL.  `ansi` overrides the session conf (the
    try_* functions pass False)."""
    t0 = time.perf_counter()
    n = batch.num_rows
    if ansi is None:
        ansi = config.ANSI_ENABLED.get()
    x, xv = unscaled_ints(a_cv, n)
    y, yv = unscaled_ints(b_cv, n)
    both = xv & yv
    try:
        if op in _CMP:
            return _compare(op, x, xv, y, yv, lt.scale, rt.scale)
        out_t = result_type(op, lt, rt)
        if op in ("+", "-", "*"):
            vals, valid = _exact(op, x, y, lt.scale, rt.scale, out_t), both
        else:
            vals, valid = _divmod(op, x, y, both, lt.scale, rt.scale, out_t,
                                  ansi, batch)
        over = valid & (np.abs(vals) >= 10 ** out_t.precision)
        if over.any():
            if ansi and (over & _selected(batch, n)).any():
                raise _overflow_error(out_t)
            valid = valid & ~over
        return ColVal.host(out_t, decimal_from_ints(vals, valid, out_t))
    finally:
        HOST_STATS["calls"] += 1
        HOST_STATS["rows"] += n
        HOST_STATS["seconds"] += time.perf_counter() - t0


def _compare(op, x, xv, y, yv, s1: int, s2: int):
    s = max(s1, s2)
    x = x * (10 ** (s - s1)) if s > s1 else x
    y = y * (10 ** (s - s2)) if s > s2 else y
    if op == "<=>":
        out = (xv & yv & (x == y).astype(bool)) | (~xv & ~yv)
        return ColVal.host(BOOL, pa.array(out, type=pa.bool_()))
    res = {"==": x == y, "!=": x != y, "<": x < y, "<=": x <= y,
           ">": x > y, ">=": x >= y}[op]
    res = np.asarray(res, dtype=bool) if len(x) else np.zeros(0, bool)
    return ColVal.host(BOOL, pa.array(res, type=pa.bool_(),
                                      mask=~(xv & yv)))


def _exact(op, x, y, s1: int, s2: int, out_t: DataType) -> np.ndarray:
    """+ - * over Python ints, rounded HALF_UP to the result scale."""
    if op == "*":
        r, s = x * y, s1 + s2
    else:
        s = max(s1, s2)
        xs = x * (10 ** (s - s1)) if s > s1 else x
        ys = y * (10 ** (s - s2)) if s > s2 else y
        r = xs + ys if op == "+" else xs - ys
    return _half_up(r, s - out_t.scale)


def _divmod(op, x, y, both, s1: int, s2: int, out_t: DataType, ansi: bool,
            batch):
    """/ % pmod row by row over decimal.Decimal at precision 76 (the
    reference's arithmetic, rounding included)."""
    n = len(x)
    sel = _selected(batch, n) if ansi else None
    quant = pydec.Decimal(1).scaleb(-out_t.scale)
    vals = np.zeros(n, dtype=object)
    valid = both.copy()
    with pydec.localcontext() as ctx:
        ctx.prec = 76  # two full decimal128 operands
        for row in np.flatnonzero(both):
            xd = pydec.Decimal(int(x[row])).scaleb(-s1)
            yd = pydec.Decimal(int(y[row])).scaleb(-s2)
            if yd == 0:
                if ansi and sel[row]:
                    raise ValueError("[DIVIDE_BY_ZERO] decimal division "
                                     "by zero (ANSI mode)")
                valid[row] = False
                continue
            try:
                if op == "/":
                    r = xd / yd
                else:
                    r = xd % yd  # the sign follows the dividend (Java)
                    if op == "pmod" and r != 0 and (r < 0) != (yd < 0):
                        r += yd
                r = r.quantize(quant, rounding=pydec.ROUND_HALF_UP)
            except pydec.InvalidOperation:
                valid[row] = False
                continue
            vals[row] = int(r.scaleb(out_t.scale))
    return vals, valid
