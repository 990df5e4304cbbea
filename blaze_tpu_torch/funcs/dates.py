"""Date and time functions (port of blaze_tpu/funcs/dates.py).

Field extraction and date arithmetic run as torch ops on the batch's
device with exact civil-from-days arithmetic (Howard Hinnant's
public-domain algorithm); parsing and formatting run on the host.

Every division and modulo here can meet a negative day count (a date
before 1970), so each is a floor division or a floor modulo:
`_fdiv` is `torch.div(..., rounding_mode="floor")` and `_fmod` is
`torch.remainder` (the sign of the divisor), which are what the JAX
package's `//` and `%` on jnp integers compute.  C-style truncation
(`torch.fmod`, `rounding_mode="trunc"`) would put a pre-1970 date in
the wrong day.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import const_arg
from blaze_tpu_torch.schema import (DATE32, FLOAT64, INT32, INT64,
                                    TIMESTAMP_MICROS, TypeId, UTF8)

_US_PER_DAY = 86_400_000_000


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _fmod(a, b):
    return torch.remainder(a, b)


def _dev(v: ColVal, batch) -> ColVal:
    return v.to_device(batch.capacity, batch.device)


def _to_days(v: ColVal, batch):
    """A date or timestamp value -> (days as int32, validity)."""
    dv = _dev(v, batch)
    if dv.dtype.id == TypeId.TIMESTAMP_MICROS:
        days = _fdiv(dv.data, _US_PER_DAY).to(torch.int32)
    else:
        days = dv.data.to(torch.int32)
    return days, dv.validity


def _civil_from_days(z):
    """days since the epoch -> (year, month, day) as int32."""
    z = z.to(torch.int64) + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def _days_from_civil(y, m, d):
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    m = m.to(torch.int64)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d.to(torch.int64) - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return (era * 146097 + doe - 719468).to(torch.int32)


def _monday_based_dow(days):
    """0 = Monday ... 6 = Sunday (the epoch, day 0, is a Thursday)."""
    return _fmod(days.to(torch.int64) + 3, 7)


def _int32(ts):
    return INT32


def _field(pick):
    def impl(args, batch, out_type):
        days, valid = _to_days(args[0], batch)
        return ColVal(INT32, pick(days), valid)
    return impl


register("year", _int32)(_field(lambda d: _civil_from_days(d)[0]))
register("month", _int32)(_field(lambda d: _civil_from_days(d)[1]))
register("day", _int32)(_field(lambda d: _civil_from_days(d)[2]))
register("dayofmonth", _int32)(_field(lambda d: _civil_from_days(d)[2]))
register("quarter", _int32)(_field(
    lambda d: _fdiv(_civil_from_days(d)[1] - 1, 3) + 1))
# Spark dayofweek: 1 = Sunday ... 7 = Saturday; weekday: 0 = Monday
register("dayofweek", _int32)(_field(
    lambda d: (_fmod(d.to(torch.int64) + 4, 7) + 1).to(torch.int32)))
register("weekday", _int32)(_field(
    lambda d: _monday_based_dow(d).to(torch.int32)))


def _jan1(y):
    one = torch.ones_like(y)
    return _days_from_civil(y, one, one)


@register("dayofyear", _int32)
def _dayofyear(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    y, _, _ = _civil_from_days(days)
    return ColVal(INT32, days - _jan1(y) + 1, valid)


@register("weekofyear", _int32)
def _weekofyear(args, batch, out_type):
    """ISO 8601 week: the week of this row's week's Thursday."""
    days, valid = _to_days(args[0], batch)
    thursday = days + (3 - _monday_based_dow(days)).to(torch.int32)
    y, _, _ = _civil_from_days(thursday)
    week = _fdiv(thursday - _jan1(y), 7) + 1
    return ColVal(INT32, week.to(torch.int32), valid)


def _time_field(unit_us: int, part_us: int):
    def impl(args, batch, out_type):
        v = _dev(args[0], batch)
        us = _fmod(v.data, unit_us)
        return ColVal(INT32, _fdiv(us, part_us).to(torch.int32), v.validity)
    return impl


register("hour", _int32)(_time_field(_US_PER_DAY, 3_600_000_000))
register("minute", _int32)(_time_field(3_600_000_000, 60_000_000))
register("second", _int32)(_time_field(60_000_000, 1_000_000))


@register("date_add", lambda ts: DATE32)
def _date_add(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    n = _dev(args[1], batch)
    return ColVal(DATE32, days + n.data.to(torch.int32), valid & n.validity)


@register("date_sub", lambda ts: DATE32)
def _date_sub(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    n = _dev(args[1], batch)
    return ColVal(DATE32, days - n.data.to(torch.int32), valid & n.validity)


@register("datediff", _int32)
def _datediff(args, batch, out_type):
    a, av = _to_days(args[0], batch)
    b, bv = _to_days(args[1], batch)
    return ColVal(INT32, a - b, av & bv)


def _first_of_next_month(y, m):
    ny = torch.where(m == 12, y + 1, y)
    nm = torch.where(m == 12, torch.ones_like(m), m + 1)
    return _days_from_civil(ny, nm, torch.ones_like(nm))


@register("last_day", lambda ts: DATE32)
def _last_day(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    y, m, _ = _civil_from_days(days)
    return ColVal(DATE32, _first_of_next_month(y, m) - 1, valid)


@register("add_months", lambda ts: DATE32)
def _add_months(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    n = _dev(args[1], batch)
    y, m, d = _civil_from_days(days)
    total = y.to(torch.int64) * 12 + (m - 1) + n.data.to(torch.int64)
    ny = _fdiv(total, 12).to(torch.int32)
    nm = _fmod(total, 12).to(torch.int32) + 1
    # the day clamps to the target month's length (Spark keeps the end
    # of a month at the end)
    month_len = _first_of_next_month(ny, nm) - \
        _days_from_civil(ny, nm, torch.ones_like(nm))
    nd = torch.minimum(d, month_len.to(torch.int32))
    return ColVal(DATE32, _days_from_civil(ny, nm, nd), valid & n.validity)


def _secs_of_day(arg: ColVal, batch):
    """Seconds past midnight (0 for a date) as float64."""
    dv = _dev(arg, batch)
    if dv.dtype.id == TypeId.TIMESTAMP_MICROS:
        return _fmod(dv.data, _US_PER_DAY).to(torch.float64) / 1e6
    return torch.zeros(batch.capacity, dtype=torch.float64,
                       device=batch.device)


def _is_last_day(days):
    y, m, _ = _civil_from_days(days)
    return days == (_first_of_next_month(y, m) - 1)


@register("months_between", lambda ts: FLOAT64)
def _months_between(args, batch, out_type):
    """DateTimeUtils.monthsBetween: the same day of month, or both at a
    month's end, is a whole number; otherwise the day and time-of-day
    difference counts over a 31-day month; roundOff (the SQL default)
    rounds to 8 decimals."""
    d1, v1 = _to_days(args[0], batch)
    d2, v2 = _to_days(args[1], batch)
    y1, m1, dd1 = _civil_from_days(d1)
    y2, m2, dd2 = _civil_from_days(d2)
    months = ((y1 - y2) * 12 + (m1 - m2)).to(torch.float64)
    secs_diff = ((dd1 - dd2).to(torch.float64) * 86400.0
                 + _secs_of_day(args[0], batch)
                 - _secs_of_day(args[1], batch))
    out = months + secs_diff / (31.0 * 86400.0)
    out = torch.where((dd1 == dd2) | (_is_last_day(d1) & _is_last_day(d2)),
                      months, out)
    round_off = True
    if len(args) > 2:
        round_off = bool(const_arg(args[2], batch, "months_between"))
    if round_off:
        out = torch.round(out * 1e8) / 1e8
    return ColVal(FLOAT64, out, v1 & v2)


def _truncated_days(days, fmt: str):
    """The first day of `days`'s year, quarter, month or week, or None
    for an unknown unit."""
    y, m, _ = _civil_from_days(days)
    one = torch.ones_like(m)
    if fmt in ("year", "yyyy", "yy"):
        return _days_from_civil(y, one, one)
    if fmt in ("month", "mon", "mm"):
        return _days_from_civil(y, m, one)
    if fmt == "quarter":
        return _days_from_civil(y, _fdiv(m - 1, 3) * 3 + 1, one)
    if fmt == "week":
        return days - _monday_based_dow(days).to(torch.int32)
    return None


@register("trunc", lambda ts: DATE32)
def _trunc_date(args, batch, out_type):
    """trunc(date, fmt): year, quarter, month or week; NULL for another
    unit."""
    days, valid = _to_days(args[0], batch)
    out = _truncated_days(days, _literal_str(args[1], batch).lower())
    if out is None:
        return ColVal(DATE32, torch.zeros_like(days),
                      torch.zeros_like(valid))
    return ColVal(DATE32, out, valid)


@register("date_trunc", lambda ts: TIMESTAMP_MICROS)
def _date_trunc(args, batch, out_type):
    """date_trunc(fmt, timestamp)."""
    fmt = _literal_str(args[0], batch).lower()
    v = _dev(args[1], batch)
    us = v.data
    unit = {"second": 1_000_000, "minute": 60_000_000,
            "hour": 3_600_000_000, "day": _US_PER_DAY,
            "millisecond": 1_000, "microsecond": 1}.get(fmt)
    if unit is not None:
        return ColVal(TIMESTAMP_MICROS, _fdiv(us, unit) * unit, v.validity)
    days = _fdiv(us, _US_PER_DAY).to(torch.int32)
    tdays = _truncated_days(days, fmt)
    if tdays is None:
        return ColVal(TIMESTAMP_MICROS, torch.zeros_like(us),
                      torch.zeros_like(v.validity))
    return ColVal(TIMESTAMP_MICROS, tdays.to(torch.int64) * _US_PER_DAY,
                  v.validity)


@register("next_day", lambda ts: DATE32)
def _next_day(args, batch, out_type):
    days, valid = _to_days(args[0], batch)
    name = _literal_str(args[1], batch).lower()
    targets = {"mo": 0, "tu": 1, "we": 2, "th": 3, "fr": 4, "sa": 5, "su": 6}
    t = targets.get(name[:2])
    if t is None:
        return ColVal(DATE32, torch.zeros_like(days),
                      torch.zeros_like(valid))
    delta = _fmod(t - _monday_based_dow(days), 7)
    delta = torch.where(delta == 0, torch.full_like(delta, 7), delta)
    return ColVal(DATE32, days + delta.to(torch.int32), valid)


@register("to_date", lambda ts: DATE32)
def _to_date(args, batch, out_type):
    v = args[0]
    if v.dtype.id == TypeId.DATE32:
        return v
    if v.dtype.id == TypeId.TIMESTAMP_MICROS:
        days, valid = _to_days(v, batch)
        return ColVal(DATE32, days, valid)
    from blaze_tpu_torch.exprs.cast import _spark_to_date
    arr = pa.array([_spark_to_date(x) if x is not None else None
                    for x in v.to_host(batch.num_rows).to_pylist()],
                   type=pa.date32())
    return _dev(ColVal.host(DATE32, arr), batch)


@register("unix_timestamp", lambda ts: INT64)
def _unix_timestamp(args, batch, out_type):
    if not args:
        return ColVal.device(INT64, torch.full(
            (batch.capacity,), int(time.time()), dtype=torch.int64,
            device=batch.device))
    if args[0].dtype.id == TypeId.UTF8:
        # Spark's lenient default-pattern parser (optional time and
        # fraction, a 'T', surrounding blanks), NULL on failure: the
        # cast's parser
        from blaze_tpu_torch.exprs.cast import _try_parse_timestamp
        ts = _try_parse_timestamp(args[0].to_host(batch.num_rows))
        valid = ts.is_valid().to_numpy(zero_copy_only=False)
        micros = ts.cast(pa.int64()).fill_null(0).to_numpy(
            zero_copy_only=False)
        secs = np.floor_divide(micros, 1_000_000)
        return ColVal.host(INT64, pa.array(secs, mask=~valid))
    v = _dev(args[0], batch)
    if v.dtype.id == TypeId.DATE32:
        secs = v.data.to(torch.int64) * 86400
    else:
        secs = _fdiv(v.data, 1_000_000)
    return ColVal(INT64, secs, v.validity)


@register("from_unixtime", lambda ts: UTF8)
def _from_unixtime(args, batch, out_type):
    py = []
    for x in args[0].to_host(batch.num_rows).to_pylist():
        if x is None:
            py.append(None)
        else:
            dt = datetime.datetime.fromtimestamp(int(x),
                                                 datetime.timezone.utc)
            py.append(dt.strftime("%Y-%m-%d %H:%M:%S"))
    return ColVal.host(UTF8, pa.array(py, type=pa.utf8()))


def _literal_str(v: ColVal, batch) -> str:
    arr = v.to_host(min(batch.num_rows, 1))
    return arr[0].as_py() if len(arr) and arr[0].is_valid else ""
