"""Cast and TryCast (port of blaze_tpu/exprs/cast.py).

A fixed-width value on the device casts with torch ops on its device
(kernels/cast.py).  A cast from or to a string runs at the host boundary
over pyarrow with Spark's parsing and display rules, as in the
reference: `_parse_string` (trim, invalid input -> NULL; integral casts
by `_spark_to_integer`, dates by `_spark_to_date`) and `_format_string`
(`_spark_str`); a fixed-width result crosses back to the batch's device.
Decimals belong to the strings/decimals slice (ROADMAP Queue 1 item 13)
and raise.

ANSI mode (`spark.sql.ansi.enabled`): a Cast raises on input it cannot
convert instead of producing NULL; TryCast always produces NULL (the
distinction the reference keeps between CastExpr and TryCastExpr).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.kernels import cast as cast_kernels
from blaze_tpu_torch.schema import DataType, Schema, TypeId

_NESTED = (TypeId.LIST, TypeId.STRUCT, TypeId.MAP)


@dataclass(frozen=True, repr=False)
class Cast(PhysicalExpr):
    child: PhysicalExpr
    to: DataType

    ansi_capable = True  # TryCast overrides

    def children(self):
        return (self.child,)

    def data_type(self, schema: Schema) -> DataType:
        return self.to

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        v = self.child.evaluate(batch)
        src = v.dtype
        if src == self.to:
            return v
        if TypeId.DECIMAL in (src.id, self.to.id):
            raise NotImplementedError(
                f"cast {src} -> {self.to}: decimal casts belong to the "
                f"strings/decimals slice of the PyTorch port (ROADMAP "
                f"Queue 1 item 13)")
        ansi = self.ansi_capable and config.ANSI_ENABLED.get()
        if v.is_device and self.to.is_fixed_width:
            data, valid = cast_kernels.cast_column(v.data, v.validity,
                                                   src, self.to)
            if ansi:
                lost = v.validity & ~valid & batch.row_mask()
                if bool(lost.any()):
                    raise _ansi_error(self.to)
            return ColVal(self.to, data=data, validity=valid)
        out = _host_cast(v, self.to, batch)
        if ansi:
            n = batch.num_rows
            in_valid = np.asarray(v.to_host(n).is_valid())
            out_valid = np.asarray(out.to_host(n).is_valid())
            if (in_valid & ~out_valid).any():
                raise _ansi_error(self.to)
        return out

    def __repr__(self):
        return f"cast({self.child!r} as {self.to!r})"


@dataclass(frozen=True, repr=False)
class TryCast(Cast):
    """Invalid input -> NULL even under ANSI (ref cast.rs TryCastExpr)."""

    ansi_capable = False

    def __repr__(self):
        return f"try_cast({self.child!r} as {self.to!r})"


def _ansi_error(to: DataType) -> ValueError:
    return ValueError(
        f"[CAST_INVALID_INPUT] cast to {to!r} failed in ANSI mode (use "
        f"try_cast to tolerate malformed input)")


def _host_cast(v: ColVal, to: DataType, batch: ColumnBatch) -> ColVal:
    """The cast over pyarrow on the host; a fixed-width result in device
    form on the batch's device."""
    n = batch.num_rows
    arr = v.to_host(n)
    src = v.dtype
    if src.id == TypeId.UTF8:
        out = _parse_string(arr, to)
    elif to.id == TypeId.UTF8:
        out = _format_string(arr, src)
    else:
        try:
            out = arr.cast(to.to_arrow(), safe=False)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            out = pa.nulls(n, type=to.to_arrow())
    if to.is_fixed_width:
        col = DeviceColumn.from_arrow(out, to, batch.capacity, batch.device)
        return ColVal(to, col.data, col.validity)
    return ColVal(to, array=out)


def _parse_string(arr: pa.Array, to: DataType) -> pa.Array:
    """Spark string parsing: trim, invalid -> null (non-ANSI)."""
    if config.CAST_TRIM_STRING.get():
        arr = pc.utf8_trim_whitespace(arr)
    t = to.to_arrow()
    if to.id == TypeId.BOOL:
        lowered = pc.utf8_lower(arr)
        truthy = pc.is_in(lowered, value_set=pa.array(
            ["true", "t", "yes", "y", "1"]))
        falsy = pc.is_in(lowered, value_set=pa.array(
            ["false", "f", "no", "n", "0"]))
        out = pc.if_else(truthy, True, pc.if_else(
            falsy, False, pa.nulls(len(arr), pa.bool_())))
        return pc.if_else(pc.is_valid(arr), out,
                          pa.nulls(len(arr), pa.bool_()))
    if to.id == TypeId.DATE32:
        return pa.array([_spark_to_date(x.as_py()) if x.is_valid else None
                         for x in arr], type=pa.date32())
    if to.id == TypeId.TIMESTAMP_MICROS:
        return _try_parse_timestamp(arr)
    if to.is_integer:
        # Spark accepts "12.5" -> 12 for integral casts: parsed as digits
        # and truncated (a double round trip would corrupt > 2^53)
        return _string_to_integral(arr, to)
    return _try_cast(arr, t)


def _spark_to_integer(s: str, lo: int, hi: int):
    """Spark UTF8String.toLong/toInt semantics (ref cast.rs:394
    to_integer): optional sign, decimal digits, an optional '.' whose
    fractional part must be all digits (the value truncates), anything
    else -> null.  Scientific notation is rejected ("1e3" -> null)."""
    if not s:
        return None
    neg = s[0] == "-"
    i = 1 if s[0] in "+-" else 0
    if i == len(s):
        return None
    mag_limit = -lo if neg else hi  # asymmetric two's-complement bounds
    result = 0
    n = len(s)
    saw_digit = False
    while i < n:
        ch = s[i]
        i += 1
        if ch == ".":
            break
        if not ("0" <= ch <= "9"):
            return None
        saw_digit = True
        result = result * 10 + (ord(ch) - 48)
        if result > mag_limit:
            return None
    if not saw_digit:
        return None
    # the fractional part: checked well formed, its value dropped
    while i < n:
        if not ("0" <= s[i] <= "9"):
            return None
        i += 1
    return -result if neg else result


def _string_to_integral(arr: pa.Array, to: DataType) -> pa.Array:
    lo, hi = cast_kernels._int_bounds(to.id)
    trim = config.CAST_TRIM_STRING.get()
    out = []
    for x in arr:
        if not x.is_valid:
            out.append(None)
            continue
        s = x.as_py()
        if trim:
            s = s.strip()
        elif s != s.strip():
            out.append(None)
            continue
        out.append(_spark_to_integer(s, lo, hi))
    return pa.array(out, type=to.to_arrow())


def _try_cast(arr: pa.Array, t: pa.DataType) -> pa.Array:
    """Element-wise safe cast: failures become null, not errors."""
    try:
        return arr.cast(t, safe=False)
    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
        pass
    out = []
    for x in arr:
        try:
            out.append(pa.array([x.as_py()]).cast(t, safe=False)[0].as_py()
                       if x.is_valid else None)
        except (pa.ArrowInvalid, ValueError, TypeError, OverflowError):
            out.append(None)
    return pa.array(out, type=t)


def _spark_to_date(s: str):
    """SparkDateTimeUtils.stringToDate (ref cast.rs:471 to_date):
    [+-]yyyy[-[m]m[-[d]d]], year 4-7 digits, month and day 1-2 digits; a
    ' '/'T' suffix only after all three segments; otherwise the whole
    input must be consumed."""
    import datetime
    s = s.strip()
    if not s:
        return None

    def valid_digits(segment: int, digits: int) -> bool:
        return (segment == 0 and 4 <= digits <= 7) or \
            (segment != 0 and 0 < digits <= 2)

    segments = [1, 1, 1]
    sign = 1
    i = 0
    cur_val = 0
    cur_digits = 0
    j = 0
    if s[0] in "+-":
        sign = -1 if s[0] == "-" else 1
        j = 1
    n = len(s)
    while j < n and i < 3 and s[j] not in " T":
        ch = s[j]
        if i < 2 and ch == "-":
            if not valid_digits(i, cur_digits):
                return None
            segments[i] = cur_val
            cur_val = 0
            cur_digits = 0
            i += 1
        else:
            if not ("0" <= ch <= "9"):
                return None
            cur_val = cur_val * 10 + (ord(ch) - 48)
            cur_digits += 1
        j += 1
    if not valid_digits(i, cur_digits):
        return None
    if i < 2 and j < n:
        # the yyyy and yyyy-[m]m forms must consume the whole input
        return None
    segments[i] = cur_val
    if segments[0] > 9999 or segments[1] > 12 or segments[2] > 31:
        return None
    try:
        return datetime.date(sign * segments[0], segments[1], segments[2])
    except ValueError:
        return None


def _try_parse_timestamp(arr: pa.Array) -> pa.Array:
    import datetime
    out = []
    for x in arr:
        if not x.is_valid:
            out.append(None)
            continue
        s = x.as_py().strip().replace("T", " ")
        val = None
        for fmt in ("%Y-%m-%d %H:%M:%S.%f", "%Y-%m-%d %H:%M:%S",
                    "%Y-%m-%d %H:%M", "%Y-%m-%d"):
            try:
                val = datetime.datetime.strptime(s, fmt)
                break
            except ValueError:
                continue
        out.append(val)
    return pa.array(out, type=pa.timestamp("us"))


# ---------------------------------------------------------------------------
# value -> string (Spark display formats, ref cast.rs *_to_string tests)
# ---------------------------------------------------------------------------

def _format_string(arr: pa.Array, src: DataType) -> pa.Array:
    if src.id == TypeId.BOOL:
        return pc.if_else(arr, "true", "false")
    if src.id in (TypeId.FLOAT32, TypeId.FLOAT64) or src.id in _NESTED:
        return pa.array([_spark_str(x.as_py(), src) if x.is_valid else None
                         for x in arr], type=pa.utf8())
    if src.id == TypeId.TIMESTAMP_MICROS:
        # Spark timestampToString: the fraction without trailing zeros,
        # none at .000000 (Arrow's cast always prints it)
        py = []
        for x in arr:
            if not x.is_valid:
                py.append(None)
                continue
            v = x.as_py()
            # %Y does not zero-pad years < 1000 on Linux; Spark does
            s = f"{v.year:04d}" + v.strftime("-%m-%d %H:%M:%S")
            if v.microsecond:
                s += "." + f"{v.microsecond:06d}".rstrip("0")
            py.append(s)
        return pa.array(py, type=pa.utf8())
    return arr.cast(pa.utf8())


def _spark_str(v, t: DataType) -> str:
    """One value in Spark's display format: struct "{1, a, true}", map
    "{k -> v}", array "[1, 2]", nulls as the literal "null"."""
    if v is None:
        return "null"
    if t.id == TypeId.BOOL:
        return "true" if v else "false"
    if t.id in (TypeId.FLOAT32, TypeId.FLOAT64):
        f = float(v)
        if f != f:
            return "NaN"
        if f in (float("inf"), float("-inf")):
            return "Infinity" if f > 0 else "-Infinity"
        return repr(f) if not f.is_integer() else f"{f:.1f}"
    if t.id == TypeId.STRUCT:
        inner = ", ".join(
            _spark_str(v.get(f.name), f.data_type) for f in t.children)
        return "{" + inner + "}"
    if t.id == TypeId.MAP:
        kt = t.children[0].data_type
        vt = t.children[1].data_type
        items = v.items() if isinstance(v, dict) else v
        inner = ", ".join(f"{_spark_str(k, kt)} -> {_spark_str(val, vt)}"
                          for k, val in items)
        return "{" + inner + "}"
    if t.id == TypeId.LIST:
        et = t.children[0].data_type
        return "[" + ", ".join(_spark_str(e, et) for e in v) + "]"
    return str(v)
