"""Binary operators with Spark null semantics (port of
blaze_tpu/exprs/binary.py but its dictionary-code branch).

  * comparisons `== != < <= > >=` promote mismatched widths like the JAX
    package (the widest type wins); the result is NULL where either side
    is NULL, and NaN == NaN is false; `<=>` (null-safe equality) treats
    NULL <=> NULL and NaN <=> NaN as true;
  * AND/OR are Kleene three-valued logic: FALSE AND NULL is FALSE,
    TRUE OR NULL is TRUE;
  * arithmetic `+ - * / % pmod` promotes the same way; NULL in, NULL out;
    integers wrap; `/`, `%` and `pmod` by zero give NULL for every
    numeric type (non-ANSI Spark); integral `/` truncates toward zero,
    `%` takes the dividend's sign (Java) and `pmod` is Spark's Pmod
    (r = x % y, then (r + y) % y where r < 0); under
    `spark.sql.ansi.enabled` a selected row that divides by zero or
    overflows an integer raises instead;
  * bitwise `& | ^ << >>` over integers; a shift count is taken modulo
    the width and `>>` keeps the sign, as Java does.

Variable-width operands (host form: Arrow arrays) take the JAX
package's host branch: the six comparisons and `<=>` run on the host
through Arrow's kernels, which order utf8 by its bytes, unsigned, as
Spark does (q08's `ca_zip < '20000'`).  An AND/OR whose side is a host
bool (a string predicate's result) uploads it and runs the Kleene logic
on the device.

Decimal operands (an integral operand widens to a decimal, as Spark's
DecimalType.forType) take the JAX package's routes:

  * equal scales within precision 18: comparisons and `+ -` (whose
    result precision stays <= 18) on the unscaled int64s on the device;
  * unequal scales within precision 18: comparisons rescale through the
    int128 limbs of kernels/decimal128.py on the device when
    `auron.tpu.encoding.decimal.enable` is on;
  * everything else (`* / % pmod`, mixed scales, precision > 18, a host
    operand) is exact on the host (exprs/decimal_arith.py), NULL on
    overflow, raising under ANSI.

A decimal meeting a float operand takes its value, unscaled / 10^scale in
float64, before the float operation, as Spark casts it to double (the
JAX package computes on the unscaled integers there: ROADMAP Queue 3).
"""

from __future__ import annotations

import operator
from dataclasses import dataclass

import pyarrow as pa
import pyarrow.compute as pc
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import decimal_arith as D
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.kernels import decimal128 as d128
from blaze_tpu_torch.kernels.cast import decimal_to_double
from blaze_tpu_torch.kernels.compare import null_aware_eq
from blaze_tpu_torch.schema import (BOOL, FLOAT64, DataType, Schema, TypeId,
                                    _BY_TORCH)

_CMP = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}
_BOOLEAN = {"and", "or"}
_ARITH = {"+", "-", "*", "/", "%", "pmod", "&", "|", "^", "<<", ">>"}
_HOST_CMP = {"==": pc.equal, "!=": pc.not_equal, "<": pc.less,
             "<=": pc.less_equal, ">": pc.greater, ">=": pc.greater_equal}


def _check_op(op: str) -> None:
    if op not in _CMP and op not in _BOOLEAN and op not in _ARITH \
            and op != "<=>":
        raise ValueError(f"unknown binary operator {op!r}")


def _check_operand(t: DataType) -> None:
    if not t.is_fixed_width:
        raise TypeError(f"{t} operands have no arithmetic")


def _storage(t: DataType) -> torch.dtype:
    """The dtype an operand computes in: a decimal meeting a float is its
    float64 value."""
    return torch.float64 if t.id == TypeId.DECIMAL else t.torch_dtype()


def arith_type(lt: DataType, rt: DataType) -> DataType:
    """Result type of `+ - * / %` over non-decimal operands, or a decimal
    with a float: the promotion of the two storage types (date32 and
    timestamp operands compute as their integers)."""
    for t in (lt, rt):
        _check_operand(t)
    return _BY_TORCH[torch.promote_types(_storage(lt), _storage(rt))]


def decimal_types(op: str, lt: DataType, rt: DataType):
    """(lt, rt) as decimal types where `op` is decimal-valued: a decimal
    side, the other decimal-coercible (an integer), an arithmetic or
    comparison operator.  A float side makes the operation a float one."""
    if op in _BOOLEAN or op in ("&", "|", "^", "<<", ">>"):
        return None
    if TypeId.DECIMAL not in (lt.id, rt.id):
        return None
    if lt.is_floating or rt.is_floating:
        return None
    ldt, rdt = D.as_decimal_type(lt), D.as_decimal_type(rt)
    if ldt is None or rdt is None:
        return None
    return ldt, rdt


def _decimal_device_ok(op: str, ldt: DataType, rdt: DataType) -> bool:
    """Equal-scale decimals within precision 18 compare, add and subtract
    exactly on their unscaled int64s (a +/- result of precision
    max(p1, p2) + 1 <= 18 cannot overflow)."""
    if ldt.scale != rdt.scale or max(ldt.precision, rdt.precision) > 18:
        return False
    if op in _CMP or op == "<=>":
        return True
    return op in ("+", "-") and max(ldt.precision, rdt.precision) + 1 <= 18


def _decimal_limb_ok(ldt: DataType, rdt: DataType) -> bool:
    """Unequal-scale comparisons within precision 18 rescale through the
    int128 limbs (10^18 x 10^20 < 2^127) when the knob is on."""
    return (config.ENCODING_DECIMAL_ENABLE.get()
            and max(ldt.precision, rdt.precision) <= 18
            and abs(ldt.scale - rdt.scale) <= 20)


def _decimal_as_double(v: ColVal, batch: ColumnBatch) -> ColVal:
    """A decimal's value as float64, for a float operation: unscaled /
    10^scale on the device (a division, so a short scale is exact), each
    value's nearest double on the host for precision > 18."""
    if v.dtype.id != TypeId.DECIMAL:
        return v
    if v.is_device:
        return ColVal(FLOAT64, decimal_to_double(v.data, v.dtype.scale),
                      v.validity)
    arr = v.to_host(batch.num_rows)
    return ColVal(FLOAT64, array=pa.array(
        [None if x is None else float(x) for x in arr.to_pylist()],
        type=pa.float64()))


@dataclass(frozen=True, repr=False)
class BinaryExpr(PhysicalExpr):
    op: str
    left: PhysicalExpr
    right: PhysicalExpr

    def __post_init__(self):
        _check_op(self.op)

    def children(self):
        return (self.left, self.right)

    def data_type(self, schema: Schema) -> DataType:
        if self.op in _ARITH:
            lt = self.left.data_type(schema)
            rt = self.right.data_type(schema)
            dec = decimal_types(self.op, lt, rt)
            if dec is not None:
                return D.result_type(self.op, *dec)
            return arith_type(lt, rt)
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        a = self.left.evaluate(batch)
        b = self.right.evaluate(batch)
        # an untyped NULL takes the other side's type (BOOL under AND/OR)
        a, b = _typed_null(a, b, self.op, batch), _typed_null(b, a, self.op,
                                                              batch)
        dec = decimal_types(self.op, a.dtype, b.dtype)
        if dec is not None:
            return self._evaluate_decimal(batch, a, b, *dec)
        # a decimal meeting a float is its double value (Spark's cast)
        a, b = _decimal_as_double(a, batch), _decimal_as_double(b, batch)
        # a fixed-width value a host function computed (a string
        # predicate's bools, a length) crosses to the device
        a, b = (_fixed_on_device(v, batch) for v in (a, b))
        if not (a.is_device and b.is_device):
            return self._evaluate_host(batch, a, b)
        for side in (a, b):
            _check_operand(side.dtype)
        if self.op in _BOOLEAN:
            return _kleene(self.op, a, b)
        if self.op == "<=>":
            x, y = _promote(a, b)
            return ColVal(BOOL, null_aware_eq(x, a.validity, y, b.validity),
                          torch.ones_like(a.validity))
        if self.op in _CMP:
            return _compare(self.op, a, b)
        out = _arith(self.op, a, b, arith_type(a.dtype, b.dtype))
        if config.ANSI_ENABLED.get() and self.op in ("+", "-", "*", "/",
                                                     "%", "pmod"):
            _ansi_arith_check(self.op, batch, a, b, out)
        return out

    def _evaluate_decimal(self, batch: ColumnBatch, a: ColVal, b: ColVal,
                          ldt: DataType, rdt: DataType) -> ColVal:
        """The JAX package's three decimal routes: the unscaled int64s on
        the device, the int128 limbs on the device, or exact on the
        host."""
        op = self.op
        on_device = a.is_device and b.is_device
        if on_device and _decimal_device_ok(op, ldt, rdt):
            if op == "<=>":
                return ColVal(BOOL, null_aware_eq(
                    a.data.to(torch.int64), a.validity,
                    b.data.to(torch.int64), b.validity),
                    torch.ones_like(a.validity))
            if op in _CMP:
                return _compare(op, a, b)
            return _arith(op, a, b, D.result_type(op, ldt, rdt))
        if on_device and op in (*_CMP, "<=>") and _decimal_limb_ok(ldt, rdt):
            return d128.compare_colvals(op, a, b, ldt, rdt)
        return D.evaluate(op, a, b, ldt, rdt, batch)

    def _evaluate_host(self, batch: ColumnBatch, a: ColVal,
                       b: ColVal) -> ColVal:
        """Comparisons with a host operand on host Arrow arrays (the JAX
        package's `_evaluate_host`)."""
        n = batch.num_rows
        ha, hb = a.to_host(n), b.to_host(n)
        if self.op in _HOST_CMP:
            return ColVal(BOOL, array=_HOST_CMP[self.op](ha, hb))
        if self.op == "<=>":
            eq = pc.equal(ha, hb)
            both_null = pc.and_(pc.is_null(ha), pc.is_null(hb))
            return ColVal(BOOL, array=pc.or_kleene(
                eq.fill_null(False), both_null).fill_null(False))
        raise TypeError(f"operator {self.op!r} over {a.dtype} and "
                        f"{b.dtype}: strings concatenate with concat()")

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _typed_null(v: ColVal, other: ColVal, op: str,
                batch: ColumnBatch) -> ColVal:
    if v.dtype.id != TypeId.NULL:
        return v
    t = BOOL if op in _BOOLEAN or other.dtype.id == TypeId.NULL \
        else other.dtype
    return ColVal(t, array=pa.nulls(batch.num_rows, type=t.to_arrow()))


def _fixed_on_device(v: ColVal, batch: ColumnBatch) -> ColVal:
    if v.is_device or not v.dtype.is_fixed_width:
        return v
    return v.to_device(batch.capacity, batch.device)


def _promote(a: ColVal, b: ColVal):
    dt = torch.promote_types(a.data.dtype, b.data.dtype)
    return a.data.to(dt), b.data.to(dt)


def _kleene(op: str, a: ColVal, b: ColVal) -> ColVal:
    av, bv = a.validity, b.validity
    ad = a.data.to(torch.bool)
    bd = b.data.to(torch.bool)
    if op == "and":
        data = ad & bd
        # known when both are valid, or either side is a known False
        valid = (av & bv) | (av & ~ad) | (bv & ~bd)
    else:
        data = ad | bd
        valid = (av & bv) | (av & ad) | (bv & bd)
    return ColVal(BOOL, data & valid, valid)


def _compare(op: str, a: ColVal, b: ColVal) -> ColVal:
    x, y = _promote(a, b)
    valid = a.validity & b.validity
    return ColVal(BOOL, _CMP[op](x, y) & valid, valid)


def _arith(op: str, a: ColVal, b: ColVal, out_dtype: DataType) -> ColVal:
    x, y = _promote(a, b)
    valid = a.validity & b.validity
    is_float = x.dtype.is_floating_point
    if op in ("/", "%", "pmod"):
        # Spark DivModLike: a zero divisor gives NULL for every numeric
        # type (non-ANSI), a double one included
        zero = y == 0
        valid = valid & ~zero
        y = torch.where(zero, torch.ones_like(y), y)
    if op == "+":
        data = x + y
    elif op == "-":
        data = x - y
    elif op == "*":
        data = x * y
    elif op == "/":
        if is_float:
            data = x / y
        else:
            # truncating integral division, as Java
            q = torch.div(x.abs(), y.abs(), rounding_mode="floor")
            data = torch.where((x < 0) ^ (y < 0), -q, q)
    elif op == "%":
        if is_float:
            data = torch.where(torch.isfinite(y) | torch.isnan(y),
                               x - torch.trunc(x / y) * y, x)
            data = torch.where(torch.isinf(y) & torch.isfinite(x), x, data)
        else:
            # Java %: the sign follows the dividend
            r = x.abs() % y.abs()
            data = torch.where(x < 0, -r, r)
    elif op == "pmod":
        # Spark Pmod, not a floor modulo: a non-negative remainder stays
        # for a negative divisor (pmod(7, -3) = 1, pmod(-7, -3) = -1);
        # torch.fmod is Java's % for integers and floats alike
        r = torch.fmod(x, y)
        data = torch.where(r < 0, torch.fmod(r + y, y), r)
    elif op in ("<<", ">>"):
        n = y.to(x.dtype) & (x.element_size() * 8 - 1)
        data = (torch.bitwise_left_shift(x, n) if op == "<<"
                else torch.bitwise_right_shift(x, n))
    else:
        data = {"&": torch.bitwise_and, "|": torch.bitwise_or,
                "^": torch.bitwise_xor}[op](x, y)
    data = data.to(out_dtype.torch_dtype())
    data = torch.where(valid, data, torch.zeros_like(data))
    return ColVal(out_dtype, data, valid)


def _ansi_arith_check(op: str, batch: ColumnBatch, a: ColVal, b: ColVal,
                      out: ColVal) -> None:
    """ANSI mode: division or modulo by zero raises DIVIDE_BY_ZERO and
    integer overflow in + - * / raises ARITHMETIC_OVERFLOW, for selected
    rows only (one device sync per check)."""
    both = a.validity & b.validity & batch.row_mask()
    if op in ("/", "%", "pmod"):
        # a row valid on both sides but NULL in the result divided by 0
        if bool((both & ~out.validity).any()):
            raise ValueError(
                "[DIVIDE_BY_ZERO] division by zero (ANSI mode; use "
                "try_divide or nullif to tolerate)")
    dt = out.data.dtype
    if dt.is_floating_point or dt == torch.bool or \
            op not in ("+", "-", "*", "/"):
        return
    x, y, r = a.data.to(dt), b.data.to(dt), out.data
    int_min = torch.iinfo(dt).min
    if op == "+":
        ovf = ((x > 0) & (y > 0) & (r < 0)) | ((x < 0) & (y < 0) & (r >= 0))
    elif op == "-":
        ovf = ((x >= 0) & (y < 0) & (r < 0)) | ((x < 0) & (y > 0) & (r >= 0))
    elif op == "*":
        # verify by division (exact where y != 0); the verify division
        # itself wraps for INT_MIN // -1, so that pair has its own clause
        y_safe = torch.where(y == 0, torch.ones_like(y), y)
        ovf = (((y != 0) & (torch.div(r, y_safe, rounding_mode="floor")
                             != x))
               | ((x == int_min) & (y == -1)) | ((y == int_min) & (x == -1)))
    else:
        # integral division overflows only at INT_MIN / -1
        ovf = (x == int_min) & (y == -1)
    if bool((ovf & both).any()):
        raise ValueError(
            "[ARITHMETIC_OVERFLOW] integer overflow (ANSI mode; use "
            "try_add/try_multiply to tolerate)")
