"""Binary operators with Spark null semantics (port of the fixed-width part
of blaze_tpu/exprs/binary.py).

  * comparisons `== != < <= > >=` promote mismatched widths like the JAX
    package (the widest type wins); the result is NULL where either side
    is NULL, and NaN == NaN is false; `<=>` (null-safe equality) treats
    NULL <=> NULL and NaN <=> NaN as true;
  * AND/OR are Kleene three-valued logic: FALSE AND NULL is FALSE,
    TRUE OR NULL is TRUE;
  * arithmetic `+ - * / %` promotes the same way; NULL in, NULL out;
    integers wrap; `/` and `%` by zero give NULL for every numeric type
    (non-ANSI Spark); integral `/` truncates toward zero and `%` takes the
    dividend's sign (Java).  Under `spark.sql.ansi.enabled` a selected
    row that divides by zero or overflows an integer raises instead.

A utf8 operand (host form: an Arrow array) takes the host-operand branch
of the JAX package: `==` and `!=` run on the host through Arrow's
kernels, NULL in, NULL out (q01's `s_state = 'TN'`).  The other operators
over utf8, and decimal operands, belong to the strings/decimals slice and
raise NotImplementedError.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass

import pyarrow.compute as pc
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.kernels.compare import null_aware_eq
from blaze_tpu_torch.schema import BOOL, DataType, Schema, TypeId, _BY_TORCH

_CMP = {"==": operator.eq, "!=": operator.ne, "<": operator.lt,
        "<=": operator.le, ">": operator.gt, ">=": operator.ge}
_BOOLEAN = {"and", "or"}
_ARITH = {"+", "-", "*", "/", "%"}


def _check_op(op: str) -> None:
    if op not in _CMP and op not in _BOOLEAN and op not in _ARITH \
            and op != "<=>":
        raise NotImplementedError(
            f"binary operator {op!r} belongs to a later slice of the "
            f"PyTorch port (ROADMAP Queue 1 item 3); the port has "
            f"== != < <= > >= <=> and or + - * / %")


def _check_operand(t: DataType) -> None:
    if t.id == TypeId.DECIMAL:
        raise NotImplementedError(
            "decimal operands belong to the strings/decimals slice of the "
            "PyTorch port (ROADMAP Queue 1 item 13)")
    if not t.is_fixed_width:
        raise NotImplementedError(
            f"{t} operands belong to the strings/decimals slice of the "
            f"PyTorch port (ROADMAP Queue 1 item 13)")


def arith_type(lt: DataType, rt: DataType) -> DataType:
    """Result type of `+ - * / %`: the promotion of the two storage types
    (date32 and timestamp operands compute as their integers)."""
    for t in (lt, rt):
        _check_operand(t)
    return _BY_TORCH[torch.promote_types(lt.torch_dtype(), rt.torch_dtype())]


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
            return arith_type(self.left.data_type(schema),
                              self.right.data_type(schema))
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        a = self.left.evaluate(batch)
        b = self.right.evaluate(batch)
        if self.op in _BOOLEAN:
            # a utf8 comparison's bool result crosses to the device
            a, b = (_bool_on_device(v, batch) for v in (a, b))
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
        if config.ANSI_ENABLED.get():
            _ansi_arith_check(self.op, batch, a, b, out)
        return out

    def _evaluate_host(self, batch: ColumnBatch, a: ColVal,
                       b: ColVal) -> ColVal:
        """utf8 `==`/`!=` on host Arrow arrays (the JAX package's
        `_evaluate_host`)."""
        fns = {"==": pc.equal, "!=": pc.not_equal}
        for side in (a, b):
            if side.dtype.id != TypeId.UTF8:
                _check_operand(side.dtype)
        if self.op not in fns:
            raise NotImplementedError(
                f"utf8 operator {self.op!r} belongs to the strings slice "
                f"of the PyTorch port (ROADMAP Queue 1 item 13); the port "
                f"has == and !=")
        n = batch.num_rows
        return ColVal(BOOL, array=fns[self.op](a.to_host(n), b.to_host(n)))

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


def _bool_on_device(v: ColVal, batch: ColumnBatch) -> ColVal:
    if v.is_device or v.dtype.id != TypeId.BOOL:
        return v
    dc = DeviceColumn.from_arrow(v.array, BOOL, batch.capacity,
                                 batch.device)
    return ColVal(BOOL, dc.data, dc.validity)


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
    if op in ("/", "%"):
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
    else:
        if is_float:
            data = torch.where(torch.isfinite(y) | torch.isnan(y),
                               x - torch.trunc(x / y) * y, x)
            data = torch.where(torch.isinf(y) & torch.isfinite(x), x, data)
        else:
            # Java %: the sign follows the dividend
            r = x.abs() % y.abs()
            data = torch.where(x < 0, -r, r)
    data = data.to(out_dtype.torch_dtype())
    data = torch.where(valid, data, torch.zeros_like(data))
    return ColVal(out_dtype, data, valid)


def _ansi_arith_check(op: str, batch: ColumnBatch, a: ColVal, b: ColVal,
                      out: ColVal) -> None:
    """ANSI mode: division or modulo by zero raises DIVIDE_BY_ZERO and
    integer overflow in + - * / raises ARITHMETIC_OVERFLOW, for selected
    rows only (one device sync per check)."""
    both = a.validity & b.validity & batch.row_mask()
    if op in ("/", "%"):
        # a row valid on both sides but NULL in the result divided by 0
        if bool((both & ~out.validity).any()):
            raise ValueError(
                "[DIVIDE_BY_ZERO] division by zero (ANSI mode; use "
                "try_divide or nullif to tolerate)")
    dt = out.data.dtype
    if dt.is_floating_point or dt == torch.bool or op == "%":
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
