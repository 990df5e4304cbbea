"""Spark's `try_*` arithmetic (port of blaze_tpu/funcs/try_arith.py):
the ANSI-tolerant forms that never raise.

  * try_add, try_subtract, try_multiply: the plain operator, but an
    integer overflow at the operands' common width is NULL (exact Python
    integers on the host: these are boundary checks, not hot loops);
    float operands run the plain device operator;
  * try_divide: double division, a zero divisor NULL even for doubles;
  * try_element_at: element_at with an index out of range NULL in every
    mode (index 0 still raises).

A decimal operand (with a decimal or an integer) takes the exact decimal
path (exprs/decimal_arith.py) with ANSI off: Spark's widened result type,
a zero divisor and an overflow NULL.
"""

from __future__ import annotations

import pyarrow as pa
import torch

from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import dev
from blaze_tpu_torch.schema import (DataType, FLOAT32, FLOAT64, INT8, INT16,
                                    INT32, INT64, TypeId)

_INT_ORDER = [("int8", INT8, 8), ("int16", INT16, 16),
              ("int32", INT32, 32), ("int64", INT64, 64)]
_INT_BITS = {tid: bits for tid, _t, bits in _INT_ORDER}


def _decimal_pair_types(lt: DataType, rt: DataType):
    """(lt, rt) as decimals where one is a decimal and the other
    decimal-coercible, else None."""
    from blaze_tpu_torch.exprs import decimal_arith as D
    if TypeId.DECIMAL not in (lt.id, rt.id):
        return None
    la, lb = D.as_decimal_type(lt), D.as_decimal_type(rt)
    if la is None or lb is None:
        return None
    return la, lb


def _promoted_int(lt: DataType, rt: DataType) -> DataType:
    bits = max(_INT_BITS.get(lt.id.value, 64),
               _INT_BITS.get(rt.id.value, 64))
    return next(t for _tid, t, b in _INT_ORDER if b == bits)


def _promoted_float(lt: DataType, rt: DataType) -> DataType:
    """ints < float < double: float32 with any integral stays float32;
    only a float64 operand widens to double."""
    return FLOAT64 if TypeId.FLOAT64 in (lt.id, rt.id) else FLOAT32


def _try_type_fn(op):
    def tf(ts):
        lt = ts[0] if ts else INT64
        rt = ts[1] if len(ts) > 1 else lt
        dec = _decimal_pair_types(lt, rt)
        if dec is not None:
            from blaze_tpu_torch.exprs import decimal_arith as D
            return D.result_type(op, *dec)
        if op == "/":
            return FLOAT64
        if lt.is_floating or rt.is_floating:
            return _promoted_float(lt, rt)
        return _promoted_int(lt, rt)
    return tf


def _try_int_arith(op: str, a: ColVal, b: ColVal, batch,
                   out_t: DataType) -> ColVal:
    """An integer operator whose overflow at out_t's width is NULL."""
    n = batch.num_rows
    bits = _INT_BITS.get(out_t.id.value, 64)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    out = []
    for x, y in zip(a.to_host(n).to_pylist(), b.to_host(n).to_pylist()):
        if x is None or y is None:
            out.append(None)
            continue
        r = x + y if op == "+" else x - y if op == "-" else x * y
        out.append(r if lo <= r <= hi else None)
    return ColVal.host(out_t, pa.array(out, type=out_t.to_arrow()))


def _try_binary(op):
    def fn(args, batch, out_type):
        a, b = args[0], args[1]
        dec = _decimal_pair_types(a.dtype, b.dtype)
        if dec is not None:
            from blaze_tpu_torch.exprs import decimal_arith as D
            # ansi=False explicitly: try_* never raises
            return D.evaluate(op, a, b, dec[0], dec[1], batch, ansi=False)
        if op == "/":
            da, db = dev([a, b], batch)
            x = da.data.to(torch.float64)
            y = db.data.to(torch.float64)
            zero = y == 0
            data = x / torch.where(zero, torch.ones_like(y), y)
            valid = da.validity & db.validity & ~zero
            return ColVal(FLOAT64, torch.where(valid, data,
                                               torch.zeros_like(data)),
                          valid)
        if a.dtype.is_floating or b.dtype.is_floating:
            from blaze_tpu_torch.exprs.binary import _arith
            da, db = dev([a, b], batch)
            return _arith(op, da, db, _promoted_float(a.dtype, b.dtype))
        return _try_int_arith(op, a, b, batch,
                              _promoted_int(a.dtype, b.dtype))
    return fn


register("try_add", _try_type_fn("+"))(_try_binary("+"))
register("try_subtract", _try_type_fn("-"))(_try_binary("-"))
register("try_multiply", _try_type_fn("*"))(_try_binary("*"))
register("try_divide", _try_type_fn("/"))(_try_binary("/"))


@register("try_element_at")
def _try_element_at(args, batch, out_type):
    """element_at with an index out of range NULL in every mode; index 0
    still raises INVALID_INDEX_OF_ZERO."""
    from blaze_tpu_torch.funcs.collections import _element_at
    return _element_at(args, batch, out_type, ansi=False)
