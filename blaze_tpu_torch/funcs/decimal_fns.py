"""The three internal functions Spark wraps around decimal arithmetic
(port of blaze_tpu/funcs/decimal_fns.py): `unscaled_value`,
`make_decimal` and `check_overflow`, element-wise integer ops on the
unscaled values.  A decimal of precision > 18 is a host column and
rescales exactly on the host.
"""

from __future__ import annotations

import torch

from blaze_tpu_torch.batch import decimal_from_unscaled, to_host
from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.funcs.common import dev
from blaze_tpu_torch.schema import INT64, TypeId


@register("unscaled_value", lambda ts: INT64)
def _unscaled_value(args, batch, out_type):
    (v,) = dev(args, batch)
    return ColVal(INT64, v.data.to(torch.int64), v.validity)


@register("make_decimal")
def _make_decimal(args, batch, out_type):
    """long unscaled -> decimal(p, s); past the precision is NULL."""
    (v,) = dev(args, batch)
    p = out_type.precision if out_type.id == TypeId.DECIMAL else 18
    ok = v.data.abs() < 10 ** min(p, 18)
    data = torch.where(ok, v.data, 0).to(torch.int64)
    valid = v.validity & ok
    if out_type.is_fixed_width:
        return ColVal(out_type, data, valid)
    n = batch.num_rows
    return ColVal.host(out_type, decimal_from_unscaled(
        to_host(data[:n]), to_host(valid[:n]), out_type.to_arrow()))


@register("check_overflow")
def _check_overflow(args, batch, out_type):
    """The rescale and precision check after decimal arithmetic:
    overflow is NULL (non-ANSI)."""
    from blaze_tpu_torch.kernels.cast import cast_column
    v = args[0]
    if v.dtype.id == TypeId.DECIMAL and out_type.id == TypeId.DECIMAL:
        if v.dtype.precision > 18 or out_type.precision > 18:
            from blaze_tpu_torch.exprs.cast import _to_decimal
            return ColVal.host(out_type, _to_decimal(
                v.to_host(batch.num_rows), out_type))
        (d,) = dev([v], batch)
        data, valid = cast_column(d.data, d.validity, d.dtype, out_type)
        return ColVal(out_type, data, valid)
    (d,) = dev([v], batch)
    return d
