"""The three internal functions Spark wraps around decimal arithmetic
(`unscaled_value`, `make_decimal`, `check_overflow`; the JAX package's
blaze_tpu/funcs/decimal_fns.py).  The port has no decimal column yet, so
each is registered and raises NotImplementedError naming the decimal
slice (ROADMAP Queue 1 item 13, decimals), which ports them with
`kernels/decimal128.py` and `exprs/decimal_arith.py`.
"""

from __future__ import annotations

from blaze_tpu_torch.exprs.base import DECIMAL_LATER
from blaze_tpu_torch.funcs import register
from blaze_tpu_torch.schema import INT64


def _later(args, batch, out_type):
    raise NotImplementedError(DECIMAL_LATER)


register("unscaled_value", lambda ts: INT64)(_later)
register("make_decimal")(_later)
register("check_overflow")(_later)
