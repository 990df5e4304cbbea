"""Spark scalar-function registry (port of blaze_tpu/funcs/__init__.py).

`ScalarFunctionExpr` evaluates its arguments and calls the registered
callable `fn(args: List[ColVal], batch, out_type) -> ColVal`.  As in the
JAX package, numeric and date functions run as tensor ops on the batch's
device (torch here, jnp there), and string, JSON, collection and digest
functions run on the host over Arrow arrays with pyarrow.compute.

A name nobody registered raises KeyError.  The decimal functions
(`unscaled_value`, `make_decimal`, `check_overflow`) run on the unscaled
integers (funcs/decimal_fns.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.schema import DataType, Schema

_REGISTRY: Dict[str, Tuple[Callable, Callable]] = {}


def register(name: str, type_fn: Optional[Callable] = None):
    """Decorator: register `fn(args, batch, out_type) -> ColVal`;
    `type_fn(arg_types) -> DataType` infers the return type (the first
    argument's when None)."""
    def deco(fn):
        _REGISTRY[name.lower()] = (fn, type_fn or (lambda ts: ts[0]))
        return fn
    return deco


def lookup(name: str):
    entry = _REGISTRY.get(name.lower())
    if entry is None:
        raise KeyError(f"unknown scalar function {name!r}; "
                       f"known: {sorted(_REGISTRY)}")
    return entry


def registered_names() -> List[str]:
    return sorted(_REGISTRY)


@dataclass(frozen=True, repr=False)
class ScalarFunctionExpr(PhysicalExpr):
    name: str
    args: Tuple[PhysicalExpr, ...] = ()
    out_type: Optional[DataType] = None  # the plan's return type

    def children(self):
        return self.args

    def data_type(self, schema: Schema) -> DataType:
        if self.out_type is not None:
            return self.out_type
        _, type_fn = lookup(self.name)
        return type_fn([a.data_type(schema) for a in self.args])

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        fn, type_fn = lookup(self.name)
        vals = [a.evaluate(batch) for a in self.args]
        out_type = self.out_type or type_fn([v.dtype for v in vals])
        return fn(vals, batch, out_type)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def fn(name: str, *args: PhysicalExpr,
       out_type: Optional[DataType] = None) -> ScalarFunctionExpr:
    return ScalarFunctionExpr(name, tuple(args), out_type)


# the registrations (order-independent)
from blaze_tpu_torch.funcs import math as _math          # noqa: E402,F401
from blaze_tpu_torch.funcs import dates as _dates        # noqa: E402,F401
from blaze_tpu_torch.funcs import strings as _strings    # noqa: E402,F401
from blaze_tpu_torch.funcs import collections as _coll   # noqa: E402,F401
from blaze_tpu_torch.funcs import crypto as _crypto      # noqa: E402,F401
from blaze_tpu_torch.funcs import decimal_fns as _dec    # noqa: E402,F401
from blaze_tpu_torch.funcs import json_fns as _json      # noqa: E402,F401
from blaze_tpu_torch.funcs import try_arith as _try      # noqa: E402,F401

__all__ = ["ScalarFunctionExpr", "fn", "register", "lookup",
           "registered_names"]
