"""Constant folding at plan decode: literal-only subexpressions become
one Literal (port of blaze_tpu/exprs/fold.py).

Spark folds constants before a plan crosses the wire, but directly
written plans (tests, the itest builders) do not, and every unfolded
constant subtree widens the fingerprint of the expression programs
(exprs/program.py): equivalent queries would build distinct programs.

Folding evaluates a pure node whose children are all Literals over a
one-row batch with no columns, on the CPU (no device work at decode, and
the CPU's bits, which are the JAX package's), and replaces it with a
Literal of the value.  Whatever raises during that probe (an ANSI cast
error, a decimal edge) stays unfolded, so the error comes at run time as
before.  The port always folds (the JAX package's
`auron.tpu.expr.constFold` is not carried over).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from blaze_tpu_torch.batch import ColumnBatch, round_capacity
from blaze_tpu_torch.exprs.base import ColVal, Literal, PhysicalExpr
from blaze_tpu_torch.exprs.binary import BinaryExpr
from blaze_tpu_torch.exprs.cast import Cast
from blaze_tpu_torch.exprs.conditional import (CaseWhen, Coalesce, If,
                                               InList, IsNotNull, IsNull,
                                               Not)
from blaze_tpu_torch.exprs.strings import Like, RLike, StringPredicate
from blaze_tpu_torch.schema import Schema, TypeId

#: value-level expression classes: the output depends only on the
#: children's values, so evaluating them over literal children at decode
#: is the run-time result.  Stateful or contextual expressions (rand, ids,
#: subqueries, UDFs) and anything not listed stay unfolded.
_FOLDABLE = (BinaryExpr, Not, IsNull, IsNotNull, If, CaseWhen, Coalesce,
             InList, Cast, Like, RLike, StringPredicate)

_EMPTY_SCHEMA = Schema([])


def map_exprs(e: PhysicalExpr, fn: Callable[[PhysicalExpr], PhysicalExpr]
              ) -> PhysicalExpr:
    """`e` rebuilt with `fn` applied to each direct expression child (a
    field, or an element of a tuple or list field, as CaseWhen's
    branches); TypeError for an expression that is not a dataclass."""
    if not dataclasses.is_dataclass(e):
        raise TypeError(f"cannot rebuild non-dataclass expr "
                        f"{type(e).__name__}")

    def one(v):
        if isinstance(v, PhysicalExpr):
            return fn(v)
        if isinstance(v, tuple):
            return tuple(one(x) for x in v)
        if isinstance(v, list):
            return [one(x) for x in v]
        return v

    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        nv = one(v)
        if nv is not v:
            changes[f.name] = nv
    return dataclasses.replace(e, **changes) if changes else e


def _scalar_of(v: ColVal):
    """Row 0 of an evaluated literal-only expression as a Python value."""
    if v.is_device:
        if not bool(v.validity[0]):
            return None
        return v.data[0].item()
    if len(v.array) == 0:
        return None
    return v.array[0].as_py()


def _probe_batch() -> ColumnBatch:
    """One row, no columns, on the CPU (the selection sets the device)."""
    return ColumnBatch(_EMPTY_SCHEMA, [], 1,
                       torch.ones(round_capacity(1), dtype=torch.bool))


def fold_node(e: PhysicalExpr, schema: Optional[Schema] = None
              ) -> PhysicalExpr:
    """Fold THIS node if it is a pure expression over Literal children.
    The plan decoder calls it on each decoded node, children first, so
    one bottom-up pass falls out."""
    if not isinstance(e, _FOLDABLE):
        return e
    children = e.children()
    if not children or not all(isinstance(c, Literal) for c in children):
        return e
    try:
        dtype = e.data_type(schema if schema is not None else _EMPTY_SCHEMA)
        if dtype.id == TypeId.DECIMAL or \
                any(c.dtype.id == TypeId.DECIMAL for c in children):
            # a decimal value round-trips through scale-sensitive forms:
            # not worth folding
            return e
        return Literal(_scalar_of(e.evaluate(_probe_batch())), dtype)
    except Exception:
        return e


def fold_constants(e: PhysicalExpr, schema: Optional[Schema] = None
                   ) -> PhysicalExpr:
    """Recursive bottom-up fold (the direct entry; the plan decoder gets
    the same through `fold_node` at each level)."""
    if e.children():
        try:
            e = map_exprs(e, lambda c: fold_constants(c, schema))
        except TypeError:
            return e
    return fold_node(e, schema)
