"""Expression decoding: IR dicts -> PhysicalExpr trees (port of the part of
blaze_tpu/plan/exprs.py the port uses: column, literal, binary, the
conditional kinds is_null, is_not_null, not, case, if, coalesce and
in_list, cast and try_cast, and sort specs).

Constant folding of all-literal subtrees (the JAX package's exprs/fold.py)
is not carried over: it changes no result, and this slice's filters
compare columns with literals.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from blaze_tpu_torch.exprs import (BinaryExpr, BoundReference, CaseWhen,
                                   Cast, Coalesce, If, InList, IsNotNull,
                                   IsNull, Literal, Not, PhysicalExpr,
                                   TryCast)
from blaze_tpu_torch.plan.types import type_from_dict
from blaze_tpu_torch.schema import Schema


_UNARY = {"is_null": IsNull, "is_not_null": IsNotNull, "not": Not}


def expr_from_dict(d: Dict[str, Any], schema: Optional[Schema] = None
                   ) -> PhysicalExpr:
    """Decode one expression node and its children."""
    k = d["kind"]
    if k == "column":
        idx = d.get("index")
        if idx is None:
            if schema is None:
                raise ValueError("named column ref requires an input schema")
            idx = schema.index_of(d["name"])
        return BoundReference(idx, d.get("name", ""))
    if k == "literal":
        return Literal(d.get("value"), type_from_dict(d["type"]))
    if k == "binary":
        return BinaryExpr(d["op"], expr_from_dict(d["l"], schema),
                          expr_from_dict(d["r"], schema))
    if k in _UNARY:
        return _UNARY[k](expr_from_dict(d["child"], schema))
    if k == "case":
        branches = tuple((expr_from_dict(w, schema),
                          expr_from_dict(t, schema))
                         for w, t in d["branches"])
        other = (expr_from_dict(d["else"], schema)
                 if d.get("else") is not None else None)
        return CaseWhen(branches, other)
    if k == "if":
        return If(expr_from_dict(d["cond"], schema),
                  expr_from_dict(d["then"], schema),
                  expr_from_dict(d["else"], schema))
    if k == "coalesce":
        return Coalesce(tuple(expr_from_dict(a, schema) for a in d["args"]))
    if k == "in_list":
        return InList(expr_from_dict(d["child"], schema),
                      tuple(d["values"]), d.get("negated", False))
    if k in ("cast", "try_cast"):
        cls = Cast if k == "cast" else TryCast
        return cls(expr_from_dict(d["child"], schema),
                   type_from_dict(d["type"]))
    raise NotImplementedError(
        f"expression kind {k!r} belongs to a later slice of the PyTorch port "
        f"(ROADMAP Queue 1 item 13 for the string and scalar functions); "
        f"this slice decodes column, literal, binary, is_null, is_not_null, "
        f"not, case, if, coalesce, in_list, cast and try_cast")


def sort_spec_from_dict(d: Dict[str, Any], schema: Optional[Schema] = None):
    """{expr, descending, nulls_first} -> a SortExec spec tuple (nulls
    first by default on ASC, last on DESC)."""
    return (expr_from_dict(d["expr"], schema),
            bool(d.get("descending", False)),
            bool(d.get("nulls_first", not d.get("descending", False))))
