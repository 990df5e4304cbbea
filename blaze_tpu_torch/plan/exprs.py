"""Expression decoding: IR dicts -> PhysicalExpr trees (port of
blaze_tpu/plan/exprs.py).

Kinds: column, literal, binary, is_null, is_not_null, not, case, if,
coalesce, in_list, cast, try_cast, like, rlike, string_starts_with,
string_ends_with, string_contains, scalar_function, named_struct,
get_indexed_field, get_map_value, row_num, spark_partition_id,
monotonically_increasing_id, rand, randn, bloom_filter_might_contain
and scalar_subquery.  `udf` raises NotImplementedError naming ROADMAP
item 16.

Each decoded node is constant-folded when every child is a Literal
(exprs/fold.py; always, where the JAX package has a key to turn it off);
children decode through the same entry, so the fold runs bottom-up across
the tree, as in the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from blaze_tpu_torch.exprs import (BinaryExpr, BloomFilterMightContain,
                                   BoundReference, CaseWhen,
                                   Cast, Coalesce, GetIndexedField,
                                   GetMapValue, If, InList, IsNotNull,
                                   IsNull, Like, Literal,
                                   MonotonicallyIncreasingId, NamedStruct,
                                   Not, PhysicalExpr, RLike, Rand, RowNum,
                                   ScalarSubqueryWrapper, SparkPartitionId,
                                   StringPredicate, TryCast)
from blaze_tpu_torch.plan.types import type_from_dict
from blaze_tpu_torch.schema import Schema


_UNARY = {"is_null": IsNull, "is_not_null": IsNotNull, "not": Not}
_NULLARY = {"row_num": RowNum, "spark_partition_id": SparkPartitionId,
            "monotonically_increasing_id": MonotonicallyIncreasingId}
#: decoded kinds whose expression waits for a later item
_LATER = {"udf": "item 16 (the host UDF bridge)"}


def expr_from_dict(d: Dict[str, Any], schema: Optional[Schema] = None
                   ) -> PhysicalExpr:
    """Decode one expression node and its children, then fold it if every
    child is a Literal."""
    from blaze_tpu_torch.exprs.fold import fold_node
    return fold_node(_expr_from_dict(d, schema), schema)


def _expr_from_dict(d: Dict[str, Any], schema: Optional[Schema] = None
                    ) -> PhysicalExpr:
    k = d["kind"]

    def sub(x):
        return expr_from_dict(x, schema)

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
        return BinaryExpr(d["op"], sub(d["l"]), sub(d["r"]))
    if k in _UNARY:
        return _UNARY[k](sub(d["child"]))
    if k in _NULLARY:
        return _NULLARY[k]()
    if k == "case":
        branches = tuple((sub(w), sub(t)) for w, t in d["branches"])
        other = sub(d["else"]) if d.get("else") is not None else None
        return CaseWhen(branches, other)
    if k == "if":
        return If(sub(d["cond"]), sub(d["then"]), sub(d["else"]))
    if k == "coalesce":
        return Coalesce(tuple(sub(a) for a in d["args"]))
    if k == "in_list":
        return InList(sub(d["child"]), tuple(d["values"]),
                      d.get("negated", False))
    if k in ("cast", "try_cast"):
        cls = Cast if k == "cast" else TryCast
        return cls(sub(d["child"]), type_from_dict(d["type"]))
    if k == "like":
        return Like(sub(d["child"]), d["pattern"], d.get("negated", False),
                    d.get("case_insensitive", False))
    if k == "rlike":
        return RLike(sub(d["child"]), d["pattern"],
                     d.get("case_insensitive", False))
    if k in ("string_starts_with", "string_ends_with", "string_contains"):
        return StringPredicate(k.replace("string_", ""), sub(d["child"]),
                               d["pattern"])
    if k == "scalar_function":
        from blaze_tpu_torch.funcs import ScalarFunctionExpr
        out_t = (type_from_dict(d["return_type"])
                 if d.get("return_type") else None)
        return ScalarFunctionExpr(
            d["name"], tuple(sub(a) for a in d.get("args", ())), out_t)
    if k == "named_struct":
        return NamedStruct(tuple(d["names"]),
                           tuple(sub(a) for a in d["args"]))
    if k == "get_indexed_field":
        return GetIndexedField(sub(d["child"]), d["index"],
                               type_from_dict(d["type"]))
    if k == "get_map_value":
        return GetMapValue(sub(d["child"]), d["key"],
                           type_from_dict(d["type"]))
    if k in ("rand", "randn"):
        return Rand(d.get("seed", 0), normal=(k == "randn"))
    if k == "scalar_subquery":
        return ScalarSubqueryWrapper(d["uuid"], type_from_dict(d["type"]))
    if k == "bloom_filter_might_contain":
        return BloomFilterMightContain(d["uuid"], sub(d["value"]))
    if k in _LATER:
        raise NotImplementedError(
            f"expression kind {k!r} belongs to a later slice of the PyTorch "
            f"port (ROADMAP Queue 1 {_LATER[k]})")
    raise ValueError(f"unknown expression kind {k!r}")


def sort_spec_from_dict(d: Dict[str, Any], schema: Optional[Schema] = None):
    """{expr, descending, nulls_first} -> a SortExec spec tuple (nulls
    first by default on ASC, last on DESC)."""
    return (expr_from_dict(d["expr"], schema),
            bool(d.get("descending", False)),
            bool(d.get("nulls_first", not d.get("descending", False))))
