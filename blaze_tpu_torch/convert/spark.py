"""Spark physical-plan -> engine-IR converter (the PyTorch port's copy of
blaze_tpu/convert/spark.py).

The same pure function of the JSON as the JAX package's: for the same
plan and the same `auron.*` keys it returns the same plan-IR dict, the
same converted-class log and the same wrapped UDFs, and raises the same
`ConversionError` (node class and reason).  Two departures, neither in
the dict: the JAX package's Auron UI records (`bridge/ui.py`,
`record_conversion`) are left out (ROADMAP item 16), and `query_id` comes
from a per-process counter here.  An expression wrapped as a host UDF
(`kind: udf`) converts exactly as there but runs only in a later slice
(ROADMAP Queue 1 item 16): the port raises NotImplementedError where it
would run it.

Parity: the JVM translation layer —
  AuronConvertStrategy.apply     (AuronConvertStrategy.scala:49: per-node
                                  convertible tagging + per-op enable
                                  gates + neverConvertReason)
  AuronConverters.convertSparkPlanRecursively (AuronConverters.scala:189:
                                  the ~20-exec-class dispatch)
  NativeConverters.convertExpr   (NativeConverters.scala:329: Catalyst
                                  expression translation)

Input: Spark's `TreeNode.toJSON` rendering of an executed physical plan —
a pre-order JSON array of node objects, each `{"class": fqcn,
"num-children": n, ...fields}`, where expression-valued fields are nested
arrays in the same format.  This is what
`df._jdf.queryExecution().executedPlan().toJSON()` emits, so a thin JVM
shim can hand plans to this converter without any Scala translation code.

The essential Catalyst semantic preserved here is exprId-based attribute
binding: columns resolve by `exprId.id` against the child's output
attributes — NOT by name, which Spark allows to collide.  Each converted
node therefore tracks its output attribute ids, exactly like
`NativeSupports` nodes track `output: Seq[Attribute]`.

One divergence is unavoidable: `FileSourceScanExec.relation` (the
HadoopFsRelation with the file listing) does not serialize into toJSON;
the shim must attach the selected files as a `"files"` field (list of
file groups).  Everything else is consumed in Spark's own vocabulary.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from blaze_tpu_torch import config


class ConversionError(ValueError):
    """A subtree cannot convert; carries the neverConvertReason tag."""

    def __init__(self, node_class: str, reason: str):
        super().__init__(f"{node_class}: {reason}")
        self.node_class = node_class
        self.reason = reason


@dataclass
class ConversionResult:
    plan: Dict[str, Any]            # engine plan-IR dict
    output_ids: List[int]           # exprIds of the root's output attrs
    output_names: List[str]
    converted_nodes: List[str] = field(default_factory=list)
    # expressions wrapped by the UDF fallback: the driver registers a
    # host evaluator under `udf://<name>` for each BEFORE executing
    # (the SparkAuronUDFWrapperContext registration step)
    wrapped_udfs: List[Dict[str, str]] = field(default_factory=list)
    # the conversion's id in this process (the JAX package's Auron-tab
    # correlation handle, without its UI records)
    query_id: str = ""


import itertools as _itertools
import threading as _threading

_wrap_ctx = _threading.local()
_query_ids = _itertools.count(1)
_query_ids_lock = _threading.Lock()


def next_query_id() -> str:
    """A fresh conversion id of this process: q1, q2, ..."""
    with _query_ids_lock:
        return f"q{next(_query_ids)}"


# ---------------------------------------------------------------------------
# TreeNode JSON decoding: pre-order array + num-children -> tree
# ---------------------------------------------------------------------------

def _build_tree(nodes: List[dict], pos: int = 0) -> Tuple[dict, int]:
    node = dict(nodes[pos])
    n = int(node.get("num-children", 0))
    children = []
    pos += 1
    for _ in range(n):
        child, pos = _build_tree(nodes, pos)
        children.append(child)
    node["__children"] = children
    return node, pos


def _tree(obj) -> dict:
    if isinstance(obj, str):
        import json
        obj = json.loads(obj)
    if isinstance(obj, list):
        root, consumed = _build_tree(obj, 0)
        return root
    raise ConversionError("<root>", "expected a TreeNode JSON array")


def _cls(node: dict) -> str:
    return node.get("class", "").rsplit(".", 1)[-1]


def _expr_tree(value) -> Optional[dict]:
    """Expression-valued fields are nested TreeNode arrays."""
    if value is None:
        return None
    if isinstance(value, list):
        if not value:
            return None
        inner = value[0] if isinstance(value[0], list) else value
        root, _ = _build_tree(inner, 0)
        return root
    if isinstance(value, dict):
        return value
    raise ConversionError("<expr>", f"unexpected expression field {value!r}")


def _expr_list(value) -> List[dict]:
    """Fields holding Seq[Expression] serialize as a list of nested
    arrays (one per expression)."""
    if value is None:
        return []
    out = []
    for item in value:
        t = _expr_tree(item if isinstance(item, list) else [item])
        if t is not None:
            out.append(t)
    return out


# ---------------------------------------------------------------------------
# Catalyst data types -> engine type dicts
# ---------------------------------------------------------------------------

_SIMPLE_TYPES = {
    "boolean": "bool", "byte": "int8", "short": "int16",
    "integer": "int32", "long": "int64", "float": "float32",
    "double": "float64", "string": "utf8", "binary": "binary",
    "date": "date32", "timestamp": "timestamp_us", "null": "null",
}
_DECIMAL_RE = re.compile(r"decimal\((\d+),\s*(-?\d+)\)")


def _type_from_catalyst(t) -> Dict[str, Any]:
    if isinstance(t, str):
        if t in _SIMPLE_TYPES:
            return {"id": _SIMPLE_TYPES[t]}
        m = _DECIMAL_RE.fullmatch(t)
        if m:
            return {"id": "decimal", "precision": int(m.group(1)),
                    "scale": int(m.group(2))}
        raise ConversionError("<type>", f"unsupported data type {t!r}")
    if isinstance(t, dict):
        kind = t.get("type")
        if kind == "struct":
            return {"id": "struct", "children": [
                {"name": f["name"],
                 "type": _type_from_catalyst(f["type"]),
                 "nullable": f.get("nullable", True)}
                for f in t.get("fields", [])]}
        if kind == "array":
            return {"id": "list", "children": [
                {"name": "item",
                 "type": _type_from_catalyst(t["elementType"]),
                 "nullable": t.get("containsNull", True)}]}
        if kind == "map":
            return {"id": "map", "children": [
                {"name": "key", "type": _type_from_catalyst(t["keyType"]),
                 "nullable": False},
                {"name": "value",
                 "type": _type_from_catalyst(t["valueType"]),
                 "nullable": t.get("valueContainsNull", True)}]}
        if kind == "udt":
            raise ConversionError("<type>", "UDTs are not convertible")
    raise ConversionError("<type>", f"unsupported data type {t!r}")


def _expr_id(node: dict) -> int:
    e = node.get("exprId") or {}
    return int(e.get("id", -1))


# ---------------------------------------------------------------------------
# Attribute scope: exprId -> column index (the Catalyst binding rule)
# ---------------------------------------------------------------------------

class Scope:
    def __init__(self, ids: List[int], names: List[str]):
        self.ids = list(ids)
        self.names = list(names)
        self._index = {i: pos for pos, i in enumerate(ids)}

    def bind(self, expr_id: int, name: str) -> Dict[str, Any]:
        pos = self._index.get(expr_id)
        if pos is None:
            raise ConversionError(
                "AttributeReference",
                f"exprId {expr_id} ({name!r}) not found in child output "
                f"{list(zip(self.ids, self.names))}")
        return {"kind": "column", "index": pos}

    @staticmethod
    def concat(a: "Scope", b: "Scope") -> "Scope":
        return Scope(a.ids + b.ids, a.names + b.names)


# ---------------------------------------------------------------------------
# Expressions (NativeConverters.convertExpr, :329)
# ---------------------------------------------------------------------------

_BINARY_OPS = {
    "And": "and", "Or": "or", "EqualTo": "==", "EqualNullSafe": "<=>",
    "LessThan": "<", "LessThanOrEqual": "<=", "GreaterThan": ">",
    "GreaterThanOrEqual": ">=", "Add": "+", "Subtract": "-",
    "Multiply": "*", "Divide": "/", "Remainder": "%", "Pmod": "pmod",
}

# Catalyst expression class -> engine scalar_function name
_SCALAR_FNS = {
    "Upper": "upper", "Lower": "lower", "Length": "length",
    "Abs": "abs", "Ceil": "ceil", "Floor": "floor", "Round": "round",
    "Sqrt": "sqrt", "Exp": "exp", "Concat": "concat",
    "Year": "year", "Month": "month", "DayOfMonth": "dayofmonth",
    "Hour": "hour", "Minute": "minute", "Second": "second",
    "Substring": "substring", "Trim": "trim", "StringTrim": "trim",
    "Md5": "md5", "Signum": "signum",
    # string family (Catalyst child order == engine arg order for all
    # entries below; order-mismatched classes like TruncTimestamp stay
    # on the UDF-wrap fallback)
    "InitCap": "initcap", "StringLPad": "lpad", "StringRPad": "rpad",
    "StringTrimLeft": "ltrim", "StringTrimRight": "rtrim",
    "StringRepeat": "repeat",
    "StringSpace": "space", "Chr": "chr", "Ascii": "ascii",
    "StringReplace": "replace",
    "StringTranslate": "translate", "SubstringIndex": "substring_index",
    "StringLocate": "locate", "StringInstr": "instr",
    "GetJsonObject": "get_json_object",
    # NOT mapped (the UDF-wrap fallback keeps Spark semantics the engine
    # kernels narrow): RegExpReplace (Java $1 group refs + pos arg),
    # Reverse/ConcatWs (array inputs), Greatest/Least (non-fixed-width
    # types reach device-only kernels), TruncTimestamp (reversed args)
    # math family
    "Log": "ln", "Log10": "log10", "Log2": "log2", "Log1p": "log1p",
    "Expm1": "expm1", "Pow": "pow", "Cbrt": "cbrt",
    "Sin": "sin", "Cos": "cos", "Tan": "tan", "Asin": "asin",
    "Acos": "acos", "Atan": "atan", "Atan2": "atan2", "Sinh": "sinh",
    "Cosh": "cosh", "Tanh": "tanh", "ToDegrees": "degrees",
    "ToRadians": "radians", "IsNaN": "isnan", "NaNvl": "nanvl",
    # date family
    "DateAdd": "date_add", "DateSub": "date_sub",
    "DateDiff": "datediff", "LastDay": "last_day",
    "NextDay": "next_day", "AddMonths": "add_months",
    "Quarter": "quarter", "WeekOfYear": "weekofyear",
    "DayOfWeek": "dayofweek", "WeekDay": "weekday",
    "DayOfYear": "dayofyear", "TruncDate": "trunc",
    # crypto
    "Sha1": "sha1", "Sha2": "sha2", "Crc32": "crc32",
    # collections
    "ArrayContains": "array_contains", "ArrayDistinct": "array_distinct",
    "ArrayMax": "array_max", "ArrayMin": "array_min",
    "ArrayJoin": "array_join", "ArrayUnion": "array_union",
    "Size": "size", "ElementAt": "element_at",
    "MapKeys": "map_keys", "MapValues": "map_values",
}


# engine kernels that require CONSTANT trailing arguments (const_arg
# raises at evaluate time otherwise): a non-literal child must fall back
# to the UDF wrapper at CONVERT time, where the fallback still exists
_LITERAL_ONLY_TAIL = {
    "StringTranslate": (1, 2), "StringReplace": (1, 2),
    "StringTrim": (1,), "StringTrimLeft": (1,), "StringTrimRight": (1,),
    "SubstringIndex": (1,), "GetJsonObject": (1,),
}


def _require_literal_args(cls_name: str, children) -> None:
    for i in _LITERAL_ONLY_TAIL.get(cls_name, ()):
        if i < len(children) and _cls(children[i]) != "Literal":
            raise ConversionError(
                cls_name, f"argument {i} must be a literal for the "
                          f"native kernel (UDF fallback handles the rest)")


def convert_expr(node: dict, scope: Scope) -> Dict[str, Any]:
    c = _cls(node)
    ch = node["__children"]

    if c == "AttributeReference":
        return scope.bind(_expr_id(node), node.get("name", ""))
    if c == "Literal":
        t = _type_from_catalyst(node.get("dataType"))
        return {"kind": "literal",
                "value": _parse_literal(node.get("value"), t), "type": t}
    if c == "Alias":
        return convert_expr(ch[0], scope)
    if c in _BINARY_OPS:
        return {"kind": "binary", "op": _BINARY_OPS[c],
                "l": convert_expr(ch[0], scope),
                "r": convert_expr(ch[1], scope)}
    if c == "Not":
        inner = ch[0]
        return {"kind": "not", "child": convert_expr(inner, scope)}
    if c == "IsNull":
        return {"kind": "is_null", "child": convert_expr(ch[0], scope)}
    if c == "IsNotNull":
        return {"kind": "is_not_null",
                "child": convert_expr(ch[0], scope)}
    if c in ("Cast", "AnsiCast"):
        return {"kind": "cast", "child": convert_expr(ch[0], scope),
                "type": _type_from_catalyst(node.get("dataType"))}
    if c == "TryCast":
        return {"kind": "try_cast", "child": convert_expr(ch[0], scope),
                "type": _type_from_catalyst(node.get("dataType"))}
    if c == "In":
        values = []
        for v in ch[1:]:
            if _cls(v) != "Literal":
                raise ConversionError("In", "non-literal IN list")
            t = _type_from_catalyst(v.get("dataType"))
            values.append(_parse_literal(v.get("value"), t))
        return {"kind": "in_list", "child": convert_expr(ch[0], scope),
                "values": values, "negated": False}
    if c == "CaseWhen":
        # children = [w1, t1, w2, t2, ..., else?]
        branches = []
        pairs = ch if len(ch) % 2 == 0 else ch[:-1]
        for i in range(0, len(pairs), 2):
            branches.append([convert_expr(pairs[i], scope),
                             convert_expr(pairs[i + 1], scope)])
        out: Dict[str, Any] = {"kind": "case", "branches": branches}
        if len(ch) % 2 == 1:
            out["else"] = convert_expr(ch[-1], scope)
        return out
    if c == "If":
        return {"kind": "if", "cond": convert_expr(ch[0], scope),
                "then": convert_expr(ch[1], scope),
                "else": convert_expr(ch[2], scope)}
    if c == "Coalesce":
        return {"kind": "coalesce",
                "args": [convert_expr(a, scope) for a in ch]}
    if c == "Like":
        if _cls(ch[1]) != "Literal":
            raise ConversionError("Like", "non-literal pattern")
        return {"kind": "like", "child": convert_expr(ch[0], scope),
                "pattern": ch[1].get("value"), "negated": False,
                "case_insensitive": False}
    if c == "RLike":
        return {"kind": "rlike", "child": convert_expr(ch[0], scope),
                "pattern": ch[1].get("value"),
                "case_insensitive": False}
    if c == "StartsWith":
        return {"kind": "string_starts_with",
                "child": convert_expr(ch[0], scope),
                "pattern": ch[1].get("value")}
    if c == "EndsWith":
        return {"kind": "string_ends_with",
                "child": convert_expr(ch[0], scope),
                "pattern": ch[1].get("value")}
    if c == "Contains":
        return {"kind": "string_contains",
                "child": convert_expr(ch[0], scope),
                "pattern": ch[1].get("value")}
    if c in _SCALAR_FNS:
        _require_literal_args(c, ch)
        return {"kind": "scalar_function", "name": _SCALAR_FNS[c],
                "args": [convert_expr(a, scope) for a in ch]}
    if c in ("HiveSimpleUDF", "HiveGenericUDF"):
        # HiveUDFUtil.getFunctionClassName analog: map the well-known
        # Hive UDF classes to native kernels (NativeConverters.scala:
        # 1212-1237 udfJson / brickhouse cases); anything else raises so
        # convert_expr_with_fallback wraps it as a host-evaluated UDF —
        # exactly the reference's fallback(e) tail
        fcls = _hive_function_class(node)
        if (config.UDF_JSON_ENABLED.get() and fcls
                and "hive.ql.udf.UDFJson" in fcls and len(ch) == 2
                and _cls(ch[1]) == "Literal"):
            return {"kind": "scalar_function", "name": "get_json_object",
                    "args": [convert_expr(a, scope) for a in ch],
                    "return_type": {"id": "utf8"}}
        if (config.UDF_BRICKHOUSE_ENABLED.get() and fcls
                and "brickhouse.udf.collect.ArrayUnionUDF" in fcls
                and len(ch) == 2):  # the native kernel is binary;
            # variadic brickhouse calls take the UDF-wrap fallback
            return {"kind": "scalar_function", "name": "array_union",
                    "args": [convert_expr(a, scope) for a in ch]}
        raise ConversionError(
            c, f"hive UDF {fcls or node.get('name')!r} has no native "
               f"kernel (the UDF-wrap fallback hosts it)")
    raise ConversionError(c, "unsupported expression "
                             "(the reference wraps these in "
                             "SparkUDFWrapper; register a udf:// "
                             "resource and use kind=udf)")


def _hive_function_class(node: dict) -> Optional[str]:
    """Extract functionClassName from a serialized Hive UDF expression.
    Catalyst's toJSON renders funcWrapper either as a nested object or
    as its string form depending on Spark version — accept both
    (HiveUDFUtil.scala:37-44)."""
    fw = node.get("funcWrapper")
    if isinstance(fw, dict):
        return fw.get("functionClassName")
    if isinstance(fw, str):
        m = re.search(r"functionClassName[=:]\s*([\w.$]+)", fw)
        if m:
            return m.group(1)
    name = node.get("name")
    return name if isinstance(name, str) and "." in name else None


def _unparse(node: dict) -> dict:
    """Tree back to plain JSON (children nested) — the `serialized`
    payload a host-side evaluator receives for wrapped expressions."""
    out = {k: v for k, v in node.items() if k != "__children"}
    out["children"] = [_unparse(c) for c in node["__children"]]
    return out


def _collect_attrs(node: dict, out: List[dict]) -> None:
    if _cls(node) == "AttributeReference":
        if _expr_id(node) not in {_expr_id(a) for a in out}:
            out.append(node)
        return
    for c in node["__children"]:
        _collect_attrs(c, out)


def convert_expr_with_fallback(node: dict, scope: Scope) -> Dict[str, Any]:
    """convertExprWithFallback (NativeConverters.scala:399): when any part
    of an expression fails to convert, the WHOLE subtree wraps into one
    host-evaluated UDF whose params are the attribute references the
    subtree reads (the SparkUDFWrapper contract: the host evaluates the
    serialized expression from column inputs — natively-supported
    ancestors are not wrapped separately and no nesting occurs).
    Execution requires the host to register the evaluator under
    `udf://<name>` (bridge/host_callbacks.py)."""
    if _cls(node) == "Alias":  # transparent: wrap the aliased child
        return convert_expr_with_fallback(node["__children"][0], scope)
    try:
        return convert_expr(node, scope)
    except ConversionError as err:
        if not config.UDF_FALLBACK_ENABLE.get():
            raise
        c = _cls(node)
        dt = node.get("dataType")
        if dt is None:
            raise ConversionError(
                c, f"cannot wrap (no dataType); inner: {err.reason}")
        import hashlib
        import json as _json
        attrs: List[dict] = []
        _collect_attrs(node, attrs)
        payload = {"expr": _unparse(node),
                   "params": [{"id": _expr_id(a),
                               "name": a.get("name", "")}
                              for a in attrs]}
        serialized = _json.dumps(payload, sort_keys=True, default=str)
        digest = hashlib.sha256(serialized.encode()).hexdigest()[:10]
        args = [scope.bind(_expr_id(a), a.get("name", ""))
                for a in attrs]
        name = f"spark:{c}#{digest}"
        sink = getattr(_wrap_ctx, "items", None)
        if sink is not None:
            sink.append({"name": name, "class": c,
                         "serialized": serialized})
        return {"kind": "udf", "name": name,
                "args": args, "type": _type_from_catalyst(dt),
                "serialized": serialized}


def _parse_partition_value(v, t: Dict[str, Any], node_cls: str):
    """Metastore partition strings -> typed constants: the Hive null
    sentinel becomes NULL, DATE partitions parse 'yyyy-MM-dd' (the
    int() coercion in _parse_literal would throw), and anything
    malformed raises ConversionError instead of a raw ValueError."""
    if v is None or v == "__HIVE_DEFAULT_PARTITION__":
        return None
    try:
        if t.get("id") == "date32" and isinstance(v, str):
            import datetime as _dt
            return _dt.date.fromisoformat(v)
        return _parse_literal(v, t)
    except (ValueError, TypeError) as e:
        raise ConversionError(
            node_cls, f"partition value {v!r} does not coerce to "
                      f"{t.get('id')}: {e}")


def _parse_literal(v, t: Dict[str, Any]):
    """toJSON renders literal values as strings; coerce to the type."""
    if v is None:
        return None
    tid = t["id"]
    if tid in ("int8", "int16", "int32", "int64", "date32"):
        return int(v)
    if tid in ("float32", "float64"):
        return float(v)
    if tid == "bool":
        return v if isinstance(v, bool) else str(v).lower() == "true"
    return v


def _sort_specs(order_nodes: List[dict], scope: Scope) -> List[dict]:
    out = []
    for so in order_nodes:
        if _cls(so) != "SortOrder":
            raise ConversionError(_cls(so), "expected SortOrder")
        desc = "Descending" in str(so.get("direction", ""))
        null_order = str(so.get("nullOrdering", ""))
        nulls_first = ("NullsFirst" in null_order if null_order
                       else not desc)
        out.append({"expr": convert_expr(so["__children"][0], scope),
                    "descending": desc, "nulls_first": nulls_first})
    return out


def _attrs_of(exprs: List[dict]) -> Tuple[List[int], List[str]]:
    ids, names = [], []
    for e in exprs:
        ids.append(_expr_id(e))
        names.append(e.get("name", f"col{len(names)}"))
    return ids, names


def _gate(op: str, node_class: str) -> None:
    if not config.operator_enabled(op):
        raise ConversionError(node_class,
                              f"disabled by auron.enable.{op}")


# ---------------------------------------------------------------------------
# Plan nodes (AuronConverters.scala:212-271 dispatch)
# ---------------------------------------------------------------------------

def convert_spark_plan(plan_json, num_partitions: int = 1
                       ) -> ConversionResult:
    if not config.ENABLED.get():
        raise ConversionError("<plan>", "disabled by auron.enabled")
    root = _tree(plan_json)
    converted: List[str] = []
    _wrap_ctx.items = []
    try:
        plan, scope = _convert_node(root, num_partitions, converted)
        return ConversionResult(plan, scope.ids, scope.names, converted,
                                wrapped_udfs=list(_wrap_ctx.items),
                                query_id=next_query_id())
    finally:
        _wrap_ctx.items = None


def _convert_node(node: dict, parts: int, log: List[str]
                  ) -> Tuple[Dict[str, Any], Scope]:
    c = _cls(node)
    ch = node["__children"]
    log.append(c)

    # transparent wrappers Spark inserts around stages
    if c in ("InputAdapter", "WholeStageCodegenExec", "AQEShuffleReadExec",
             "ShuffleQueryStageExec", "ColumnarToRowExec",
             "RowToColumnarExec", "AdaptiveSparkPlanExec"):
        return _convert_node(ch[0], parts, log)

    if c == "FileSourceScanExec":
        _gate("scan", c)
        _gate("scan.parquet", c)
        out_attrs = _expr_list(node.get("output"))
        ids, names = _attrs_of(out_attrs)
        fields = []
        for a in out_attrs:
            fields.append({"name": a.get("name"),
                           "type": _type_from_catalyst(a.get("dataType")),
                           "nullable": a.get("nullable", True)})
        files = node.get("files")
        if not files:
            raise ConversionError(
                c, "HadoopFsRelation does not serialize; the shim must "
                   "attach the selected file groups as a 'files' field")
        return ({"kind": "parquet_scan",
                 "schema": {"fields": fields},
                 "file_groups": files},
                Scope(ids, names))

    if c == "HiveTableScanExec":
        # NativeHiveTableScanBase analog (spark-extension hive/...
        # NativeHiveTableScanBase.scala:23-105): the Hive relation's
        # storage descriptor does not serialize, so the shim attaches the
        # resolved file groups, storage format, and the partition
        # schema + per-file partition values; the scan converts to the
        # same native parquet/orc scan as FileSourceScanExec with the
        # partition columns appended as per-file constants
        _gate("scan", c)
        fmt = (node.get("format") or "parquet").lower()
        _gate(f"scan.{fmt}", c)
        out_attrs = _expr_list(node.get("requestedAttributes")
                               or node.get("output"))
        ids, names = _attrs_of(out_attrs)
        part_fields = node.get("partition_schema") or []
        part_names = {f["name"] for f in part_fields}
        fields = []
        for a in out_attrs:
            if a.get("name") in part_names:
                continue  # partition columns are not file columns
            fields.append({"name": a.get("name"),
                           "type": _type_from_catalyst(a.get("dataType")),
                           "nullable": True})
        files = node.get("files")
        if not files:
            raise ConversionError(
                c, "HiveTableRelation does not serialize; the shim must "
                   "attach the selected file groups as a 'files' field")
        d = {"kind": "orc_scan" if fmt == "orc" else "parquet_scan",
             "schema": {"fields": fields},
             "file_groups": files,
             "projection": [a.get("name") for a in out_attrs]}
        if part_fields:
            pv = node.get("partition_values")
            if not pv:
                # silent NULL partition columns would be wrong results;
                # symmetric with the missing-'files' check above
                raise ConversionError(
                    c, "partition_schema without partition_values; the "
                       "shim must attach per-file partition values")
            # Hive metastore partition values arrive as STRINGS; coerce
            # against the partition schema like NativeHiveTableScanBase
            # casts them (Literal(file.partitionValues.get(i, dataType)))
            types = [f["type"] for f in part_fields]
            coerced = [[[_parse_partition_value(v, t, c)
                         for v, t in zip(fvals, types)]
                        for fvals in group] for group in pv]
            d["partition_schema"] = {"fields": part_fields}
            d["partition_values"] = coerced
        return (d, Scope(ids, names))

    if c == "ProjectExec":
        _gate("project", c)
        child, scope = _convert_node(ch[0], parts, log)
        exprs = _expr_list(node.get("projectList"))
        ids, names = _attrs_of(exprs)
        return ({"kind": "project", "input": child,
                 "exprs": [convert_expr_with_fallback(e, scope)
                           for e in exprs],
                 "names": names},
                Scope(ids, names))

    if c == "FilterExec":
        _gate("filter", c)
        child, scope = _convert_node(ch[0], parts, log)
        cond = _expr_tree(node.get("condition"))
        return ({"kind": "filter", "input": child,
                 "predicates": [convert_expr_with_fallback(cond, scope)]},
                scope)

    if c == "SortExec":
        _gate("sort", c)
        child, scope = _convert_node(ch[0], parts, log)
        specs = _sort_specs(_expr_list(node.get("sortOrder")), scope)
        return ({"kind": "sort", "input": child, "specs": specs}, scope)

    if c in ("GlobalLimitExec", "LocalLimitExec"):
        _gate("global.limit" if c.startswith("Global") else "local.limit",
              c)
        child, scope = _convert_node(ch[0], parts, log)
        return ({"kind": "limit", "input": child,
                 "limit": int(node.get("limit", 0)),
                 "offset": int(node.get("offset", 0) or 0)}, scope)

    if c == "TakeOrderedAndProjectExec":
        _gate("take.ordered.and.project", c)
        child, scope = _convert_node(ch[0], parts, log)
        specs = _sort_specs(_expr_list(node.get("sortOrder")), scope)
        limit = int(node.get("limit", 0))
        sorted_d = {"kind": "sort",
                    "input": {"kind": "local_exchange",
                              "partitioning": {"kind": "single"},
                              "input": child},
                    "specs": specs, "fetch": limit}
        limited = {"kind": "limit", "input": sorted_d, "limit": limit}
        exprs = _expr_list(node.get("projectList"))
        ids, names = _attrs_of(exprs)
        return ({"kind": "project", "input": limited,
                 "exprs": [convert_expr(e, scope) for e in exprs],
                 "names": names},
                Scope(ids, names))

    if c == "UnionExec":
        _gate("union", c)
        inputs, scopes = [], []
        for sub in ch:
            p, s = _convert_node(sub, parts, log)
            inputs.append(p)
            scopes.append(s)
        return ({"kind": "union", "inputs": inputs}, scopes[0])

    if c == "ShuffleExchangeExec":
        _gate("shuffleExchange", c)
        child, scope = _convert_node(ch[0], parts, log)
        part = _partitioning(node.get("outputPartitioning"), scope, parts)
        return ({"kind": "local_exchange", "partitioning": part,
                 "input": child}, scope)

    if c == "BroadcastExchangeExec":
        _gate("broadcastExchange", c)
        # the broadcast boundary disappears: the join's build side reads
        # the child directly and caches the built map by broadcast id
        return _convert_node(ch[0], parts, log)

    if c in ("SortMergeJoinExec", "ShuffledHashJoinExec",
             "BroadcastHashJoinExec"):
        return _convert_join(node, parts, log)

    if c == "BroadcastNestedLoopJoinExec":
        _gate("bnlj", c)
        left, lscope = _convert_node(ch[0], parts, log)
        right, rscope = _convert_node(ch[1], parts, log)
        import uuid
        jt = _parse_join_type(node, c)
        d: Dict[str, Any] = {"kind": "broadcast_nested_loop_join",
                             "left": left, "right": right,
                             "join_type": jt,
                             "build_side": _parse_build_side(node),
                             "broadcast_id":
                                 f"conv-{uuid.uuid4().hex[:10]}"}
        cond = _expr_tree(node.get("condition"))
        if cond is not None:
            d["join_filter"] = convert_expr(cond,
                                            Scope.concat(lscope, rscope))
        return d, _join_output_scope(jt, lscope, rscope)

    if c in ("HashAggregateExec", "ObjectHashAggregateExec",
             "SortAggregateExec"):
        return _convert_agg(node, parts, log)

    if c == "ExpandExec":
        _gate("expand", c)
        child, scope = _convert_node(ch[0], parts, log)
        out_attrs = _expr_list(node.get("output"))
        ids, names = _attrs_of(out_attrs)
        projections = []
        for proj in node.get("projections", []):
            exprs = _expr_list(proj)
            projections.append([convert_expr(e, scope) for e in exprs])
        return ({"kind": "expand", "input": child,
                 "projections": projections, "names": names},
                Scope(ids, names))

    if c == "WindowExec":
        _gate("window", c)
        return _convert_window(node, parts, log)

    if c == "WindowGroupLimitExec":
        _gate("window.group.limit", c)
        # the engine (and the proto WindowGroupLimit, auron.proto:600)
        # filter with RANK semantics: exact for Rank, a safe superset for
        # RowNumber (the downstream filter still applies) — but DenseRank
        # keeps rows rank-filtering would wrongly drop
        rank_fn = _expr_tree(node.get("rankLikeFunction"))
        if rank_fn is not None and _cls(rank_fn) == "DenseRank":
            raise ConversionError(
                c, "DenseRank group-limit has no rank-filter encoding")
        child, scope = _convert_node(ch[0], parts, log)
        order = _sort_specs(_expr_list(node.get("orderSpec")), scope)
        part_by = [convert_expr(e, scope)
                   for e in _expr_list(node.get("partitionSpec"))]
        # rank-filter only: no output column added (proto auron.proto:600
        # window_group_limit; engine: WindowExec(funcs=[], group_limit=k))
        return ({"kind": "window", "input": child, "functions": [],
                 "partition_by": part_by, "order_by": order,
                 "group_limit": int(node.get("limit", 0))}, scope)

    if c == "GenerateExec":
        _gate("generate", c)
        return _convert_generate(node, parts, log)

    raise ConversionError(c, "unsupported plan node")


_WINDOW_RANK_CLASSES = {
    "RowNumber": "row_number", "Rank": "rank", "DenseRank": "dense_rank",
    "PercentRank": "percent_rank", "CumeDist": "cume_dist",
}


def _convert_window(node: dict, parts: int, log: List[str]
                    ) -> Tuple[Dict[str, Any], Scope]:
    c = "WindowExec"
    ch = node["__children"]
    child, scope = _convert_node(ch[0], parts, log)
    part_by = [convert_expr(e, scope)
               for e in _expr_list(node.get("partitionSpec"))]
    order = _sort_specs(_expr_list(node.get("orderSpec")), scope)
    functions = []
    out_ids = list(scope.ids)
    out_names = list(scope.names)
    for we in _expr_list(node.get("windowExpression")):
        if _cls(we) != "Alias":
            raise ConversionError(_cls(we),
                                  "expected Alias(WindowExpression)")
        name = we.get("name", f"w{len(functions)}")
        wid = _expr_id(we)
        wex = we["__children"][0]
        if _cls(wex) != "WindowExpression":
            raise ConversionError(_cls(wex), "expected WindowExpression")
        fn = wex["__children"][0]
        fcls = _cls(fn)
        fch = fn["__children"]
        if fcls == "AggregateExpression" and len(wex["__children"]) > 1:
            # the engine's running aggregate implements the DEFAULT frame
            # (RANGE UNBOUNDED PRECEDING .. CURRENT ROW); any other frame
            # would convert silently into wrong values
            _check_default_frame(wex["__children"][1])
        if fcls in _WINDOW_RANK_CLASSES:
            functions.append({"kind": _WINDOW_RANK_CLASSES[fcls],
                              "name": name})
        elif fcls in ("Lead", "Lag"):
            d: Dict[str, Any] = {"kind": fcls.lower(), "name": name,
                                 "expr": convert_expr(fch[0], scope)}
            if len(fch) > 1 and _cls(fch[1]) == "Literal":
                d["offset"] = int(fch[1].get("value", 1))
            if len(fch) > 2 and _cls(fch[2]) == "Literal" \
                    and fch[2].get("value") is not None:
                t = _type_from_catalyst(fch[2].get("dataType"))
                d["default"] = _parse_literal(fch[2].get("value"), t)
            functions.append(d)
        elif fcls == "NthValue":
            d = {"kind": "nth_value", "name": name,
                 "expr": convert_expr(fch[0], scope),
                 "ignore_nulls": bool(node.get("ignoreNulls", False)
                                      or fn.get("ignoreNulls", False))}
            if len(fch) > 1 and _cls(fch[1]) == "Literal":
                d["n"] = int(fch[1].get("value", 1))
            functions.append(d)
        elif fcls == "AggregateExpression":
            agg_fn = fch[0]
            afcls = _cls(agg_fn)
            fn_name = _AGG_FNS.get(afcls)
            if fn_name is None:
                raise ConversionError(afcls,
                                      "unsupported window aggregate")
            functions.append({
                "kind": "agg", "fn": fn_name, "name": name,
                "args": [convert_expr_with_fallback(a, scope)
                         for a in agg_fn["__children"]]})
        else:
            raise ConversionError(fcls, "unsupported window function")
        out_ids.append(wid)
        out_names.append(name)
    return ({"kind": "window", "input": child, "functions": functions,
             "partition_by": part_by, "order_by": order},
            Scope(out_ids, out_names))


def _check_default_frame(spec: dict) -> None:
    """Reject aggregate-over-window frames the engine cannot honor."""
    for n in _walk_tree(spec):
        if _cls(n) == "SpecifiedWindowFrame":
            bounds = [_cls(b) for b in n["__children"]]
            ftype = str(n.get("frameType", ""))
            ok = ("Unbounded" in (bounds[0] if bounds else "")
                  and "CurrentRow" in (bounds[1] if len(bounds) > 1
                                       else "")
                  and "Row" not in ftype)
            if not ok:
                raise ConversionError(
                    "SpecifiedWindowFrame",
                    f"unsupported window frame {ftype} {bounds} (only "
                    f"the default RANGE UNBOUNDED PRECEDING..CURRENT "
                    f"ROW converts)")


def _walk_tree(node: dict):
    yield node
    for c in node.get("__children", []):
        yield from _walk_tree(c)


_GENERATOR_CLASSES = {"Explode": ("explode", False),
                      "PosExplode": ("posexplode", True)}


def _convert_generate(node: dict, parts: int, log: List[str]
                      ) -> Tuple[Dict[str, Any], Scope]:
    c = "GenerateExec"
    ch = node["__children"]
    child, scope = _convert_node(ch[0], parts, log)
    gen_node = _expr_tree(node.get("generator"))
    if gen_node is None:
        raise ConversionError(c, "missing generator")
    gcls = _cls(gen_node)
    outer = bool(node.get("outer", False))
    if gcls in _GENERATOR_CLASSES:
        kind, _pos = _GENERATOR_CLASSES[gcls]
        gen: Dict[str, Any] = {
            "kind": kind, "outer": outer,
            "child": convert_expr(gen_node["__children"][0], scope)}
    elif gcls == "JsonTuple":
        gch = gen_node["__children"]
        fields = []
        for f in gch[1:]:
            if _cls(f) != "Literal":
                raise ConversionError("JsonTuple", "non-literal field")
            fields.append(str(f.get("value")))
        gen = {"kind": "json_tuple", "outer": outer,
               "child": convert_expr(gch[0], scope), "fields": fields}
    else:
        raise ConversionError(gcls, "unsupported generator")
    req_attrs = _expr_list(node.get("requiredChildOutput"))
    req_names = []
    req_ids = []
    for a in req_attrs:
        req_ids.append(_expr_id(a))
        req_names.append(a.get("name", ""))
    gen_attrs = _expr_list(node.get("generatorOutput"))
    gids, gnames = _attrs_of(gen_attrs)
    missing = [i for i in req_ids if i not in scope._index]
    if missing:
        raise ConversionError(
            c, f"requiredChildOutput exprIds {missing} not found in "
               f"child output — positional binding would shift")
    required_cols = [scope._index[i] for i in req_ids]
    out_names = req_names + gnames
    # the engine generator names its output columns itself (col/pos);
    # rename to the Catalyst generatorOutput attribute names so parents
    # bind the names Spark assigned
    d = {"kind": "rename_columns",
         "input": {"kind": "generate", "input": child, "generator": gen,
                   "required_cols": required_cols},
         "names": out_names}
    return d, Scope(req_ids + gids, out_names)


def _partitioning(p, scope: Scope, parts: int) -> Dict[str, Any]:
    t = _expr_tree(p) if isinstance(p, list) else p
    if isinstance(t, dict):
        pc = _cls(t)
        if pc == "HashPartitioning":
            return {"kind": "hash",
                    "exprs": [convert_expr(e, scope)
                              for e in t["__children"]],
                    "num_partitions": int(t.get("numPartitions", parts))}
        if pc == "RoundRobinPartitioning":
            return {"kind": "round_robin",
                    "num_partitions": int(t.get("numPartitions", parts))}
        if pc == "SinglePartition$":
            return {"kind": "single"}
    if isinstance(p, str) and "SinglePartition" in p:
        return {"kind": "single"}
    raise ConversionError("Partitioning", f"unsupported {p!r}")


_JOIN_TYPES = {
    "Inner": "inner", "LeftOuter": "left", "RightOuter": "right",
    "FullOuter": "full", "LeftSemi": "left_semi", "LeftAnti": "left_anti",
    "ExistenceJoin": "existence", "Cross": "inner",
}


def _parse_join_type(node: dict, node_class: str) -> str:
    jt_raw = str(node.get("joinType", "Inner"))
    for k, v in _JOIN_TYPES.items():
        if jt_raw.startswith(k):
            return v
    raise ConversionError(node_class, f"unsupported join type {jt_raw!r}")


def _parse_build_side(node: dict) -> str:
    return "left" if "Left" in str(node.get("buildSide", "BuildRight")) \
        else "right"


def _join_output_scope(jt: str, lscope: Scope, rscope: Scope) -> Scope:
    """Output attributes per Spark join semantics."""
    if jt in ("left_semi", "left_anti"):
        return lscope
    if jt == "existence":
        return Scope(lscope.ids + [-2], lscope.names + ["exists"])
    return Scope.concat(lscope, rscope)


def _convert_join(node: dict, parts: int, log: List[str]
                  ) -> Tuple[Dict[str, Any], Scope]:
    c = _cls(node)
    op = {"SortMergeJoinExec": "smj", "ShuffledHashJoinExec": "shj",
          "BroadcastHashJoinExec": "bhj"}[c]
    _gate(op, c)
    ch = node["__children"]
    left, lscope = _convert_node(ch[0], parts, log)
    right, rscope = _convert_node(ch[1], parts, log)
    jt = _parse_join_type(node, c)
    lkeys = [convert_expr(e, lscope)
             for e in _expr_list(node.get("leftKeys"))]
    rkeys = [convert_expr(e, rscope)
             for e in _expr_list(node.get("rightKeys"))]
    kind = {"smj": "sort_merge_join", "shj": "hash_join",
            "bhj": "broadcast_join"}[op]
    d: Dict[str, Any] = {"kind": kind, "left": left, "right": right,
                         "left_keys": lkeys, "right_keys": rkeys,
                         "join_type": jt}
    if op in ("shj", "bhj"):
        d["build_side"] = _parse_build_side(node)
    if op == "bhj":
        import uuid
        d["broadcast_id"] = f"conv-{uuid.uuid4().hex[:10]}"
    cond = _expr_tree(node.get("condition"))
    if cond is not None:
        _gate("native.join.condition", c)
        d["join_filter"] = convert_expr_with_fallback(
            cond, Scope.concat(lscope, rscope))
    return d, _join_output_scope(jt, lscope, rscope)


_AGG_FNS = {
    "Sum": "sum", "Count": "count", "Average": "avg", "Min": "min",
    "Max": "max", "First": "first", "CollectList": "collect_list",
    "CollectSet": "collect_set",
}
_ACC_COUNTS = {"sum": 1, "count": 1, "avg": 2, "min": 1, "max": 1,
               "first": 1, "collect_list": 1, "collect_set": 1}


def _convert_agg(node: dict, parts: int, log: List[str]
                 ) -> Tuple[Dict[str, Any], Scope]:
    c = _cls(node)
    _gate("aggr", c)
    ch = node["__children"]
    child, scope = _convert_node(ch[0], parts, log)

    group_exprs = _expr_list(node.get("groupingExpressions"))
    agg_exprs = _expr_list(node.get("aggregateExpressions"))
    result_attrs = _expr_list(node.get("resultExpressions")) or \
        _expr_list(node.get("aggregateAttributes"))

    groupings = []
    group_ids = []
    for g in group_exprs:
        name = g.get("name", f"g{len(groupings)}")
        groupings.append({"expr": convert_expr(g, scope), "name": name})
        group_ids.append(_expr_id(g))

    aggs = []
    out_ids: List[int] = list(group_ids)
    out_names: List[str] = [g["name"] for g in groupings]
    acc_pos = len(groupings)
    modes = set()
    for ae in agg_exprs:
        if _cls(ae) != "AggregateExpression":
            raise ConversionError(_cls(ae),
                                  "expected AggregateExpression")
        mode_raw = str(ae.get("mode", "Partial"))
        mode = ("partial_merge" if "PartialMerge" in mode_raw else
                "partial" if "Partial" in mode_raw else
                "final" if "Final" in mode_raw else
                "complete" if "Complete" in mode_raw else None)
        if mode is None:
            raise ConversionError(c, f"unsupported agg mode {mode_raw!r}")
        modes.add(mode)
        if len(modes) > 1:
            # Spark distinct-aggregation stages mix modes in one node;
            # the positional acc layout below assumes uniformity
            raise ConversionError(
                c, f"mixed aggregate modes {sorted(modes)} in one node "
                   f"are not convertible")
        fn_node = ae["__children"][0]
        fn_cls = _cls(fn_node)
        fn = _AGG_FNS.get(fn_cls)
        if fn is None:
            raise ConversionError(fn_cls, "unsupported aggregate "
                                          "(UDAF fallback not wired in "
                                          "the converter)")
        result_id = int((ae.get("resultId") or {}).get("id", -1))
        name = f"{fn}_{result_id}"
        nacc = _ACC_COUNTS[fn]
        if mode in ("partial", "complete"):
            args = [convert_expr(a, scope)
                    for a in fn_node["__children"]]
        else:
            # merge modes read acc columns positionally
            # (ref NativeAggBase placeholder children)
            args = [{"kind": "column", "index": acc_pos + t}
                    for t in range(nacc)]
        acc_pos += nacc
        aggs.append({"fn": fn, "mode": mode, "name": name, "args": args})
        out_ids.append(result_id)
        out_names.append(name)

    kind = "sort_agg" if c == "SortAggregateExec" else "hash_agg"
    d: Dict[str, Any] = {"kind": kind, "input": child,
                         "groupings": groupings, "aggs": aggs}
    # the physical output layout is [groups..., agg values...]; grouping
    # attrs keep their exprIds, agg outputs take the AggregateExpression
    # resultId (what downstream attrs reference)
    phys = Scope(out_ids, out_names)
    if result_attrs and all(_cls(a) == "AttributeReference"
                            for a in result_attrs):
        ids, names = _attrs_of(result_attrs)
        ng = len(groupings)
        if ids != phys.ids:
            if (ids[:ng] == phys.ids[:ng] and
                    not any(i in phys.ids for i in ids[ng:])):
                # real Spark partial aggregates expose their
                # aggBufferAttributes (e.g. sum#110) as output ids — not
                # the AggregateExpression resultId the synthesized corpus
                # used.  Same physical layout [groups..., acc columns...],
                # different identity: adopt the attrs verbatim (caught by
                # the hand-captured Spark 3.5 fixture, VERDICT r3 #5)
                return d, Scope(ids, names)
            # resultExpressions reorder the output: emit the projection
            # Spark folds into the aggregate, else parents bind wrong
            # physical columns
            d = {"kind": "project", "input": d,
                 "exprs": [phys.bind(i, n) for i, n in zip(ids, names)],
                 "names": names}
        return d, Scope(ids, names)
    return d, phys
