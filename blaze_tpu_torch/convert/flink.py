"""The Flink front end: a COMPILE PLAN JSON -> one engine plan (port of
blaze_tpu/convert/flink.py).

Parity: auron-flink-planner (ref auron-flink-extension/): convert
StreamExecCalc's Calcite RexNode projections and conditions
(RexCallConverter, RexInputRefConverter, RexLiteralConverter) and fuse the
adjacent Calc and Kafka-source exec nodes into ONE native plan
(AuronOperatorFusionProcessor + NativePlanFusionBuilder), run by the
Kafka scan (flink/kafka_scan_exec.rs:81).

A JVM-less build reads the same information from Flink's serialized
plan: `table_env.compile_plan_sql(...)` / `EXECUTE ... COMPILE PLAN`
emits a JSON exec graph whose nodes carry the RexNode JSON this module
converts.  Nodes:

  stream-exec-table-source-scan  (kafka; values for tests) -> kafka_scan
                                                            (memory_scan)
  stream-exec-calc               (projection + condition) -> filter/project
  stream-exec-{local-,global-,}group-aggregate            -> hash_agg
  stream-exec-exchange, stream-exec-sink                  -> pass-through

RexNode vocabulary: INPUT_REF, LITERAL and CALL with the internalName
operators the reference's RexCallConverter takes (arithmetic, comparison,
AND/OR/NOT, IS [NOT] NULL, LIKE, CAST/TRY_CAST, CASE, UPPER/LOWER/
CHAR_LENGTH ...).  Anything else raises ConversionError with the Calc
fallback's reason, as UnsupportedFlinkNodeRecorder records it.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict

from blaze_tpu_torch.convert.spark import ConversionError

# ---------------------------------------------------------------------------
# Flink logical types -> engine type dicts
# ---------------------------------------------------------------------------

_FLINK_TYPES = {
    "BOOLEAN": "bool", "TINYINT": "int8", "SMALLINT": "int16",
    "INT": "int32", "INTEGER": "int32", "BIGINT": "int64",
    "FLOAT": "float32", "REAL": "float32", "DOUBLE": "float64",
    "DATE": "date32", "STRING": "utf8", "BYTES": "binary",
}
_VARCHAR_RE = re.compile(r"(VAR)?CHAR\(\d+\)")
_DECIMAL_RE = re.compile(r"DECIMAL\((\d+),\s*(\d+)\)")
_TS_RE = re.compile(r"TIMESTAMP(_LTZ)?\((\d+)\)")


def type_from_flink(t: str) -> Dict[str, Any]:
    base = t.replace(" NOT NULL", "").strip()
    if base in _FLINK_TYPES:
        return {"id": _FLINK_TYPES[base]}
    if _VARCHAR_RE.fullmatch(base):
        return {"id": "utf8"}
    m = _DECIMAL_RE.fullmatch(base)
    if m:
        return {"id": "decimal", "precision": int(m.group(1)),
                "scale": int(m.group(2))}
    if _TS_RE.fullmatch(base):
        return {"id": "timestamp_us"}
    raise ConversionError("<flink-type>", f"unsupported type {t!r}")


# ---------------------------------------------------------------------------
# RexNode JSON -> engine expression IR (RexCallConverter parity)
# ---------------------------------------------------------------------------

_BINARY_OPS = {
    "=": "==", "<>": "!=", ">": ">", ">=": ">=", "<": "<", "<=": "<=",
    "+": "+", "-": "-", "*": "*", "/": "/", "%": "%", "MOD": "%",
    "AND": "and", "OR": "or",
}
_FNS = {"UPPER": "upper", "LOWER": "lower", "CHAR_LENGTH": "length",
        "CHARLENGTH": "length", "ABS": "abs", "CEIL": "ceil",
        "FLOOR": "floor", "SQRT": "sqrt", "EXP": "exp", "TRIM": "trim",
        "CONCAT": "concat", "MD5": "md5"}


def _op_name(call: dict) -> str:
    """CALL operator: `internalName` "$OP$1" (compiled plan) or a bare
    `operator` field.  Calcite spells some internal aggregates with a
    leading dollar and no suffix ("$SUM0") — strip that too, or the
    lookup key never matches."""
    name = call.get("internalName") or call.get("operator") or ""
    m = re.fullmatch(r"\$(.+)\$\d+", name)
    return (m.group(1) if m else name.lstrip("$")).upper()


# ---------------------------------------------------------------------------
# converter registry (FlinkNodeConverterFactory parity: pluggable Rex /
# AggregateCall converters keyed by node kind, consulted before the
# built-ins; registering a duplicate kind raises like the reference)
# ---------------------------------------------------------------------------

_REX_CONVERTERS: Dict[str, Any] = {}
_AGG_CONVERTERS: Dict[str, Any] = {}


def register_rex_converter(kind: str, fn) -> None:
    """FlinkNodeConverterFactory.registerRexConverter analog."""
    if kind in _REX_CONVERTERS:
        raise ValueError(f"rex converter for {kind!r} already registered")
    _REX_CONVERTERS[kind] = fn


def register_agg_converter(name: str, fn) -> None:
    """FlinkNodeConverterFactory.registerAggConverter analog."""
    if name in _AGG_CONVERTERS:
        raise ValueError(f"agg converter for {name!r} already registered")
    _AGG_CONVERTERS[name] = fn


def convert_agg_call(call: dict) -> Dict[str, Any]:
    """Calcite AggregateCall -> engine agg spec (FlinkAggCallConverter:
    function name + argument input refs + distinctness).  Custom
    converters registered for the function name win."""
    name = _op_name(call) or str(call.get("name", "")).split("(")[0]
    custom = _AGG_CONVERTERS.get(name)
    if custom is not None:
        return custom(call)
    args = [{"kind": "column", "index": int(i)}
            for i in call.get("argList", [])]
    distinct = bool(call.get("distinct", False))
    fns = {"SUM": "sum", "SUM0": "sum", "COUNT": "count", "MIN": "min",
           "MAX": "max", "AVG": "avg"}
    if name not in fns:
        raise ConversionError("AggregateCall",
                              f"unsupported aggregate {name!r}")
    if distinct:
        raise ConversionError("AggregateCall",
                              f"DISTINCT {name} has no native kernel")
    if name == "COUNT" and not args:
        args = [{"kind": "literal", "value": 1, "type": {"id": "int64"}}]
    spec = {"fn": fns[name], "args": args}
    if name == "SUM0":
        # Calcite SUM0 ($SUM0): sum that returns 0 — not NULL — for a
        # group whose values are all NULL.  Lowered as coalesce(sum, 0)
        # over the FINAL/COMPLETE output (the partial accumulator must
        # stay null-preserving for the merge)
        spec["zero_on_null"] = True
    return spec


def convert_rex(node: dict) -> Dict[str, Any]:
    kind = node.get("kind")
    custom = _REX_CONVERTERS.get(kind or "")
    if custom is not None:
        return custom(node)
    if kind == "INPUT_REF":
        return {"kind": "column", "index": int(node["inputIndex"])}
    if kind == "LITERAL":
        t = type_from_flink(node.get("type", ""))
        v = node.get("value")
        if v is not None and t["id"] in ("int8", "int16", "int32",
                                         "int64", "date32"):
            v = int(v)
        elif v is not None and t["id"] in ("float32", "float64"):
            v = float(v)
        elif v is not None and t["id"] == "bool" and isinstance(v, str):
            v = v.lower() == "true"
        return {"kind": "literal", "value": v, "type": t}
    if kind != "CALL":
        raise ConversionError("RexNode", f"unsupported kind {kind!r}")

    op = _op_name(node)
    args = [convert_rex(a) for a in node.get("operands", [])]
    if op in _BINARY_OPS and len(args) == 2:
        engine_op = _BINARY_OPS[op]
        if engine_op == "!=":
            return {"kind": "not",
                    "child": {"kind": "binary", "op": "==",
                              "l": args[0], "r": args[1]}}
        return {"kind": "binary", "op": engine_op,
                "l": args[0], "r": args[1]}
    if op in ("AND", "OR") and len(args) > 2:  # Calcite folds variadic
        out = args[0]
        for a in args[1:]:
            out = {"kind": "binary", "op": _BINARY_OPS[op], "l": out,
                   "r": a}
        return out
    if op == "NOT":
        return {"kind": "not", "child": args[0]}
    if op == "IS NULL":
        return {"kind": "is_null", "child": args[0]}
    if op == "IS NOT NULL":
        return {"kind": "is_not_null", "child": args[0]}
    if op in ("CAST", "TRY_CAST"):
        return {"kind": "cast" if op == "CAST" else "try_cast",
                "child": args[0],
                "type": type_from_flink(node.get("type", ""))}
    if op == "LIKE" and len(node.get("operands", [])) >= 2:
        pat = node["operands"][1]
        if pat.get("kind") != "LITERAL":
            raise ConversionError("LIKE", "non-literal pattern")
        return {"kind": "like", "child": args[0],
                "pattern": pat.get("value"), "negated": False,
                "case_insensitive": False}
    if op == "CASE":
        # operands: w1, t1, [w2, t2, ...], else
        branches = []
        ops = args
        for i in range(0, len(ops) - 1, 2):
            branches.append([ops[i], ops[i + 1]])
        out: Dict[str, Any] = {"kind": "case", "branches": branches}
        if len(ops) % 2 == 1:
            out["else"] = ops[-1]
        return out
    if op in _FNS:
        return {"kind": "scalar_function", "name": _FNS[op],
                "args": args}
    raise ConversionError("RexCall", f"unsupported operator {op!r} "
                                     f"(Calc falls back to Flink)")


# ---------------------------------------------------------------------------
# exec graph -> engine plan (AuronOperatorFusionProcessor parity)
# ---------------------------------------------------------------------------

def convert_flink_plan(plan_json, num_partitions: int = 1
                       ) -> Dict[str, Any]:
    """Flink CompiledPlan JSON -> ONE fused engine plan dict."""
    if isinstance(plan_json, str):
        plan_json = json.loads(plan_json)
    nodes = {n["id"]: n for n in plan_json.get("nodes", [])}
    downstream: Dict[Any, Any] = {}
    for e in plan_json.get("edges", []):
        if e["source"] in downstream:
            # a COMPILE-PLAN with fan-out is not a single operator chain;
            # silently keeping one edge would mis-walk the DAG
            raise ConversionError("<flink-plan>",
                                  f"node {e['source']} has multiple "
                                  f"outgoing edges (DAG fan-out is not "
                                  f"supported)")
        downstream[e["source"]] = e["target"]
    src = [nid for nid in nodes
           if nodes[nid]["type"].split("_")[0]
           == "stream-exec-table-source-scan"]
    if len(src) != 1:
        raise ConversionError("<flink-plan>",
                              f"expected exactly one source scan, "
                              f"found {len(src)}")
    plan = _convert_source(nodes[src[0]], num_partitions)
    nid = src[0]
    while nid in downstream:
        nid = downstream[nid]
        node = nodes[nid]
        ntype = node["type"].split("_")[0]
        if ntype == "stream-exec-calc":
            plan = _convert_calc(node, plan)
        elif ntype in ("stream-exec-local-group-aggregate",
                       "stream-exec-group-aggregate",
                       "stream-exec-global-group-aggregate"):
            plan = _convert_group_aggregate(node, plan, ntype)
        elif ntype in ("stream-exec-sink", "stream-exec-exchange"):
            continue  # sink collects; exchange is the host's business
        else:
            raise ConversionError(node["type"],
                                  "unsupported Flink exec node")
    return plan


def _convert_group_aggregate(node: dict, child: Dict[str, Any],
                             ntype: str) -> Dict[str, Any]:
    """Flink group aggregate -> engine hash_agg.  The TWO_PHASE pair
    maps onto the engine's partial/final split: the LOCAL node emits
    accumulator columns (mode=partial), the GLOBAL node rebinds them
    POSITIONALLY (groups first, then each agg's acc columns — two for
    avg, one otherwise) and finalizes (mode=final).  The one-phase
    GroupAggregate node runs COMPLETE over raw input.  AggregateCalls
    convert through the registry (convert_agg_call)."""
    grouping = [int(i) for i in node.get("grouping", [])]
    calls = node.get("aggCalls", [])
    mode = {"stream-exec-local-group-aggregate": "partial",
            "stream-exec-global-group-aggregate": "final",
            "stream-exec-group-aggregate": "complete"}[ntype]
    aggs = []
    zero_on_null = []  # agg positions needing coalesce(out, 0) (SUM0)
    if mode == "final":
        pos = len(grouping)
        for i, call in enumerate(calls):
            spec = convert_agg_call(call)
            nacc = 2 if spec["fn"] == "avg" else 1
            aggs.append({"fn": spec["fn"], "mode": "final",
                         "name": str(call.get("name") or f"agg{i}"),
                         "args": [{"kind": "column", "index": pos + t}
                                  for t in range(nacc)]})
            if spec.get("zero_on_null"):
                zero_on_null.append(i)
            pos += nacc
        groupings = [{"expr": {"kind": "column", "index": i},
                      "name": f"g{g}"}
                     for i, g in enumerate(grouping)]
    else:
        for i, call in enumerate(calls):
            spec = convert_agg_call(call)
            aggs.append({"fn": spec["fn"], "mode": mode,
                         "name": str(call.get("name") or f"agg{i}"),
                         "args": spec["args"]})
            if spec.get("zero_on_null") and mode == "complete":
                zero_on_null.append(i)
        groupings = [{"expr": {"kind": "column", "index": g},
                      "name": f"g{g}"} for g in grouping]
    agg = {"kind": "hash_agg", "groupings": groupings,
           "aggs": aggs, "input": child}
    if not zero_on_null:
        return agg
    # SUM0 finalization: output columns are groupings then one column
    # per agg; replace the SUM0 outputs with coalesce(col, 0) — the
    # Coalesce kernel casts the int64 zero to the sum's own type
    ng = len(groupings)
    exprs, names = [], []
    for j in range(ng):
        exprs.append({"kind": "column", "index": j})
        names.append(groupings[j]["name"])
    zeros = set(zero_on_null)
    for i, a in enumerate(aggs):
        c = {"kind": "column", "index": ng + i}
        if i in zeros:
            c = {"kind": "coalesce", "args": [
                c, {"kind": "literal", "value": 0,
                    "type": {"id": "int64"}}]}
        exprs.append(c)
        names.append(a["name"])
    return {"kind": "project", "input": agg, "exprs": exprs,
            "names": names}


def _convert_source(node: dict, num_partitions: int) -> Dict[str, Any]:
    table = (node.get("scanTableSource") or {}).get("table") or {}
    resolved = table.get("resolvedTable") or table
    options = resolved.get("options") or {}
    connector = options.get("connector", "")
    if connector not in ("kafka", "values"):
        raise ConversionError(node.get("type", "source"),
                              f"unsupported connector {connector!r} "
                              f"(the reference accelerates Kafka "
                              f"sources, kafka_scan_exec.rs:81)")
    cols = resolved.get("schema", {}).get("columns", [])
    fields = [{"name": c["name"],
               "type": type_from_flink(c.get("dataType", c.get("type"))),
               "nullable": "NOT NULL" not in str(c.get("dataType",
                                                       c.get("type")))}
              for c in cols]
    if connector == "values":
        # the `values` bounded test connector (Flink's ITCase source):
        # rows come from a pre-registered engine resource
        rid = options.get("resource-id")
        if not rid:
            raise ConversionError(node.get("type", "source"),
                                  "values connector needs a "
                                  "'resource-id' option")
        return {"kind": "memory_scan", "resource_id": rid,
                "schema": {"fields": fields},
                "num_partitions": num_partitions}
    fmt = options.get("format", options.get("value.format", "json"))
    d: Dict[str, Any] = {
        "kind": "kafka_scan",
        "schema": {"fields": fields},
        "topic": options.get("topic", ""),
        "format": {"json": "json", "protobuf": "protobuf"}.get(fmt, fmt),
        "num_partitions": num_partitions,
    }
    if options.get("__mock_data__"):  # test hook (kafka_mock_scan_exec)
        d["mock_data_json_array"] = options["__mock_data__"]
    return d


def _convert_calc(node: dict, child: Dict[str, Any]) -> Dict[str, Any]:
    projection = [convert_rex(r) for r in node.get("projection", [])]
    cond = node.get("condition")
    names = [f"f{i}" for i in range(len(projection))]
    out: Dict[str, Any] = child
    if cond is not None:
        out = {"kind": "filter", "input": out,
               "predicates": [convert_rex(cond)]}
    if projection:
        out = {"kind": "project", "input": out, "exprs": projection,
               "names": names}
    return out
