"""Protobuf plan serde: the `TaskDefinition` wire boundary (port of the part
of blaze_tpu/plan/proto_serde.py this slice uses).

Maps proto messages <-> the plan-IR dicts that `plan/planner.py`
`create_plan` reads, with the same dict vocabulary as the JAX package, so
the same bytes decode to equal dicts in both.  Node kinds: parquet_scan,
ipc_reader, filter, projection, agg (hash_agg/sort_agg), sort, limit,
union, shuffle_writer, the joins (sort_merge_join, hash_join,
broadcast_join, with join type, build side, broadcast_id /
cached_build_hash_map_id and join_filter), the nested-loop join (a
KEYLESS broadcast_join on the wire, its inner filter lifted into a
filter node above it), broadcast_join_build_hash_map, expand, window
(the rank family, lead/lag, nth_value and aggregates, with group_limit),
rename_columns and generate (explode and posexplode, the kept columns by
name); types: the fixed-width ones, utf8, binary and list;
expressions:
column, bound_reference, literal, binary (comparisons, and/or,
arithmetic), is_null, is_not_null, not, case (an `if` encodes as a case
with one branch), coalesce (a scalar function), in_list, cast, try_cast
and the sort expression of a sort node; partitionings: single and hash.
Every other variant raises NotImplementedError.

`ScalarValue` follows the reference encoding: a one-batch Arrow IPC stream
whose column 0 row 0 is the value.
"""

from __future__ import annotations

import io
from typing import Any, Dict, List, Tuple

import pyarrow as pa

from blaze_tpu_torch.plan.proto import auron_pb2 as pb

_LATER = ("belongs to a later slice of the PyTorch port (ROADMAP Queue 1 "
          "item 3)")

# ---------------------------------------------------------------------------
# ArrowType <-> type dicts ({"id": ...} of plan/types.py)
# ---------------------------------------------------------------------------

_SIMPLE_DECODE = {
    "NONE": "null", "BOOL": "bool", "INT8": "int8", "INT16": "int16",
    "INT32": "int32", "INT64": "int64", "FLOAT32": "float32",
    "FLOAT64": "float64", "UTF8": "utf8", "LARGE_UTF8": "utf8",
    "BINARY": "binary", "LARGE_BINARY": "binary", "DATE32": "date32",
}

_SIMPLE_ENCODE = {
    "null": "NONE", "bool": "BOOL", "int8": "INT8", "int16": "INT16",
    "int32": "INT32", "int64": "INT64", "float32": "FLOAT32",
    "float64": "FLOAT64", "utf8": "UTF8", "binary": "BINARY",
    "date32": "DATE32",
}


def type_from_proto(at: pb.ArrowType) -> Dict[str, Any]:
    kind = at.WhichOneof("arrow_type_enum")
    if kind is None:
        raise ValueError("ArrowType with no variant set")
    if kind in _SIMPLE_DECODE:
        return {"id": _SIMPLE_DECODE[kind]}
    if kind == "TIMESTAMP":
        return {"id": "timestamp_us"}
    if kind == "DECIMAL":
        return {"id": "decimal", "precision": int(at.DECIMAL.whole),
                "scale": int(at.DECIMAL.fractional)}
    if kind in ("LIST", "LARGE_LIST"):
        lst = at.LIST if kind == "LIST" else at.LARGE_LIST
        return {"id": "list", "children": [field_from_proto(lst.field_type)]}
    raise NotImplementedError(f"ArrowType {kind!r} {_LATER}")


def type_to_proto(t: Dict[str, Any]) -> pb.ArrowType:
    out = pb.ArrowType()
    tid = t["id"]
    if tid in _SIMPLE_ENCODE:
        getattr(out, _SIMPLE_ENCODE[tid]).SetInParent()
        return out
    if tid == "timestamp_us":
        out.TIMESTAMP.time_unit = pb.Microsecond
        return out
    if tid == "decimal":
        out.DECIMAL.whole = t.get("precision", 0)
        out.DECIMAL.fractional = t.get("scale", 0)
        return out
    if tid == "list":
        out.LIST.field_type.CopyFrom(field_to_proto(t["children"][0]))
        return out
    raise NotImplementedError(f"type {tid!r} {_LATER}")


def field_from_proto(f: pb.Field) -> Dict[str, Any]:
    return {"name": f.name, "type": type_from_proto(f.arrow_type),
            "nullable": f.nullable}


def field_to_proto(fd: Dict[str, Any]) -> pb.Field:
    f = pb.Field(name=fd["name"], nullable=fd.get("nullable", True))
    f.arrow_type.CopyFrom(type_to_proto(fd["type"]))
    return f


def schema_from_proto(s: pb.Schema) -> Dict[str, Any]:
    return {"fields": [field_from_proto(f) for f in s.columns]}


def schema_to_proto(sd: Dict[str, Any]) -> pb.Schema:
    s = pb.Schema()
    for f in sd["fields"]:
        s.columns.append(field_to_proto(f))
    return s


# ---------------------------------------------------------------------------
# ScalarValue: one-batch Arrow IPC stream, column 0 row 0
# ---------------------------------------------------------------------------

def scalar_from_proto(sv: pb.ScalarValue) -> Tuple[Any, Dict[str, Any]]:
    from blaze_tpu_torch.plan.types import type_to_dict
    from blaze_tpu_torch.schema import DataType
    with pa.ipc.open_stream(io.BytesIO(sv.ipc_bytes)) as r:
        rb = next(iter(r))
    col = rb.column(0)
    val = col[0].as_py() if col[0].is_valid else None
    return val, type_to_dict(DataType.from_arrow(col.type))


def scalar_to_proto(value: Any, type_dict: Dict[str, Any]) -> pb.ScalarValue:
    from blaze_tpu_torch.plan.types import type_from_dict
    t = type_from_dict(type_dict).to_arrow()
    rb = pa.record_batch([pa.array([value], type=t)], names=["c0"])
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return pb.ScalarValue(ipc_bytes=sink.getvalue())


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_BINOP_DECODE = {
    "And": "and", "Or": "or", "Eq": "==", "NotEq": "!=", "LtEq": "<=",
    "Lt": "<", "Gt": ">", "GtEq": ">=", "Plus": "+", "Minus": "-",
    "Multiply": "*", "Divide": "/", "Modulo": "%",
    "IsNotDistinctFrom": "<=>",
}
_BINOP_ENCODE = {v: k for k, v in _BINOP_DECODE.items()}

_AGG_FN_DECODE = {pb.MIN: "min", pb.MAX: "max", pb.SUM: "sum",
                  pb.AVG: "avg", pb.COUNT: "count"}
_AGG_FN_ENCODE = {v: k for k, v in _AGG_FN_DECODE.items()}

_WINDOW_RANK_DECODE = {
    pb.ROW_NUMBER: "row_number", pb.RANK: "rank", pb.DENSE_RANK: "dense_rank",
    pb.PERCENT_RANK: "percent_rank", pb.CUME_DIST: "cume_dist",
}
_WINDOW_RANK_ENCODE = {v: k for k, v in _WINDOW_RANK_DECODE.items()}

_JOIN_TYPE_DECODE = {
    pb.INNER: "inner", pb.LEFT: "left", pb.RIGHT: "right", pb.FULL: "full",
    pb.SEMI: "left_semi", pb.ANTI: "left_anti", pb.EXISTENCE: "existence",
}
_JOIN_TYPE_ENCODE = {v: k for k, v in _JOIN_TYPE_DECODE.items()}

#: acc-column counts per agg kind (ops/agg/functions.py acc_fields): avg
#: carries (sum, count)
_ACC_FIELD_COUNT = {"sum": 1, "count": 1, "min": 1, "max": 1, "avg": 2}


def expr_from_proto(e: pb.PhysicalExprNode) -> Dict[str, Any]:
    kind = e.WhichOneof("ExprType")
    if kind is None:
        raise ValueError("PhysicalExprNode with no variant set")
    if kind == "column":
        if e.column.name:
            return {"kind": "column", "name": e.column.name}
        return {"kind": "column", "index": int(e.column.index)}
    if kind == "bound_reference":
        return {"kind": "column", "index": int(e.bound_reference.index)}
    if kind == "literal":
        val, t = scalar_from_proto(e.literal)
        return {"kind": "literal", "value": val, "type": t}
    if kind == "binary_expr":
        op = _BINOP_DECODE.get(e.binary_expr.op)
        if op is None:
            raise NotImplementedError(
                f"binary op {e.binary_expr.op!r} {_LATER}")
        return {"kind": "binary", "op": op,
                "l": expr_from_proto(e.binary_expr.l),
                "r": expr_from_proto(e.binary_expr.r)}
    if kind == "is_null_expr":
        return {"kind": "is_null",
                "child": expr_from_proto(e.is_null_expr.expr)}
    if kind == "is_not_null_expr":
        return {"kind": "is_not_null",
                "child": expr_from_proto(e.is_not_null_expr.expr)}
    if kind == "not_expr":
        return {"kind": "not", "child": expr_from_proto(e.not_expr.expr)}
    if kind == "case_":
        c = e.case_
        operand = expr_from_proto(c.expr) if c.HasField("expr") else None
        branches = []
        for wt in c.when_then_expr:
            w = expr_from_proto(wt.when_expr)
            if operand is not None:
                w = {"kind": "binary", "op": "==", "l": operand, "r": w}
            branches.append([w, expr_from_proto(wt.then_expr)])
        out: Dict[str, Any] = {"kind": "case", "branches": branches}
        if c.HasField("else_expr"):
            out["else"] = expr_from_proto(c.else_expr)
        return out
    if kind == "in_list":
        values = []
        for v in e.in_list.list:
            if v.WhichOneof("ExprType") != "literal":
                raise ValueError("in_list values must be literals")
            values.append(scalar_from_proto(v.literal)[0])
        return {"kind": "in_list",
                "child": expr_from_proto(e.in_list.expr),
                "values": values, "negated": e.in_list.negated}
    if kind in ("cast", "try_cast"):
        node = e.cast if kind == "cast" else e.try_cast
        return {"kind": kind, "child": expr_from_proto(node.expr),
                "type": type_from_proto(node.arrow_type)}
    if kind == "scalar_function" and \
            e.scalar_function.fun == pb.Coalesce:
        return {"kind": "coalesce",
                "args": [expr_from_proto(a) for a in e.scalar_function.args]}
    raise NotImplementedError(f"expression {kind!r} {_LATER}")


def expr_to_proto(d: Dict[str, Any]) -> pb.PhysicalExprNode:
    e = pb.PhysicalExprNode()
    k = d["kind"]
    if k == "column":
        if d.get("name"):
            e.column.name = d["name"]
            if d.get("index") is not None:
                e.column.index = d["index"]
        else:
            e.bound_reference.index = d["index"]
            e.bound_reference.nullable = True
        return e
    if k == "literal":
        e.literal.CopyFrom(scalar_to_proto(d.get("value"), d["type"]))
        return e
    if k == "binary":
        e.binary_expr.op = _BINOP_ENCODE[d["op"]]
        e.binary_expr.l.CopyFrom(expr_to_proto(d["l"]))
        e.binary_expr.r.CopyFrom(expr_to_proto(d["r"]))
        return e
    if k == "is_null":
        e.is_null_expr.expr.CopyFrom(expr_to_proto(d["child"]))
        return e
    if k == "is_not_null":
        e.is_not_null_expr.expr.CopyFrom(expr_to_proto(d["child"]))
        return e
    if k == "not":
        e.not_expr.expr.CopyFrom(expr_to_proto(d["child"]))
        return e
    if k == "case":
        for w, t in d["branches"]:
            wt = e.case_.when_then_expr.add()
            wt.when_expr.CopyFrom(expr_to_proto(w))
            wt.then_expr.CopyFrom(expr_to_proto(t))
        if d.get("else") is not None:
            e.case_.else_expr.CopyFrom(expr_to_proto(d["else"]))
        return e
    if k == "if":
        # if(c, a, b) is case [(c, a)] else b on the wire
        wt = e.case_.when_then_expr.add()
        wt.when_expr.CopyFrom(expr_to_proto(d["cond"]))
        wt.then_expr.CopyFrom(expr_to_proto(d["then"]))
        e.case_.else_expr.CopyFrom(expr_to_proto(d["else"]))
        return e
    if k == "coalesce":
        e.scalar_function.fun = pb.Coalesce
        e.scalar_function.name = "coalesce"
        for a in d["args"]:
            e.scalar_function.args.append(expr_to_proto(a))
        return e
    if k in ("cast", "try_cast"):
        node = e.cast if k == "cast" else e.try_cast
        node.expr.CopyFrom(expr_to_proto(d["child"]))
        node.arrow_type.CopyFrom(type_to_proto(d["type"]))
        return e
    if k == "in_list":
        e.in_list.expr.CopyFrom(expr_to_proto(d["child"]))
        e.in_list.negated = d.get("negated", False)
        for v in d["values"]:
            e.in_list.list.add().literal.CopyFrom(
                scalar_to_proto(v, _value_type(v)))
        return e
    raise NotImplementedError(f"expression kind {k!r} {_LATER}")


def _value_type(v: Any) -> Dict[str, Any]:
    """The type an in_list member travels as (the JAX package's rule)."""
    if isinstance(v, bool):
        return {"id": "bool"}
    if isinstance(v, int):
        return {"id": "int64"}
    if isinstance(v, float):
        return {"id": "float64"}
    if isinstance(v, bytes):
        return {"id": "binary"}
    return {"id": "utf8"}


def sort_spec_from_proto(e: pb.PhysicalExprNode) -> Dict[str, Any]:
    if e.WhichOneof("ExprType") != "sort":
        raise ValueError("expected PhysicalSortExprNode")
    s = e.sort
    return {"expr": expr_from_proto(s.expr), "descending": not s.asc,
            "nulls_first": s.nulls_first}


def sort_spec_to_proto(d: Dict[str, Any]) -> pb.PhysicalExprNode:
    e = pb.PhysicalExprNode()
    e.sort.expr.CopyFrom(expr_to_proto(d["expr"]))
    e.sort.asc = not d.get("descending", False)
    e.sort.nulls_first = d.get("nulls_first",
                               not d.get("descending", False))
    return e


# ---------------------------------------------------------------------------
# partitioning
# ---------------------------------------------------------------------------

def partitioning_from_proto(p: pb.PhysicalRepartition) -> Dict[str, Any]:
    kind = p.WhichOneof("RepartitionType")
    if kind == "single_repartition":
        return {"kind": "single"}
    if kind == "hash_repartition":
        h = p.hash_repartition
        return {"kind": "hash",
                "exprs": [expr_from_proto(e) for e in h.hash_expr],
                "num_partitions": int(h.partition_count)}
    raise NotImplementedError(f"repartition {kind!r} {_LATER}")


def partitioning_to_proto(d: Dict[str, Any]) -> pb.PhysicalRepartition:
    p = pb.PhysicalRepartition()
    k = d["kind"]
    if k == "single":
        p.single_repartition.partition_count = 1
        return p
    if k == "hash":
        p.hash_repartition.partition_count = d["num_partitions"]
        for e in d["exprs"]:
            p.hash_repartition.hash_expr.append(expr_to_proto(e))
        return p
    raise NotImplementedError(f"partitioning {k!r} {_LATER}")


# ---------------------------------------------------------------------------
# plan nodes
# ---------------------------------------------------------------------------

def _file_groups_from_conf(conf: pb.FileScanExecConf):
    """The wire carries ONE file group (this task's); rebuild the
    positional file_groups list so plan.execute(partition_index) finds it."""
    n = max(1, int(conf.num_partitions))
    idx = int(conf.partition_index)
    groups: List[List[str]] = [[] for _ in range(n)]
    groups[min(idx, n - 1)] = [f.path for f in conf.file_group.files]
    if conf.HasField("partition_schema") and \
            len(conf.partition_schema.columns):
        raise NotImplementedError(f"partition columns {_LATER}")
    return groups, schema_from_proto(conf.schema)


def plan_from_proto(n: pb.PhysicalPlanNode) -> Dict[str, Any]:
    kind = n.WhichOneof("PhysicalPlanType")
    if kind is None:
        raise ValueError("PhysicalPlanNode with no variant set")
    if kind == "parquet_scan":
        node = n.parquet_scan
        groups, schema = _file_groups_from_conf(node.base_conf)
        d: Dict[str, Any] = {"kind": kind, "schema": schema,
                             "file_groups": groups}
        if node.base_conf.projection:
            names = [f["name"] for f in schema["fields"]]
            d["projection"] = [names[i] for i in node.base_conf.projection]
        if node.pruning_predicates:
            raise NotImplementedError(f"scan pruning predicates {_LATER}")
        return d
    if kind == "ipc_reader":
        return {"kind": "ipc_reader",
                "resource_id": n.ipc_reader.ipc_provider_resource_id,
                "schema": schema_from_proto(n.ipc_reader.schema),
                "num_partitions": int(n.ipc_reader.num_partitions)}
    if kind == "shuffle_writer":
        sw = n.shuffle_writer
        return {"kind": "shuffle_writer",
                "input": plan_from_proto(sw.input),
                "partitioning":
                    partitioning_from_proto(sw.output_partitioning),
                "data_file": sw.output_data_file,
                "index_file": sw.output_index_file}
    if kind == "projection":
        pr = n.projection
        return {"kind": "project", "input": plan_from_proto(pr.input),
                "exprs": [expr_from_proto(e) for e in pr.expr],
                "names": list(pr.expr_name)}
    if kind == "filter":
        return {"kind": "filter", "input": plan_from_proto(n.filter.input),
                "predicates": [expr_from_proto(e) for e in n.filter.expr]}
    if kind == "sort":
        srt = n.sort
        d = {"kind": "sort", "input": plan_from_proto(srt.input),
             "specs": [sort_spec_from_proto(e) for e in srt.expr]}
        if srt.HasField("fetch_limit"):
            if srt.fetch_limit.offset:
                raise NotImplementedError("sort fetch offset")
            d["fetch"] = int(srt.fetch_limit.limit)
        return d
    if kind == "limit":
        d = {"kind": "limit", "input": plan_from_proto(n.limit.input),
             "limit": int(n.limit.limit)}
        if n.limit.offset:
            d["offset"] = int(n.limit.offset)
        return d
    if kind == "union":
        return {"kind": "union",
                "inputs": [plan_from_proto(i.input) for i in n.union.input],
                "input_partitions": [int(i.partition)
                                     for i in n.union.input],
                "num_partitions": int(n.union.num_partitions),
                "cur_partition": int(n.union.cur_partition)}
    if kind == "agg":
        return _agg_from_proto(n.agg)
    if kind in ("sort_merge_join", "hash_join", "broadcast_join"):
        return _join_from_proto(kind, n)
    if kind == "broadcast_join_build_hash_map":
        b = n.broadcast_join_build_hash_map
        return {"kind": "broadcast_join_build_hash_map",
                "input": plan_from_proto(b.input),
                "keys": [expr_from_proto(e) for e in b.keys]}
    if kind == "expand":
        ex = n.expand
        return {"kind": "expand", "input": plan_from_proto(ex.input),
                "projections": [[expr_from_proto(e) for e in p.expr]
                                for p in ex.projections],
                "names": [f.name for f in ex.schema.columns]}
    if kind == "window":
        return _window_from_proto(n.window)
    if kind == "rename_columns":
        return {"kind": "rename_columns",
                "input": plan_from_proto(n.rename_columns.input),
                "names": list(n.rename_columns.renamed_column_names)}
    if kind == "generate":
        return _generate_from_proto(n.generate)
    raise NotImplementedError(f"plan node {kind!r} {_LATER}")


def _generate_from_proto(g: pb.GenerateExecNode) -> Dict[str, Any]:
    func = g.generator.func
    if func not in (pb.Explode, pb.PosExplode):
        raise NotImplementedError(
            f"generator {pb.GenerateFunction.Name(func)} belongs to a later "
            f"slice of the PyTorch port (ROADMAP Queue 1 items 13 and 16)")
    gen = {"kind": "explode" if func == pb.Explode else "posexplode",
           "child": expr_from_proto(g.generator.child[0]), "outer": g.outer}
    return {"kind": "generate", "input": plan_from_proto(g.input),
            "generator": gen,
            "required_child_output": list(g.required_child_output)}


def _join_from_proto(kind: str, n: pb.PhysicalPlanNode) -> Dict[str, Any]:
    node = getattr(n, kind)
    d: Dict[str, Any] = {
        "kind": kind,
        "left": plan_from_proto(node.left),
        "right": plan_from_proto(node.right),
        "left_keys": [expr_from_proto(o.left) for o in node.on],
        "right_keys": [expr_from_proto(o.right) for o in node.on],
        "join_type": _JOIN_TYPE_DECODE[node.join_type],
    }
    if kind == "hash_join":
        d["build_side"] = ("left" if node.build_side == pb.LEFT_SIDE
                           else "right")
        if node.HasField("filter"):
            d["join_filter"] = expr_from_proto(node.filter.expression)
    elif kind == "broadcast_join":
        d["build_side"] = ("left" if node.broadcast_side == pb.LEFT_SIDE
                           else "right")
        if node.cached_build_hash_map_id:
            d["broadcast_id"] = node.cached_build_hash_map_id
        if node.is_null_aware_anti_join:
            d["null_aware_anti"] = True
        if not node.on:
            # a keyless broadcast join is the nested-loop join (see
            # plan_to_proto)
            d["kind"] = "broadcast_nested_loop_join"
    else:  # sort_merge_join
        if node.HasField("filter"):
            d["join_filter"] = expr_from_proto(node.filter.expression)
    return d


def _window_from_proto(w: pb.WindowExecNode) -> Dict[str, Any]:
    funcs = []
    for we in w.window_expr:
        name = we.field.name
        if we.func_type == pb.Agg:
            fn_name = _AGG_FN_DECODE.get(we.agg_func)
            if fn_name is None:
                raise ValueError(f"unsupported window agg {we.agg_func}")
            funcs.append({"kind": "agg", "fn": fn_name, "name": name,
                          "args": [expr_from_proto(c) for c in we.children]})
            continue
        wf = we.window_func
        if wf in _WINDOW_RANK_DECODE:
            funcs.append({"kind": _WINDOW_RANK_DECODE[wf], "name": name})
        elif wf == pb.LEAD:
            entry = {"kind": "lead", "name": name,
                     "expr": expr_from_proto(we.children[0])}
            if len(we.children) > 1:
                off, _ = scalar_from_proto(we.children[1].literal)
                entry["offset"] = off
                if off is not None and off < 0:  # a lag is a negative lead
                    entry["kind"] = "lag"
                    entry["offset"] = -off
            if len(we.children) > 2:
                entry["default"], _ = scalar_from_proto(
                    we.children[2].literal)
            funcs.append(entry)
        elif wf in (pb.NTH_VALUE, pb.NTH_VALUE_IGNORE_NULLS):
            entry = {"kind": "nth_value", "name": name,
                     "expr": expr_from_proto(we.children[0])}
            if len(we.children) > 1:
                entry["n"], _ = scalar_from_proto(we.children[1].literal)
            if wf == pb.NTH_VALUE_IGNORE_NULLS:
                entry["ignore_nulls"] = True
            funcs.append(entry)
        else:
            raise ValueError(f"unsupported window function {wf}")
    d: Dict[str, Any] = {"kind": "window",
                         "input": plan_from_proto(w.input),
                         "functions": funcs,
                         "partition_by": [expr_from_proto(e)
                                          for e in w.partition_spec],
                         "order_by": [sort_spec_from_proto(e)
                                      for e in w.order_spec]}
    if w.HasField("group_limit"):
        d["group_limit"] = int(w.group_limit.k)
    return d


def _agg_from_proto(agg: pb.AggExecNode) -> Dict[str, Any]:
    d: Dict[str, Any] = {
        "kind": ("hash_agg" if agg.exec_mode == pb.HASH_AGG else "sort_agg"),
        "input": plan_from_proto(agg.input),
    }
    d["groupings"] = [{"expr": expr_from_proto(e), "name": name}
                      for e, name in zip(agg.grouping_expr,
                                         agg.grouping_expr_name)]
    aggs = []
    # merge-mode acc columns are positional: groupings first, then each
    # agg's acc fields in order, starting at initial_input_buffer_offset
    acc_pos = len(d["groupings"]) + int(agg.initial_input_buffer_offset)
    for e, name, mode in zip(agg.agg_expr, agg.agg_expr_name, agg.mode):
        if e.WhichOneof("ExprType") != "agg_expr":
            raise ValueError("agg_expr entry is not a PhysicalAggExprNode")
        an = e.agg_expr
        fn_name = _AGG_FN_DECODE.get(an.agg_function)
        if fn_name is None:
            raise NotImplementedError(
                f"AggFunction {an.agg_function} belongs to a later slice of "
                f"the PyTorch port (ROADMAP Queue 1 items 11, 13 and 16)")
        mode_name = {pb.PARTIAL: "partial", pb.PARTIAL_MERGE: "partial_merge",
                     pb.FINAL: "final"}[mode]
        entry: Dict[str, Any] = {"fn": fn_name, "mode": mode_name,
                                 "name": name}
        n_acc = _ACC_FIELD_COUNT[fn_name]
        if mode_name == "partial":
            entry["args"] = [expr_from_proto(c) for c in an.children]
        else:
            entry["args"] = [{"kind": "column", "index": acc_pos + i}
                             for i in range(n_acc)]
        acc_pos += n_acc
        aggs.append(entry)
    d["aggs"] = aggs
    if agg.supports_partial_skipping:
        d["supports_partial_skipping"] = True
    if agg.initial_input_buffer_offset:
        d["initial_input_buffer_offset"] = \
            int(agg.initial_input_buffer_offset)
    return d


def plan_to_proto(d: Dict[str, Any]) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    k = d["kind"]
    if k == "parquet_scan":
        conf = n.parquet_scan.base_conf
        groups = d["file_groups"]
        non_empty = [i for i, g in enumerate(groups) if g]
        if len(non_empty) > 1:
            raise ValueError(
                "the wire carries ONE file group per task "
                "(FileScanExecConf); emit one TaskDefinition per partition")
        conf.num_partitions = len(groups)
        idx = non_empty[0] if non_empty else 0
        conf.partition_index = idx
        for path in groups[idx]:
            conf.file_group.files.add(path=path)
        conf.schema.CopyFrom(schema_to_proto(d["schema"]))
        if d.get("projection"):
            names = [f["name"] for f in d["schema"]["fields"]]
            for p in d["projection"]:
                conf.projection.append(names.index(p))
        if d.get("predicate") or d.get("partition_schema"):
            raise NotImplementedError(
                f"scan predicates and partition columns {_LATER}")
        return n
    if k == "ipc_reader":
        n.ipc_reader.ipc_provider_resource_id = d["resource_id"]
        n.ipc_reader.schema.CopyFrom(schema_to_proto(d["schema"]))
        n.ipc_reader.num_partitions = d.get("num_partitions", 1)
        return n
    if k == "shuffle_writer":
        n.shuffle_writer.input.CopyFrom(plan_to_proto(d["input"]))
        n.shuffle_writer.output_partitioning.CopyFrom(
            partitioning_to_proto(d["partitioning"]))
        n.shuffle_writer.output_data_file = d["data_file"]
        n.shuffle_writer.output_index_file = d["index_file"]
        return n
    if k == "project":
        n.projection.input.CopyFrom(plan_to_proto(d["input"]))
        for e in d["exprs"]:
            n.projection.expr.append(expr_to_proto(e))
        for name in d["names"]:
            n.projection.expr_name.append(name)
        return n
    if k == "filter":
        n.filter.input.CopyFrom(plan_to_proto(d["input"]))
        for e in d["predicates"]:
            n.filter.expr.append(expr_to_proto(e))
        return n
    if k == "sort":
        n.sort.input.CopyFrom(plan_to_proto(d["input"]))
        for spec in d["specs"]:
            n.sort.expr.append(sort_spec_to_proto(spec))
        if d.get("fetch") is not None:
            n.sort.fetch_limit.limit = d["fetch"]
        return n
    if k == "limit":
        n.limit.input.CopyFrom(plan_to_proto(d["input"]))
        n.limit.limit = d["limit"]
        n.limit.offset = d.get("offset", 0)
        return n
    if k == "union":
        for i, child in enumerate(d["inputs"]):
            inp = n.union.input.add()
            inp.input.CopyFrom(plan_to_proto(child))
            parts = d.get("input_partitions")
            inp.partition = parts[i] if parts else 0
        n.union.num_partitions = d.get("num_partitions", 1)
        n.union.cur_partition = d.get("cur_partition", 0)
        return n
    if k in ("hash_agg", "sort_agg"):
        return _agg_to_proto(d)
    if k in ("sort_merge_join", "hash_join", "broadcast_join"):
        return _join_to_proto(d)
    if k == "broadcast_nested_loop_join":
        # no wire node of its own (auron.proto PhysicalPlanType): a
        # KEYLESS broadcast_join is the nested-loop join, and decoding
        # reverses it.  That node has no filter field; for an inner join
        # a condition is a filter over the cross product, so it is lifted
        # into one; an outer join's would change which rows are
        # null-extended, and raises
        filt = d.get("join_filter")
        if filt is not None and d.get("join_type", "inner") != "inner":
            raise ValueError(
                "outer broadcast_nested_loop_join with a join_filter "
                "has no wire encoding (lifting would change "
                "null-extension semantics)")
        bare = {key: v for key, v in d.items() if key != "join_filter"}
        inner = _join_to_proto(dict(bare, kind="broadcast_join",
                                    left_keys=[], right_keys=[]))
        if filt is None:
            return inner
        n.filter.input.CopyFrom(inner)
        n.filter.expr.append(expr_to_proto(filt))
        return n
    if k == "broadcast_join_build_hash_map":
        n.broadcast_join_build_hash_map.input.CopyFrom(
            plan_to_proto(d["input"]))
        for e in d["keys"]:
            n.broadcast_join_build_hash_map.keys.append(expr_to_proto(e))
        return n
    if k == "expand":
        n.expand.input.CopyFrom(plan_to_proto(d["input"]))
        for proj in d["projections"]:
            p = n.expand.projections.add()
            for e in proj:
                p.expr.append(expr_to_proto(e))
        for name in d["names"]:
            n.expand.schema.columns.add(name=name)
        return n
    if k == "window":
        return _window_to_proto(d)
    if k == "rename_columns":
        n.rename_columns.input.CopyFrom(plan_to_proto(d["input"]))
        for name in d["names"]:
            n.rename_columns.renamed_column_names.append(name)
        return n
    if k == "generate":
        return _generate_to_proto(d)
    raise NotImplementedError(f"plan kind {k!r} {_LATER}")


def _generate_to_proto(d: Dict[str, Any]) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    g = n.generate
    g.input.CopyFrom(plan_to_proto(d["input"]))
    gen = d["generator"]
    gk = gen["kind"]
    if gk not in ("explode", "posexplode"):
        raise NotImplementedError(
            f"the {gk} generator belongs to a later slice of the PyTorch "
            f"port (ROADMAP Queue 1 items 13 and 16)")
    g.generator.func = pb.Explode if gk == "explode" else pb.PosExplode
    g.generator.child.append(expr_to_proto(gen["child"]))
    g.outer = gen.get("outer", False)
    req_names = d.get("required_child_output")
    if req_names is None:
        # the wire carries the kept columns by NAME: an index list
        # translates through the child's output names, and no list keeps
        # them all; a duplicated name cannot ride it and raises
        names = _output_names_of(d["input"])
        if d.get("required_cols") is not None:
            req_names = [names[i] for i in d["required_cols"]]
        else:
            req_names = list(names)
        dupes = {x for x in req_names if names.count(x) > 1}
        if dupes:
            raise ValueError(
                f"generate required columns {sorted(dupes)} are "
                f"ambiguous duplicate names; the wire carries names: "
                f"rename the child columns first")
    for name in req_names:
        g.required_child_output.append(name)
    return n


def _output_names_of(d: Dict[str, Any]) -> List[str]:
    """The output column names of a plan dict, without building its
    operators where the dict says them; the planner otherwise."""
    k = d.get("kind")
    if k == "parquet_scan":
        if d.get("projection"):
            return list(d["projection"])
        return [f["name"] for f in d["schema"]["fields"]]
    if k == "ipc_reader":
        return [f["name"] for f in d["schema"]["fields"]]
    if k in ("project", "filter_project", "rename_columns", "expand"):
        return list(d["names"])
    if k in ("filter", "limit", "sort", "local_exchange"):
        return _output_names_of(d["input"])
    from blaze_tpu_torch.plan.planner import create_plan
    return [f.name for f in create_plan(d).schema]


def _window_to_proto(d: Dict[str, Any]) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    w = n.window
    w.input.CopyFrom(plan_to_proto(d["input"]))
    for f in d["functions"]:
        we = w.window_expr.add()
        we.field.name = f["name"]
        fk = f["kind"]
        if fk == "agg":
            if f.get("running") is False and d.get("order_by"):
                # the wire carries no frame: an empty order_spec means the
                # whole partition, so a whole-partition agg WITH an order
                # would decode as a running one
                raise ValueError(
                    "whole-partition window agg frame with order_by has "
                    "no wire encoding; drop order_by (partition-sorted "
                    "input still groups correctly)")
            we.func_type = pb.Agg
            we.agg_func = _AGG_FN_ENCODE[f["fn"]]
            for c in f.get("args", []):
                we.children.append(expr_to_proto(c))
        elif fk in _WINDOW_RANK_ENCODE:
            we.func_type = pb.Window
            we.window_func = _WINDOW_RANK_ENCODE[fk]
        elif fk in ("lead", "lag"):
            we.func_type = pb.Window
            we.window_func = pb.LEAD
            we.children.append(expr_to_proto(f["expr"]))
            off = f.get("offset", 1)
            if fk == "lag":
                off = -off
            we.children.append(expr_to_proto(
                {"kind": "literal", "value": off, "type": {"id": "int64"}}))
            if f.get("default") is not None:
                we.children.append(expr_to_proto(
                    {"kind": "literal", "value": f["default"],
                     "type": _value_type(f["default"])}))
        elif fk == "nth_value":
            we.func_type = pb.Window
            we.window_func = (pb.NTH_VALUE_IGNORE_NULLS
                              if f.get("ignore_nulls") else pb.NTH_VALUE)
            we.children.append(expr_to_proto(f["expr"]))
            we.children.append(expr_to_proto(
                {"kind": "literal", "value": f.get("n", 1),
                 "type": {"id": "int64"}}))
        else:
            raise ValueError(f"cannot encode window function {fk!r}")
    for e in d.get("partition_by", []):
        w.partition_spec.append(expr_to_proto(e))
    for s in d.get("order_by", []):
        w.order_spec.append(sort_spec_to_proto(s))
    if d.get("group_limit") is not None:
        w.group_limit.k = d["group_limit"]
    w.output_window_cols = True
    return n


def _join_to_proto(d: Dict[str, Any]) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    k = d["kind"]
    node = getattr(n, k)
    node.left.CopyFrom(plan_to_proto(d["left"]))
    node.right.CopyFrom(plan_to_proto(d["right"]))
    for lk, rk in zip(d["left_keys"], d["right_keys"]):
        on = node.on.add()
        on.left.CopyFrom(expr_to_proto(lk))
        on.right.CopyFrom(expr_to_proto(rk))
    jt = d.get("join_type", "inner")
    if jt in ("right_semi", "right_anti"):
        # the wire has no right-sided semi/anti; front-ends swap children
        raise ValueError(f"{jt} has no wire encoding; swap the sides")
    node.join_type = _JOIN_TYPE_ENCODE[jt]
    if k == "hash_join":
        node.build_side = (pb.LEFT_SIDE
                           if d.get("build_side", "right") == "left"
                           else pb.RIGHT_SIDE)
        if d.get("join_filter"):
            node.filter.expression.CopyFrom(expr_to_proto(d["join_filter"]))
    elif k == "broadcast_join":
        node.broadcast_side = (pb.LEFT_SIDE
                               if d.get("build_side", "right") == "left"
                               else pb.RIGHT_SIDE)
        if d.get("broadcast_id"):
            node.cached_build_hash_map_id = d["broadcast_id"]
        node.is_null_aware_anti_join = d.get("null_aware_anti", False)
    else:
        if d.get("join_filter"):
            node.filter.expression.CopyFrom(expr_to_proto(d["join_filter"]))
        for _ in d["left_keys"]:
            node.sort_options.add(asc=True, nulls_first=True)
    return n


def _agg_to_proto(d: Dict[str, Any]) -> pb.PhysicalPlanNode:
    n = pb.PhysicalPlanNode()
    agg = n.agg
    agg.input.CopyFrom(plan_to_proto(d["input"]))
    agg.exec_mode = pb.HASH_AGG if d["kind"] == "hash_agg" else pb.SORT_AGG
    for g in d.get("groupings", []):
        agg.grouping_expr.append(expr_to_proto(g["expr"]))
        agg.grouping_expr_name.append(g["name"])
    for a in d.get("aggs", []):
        mode = a.get("mode", "partial")
        if mode == "complete":
            raise ValueError("complete agg mode has no wire encoding; "
                             "split into partial+final")
        agg.mode.append({"partial": pb.PARTIAL,
                         "partial_merge": pb.PARTIAL_MERGE,
                         "final": pb.FINAL}[mode])
        agg.agg_expr_name.append(a["name"])
        e = pb.PhysicalExprNode()
        e.agg_expr.agg_function = _AGG_FN_ENCODE[a["fn"]]
        for c in a.get("args", []):
            # merge modes carry placeholders; decode rebinds positionally
            e.agg_expr.children.append(expr_to_proto(
                c if mode == "partial" else
                {"kind": "literal", "value": None, "type": {"id": "null"}}))
        agg.agg_expr.append(e)
    agg.initial_input_buffer_offset = d.get("initial_input_buffer_offset", 0)
    agg.supports_partial_skipping = d.get("supports_partial_skipping", False)
    return n


# ---------------------------------------------------------------------------
# TaskDefinition
# ---------------------------------------------------------------------------

def task_definition_from_bytes(data: bytes) -> Dict[str, Any]:
    td = pb.TaskDefinition()
    td.ParseFromString(data)
    out: Dict[str, Any] = {
        "stage_id": int(td.task_id.stage_id),
        "partition_id": int(td.task_id.partition_id),
        "task_attempt_id": int(td.task_id.task_id),
        "plan": plan_from_proto(td.plan),
    }
    if td.HasField("output_partitioning"):
        out["output_partitioning"] = \
            partitioning_from_proto(td.output_partitioning)
    return out


def task_definition_to_bytes(td_dict: Dict[str, Any]) -> bytes:
    td = pb.TaskDefinition()
    td.task_id.stage_id = td_dict.get("stage_id", 0)
    td.task_id.partition_id = td_dict.get("partition_id", 0)
    td.task_id.task_id = td_dict.get("task_attempt_id", 0)
    td.plan.CopyFrom(plan_to_proto(td_dict["plan"]))
    if td_dict.get("output_partitioning"):
        td.output_partitioning.CopyFrom(
            partitioning_to_proto(td_dict["output_partitioning"]))
    return td.SerializeToString()
