"""Physical planner: plan IR dicts -> operator trees, and the per-task
plan rewrite `collapse_filter_project` (port of the part of
blaze_tpu/plan/planner.py the port uses).

Node kinds: parquet_scan, filter, project, filter_project, hash_agg,
sort_agg, sort, limit, union, rename_columns, expand, window, generate
(explode and posexplode), shuffle_writer, local_exchange (an in-process
`LocalShuffleExchange`), ipc_reader, broadcast_join, sort_merge_join,
hash_join, broadcast_nested_loop_join and broadcast_join_build_hash_map.
Every other kind raises NotImplementedError naming the ROADMAP item it
belongs to.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from blaze_tpu_torch.ops.agg import AggExec, AggExecMode, AggMode, make_agg
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import (ExpandExec, FilterExec,
                                      FilterProjectExec, LimitExec,
                                      ProjectExec, RenameColumnsExec,
                                      UnionExec)
from blaze_tpu_torch.ops.generate import ExplodeGenerator, GenerateExec
from blaze_tpu_torch.ops.joins import (BroadcastJoinExec,
                                       BroadcastNestedLoopJoinExec,
                                       BuildHashMapExec, JoinType,
                                       ShuffledHashJoinExec,
                                       SortMergeJoinExec)
from blaze_tpu_torch.ops.scan import ParquetScanExec
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.ops.window import (LeadLagFunc, NthValueFunc, RankFunc,
                                        WindowAggFunc, WindowExec,
                                        WindowRankType)
from blaze_tpu_torch.plan.exprs import expr_from_dict, sort_spec_from_dict
from blaze_tpu_torch.plan.types import schema_from_dict
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.shuffle import (HashPartitioning, IpcReaderExec,
                                     LocalShuffleExchange, Partitioning,
                                     ShuffleWriterExec, SinglePartitioning)


#: node kinds of the JAX planner the port does not plan yet, with the
#: ROADMAP item each belongs to
_LATER_KINDS = {
    **dict.fromkeys(("coalesce_batches", "empty_partitions", "debug",
                     "memory_scan", "ffi_reader"), "item 4"),
    **dict.fromkeys(("parquet_sink", "orc_sink", "ipc_writer", "orc_scan",
                     "kafka_scan", "rss_shuffle_writer"), "item 16"),
}


def create_plan(d: Dict[str, Any]) -> ExecutionPlan:
    """Decode one plan node (and recursively its children)."""
    k = d["kind"]

    if k == "parquet_scan":
        if d.get("predicate") or d.get("partition_schema"):
            raise NotImplementedError(
                "parquet predicate pruning and partition columns belong to "
                "a later slice of the PyTorch port (ROADMAP Queue 1 item 4)")
        return ParquetScanExec(schema_from_dict(d["schema"]),
                               d["file_groups"],
                               projection=d.get("projection"))
    if k == "ipc_reader":
        return IpcReaderExec(d["resource_id"], schema_from_dict(d["schema"]),
                             d.get("num_partitions", 1))

    if k in ("sort_merge_join", "hash_join", "broadcast_join"):
        return _join_from_dict(d)
    if k == "broadcast_nested_loop_join":
        flt = (expr_from_dict(d["join_filter"])
               if d.get("join_filter") else None)  # on the joined schema
        return BroadcastNestedLoopJoinExec(
            create_plan(d["left"]), create_plan(d["right"]),
            JoinType(d.get("join_type", "inner")),
            build_side=d.get("build_side", "right"), join_filter=flt,
            broadcast_id=d.get("broadcast_id"))
    if k == "union":
        return UnionExec([create_plan(c) for c in d["inputs"]])

    if k in _LATER_KINDS:
        raise NotImplementedError(
            f"plan node kind {k!r} belongs to a later slice of the PyTorch "
            f"port (ROADMAP {_LATER_KINDS[k]})")
    if k not in ("filter", "project", "filter_project", "hash_agg",
                 "sort_agg", "sort", "limit", "rename_columns", "expand",
                 "window", "generate", "shuffle_writer", "local_exchange",
                 "broadcast_join_build_hash_map"):
        raise ValueError(f"unknown plan node kind {k!r}")
    child = create_plan(d["input"])
    in_schema = child.schema

    if k == "filter":
        return FilterExec(child, [expr_from_dict(p, in_schema)
                                  for p in d["predicates"]])
    if k == "project":
        return ProjectExec(child, [expr_from_dict(e, in_schema)
                                   for e in d["exprs"]], d["names"])
    if k == "filter_project":
        return FilterProjectExec(
            child, [expr_from_dict(p, in_schema) for p in d["predicates"]],
            [expr_from_dict(e, in_schema) for e in d["exprs"]], d["names"])
    if k == "rename_columns":
        return RenameColumnsExec(child, d["names"])
    if k == "generate":
        return _generate_from_dict(d, child)
    if k == "sort":
        specs = [sort_spec_from_dict(s, in_schema) for s in d["specs"]]
        return SortExec(child, specs, fetch=d.get("fetch"))
    if k == "limit":
        return LimitExec(child, d["limit"], offset=d.get("offset", 0))
    if k == "expand":
        return ExpandExec(child, [[expr_from_dict(e, in_schema) for e in p]
                                  for p in d["projections"]], d["names"])
    if k == "window":
        return _window_from_dict(d, child)
    if k == "broadcast_join_build_hash_map":
        return BuildHashMapExec(child, [expr_from_dict(e, in_schema)
                                        for e in d["keys"]])
    if k in ("hash_agg", "sort_agg"):
        groups = [(expr_from_dict(g["expr"], in_schema), g["name"])
                  for g in d.get("groupings", [])]
        aggs = []
        for a in d.get("aggs", []):
            children = [expr_from_dict(c, in_schema)
                        for c in a.get("args", [])]
            aggs.append((make_agg(a["fn"], children),
                         AggMode(a.get("mode", "partial")), a["name"]))
        mode = (AggExecMode.HASH_AGG if k == "hash_agg"
                else AggExecMode.SORT_AGG)
        return AggExec(child, groups, aggs, mode)
    part = partitioning_from_dict(d["partitioning"], in_schema)
    if k == "local_exchange":
        return LocalShuffleExchange(child, part,
                                    stage_id=d.get("stage_id", 0))
    return ShuffleWriterExec(child, part, d["data_file"], d["index_file"])


def _join_from_dict(d: Dict[str, Any]) -> ExecutionPlan:
    k = d["kind"]
    left = create_plan(d["left"])
    right = create_plan(d["right"])
    lkeys = [expr_from_dict(e, left.schema) for e in d["left_keys"]]
    rkeys = [expr_from_dict(e, right.schema) for e in d["right_keys"]]
    jt = JoinType(d.get("join_type", "inner"))
    flt = None
    if d.get("join_filter"):
        flt = expr_from_dict(d["join_filter"])  # bound on the joined schema
    cls = {"sort_merge_join": SortMergeJoinExec,
           "hash_join": ShuffledHashJoinExec,
           "broadcast_join": BroadcastJoinExec}[k]
    kw = dict(build_side=d.get("build_side", "right"), join_filter=flt,
              null_aware_anti=d.get("null_aware_anti", False))
    if k == "broadcast_join" and d.get("broadcast_id"):
        kw["broadcast_id"] = d["broadcast_id"]
        # a build-map stage on the broadcast side shares its map with this
        # join through the cache id
        build = right if d.get("build_side", "right") == "right" else left
        if isinstance(build, BuildHashMapExec):
            build.cache_id = d["broadcast_id"]
    return cls(left, right, lkeys, rkeys, jt, **kw)


def _generate_from_dict(d: Dict[str, Any],
                        child: ExecutionPlan) -> GenerateExec:
    in_schema = child.schema
    g = d["generator"]
    gk = g["kind"]
    if gk in ("explode", "posexplode"):
        gen = ExplodeGenerator(expr_from_dict(g["child"], in_schema),
                               position=(gk == "posexplode"),
                               outer=g.get("outer", False))
    elif gk in ("json_tuple", "udtf"):
        item = "item 13" if gk == "json_tuple" else "item 16"
        raise NotImplementedError(
            f"the {gk} generator belongs to a later slice of the PyTorch "
            f"port (ROADMAP Queue 1 {item})")
    else:
        raise ValueError(f"unknown generator kind {gk!r}")
    required = d.get("required_cols")
    if required is None and d.get("required_child_output") is not None:
        required = [in_schema.index_of(nm)
                    for nm in d["required_child_output"]]
    return GenerateExec(child, gen, required)


def _window_from_dict(d: Dict[str, Any], child: ExecutionPlan) -> WindowExec:
    in_schema = child.schema
    funcs = []
    for w in d["functions"]:
        wk = w["kind"]
        if wk in [t.value for t in WindowRankType]:
            funcs.append(RankFunc(w["name"], WindowRankType(wk)))
        elif wk in ("lead", "lag"):
            off = w.get("offset", 1)
            funcs.append(LeadLagFunc(
                w["name"], expr_from_dict(w["expr"], in_schema),
                off if wk == "lead" else -off, w.get("default")))
        elif wk == "nth_value":
            funcs.append(NthValueFunc(
                w["name"], expr_from_dict(w["expr"], in_schema),
                w.get("n", 1), ignore_nulls=w.get("ignore_nulls", False)))
        elif wk == "agg":
            children = [expr_from_dict(c, in_schema)
                        for c in w.get("args", [])]
            funcs.append(WindowAggFunc(w["name"], make_agg(w["fn"], children),
                                       running=w.get("running", True)))
        else:
            raise ValueError(f"unknown window function kind {wk!r}")
    part = [expr_from_dict(e, in_schema) for e in d.get("partition_by", [])]
    order = [sort_spec_from_dict(s, in_schema)
             for s in d.get("order_by", [])]
    return WindowExec(child, funcs, part, order,
                      group_limit=d.get("group_limit"))


def collapse_filter_project(node: ExecutionPlan) -> ExecutionPlan:
    """Per-task plan rewrite: merge each Filter under a Project into one
    `FilterProjectExec`, and a Project over a Project into one Project by
    substituting the inner expressions for the outer's column references.
    Runs before prune_columns and fuse_plan, which both read
    FilterProjectExec.  Off under `auron.tpu.plan.collapseFilterProject`
    = false."""
    from blaze_tpu_torch import config
    if not config.COLLAPSE_FILTER_PROJECT.get():
        return node
    return _collapse(node)


def _collapse(node: ExecutionPlan) -> ExecutionPlan:
    kids = node.children
    for i, c in enumerate(kids):
        kids[i] = _collapse(c)
    if isinstance(node, ProjectExec):
        child = node.children[0]
        if isinstance(child, FilterExec):
            return FilterProjectExec(child.children[0], child._predicates,
                                     node._exprs, node._names)
        if isinstance(child, ProjectExec):
            merged = _substitute_all(node._exprs, child._exprs)
            if merged is not None:
                return ProjectExec(child.children[0], merged, node._names)
    return node


def _pure(e) -> bool:
    """Whether `e` may be duplicated when an inner projection substitutes
    into several outer references: it and every child are among the
    value-only expression classes the port has."""
    from blaze_tpu_torch.exprs import (BinaryExpr, BoundReference, CaseWhen,
                                       Cast, Coalesce, If, InList,
                                       IsNotNull, IsNull, Literal, Not)
    ok = (BoundReference, Literal, BinaryExpr, Not, IsNull, IsNotNull, If,
          CaseWhen, Coalesce, InList, Cast)
    return isinstance(e, ok) and all(_pure(c) for c in e.children())


def _substitute_all(outer, inner):
    """The outer expressions rewritten over the inner projection's input,
    or None to leave the two projections apart."""
    if not all(_pure(e) for e in inner):
        return None
    from blaze_tpu_torch.exprs import BoundReference

    def subst(e):
        if isinstance(e, BoundReference):
            return inner[e.index]
        return map_children(e, subst)

    try:
        return [subst(e) for e in outer]
    except (TypeError, IndexError):
        return None


def map_children(e, fn):
    """`e` rebuilt with `fn` applied to each direct expression child (a
    field, or an element of a tuple or list field, as CaseWhen's
    branches); TypeError for an expression that is not a dataclass."""
    import dataclasses

    from blaze_tpu_torch.exprs import PhysicalExpr
    if not dataclasses.is_dataclass(e):
        raise TypeError(f"cannot rebuild {type(e).__name__}")

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


def partitioning_from_dict(d: Dict[str, Any],
                           schema: Optional[Schema]) -> Partitioning:
    k = d["kind"]
    if k == "hash":
        return HashPartitioning([expr_from_dict(e, schema)
                                 for e in d["exprs"]], d["num_partitions"])
    if k == "single":
        return SinglePartitioning()
    raise NotImplementedError(
        f"{k!r} partitioning belongs to a later slice of the PyTorch port "
        f"(ROADMAP Queue 1 item 3)")


def decode_task_definition(data) -> Dict[str, Any]:
    """Accepts a dict (already decoded), a JSON string/bytes, or raw
    protobuf `TaskDefinition` bytes."""
    if isinstance(data, (bytes, bytearray)):
        data = bytes(data)
        if data.lstrip()[:1] in (b"{", b"["):  # JSON IR
            data = data.decode("utf-8")
        else:
            from blaze_tpu_torch.plan.proto_serde import \
                task_definition_from_bytes
            return task_definition_from_bytes(data)
    if isinstance(data, str):
        data = json.loads(data)
    return data
