"""Physical planner: plan IR dicts -> operator trees (port of the part of
blaze_tpu/plan/planner.py this slice uses).

Node kinds: parquet_scan, filter, project, hash_agg, sort_agg, sort,
limit, expand, window, shuffle_writer, ipc_reader, broadcast_join,
sort_merge_join, hash_join and broadcast_join_build_hash_map.  Every
other kind (generate, the nested-loop join, union, ...) raises
NotImplementedError naming the slice it belongs to.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from blaze_tpu_torch.ops.agg import AggExec, AggExecMode, AggMode, make_agg
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import (ExpandExec, FilterExec, LimitExec,
                                      ProjectExec)
from blaze_tpu_torch.ops.joins import (BroadcastJoinExec, BuildHashMapExec,
                                       JoinType, ShuffledHashJoinExec,
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
                                     Partitioning, ShuffleWriterExec,
                                     SinglePartitioning)


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

    if k not in ("filter", "project", "hash_agg", "sort_agg", "sort",
                 "limit", "expand", "window", "shuffle_writer",
                 "broadcast_join_build_hash_map"):
        item = "12" if k == "generate" else "3"
        raise NotImplementedError(
            f"plan node kind {k!r} belongs to a later slice of the PyTorch "
            f"port (ROADMAP Queue 1 item {item})")
    child = create_plan(d["input"])
    in_schema = child.schema

    if k == "filter":
        return FilterExec(child, [expr_from_dict(p, in_schema)
                                  for p in d["predicates"]])
    if k == "project":
        return ProjectExec(child, [expr_from_dict(e, in_schema)
                                   for e in d["exprs"]], d["names"])
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
