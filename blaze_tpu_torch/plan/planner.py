"""Physical planner: plan IR dicts -> operator trees, and the per-task
plan rewrite `collapse_filter_project` (port of the part of
blaze_tpu/plan/planner.py the port uses).

Node kinds: parquet_scan (with a pruning `predicate`, `partition_schema`
and per-file `partition_values`), memory_scan (an Arrow table from the
resource map), kafka_scan (a poll callback in the resource map, or the
node's inline mock records), ffi_reader, empty_partitions, filter, project,
filter_project, hash_agg, sort_agg, sort, limit, union, rename_columns,
expand, window, generate (explode, posexplode and json_tuple), debug,
coalesce_batches, shuffle_writer, local_exchange (an in-process
`LocalShuffleExchange`), ipc_reader, ipc_writer, broadcast_join,
sort_merge_join, hash_join, broadcast_nested_loop_join and
broadcast_join_build_hash_map, parquet_sink and orc_sink; partitionings:
hash, round_robin, single and range.  Every other kind raises NotImplementedError naming the
ROADMAP item it belongs to.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from blaze_tpu_torch.ops.agg import AggExec, AggExecMode, AggMode, make_agg
from blaze_tpu_torch.ops.base import CoalesceStream, ExecutionPlan
from blaze_tpu_torch.ops.basic import (DebugExec, EmptyPartitionsExec,
                                      ExpandExec, FilterExec,
                                      FilterProjectExec, LimitExec,
                                      ProjectExec, RenameColumnsExec,
                                      UnionExec)
from blaze_tpu_torch.ops.generate import (ExplodeGenerator, GenerateExec,
                                          JsonTupleGenerator)
from blaze_tpu_torch.ops.joins import (BroadcastJoinExec,
                                       BroadcastNestedLoopJoinExec,
                                       BuildHashMapExec, JoinType,
                                       ShuffledHashJoinExec,
                                       SortMergeJoinExec)
from blaze_tpu_torch.ops.scan import MemoryScanExec, ParquetScanExec
from blaze_tpu_torch.ops.sort import SortExec
from blaze_tpu_torch.ops.window import (LeadLagFunc, NthValueFunc, RankFunc,
                                        WindowAggFunc, WindowExec,
                                        WindowRankType)
from blaze_tpu_torch.plan.exprs import expr_from_dict, sort_spec_from_dict
from blaze_tpu_torch.plan.types import schema_from_dict
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.shuffle import (FFIReaderExec, HashPartitioning,
                                     IpcReaderExec, IpcWriterExec,
                                     LocalShuffleExchange, Partitioning,
                                     RangePartitioning,
                                     RoundRobinPartitioning,
                                     ShuffleWriterExec, SinglePartitioning)


#: node kinds of the JAX planner the port does not plan yet, with the
#: ROADMAP item each belongs to
_LATER_KINDS = dict.fromkeys(("orc_scan", "rss_shuffle_writer"), "item 16")


class CoalesceBatchesExec(ExecutionPlan):
    """Plan-addressable re-batching node (ref CoalesceStream auto-wrap,
    rt.rs:160-166) over the port's CoalesceStream.  Its target is
    `batch_size`, else `auron.batch.size`, halved per `shrink-capacity`
    rung of a degraded serving query (ops/base.py
    `effective_batch_size`)."""

    def __init__(self, child: ExecutionPlan, batch_size: Optional[int] = None):
        super().__init__([child])
        self._batch_size = batch_size

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int):
        return iter(CoalesceStream(self.children[0].execute(partition),
                                   self._batch_size, metrics=self.metrics))


def create_plan(d: Dict[str, Any]) -> ExecutionPlan:
    """Decode one plan node (and recursively its children)."""
    k = d["kind"]

    if k == "parquet_scan":
        schema = schema_from_dict(d["schema"])
        pred = (expr_from_dict(d["predicate"], schema)
                if d.get("predicate") else None)
        pschema = (schema_from_dict(d["partition_schema"])
                   if d.get("partition_schema") else None)
        return ParquetScanExec(schema, d["file_groups"],
                               projection=d.get("projection"),
                               predicate=pred, partition_schema=pschema,
                               partition_values=d.get("partition_values"))
    if k == "ipc_reader":
        return IpcReaderExec(d["resource_id"], schema_from_dict(d["schema"]),
                             d.get("num_partitions", 1))
    if k == "ffi_reader":
        return FFIReaderExec(d["resource_id"], schema_from_dict(d["schema"]),
                             d.get("num_partitions", 1))
    if k == "empty_partitions":
        return EmptyPartitionsExec(schema_from_dict(d["schema"]),
                                   d.get("num_partitions", 1))
    if k == "memory_scan":
        from blaze_tpu_torch.bridge.resource import get_resource
        table = get_resource(d["resource_id"])
        if table is None:
            raise KeyError(f"memory_scan resource {d['resource_id']!r}")
        return MemoryScanExec.from_arrow(table, d.get("num_partitions", 1))
    if k == "kafka_scan":
        return _create_kafka_scan(d)

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
                 "broadcast_join_build_hash_map", "debug",
                 "coalesce_batches", "ipc_writer", "parquet_sink",
                 "orc_sink"):
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
    if k == "debug":
        return DebugExec(child, d.get("tag", "debug"))
    if k == "coalesce_batches":
        return CoalesceBatchesExec(child, d.get("batch_size"))
    if k == "ipc_writer":
        from blaze_tpu_torch.bridge.resource import get_resource
        return IpcWriterExec(child, get_resource(d["sink_resource_id"]))
    if k == "generate":
        return _generate_from_dict(d, child)
    if k == "parquet_sink":
        from blaze_tpu_torch.ops.sink import ParquetSinkExec
        return ParquetSinkExec(child, _sink_path(d),
                               partition_cols=d.get("partition_cols"))
    if k == "orc_sink":
        from blaze_tpu_torch.ops.sink import OrcSinkExec
        return OrcSinkExec(child, _sink_path(d))
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
            aggs.append((make_agg(a["fn"], children,
                                  **a.get("options", {})),
                         AggMode(a.get("mode", "partial")), a["name"]))
        mode = (AggExecMode.HASH_AGG if k == "hash_agg"
                else AggExecMode.SORT_AGG)
        return AggExec(child, groups, aggs, mode,
                       skip_partial_hint=bool(
                           d.get("supports_partial_skipping")))
    part = partitioning_from_dict(d["partitioning"], in_schema)
    if k == "local_exchange":
        return LocalShuffleExchange(child, part,
                                    stage_id=d.get("stage_id", 0))
    return ShuffleWriterExec(child, part, d["data_file"], d["index_file"])


def _sink_path(d: Dict[str, Any]) -> str:
    """A sink's output: a direct `path`, else a host-registered FS
    resource (ref NativeParquetSinkUtils through the JVM resource map,
    jni_bridge.rs:452-453), else the resource id itself."""
    if d.get("path"):
        return d["path"]
    rid = d.get("fs_resource_id", "")
    from blaze_tpu_torch.bridge.resource import get_resource
    resolved = get_resource(rid)
    return resolved if resolved is not None else rid


def _create_kafka_scan(d: Dict[str, Any]) -> ExecutionPlan:
    """(ref flink/kafka_scan_exec.rs:81 + kafka_mock_scan_exec.rs) The
    protobuf format hands the decoded `format_config_json` dict to the
    deserializer as its message factory, as the JAX planner does: every
    record then decodes to a row of nulls (ROADMAP Queue 3)."""
    from blaze_tpu_torch.ops.kafka import (JsonDeserializer, KafkaRecord,
                                           KafkaScanExec, MockKafkaScanExec,
                                           PbDeserializer)
    schema = schema_from_dict(d["schema"])
    fmt = d.get("format", "json")
    if fmt == "json":
        deser = JsonDeserializer(schema)
    elif fmt == "protobuf":
        cfg = json.loads(d.get("format_config_json") or "{}")
        deser = PbDeserializer(schema, cfg)
    else:
        raise ValueError(f"unknown kafka format {fmt!r}")
    ts_field = d.get("event_time_field")
    mock = d.get("mock_data_json_array")
    if mock:
        rows = json.loads(mock)
        recs = [KafkaRecord(value=json.dumps(r).encode("utf-8"), offset=i)
                for i, r in enumerate(rows)]
        return MockKafkaScanExec(schema, deser, [recs],
                                 event_time_field=ts_field)
    source = d.get("operator_id") or d.get("topic")
    return KafkaScanExec(schema, deser, f"kafka://{source}",
                         d.get("num_partitions", 1),
                         event_time_field=ts_field)


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
    elif gk == "json_tuple":
        gen = JsonTupleGenerator(expr_from_dict(g["child"], in_schema),
                                 g["fields"])
    elif gk == "udtf":
        raise NotImplementedError(
            "the udtf generator belongs to a later slice of the PyTorch "
            "port (ROADMAP Queue 1 item 16)")
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
                                       IsNotNull, IsNull, Like, Literal, Not,
                                       RLike, StringPredicate)
    ok = (BoundReference, Literal, BinaryExpr, Not, IsNull, IsNotNull, If,
          CaseWhen, Coalesce, InList, Cast, Like, RLike, StringPredicate)
    return isinstance(e, ok) and all(_pure(c) for c in e.children())


def _substitute_all(outer, inner):
    """The outer expressions rewritten over the inner projection's input,
    or None to leave the two projections apart."""
    if not all(_pure(e) for e in inner):
        return None
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.exprs.fold import map_exprs

    def subst(e):
        if isinstance(e, BoundReference):
            return inner[e.index]
        return map_exprs(e, subst)

    try:
        return [subst(e) for e in outer]
    except (TypeError, IndexError):
        return None


def partitioning_from_dict(d: Dict[str, Any],
                           schema: Optional[Schema]) -> Partitioning:
    k = d["kind"]
    if k == "hash":
        return HashPartitioning([expr_from_dict(e, schema)
                                 for e in d["exprs"]], d["num_partitions"])
    if k == "round_robin":
        return RoundRobinPartitioning(d["num_partitions"])
    if k == "single":
        return SinglePartitioning()
    if k == "range":
        import base64
        import io

        import pyarrow as pa
        specs = [sort_spec_from_dict(s, schema) for s in d["specs"]]
        with pa.ipc.open_stream(io.BytesIO(
                base64.b64decode(d["bounds_ipc"]))) as r:
            bounds = next(iter(r))
        return RangePartitioning(specs, d["num_partitions"], bounds)
    raise ValueError(f"unknown partitioning kind {k!r}")


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
