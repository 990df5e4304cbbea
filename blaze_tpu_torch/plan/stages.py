"""Stage DAG scheduler: a whole multi-stage plan over the wire (port of the
core of blaze_tpu/plan/stages.py).

`DagScheduler` does what Spark's DAG scheduler and shuffle manager do
around the engine: it takes ONE plan-IR dict holding `local_exchange`
nodes, cuts it into stages, and runs every task of every stage as
protobuf TaskDefinition bytes through the port's NativeExecutionRuntime.

Two modes (`exec_mode`), as in the JAX scheduler:
  * "local": a query whose file scans total at most
    `auron.tpu.dag.singleTaskBytes` (64 MiB by default;
    `_scan_input_bytes`) runs as ONE task in this process
    (`_run_single_task`): the plan is built, collapsed, pruned and fused
    as a task's plan is, and each `local_exchange` runs as a
    `LocalShuffleExchange` (shuffle/exchange.py), whose files are removed
    after the run.  Its metrics are stage 0's.  A plan the local mode
    cannot build raises; it never drops back to the staged route;
  * "staged": everything larger, and everything when the key is 0.

Cutting rules of the staged route (`split`, `_split_node`):
  * a `local_exchange` makes its child a producer stage whose per-task plan
    is wrapped in a `shuffle_writer` (per-map `.data`/`.index` files); the
    consumer reads an `ipc_reader` bound to the producer's block map;
  * subtrees are not shared: a subtree referenced twice makes two stages;
    a union's `inputs` are walked like any child;
  * a scan carries ONE file group per task on the wire, except under a
    broadcast build side (of a broadcast join or a nested-loop join),
    where every task sees every file (`_per_task`).

Lineage recovery: a bad block raises FetchFailedError naming the producer
stage and map task; `run_collect` re-runs exactly that map task
(`_recover_map_output`) and resumes from the first stage that did not
complete, at most `auron.tpu.stage.maxRecoveries` rounds.  Every task runs
through bridge/tasks.py (bounded retries; a retry declines the device
stage loop).  `task_runs` counts how often each map task ran.

Each stage runs inside a `torch.profiler.record_function` range named
`STAGE_RANGE + str(sid)` and ends in a device synchronisation;
`stage_walls` holds its host-clock seconds.

Not ported, each raising where the JAX scheduler would take it: the
device-exchange, remote-shuffle, adaptive, subplan-cache, statistics,
history, worker-pool and speculation branches (ROADMAP items 14, 15 and
16): a conf key that turns one on raises.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import pyarrow as pa

from blaze_tpu_torch.bridge.metrics import MetricNode
from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
from blaze_tpu_torch.bridge.tasks import run_tasks
from blaze_tpu_torch.faults import FetchFailedError

_SCAN_KINDS = ("parquet_scan",)

#: prefix of the named range each stage runs in, followed by its id
STAGE_RANGE = "dag stage "


@dataclass
class Stage:
    sid: int
    plan: Dict[str, Any]          # stage-root IR (no shuffle_writer yet)
    partitioning: Optional[Dict[str, Any]]  # None for the result stage
    resource_id: Optional[str]
    num_tasks: int = 1            # producer-side task count
    deps: List[int] = field(default_factory=list)
    out_schema: Optional[Dict[str, Any]] = None


def _check_ported_branches() -> None:
    """Raise where a conf key turns on a scheduler branch the port lacks."""
    from blaze_tpu_torch import config
    for key, item in config.UNPORTED_SCHEDULER_KEYS.items():
        raw = config.conf.get_raw(key)
        if raw is not None and raw.strip().lower() not in (
                "", "0", "false", "no", "off", "auto"):
            raise NotImplementedError(
                f"{key}={raw!r}: that scheduler branch is not ported "
                f"(ROADMAP Queue 1 {item})")


class DagScheduler:
    """Split at exchanges, then run stages bottom-up over the proto wire."""

    def __init__(self, work_dir: Optional[str] = None):
        self._owns_dir = work_dir is None
        self._dir = work_dir or tempfile.mkdtemp(prefix="blaze-dag-")
        os.makedirs(self._dir, exist_ok=True)
        self._files: List[str] = []
        self._cleanup_lock = threading.Lock()
        self._run_id = uuid.uuid4().hex[:10]
        self.stages: List[Stage] = []
        self._resources: List[str] = []
        # sid -> {map_id -> (data_file, offsets)}: the MapOutputTracker
        # analog.  blocks_for reads THIS dict at call time, so a recovered
        # map task's fresh output is what a retried reduce task fetches
        self._stage_outputs: Dict[int, Dict[int, tuple]] = {}
        # (sid, map_id) -> times the map task's body ran
        self.task_runs: Dict[tuple, int] = {}
        # per-stage operator-metric trees, merged across the stage's tasks
        self.stage_metrics: Dict[int, MetricNode] = {}
        # sid -> host seconds of the stage's last run, ending in a device
        # synchronisation
        self.stage_walls: Dict[int, float] = {}
        self.exec_mode: Optional[str] = None  # "local" | "staged"

    def _record_task_metrics(self, sid: int, tree: MetricNode) -> None:
        self.stage_metrics.setdefault(
            sid, MetricNode(name=tree.name)).merge_from(tree)

    # -- splitting ---------------------------------------------------------

    def split(self, plan: Dict[str, Any]) -> List[Stage]:
        """Stages in dependency order; the last is the result stage."""
        self.stages = []
        root, deps = self._split_node(plan)
        n_tasks, schema = self._plan_info(root)
        self.stages.append(Stage(sid=len(self.stages), plan=root,
                                 partitioning=None, resource_id=None,
                                 deps=deps, num_tasks=n_tasks,
                                 out_schema=schema))
        return self.stages

    def _split_node(self, d: Dict[str, Any]):
        """Rewrite one node; returns (new_dict, dep_stage_ids)."""
        if not isinstance(d, dict) or "kind" not in d:
            return d, []
        if d["kind"] == "local_exchange":
            child, deps = self._split_node(d["input"])
            part = dict(d["partitioning"])
            n_out = 1 if part["kind"] == "single" \
                else int(part.get("num_partitions", 1))
            sid = len(self.stages)
            rid = f"stage://{self._run_id}/{sid}"
            n_tasks, schema = self._plan_info(child)
            self.stages.append(Stage(sid=sid, plan=child, partitioning=part,
                                     resource_id=rid, deps=deps,
                                     num_tasks=n_tasks, out_schema=schema))
            return {"kind": "ipc_reader", "resource_id": rid,
                    "schema": schema, "num_partitions": n_out}, [sid]
        out = dict(d)
        deps: List[int] = []
        for key, val in d.items():
            if isinstance(val, dict) and "kind" in val:
                out[key], sub = self._split_node(val)
                deps.extend(sub)
            elif key == "inputs" and isinstance(val, list):  # union
                subs = []
                for v in val:
                    nv, sub = self._split_node(v)
                    subs.append(nv)
                    deps.extend(sub)
                out[key] = subs
        return out, deps

    @staticmethod
    def _plan_info(d: Dict[str, Any]):
        """One planning pass per stage: (task count, output schema dict)."""
        from blaze_tpu_torch.plan import create_plan
        from blaze_tpu_torch.plan.types import schema_to_dict
        plan = create_plan(d)
        return max(1, plan.num_partitions), schema_to_dict(plan.schema)

    # -- per-task plan rewrite --------------------------------------------

    def _per_task(self, d, task: int, n_tasks: int,
                  in_broadcast: bool = False):
        if not isinstance(d, dict) or "kind" not in d:
            return d
        k = d["kind"]
        out = dict(d)
        if k in _SCAN_KINDS:
            groups = d.get("file_groups", [])
            new_groups: List[List[str]] = [[] for _ in range(n_tasks)]
            if in_broadcast:
                # a broadcast is a full copy: every task sees every file
                new_groups[task] = [f for g in groups for f in g]
            else:
                if len(groups) > n_tasks:
                    raise ValueError(
                        f"scan has {len(groups)} file groups but the stage "
                        f"runs {n_tasks} tasks; repartition the input")
                if task < len(groups):
                    new_groups[task] = list(groups[task])
            out["file_groups"] = new_groups
            return out
        if k in ("broadcast_join", "broadcast_nested_loop_join"):
            build = d.get("build_side", "right")
            for side in ("left", "right"):
                out[side] = self._per_task(d[side], task, n_tasks,
                                           in_broadcast or side == build)
            if "join_filter" in out and out["join_filter"] is None:
                del out["join_filter"]
            return out
        if k == "broadcast_join_build_hash_map":
            out["input"] = self._per_task(d["input"], task, n_tasks, True)
            return out
        for key, val in d.items():
            if isinstance(val, dict) and "kind" in val:
                out[key] = self._per_task(val, task, n_tasks, in_broadcast)
            elif key == "inputs" and isinstance(val, list):
                out[key] = [self._per_task(v, task, n_tasks, in_broadcast)
                            for v in val]
        return out

    # -- execution ---------------------------------------------------------

    @staticmethod
    def _part_of(stage: Stage) -> Dict[str, Any]:
        part = dict(stage.partitioning)
        if part["kind"] == "single":
            part = {"kind": "single", "num_partitions": 1}
        return part

    def _map_data_path(self, sid: int, m: int) -> str:
        return os.path.join(self._dir, f"s{self._run_id}-{sid}-{m}.data")

    def _map_task_def(self, stage: Stage, part: Dict[str, Any],
                      m: int) -> Dict[str, Any]:
        """The self-contained shuffle-writer TaskDefinition of one map
        task: absolute file paths and the task's plan slice."""
        data = self._map_data_path(stage.sid, m)
        plan = {"kind": "shuffle_writer", "partitioning": part,
                "data_file": data, "index_file": data[:-5] + ".index",
                "input": self._per_task(stage.plan, m, stage.num_tasks)}
        return {"stage_id": stage.sid, "partition_id": m,
                "num_partitions": stage.num_tasks, "task_attempt_id": 0,
                "plan": plan}

    def _run_map_task(self, stage: Stage, part: Dict[str, Any],
                      m: int) -> None:
        """One producer map task: plan -> shuffle_writer -> .data/.index
        (the writer commits by os.replace, so a recovery re-run replaces a
        poisoned output atomically)."""
        from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime
        from blaze_tpu_torch.plan.proto_serde import task_definition_to_bytes
        td = task_definition_to_bytes(self._map_task_def(stage, part, m))
        rt = NativeExecutionRuntime(td).start()
        try:
            for _ in rt.batches():
                pass
        finally:
            self._record_task_metrics(stage.sid, rt.finalize())
        self.task_runs[(stage.sid, m)] = \
            self.task_runs.get((stage.sid, m), 0) + 1

    def _read_map_output(self, stage: Stage, m: int, n_out: int) -> tuple:
        """Validated (data_file, offsets) of one map output; a bad index is
        re-raised carrying the producer's (stage, map) identity."""
        from blaze_tpu_torch.shuffle.exchange import read_index_file
        data = self._map_data_path(stage.sid, m)
        try:
            offsets = read_index_file(data[:-5] + ".index",
                                      expected_partitions=n_out,
                                      data_file=data)
        except FetchFailedError as e:
            raise FetchFailedError(stage.sid, m, e.reason) from e
        return data, offsets

    def _stage_scope(self, sid: int):
        """The stage's named profiler range; its wall, ending in a device
        synchronisation, goes to `stage_walls`."""
        import contextlib

        import torch
        from blaze_tpu_torch.device import resolve

        @contextlib.contextmanager
        def scope():
            t0 = time.perf_counter()
            with torch.profiler.record_function(STAGE_RANGE + str(sid)):
                yield
                if resolve().type == "cuda":
                    torch.cuda.synchronize()
            self.stage_walls[sid] = time.perf_counter() - t0
        return scope()

    def _run_producer_file(self, stage: Stage) -> None:
        from blaze_tpu_torch.shuffle.reader import FileSegmentBlock

        os.makedirs(self._dir, exist_ok=True)
        part = self._part_of(stage)
        n_out = int(part.get("num_partitions", 1))
        for m in range(stage.num_tasks):
            data = self._map_data_path(stage.sid, m)
            for p in (data, data[:-5] + ".index"):
                if p not in self._files:
                    self._files.append(p)
        with self._stage_scope(stage.sid):
            run_tasks(lambda m: self._run_map_task(stage, part, m),
                      stage.num_tasks, f"stage {stage.sid} (shuffle write)")
        self._stage_outputs[stage.sid] = {
            m: self._read_map_output(stage, m, n_out)
            for m in range(stage.num_tasks)}

        sid = stage.sid

        def blocks_for(reduce_id: int):
            # a live read of the output map, in map-id order: recovered
            # outputs are picked up, and the reduce input order stays the
            # same across recovery rounds
            outputs = self._stage_outputs[sid]
            for map_id in sorted(outputs):
                data, offsets = outputs[map_id]
                length = offsets[reduce_id + 1] - offsets[reduce_id]
                if length:
                    yield FileSegmentBlock(data, offsets[reduce_id], length,
                                           stage_id=sid, map_id=map_id)

        put_resource(stage.resource_id, blocks_for)
        if stage.resource_id not in self._resources:
            self._resources.append(stage.resource_id)

    # -- lineage recovery --------------------------------------------------

    def _recover_map_output(self, ff: FetchFailedError,
                            stages_by_id: Dict[int, Stage]) -> None:
        """Re-run exactly the map task that produced a poisoned block and
        republish its output (Spark's stage resubmission narrowed to one
        task: in-process there is no executor loss, so only the named
        output can be bad)."""
        stage = stages_by_id.get(ff.stage_id)
        if stage is None or stage.partitioning is None \
                or not 0 <= ff.map_id < stage.num_tasks:
            raise ff  # no lineage to recover from
        part = self._part_of(stage)
        run_tasks(lambda _i: self._run_map_task(stage, part, ff.map_id), 1,
                  f"stage {ff.stage_id} recovery (map {ff.map_id})")
        self._stage_outputs[stage.sid][ff.map_id] = self._read_map_output(
            stage, ff.map_id, int(part.get("num_partitions", 1)))

    # -- the single-task local mode -----------------------------------------

    @staticmethod
    def _scan_input_bytes(plan: Dict[str, Any]) -> int:
        """Total bytes of the files behind every scan of the plan; a file
        that cannot be stat'ed gives a sentinel above any threshold."""
        total = 0
        stack = [plan]
        while stack:
            d = stack.pop()
            if not isinstance(d, dict):
                continue
            if d.get("kind") in _SCAN_KINDS:
                for group in d.get("file_groups", []):
                    for p in group:
                        try:
                            total += os.path.getsize(p)
                        except (OSError, TypeError):
                            return 1 << 62
            for v in d.values():
                if isinstance(v, dict):
                    stack.append(v)
                elif isinstance(v, list):
                    stack.extend(x for x in v if isinstance(x, dict))
        return total

    def _run_single_task(self, plan: Dict[str, Any]) -> pa.Table:
        """The whole query as one task in this process, its exchanges
        `LocalShuffleExchange`s (the analog of Spark AQE's local shuffle
        reader on small queries, where per-stage fixed costs dominate);
        nothing crosses the wire.  The tree is built as a task's is
        (collapse, prune, fuse); its metrics are stage 0's."""
        from blaze_tpu_torch.bridge.context import TaskContext, task_scope
        from blaze_tpu_torch.plan import create_plan
        from blaze_tpu_torch.plan.column_pruning import prune_columns
        from blaze_tpu_torch.plan.fused import fuse_plan
        from blaze_tpu_torch.plan.planner import collapse_filter_project
        from blaze_tpu_torch.shuffle import LocalShuffleExchange

        node = fuse_plan(prune_columns(
            collapse_filter_project(create_plan(plan))))
        try:
            with self._stage_scope(0), task_scope(TaskContext()):
                out = node.execute_collect().to_arrow()
        finally:
            self._record_task_metrics(0, node.collect_metrics())
            stack = [node]
            while stack:
                n = stack.pop()
                if isinstance(n, LocalShuffleExchange):
                    n.cleanup()
                stack.extend(n.children)
        return pa.Table.from_batches([out])

    def run_collect(self, plan: Dict[str, Any]) -> pa.Table:
        """Execute the whole query; returns the result stage's output."""
        return self._run_collect(plan)

    def _run_collect(self, plan: Dict[str, Any]) -> pa.Table:
        from blaze_tpu_torch import config
        from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime
        from blaze_tpu_torch.plan.proto_serde import task_definition_to_bytes
        from blaze_tpu_torch.plan.types import schema_from_dict

        _check_ported_branches()
        self.stage_metrics = {}  # an instance may be reused per query
        self.stage_walls = {}
        self.task_runs = {}
        threshold = config.DAG_SINGLE_TASK_BYTES.get()
        if threshold > 0 and self._scan_input_bytes(plan) <= threshold:
            self.exec_mode = "local"
            self.stages = []
            try:
                return self._run_single_task(plan)
            finally:
                self.cleanup()
        self.exec_mode = "staged"
        os.makedirs(self._dir, exist_ok=True)
        stages = self.split(plan)
        stages_by_id = {st.sid: st for st in stages}
        max_recoveries = max(0, config.STAGE_MAX_RECOVERIES.get())
        try:
            result = stages[-1]
            out_schema = schema_from_dict(result.out_schema).to_arrow()

            def run_result(p: int) -> List[pa.RecordBatch]:
                td = task_definition_to_bytes(
                    {"stage_id": result.sid, "partition_id": p,
                     "num_partitions": result.num_tasks,
                     "plan": self._per_task(result.plan, p,
                                            result.num_tasks)})
                rt = NativeExecutionRuntime(td).start()
                try:
                    return list(rt.batches())
                finally:
                    self._record_task_metrics(result.sid, rt.finalize())

            # bounded lineage recovery: a FetchFailedError anywhere names
            # the producer map task whose output is poisoned; re-run just
            # that task, then resume from the first stage that never
            # completed
            completed: set = set()
            recoveries = 0
            while True:
                try:
                    for st in stages[:-1]:
                        if st.sid not in completed:
                            self._run_producer_file(st)
                            completed.add(st.sid)
                    with self._stage_scope(result.sid):
                        parts = run_tasks(run_result, result.num_tasks,
                                          f"stage {result.sid} (result)")
                    break
                except FetchFailedError as ff:
                    recoveries += 1
                    if recoveries > max_recoveries:
                        raise FetchFailedError(
                            ff.stage_id, ff.map_id,
                            f"{ff.reason} (gave up after "
                            f"{max_recoveries} recovery rounds)") from ff
                    self._recover_map_output(ff, stages_by_id)
            batches = [b for bl in parts for b in bl if b.num_rows]
            if not batches:
                return out_schema.empty_table()
            return pa.Table.from_batches(batches)
        finally:
            self.cleanup()

    def cleanup(self) -> None:
        """Idempotent and safe under concurrent callers: state lists are
        swapped out under a lock, so each resource and file is released
        exactly once."""
        lock = getattr(self, "_cleanup_lock", None)
        if lock is None:
            return
        with lock:
            resources, self._resources = self._resources, []
            files, self._files = self._files, []
            self._stage_outputs = {}
        for rid in resources:
            remove_resource(rid)
        for path in files:
            try:
                os.unlink(path)
            except OSError:
                pass
        if self._owns_dir:
            # recreated by the next run if the instance is reused
            shutil.rmtree(self._dir, ignore_errors=True)

    def leak_report(self) -> Dict[str, List[str]]:
        """What this scheduler still holds: shuffle files on disk,
        resource-map entries and the owned scratch dir.  Empty lists
        everywhere: nothing leaked."""
        from blaze_tpu_torch.bridge.resource import get_resource
        report: Dict[str, List[str]] = {"files": [], "resources": [],
                                        "dirs": []}
        with self._cleanup_lock:
            files = list(self._files)
            resources = list(self._resources)
        report["files"] = [p for p in files if os.path.exists(p)]
        report["resources"] = [r for r in resources
                               if get_resource(r) is not None]
        if self._owns_dir and os.path.isdir(self._dir):
            leftovers = [os.path.join(self._dir, f)
                         for f in os.listdir(self._dir)]
            if leftovers:
                report["dirs"].append(self._dir)
                report["files"].extend(leftovers)
        return report

    def __enter__(self) -> "DagScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.cleanup()

    def __del__(self) -> None:
        # last-resort backstop for a scheduler dropped before run_collect
        # reached its finally; never raises at interpreter shutdown
        try:
            self.cleanup()
        except Exception:
            pass

    def describe(self) -> str:
        lines = []
        for st in self.stages:
            kind = "result" if st.partitioning is None else \
                st.partitioning["kind"]
            lines.append(f"stage {st.sid}: tasks={st.num_tasks} "
                         f"out={kind} deps={st.deps}")
        return "\n".join(lines)
