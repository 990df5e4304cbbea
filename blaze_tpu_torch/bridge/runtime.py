"""Per-task execution runtime (port of NativeExecutionRuntime,
blaze_tpu/bridge/runtime.py).

One runtime per task attempt: it decodes the `TaskDefinition` (protobuf
bytes, JSON or an already-decoded dict), builds the operator tree, fuses
eligible aggregations and streams the root's output as Arrow record
batches.  Before fusing it rewrites the tree as the JAX package does:
`collapse_filter_project` (plan/planner.py), then `prune_columns`
(plan/column_pruning.py), so every scan reads only the columns the task
uses.  It runs synchronously on the caller's thread: `start()` only
resolves the device, `batches()` pulls the tree under a `task` span
(bridge/tracing.py) in the task's (stage, partition) trace context; the
scan and the shuffle reader prefetch on worker threads of their own
(ops/base.py).  The task's context carries the thread's serving query
(bridge/context.py `current_query`), whose cancellation its batch probes
raise.  The JAX package's producer thread and placement probe belong to
later slices.

The device is `auron.torch.device` (default "cuda"); asking for CUDA on a
machine without a visible card raises here, before any work starts.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional

import pyarrow as pa

from blaze_tpu_torch.bridge.context import TaskContext, task_scope
from blaze_tpu_torch.bridge.metrics import MetricNode
from blaze_tpu_torch.ops.base import ExecutionPlan


class NativeExecutionRuntime:
    """One runtime per task attempt."""

    def __init__(self, task_definition: Any,
                 plan: Optional[ExecutionPlan] = None):
        from blaze_tpu_torch.device import resolve
        from blaze_tpu_torch.plan import create_plan, decode_task_definition
        from blaze_tpu_torch.plan.column_pruning import prune_columns
        from blaze_tpu_torch.plan.fused import fuse_plan
        from blaze_tpu_torch.plan.planner import collapse_filter_project
        self.device = resolve()
        from blaze_tpu_torch.bridge.context import current_query
        td: Dict[str, Any] = decode_task_definition(task_definition)
        self.task = TaskContext(
            stage_id=td.get("stage_id", 0),
            partition_id=td.get("partition_id", 0),
            num_partitions=td.get("num_partitions", 1),
            task_attempt_id=td.get("task_attempt_id", 0),
            # built on the task's thread inside the service's query_scope:
            # the query rides the TaskContext into the prefetch threads
            query=current_query())
        self.plan = fuse_plan(prune_columns(collapse_filter_project(
            plan if plan is not None else create_plan(td["plan"]))))
        self._finalized = False

    def start(self) -> "NativeExecutionRuntime":
        return self

    def batches(self) -> Iterator[pa.RecordBatch]:
        """The root's non-empty output batches, in order."""
        from blaze_tpu_torch.bridge import tracing
        with task_scope(self.task), \
                tracing.execution_context(stage=self.task.stage_id,
                                          partition=self.task.partition_id), \
                tracing.span("task", mode="sync"):
            for rb in self.plan.arrow_batches(self.task.partition_id):
                if self._finalized:
                    return
                if rb.num_rows:
                    yield rb

    def finalize(self) -> MetricNode:
        self._finalized = True
        self.task.is_running = lambda: False
        return self.plan.collect_metrics()


def execute_plan(plan_or_td, partition: Optional[int] = None
                 ) -> List[pa.RecordBatch]:
    """Run one task to completion and return its batches (the
    NativeHelper.executeNativePlan analog of blaze_tpu/bridge/runtime.py
    `execute_plan`): a TaskDefinition (bytes, JSON or dict) runs as one
    task; an operator tree runs `partition`, or every partition in
    order."""
    if isinstance(plan_or_td, ExecutionPlan):
        parts = ([partition] if partition is not None
                 else range(plan_or_td.num_partitions))
        out: List[pa.RecordBatch] = []
        for p in parts:
            rt = NativeExecutionRuntime(
                {"stage_id": 0, "partition_id": p,
                 "num_partitions": plan_or_td.num_partitions},
                plan=plan_or_td).start()
            try:
                out.extend(rt.batches())
            finally:
                rt.finalize()
        return out
    rt = NativeExecutionRuntime(plan_or_td).start()
    try:
        return list(rt.batches())
    finally:
        rt.finalize()
