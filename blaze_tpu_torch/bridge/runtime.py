"""Per-task execution runtime (port of NativeExecutionRuntime,
blaze_tpu/bridge/runtime.py).

One runtime per task attempt: it decodes the `TaskDefinition` (protobuf
bytes, JSON or an already-decoded dict), builds the operator tree, fuses
eligible aggregations and streams the root's output as Arrow record
batches.  Before fusing it rewrites the tree as the JAX package does:
`collapse_filter_project` (plan/planner.py), then `prune_columns`
(plan/column_pruning.py), so every scan reads only the columns the task
uses.  It runs synchronously on the caller's thread: `start()` only
resolves the device, `batches()` pulls the tree.  The JAX package's
producer thread and placement probe belong to later slices.

The device is `auron.torch.device` (default "cuda"); asking for CUDA on a
machine without a visible card raises here, before any work starts.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

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
        td: Dict[str, Any] = decode_task_definition(task_definition)
        self.task = TaskContext(
            stage_id=td.get("stage_id", 0),
            partition_id=td.get("partition_id", 0),
            num_partitions=td.get("num_partitions", 1),
            task_attempt_id=td.get("task_attempt_id", 0))
        self.plan = fuse_plan(prune_columns(collapse_filter_project(
            plan if plan is not None else create_plan(td["plan"]))))
        self._finalized = False

    def start(self) -> "NativeExecutionRuntime":
        return self

    def batches(self) -> Iterator[pa.RecordBatch]:
        """The root's non-empty output batches, in order."""
        with task_scope(self.task):
            for rb in self.plan.arrow_batches(self.task.partition_id):
                if self._finalized:
                    return
                if rb.num_rows:
                    yield rb

    def finalize(self) -> MetricNode:
        self._finalized = True
        self.task.is_running = lambda: False
        return self.plan.collect_metrics()
