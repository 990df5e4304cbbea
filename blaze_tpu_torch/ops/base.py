"""Execution operator base + the batch-coalescing stream (port of
blaze_tpu/ops/base.py).

Execution model: synchronous pull iterators of ColumnBatch per partition.
Operators keep a MetricNode of named counters; the JAX package's
automatic per-operator metering, tracing spans and prefetch threads are
not part of this slice.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, bucket_capacity
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.bridge.metrics import BASELINE_METRICS, MetricNode
from blaze_tpu_torch.schema import Schema

BatchIterator = Iterator[ColumnBatch]


class ExecutionPlan:
    """One physical operator node."""

    def __init__(self, children: Sequence["ExecutionPlan"] = ()):
        self._children: List[ExecutionPlan] = list(children)
        self.metrics = MetricNode(name=type(self).__name__)
        for m in BASELINE_METRICS:
            self.metrics.values.setdefault(m, 0)

    @property
    def children(self) -> List["ExecutionPlan"]:
        return self._children

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        """Output partition count."""
        if self._children:
            return self._children[0].num_partitions
        return 1

    @property
    def reexecutable(self) -> bool:
        """Whether execute(partition) can be called again from scratch
        (the port's sources are file-backed: yes).  The device stage loop
        (plan/stage_compiler.py) admits only stages whose source is
        re-executable, because its wholesale fallback re-runs the
        partition through the staged path.  A one-shot stream overrides
        this to False."""
        if self._children:
            return all(c.reexecutable for c in self._children)
        return True

    def execute(self, partition: int) -> BatchIterator:
        """Pull-stream of batches for one partition."""
        raise NotImplementedError

    def arrow_batches(self, partition: int):
        """Pull-stream of Arrow record batches (compacted, non-empty)."""
        for cb in self.execute(partition):
            cb = cb.compact()
            if cb.num_rows:
                yield cb.to_arrow()

    def execute_collect(self) -> ColumnBatch:
        """Every partition's batches, concatenated (the local mode's and
        the tests' collector)."""
        out = []
        for p in range(self.num_partitions):
            out.extend(self.execute(p))
        if not out:
            import pyarrow as pa
            return ColumnBatch.from_arrow(pa.Table.from_batches(
                [], schema=self.schema.to_arrow()))
        return ColumnBatch.concat(out)

    def collect_metrics(self) -> MetricNode:
        node = MetricNode(name=type(self).__name__,
                          values=dict(self.metrics.values))
        node.children = [c.collect_metrics() for c in self._children]
        return node

    def __repr__(self):
        head = type(self).__name__
        if not self._children:
            return head
        inner = ", ".join(repr(c) for c in self._children)
        return f"{head}({inner})"

    def pretty(self, indent: int = 0) -> str:
        """The tree, one operator class a line, two spaces a level (the
        text the plan-stability goldens hold)."""
        lines = ["  " * indent + type(self).__name__]
        for c in self._children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)


class CoalesceStream:
    """Re-batches a stream to ~batch_size dense rows, compacting batches
    whose surviving-row density is below `min_density` (same rules as the
    JAX package, so batch boundaries match)."""

    def __init__(self, stream: BatchIterator, batch_size: Optional[int] = None,
                 min_density: float = 0.5,
                 metrics: Optional[MetricNode] = None):
        self._stream = stream
        self._batch_size = batch_size or config.BATCH_SIZE.get()
        self._min_density = min_density
        self._metrics = metrics or MetricNode()

    def __iter__(self) -> BatchIterator:
        staged: List[ColumnBatch] = []
        staged_rows = 0
        ctx = current_task()
        target = self._batch_size
        for batch in self._stream:
            ctx.check_running()
            n = batch.selected_count()
            if n == 0:
                continue
            density = n / max(1, batch.capacity)
            if density < self._min_density:
                batch = batch.compact()
            if n >= target // 2 and not staged:
                yield batch
                continue
            staged.append(batch)
            staged_rows += n
            if staged_rows >= target:
                yield ColumnBatch.concat(staged,
                                         bucket_capacity(staged_rows))
                staged, staged_rows = [], 0
        if staged:
            yield ColumnBatch.concat(staged, bucket_capacity(staged_rows))
