"""Filter, Project, FilterProject, Limit, Union, RenameColumns, Expand,
EmptyPartitions and Debug (port of FilterExec, ProjectExec,
FilterProjectExec, LimitExec, UnionExec, RenameColumnsExec, ExpandExec,
EmptyPartitionsExec and DebugExec, blaze_tpu/ops/basic.py).

A filter ANDs its predicates into the batch's selection mask and never
compacts; CoalesceStream re-batches.  On the q01 path both operators are
absorbed into the fused aggregation (plan/fused.py), which evaluates the
same expressions inside its step.  `FilterProjectExec` is the planner's
collapse of a Filter under a Project (plan/planner.py
`collapse_filter_project`): it filters, projects and re-batches, so its
batches are the ones the two operators would emit.  `DebugExec` passes
its child's batches through and logs one INFO line a batch to the logger
`blaze_tpu_torch.debug`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from blaze_tpu_torch.batch import ColumnBatch, bucket_capacity
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.base import BatchIterator, CoalesceStream, ExecutionPlan
from blaze_tpu_torch.schema import Field, Schema


def apply_filter(batch: ColumnBatch,
                 predicates: Sequence[PhysicalExpr]) -> ColumnBatch:
    """AND every predicate's mask (NULL counts as False) into the batch's
    selection."""
    m = None
    for p in predicates:
        pm = p.evaluate(batch).as_mask(batch)
        m = pm if m is None else (m & pm)
    return batch if m is None else batch.with_selection(m)


def apply_project(batch: ColumnBatch, exprs: Sequence[PhysicalExpr],
                  out_schema: Schema) -> ColumnBatch:
    cap = batch.capacity
    cols = [e.evaluate(batch).to_column(cap, batch.device) for e in exprs]
    return ColumnBatch(out_schema, cols, batch.num_rows, batch.selection)


class FilterExec(ExecutionPlan):
    """Selection-mask filter."""

    def __init__(self, child: ExecutionPlan,
                 predicates: Sequence[PhysicalExpr]):
        super().__init__([child])
        self._predicates = list(predicates)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        def gen():
            for batch in self.children[0].execute(partition):
                yield apply_filter(batch, self._predicates)
        return iter(CoalesceStream(gen(), metrics=self.metrics))


class ProjectExec(ExecutionPlan):
    def __init__(self, child: ExecutionPlan,
                 exprs: Sequence[PhysicalExpr], names: Sequence[str]):
        super().__init__([child])
        self._exprs = list(exprs)
        self._names = list(names)
        self._out_schema: Optional[Schema] = None

    @property
    def schema(self) -> Schema:
        if self._out_schema is None:
            in_schema = self.children[0].schema
            self._out_schema = Schema([
                Field(n, e.data_type(in_schema)) for n, e in
                zip(self._names, self._exprs)])
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        out_schema = self.schema
        for batch in self.children[0].execute(partition):
            yield apply_project(batch, self._exprs, out_schema)


class FilterProjectExec(ExecutionPlan):
    """A filter and the projection above it in one operator."""

    def __init__(self, child: ExecutionPlan,
                 predicates: Sequence[PhysicalExpr],
                 exprs: Sequence[PhysicalExpr], names: Sequence[str]):
        super().__init__([child])
        self._predicates = list(predicates)
        self._exprs = list(exprs)
        self._names = list(names)
        self._out_schema: Optional[Schema] = None

    @property
    def schema(self) -> Schema:
        if self._out_schema is None:
            in_schema = self.children[0].schema
            self._out_schema = Schema([
                Field(n, e.data_type(in_schema)) for n, e in
                zip(self._names, self._exprs)])
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        out_schema = self.schema

        def gen():
            for batch in self.children[0].execute(partition):
                yield apply_project(apply_filter(batch, self._predicates),
                                    self._exprs, out_schema)
        return iter(CoalesceStream(gen(), metrics=self.metrics))


class UnionExec(ExecutionPlan):
    """Concatenates its children partition by partition: output
    partition p is every child's partition p, in child order, where the
    child has one (ref union_exec.rs)."""

    def __init__(self, children: Sequence[ExecutionPlan]):
        super().__init__(children)

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return max(c.num_partitions for c in self.children)

    def execute(self, partition: int) -> BatchIterator:
        for child in self.children:
            if partition < child.num_partitions:
                yield from child.execute(partition)


class RenameColumnsExec(ExecutionPlan):
    """The child's columns under new names (types and nullability
    kept)."""

    def __init__(self, child: ExecutionPlan, names: Sequence[str]):
        super().__init__([child])
        self._names = list(names)

    @property
    def schema(self) -> Schema:
        return Schema([Field(n, f.data_type, f.nullable)
                       for n, f in zip(self._names, self.children[0].schema)])

    def execute(self, partition: int) -> BatchIterator:
        out_schema = self.schema
        for batch in self.children[0].execute(partition):
            yield ColumnBatch(out_schema, batch.columns, batch.num_rows,
                              batch.selection)


def _take_range(batch: ColumnBatch, start: int, stop: int) -> ColumnBatch:
    """Rows [start, stop) of a compacted batch, gathered on its device
    into a buffer on the bucket ladder."""
    batch = batch.compact()
    idx = torch.arange(start, stop, device=batch.device)
    cap = bucket_capacity(stop - start)
    return ColumnBatch(batch.schema, [c.take(idx, cap) for c in batch.columns],
                       stop - start, None)


class LimitExec(ExecutionPlan):
    """The first `limit` rows of each partition after skipping `offset`
    (LocalLimit per partition, GlobalLimit on a single partition)."""

    def __init__(self, child: ExecutionPlan, limit: int, offset: int = 0):
        super().__init__([child])
        self._limit = limit
        self._offset = offset

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        to_skip = self._offset
        remaining = self._limit
        for batch in self.children[0].execute(partition):
            if remaining <= 0:
                break
            n = batch.selected_count()
            if to_skip:
                if n <= to_skip:
                    to_skip -= n
                    continue
                batch = _take_range(batch, to_skip, n)
                n -= to_skip
                to_skip = 0
            if n <= remaining:
                remaining -= n
                yield batch
            else:
                yield _take_range(batch, 0, remaining)
                break


class ExpandExec(ExecutionPlan):
    """Grouping-sets fan-out (a ROLLUP or CUBE): each input batch goes
    through K projection lists, batch by batch and projection by
    projection within a batch, into one coalesced stream.  The output
    schema is the first projection's; the others must match it (a null
    utf8 literal is a host all-null column, an int64 literal a device
    column)."""

    def __init__(self, child: ExecutionPlan,
                 projections: Sequence[Sequence[PhysicalExpr]],
                 names: Sequence[str]):
        super().__init__([child])
        self._projections = [list(p) for p in projections]
        self._names = list(names)
        self._out_schema: Optional[Schema] = None

    @property
    def schema(self) -> Schema:
        if self._out_schema is None:
            in_schema = self.children[0].schema
            self._out_schema = Schema([
                Field(n, e.data_type(in_schema)) for n, e in
                zip(self._names, self._projections[0])])
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        """Counters: the projected batches by device (`cuda_batches` /
        `cpu_batches`), beside the standard meter's."""
        out_schema = self.schema

        def gen():
            for batch in self.children[0].execute(partition):
                for exprs in self._projections:
                    out = apply_project(batch, exprs, out_schema)
                    self.metrics.add(f"{out.device.type}_batches")
                    yield out
        return iter(CoalesceStream(gen(), metrics=self.metrics))


class EmptyPartitionsExec(ExecutionPlan):
    """`num_partitions` partitions with no rows (ref
    empty_partitions_exec.rs)."""

    def __init__(self, schema: Schema, num_partitions: int = 1):
        super().__init__()
        self._schema = schema
        self._n = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._n

    def execute(self, partition: int) -> BatchIterator:
        return iter(())


class DebugExec(ExecutionPlan):
    """Pass-through that logs each batch (ref debug_exec.rs)."""

    def __init__(self, child: ExecutionPlan, tag: str = "debug"):
        super().__init__([child])
        self._tag = tag

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        import logging
        log = logging.getLogger("blaze_tpu_torch.debug")
        for i, batch in enumerate(self.children[0].execute(partition)):
            log.info("[%s] partition=%d batch=%d rows=%d", self._tag,
                     partition, i, batch.selected_count())
            yield batch
