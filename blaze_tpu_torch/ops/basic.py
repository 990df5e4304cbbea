"""Filter and Project (port of FilterExec/ProjectExec,
blaze_tpu/ops/basic.py).

A filter ANDs its predicates into the batch's selection mask and never
compacts; CoalesceStream re-batches.  On the q01 path both operators are
absorbed into the fused aggregation (plan/fused.py), which evaluates the
same expressions inside its step.
"""

from __future__ import annotations

from typing import Optional, Sequence

from blaze_tpu_torch.batch import ColumnBatch
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
    cols = [e.evaluate(batch).to_column(cap) for e in exprs]
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
