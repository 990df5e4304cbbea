"""The aggregation plan node (port of the plan-facing part of
blaze_tpu/ops/agg/exec.py).

`create_plan` builds an `AggExec` for every `hash_agg`/`sort_agg` node and
`fuse_plan` replaces it with the fused hash-lane operator.  The generic
segmented-sort engine behind `AggExec.execute` belongs to a later slice:
an `AggExec` that survives fusion raises instead of running.
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Tuple

from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.agg.functions import AggFunction
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Field, Schema


class AggMode(enum.Enum):
    PARTIAL = "partial"              # raw input -> acc columns
    PARTIAL_MERGE = "partial_merge"  # acc columns -> acc columns
    FINAL = "final"                  # acc columns -> final values
    COMPLETE = "complete"            # raw input -> final values


class AggExecMode(enum.Enum):
    HASH_AGG = "hash_agg"
    SORT_AGG = "sort_agg"


class AggExec(ExecutionPlan):

    def __init__(self, child: ExecutionPlan,
                 group_exprs: Sequence[Tuple[PhysicalExpr, str]],
                 aggs: Sequence[Tuple[AggFunction, AggMode, str]],
                 exec_mode: AggExecMode = AggExecMode.HASH_AGG):
        super().__init__([child])
        self._group_exprs = list(group_exprs)
        self._aggs = list(aggs)
        self._exec_mode = exec_mode
        in_schema = child.schema
        for fn, _, _ in self._aggs:
            fn.bind(in_schema)
        self._out_schema = build_agg_schema(in_schema, self._group_exprs,
                                            self._aggs)

    @property
    def schema(self) -> Schema:
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        raise NotImplementedError(
            "this aggregation did not fuse onto the hash lane; the generic "
            "AggExec engine belongs to a later slice of the PyTorch port "
            "(ROADMAP Queue 1 item 5)")


def build_agg_schema(in_schema: Schema, group_exprs, aggs) -> Schema:
    """Grouping columns, then each agg's final value (final/complete
    modes) or its accumulator fields named `<name>.<acc>`."""
    fields: List[Field] = []
    for e, name in group_exprs:
        fields.append(Field(name, e.data_type(in_schema)))
    for fn, mode, name in aggs:
        if mode in (AggMode.FINAL, AggMode.COMPLETE):
            fields.append(Field(name, fn.output_type(in_schema)))
        else:
            for f in fn.acc_fields(in_schema):
                fields.append(Field(f"{name}.{f.name}", f.data_type,
                                    f.nullable))
    return Schema(fields)
