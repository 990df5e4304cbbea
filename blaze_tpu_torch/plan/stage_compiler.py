"""Stage compiler: eligible fused aggregations -> StageProgram (port of
blaze_tpu/plan/stage_compiler.py).

A `StageProgram` is what the device stage loop (runtime/loop.py) folds in
chunks: on a CUDA device one CUDA graph replay per chunk of source
batches, instead of a Python dispatch per batch x operator.

Eligibility, with the JAX package's reasons (anything else stays on the
staged per-batch executor):
  * the stage root is a FusedPartialAggExec on the HASH lane
    (`_ranges is None`): the dense lanes fold their own way;
  * every group key is fixed-width (variable-width keys wait for the
    dictionary-code lane), and there is at least one;
  * every expression of the filter/project chain, the keys and the
    aggregate arguments is a device expression (fixed-width values): the
    JAX package's "chain did not trace" check.  The port has no host-only
    expressions yet, so only a chain over a variable-width column fails;
  * the source plan is re-executable, so a wholesale fallback can re-run
    the partition from scratch (the loop emits nothing until its final
    drain).

A program's fingerprint is structural (the source schema, the chain, the
keys, the aggregates, their dtypes and the grow mode; literals included),
so the tasks of a stage, each decoding its own plan, share the loop's
captured graphs.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Optional, Tuple

from blaze_tpu_torch import config
from blaze_tpu_torch.schema import TypeId

_retry_local = threading.local()


class decline_loop_scope:
    """`with decline_loop_scope():`: stage_loop_active() is False on this
    thread for the duration (a retried task takes the most conservative
    path)."""

    def __enter__(self):
        _retry_local.decline = getattr(_retry_local, "decline", 0) + 1

    def __exit__(self, *exc):
        _retry_local.decline -= 1
        return False


class StageLoopIneligible(RuntimeError):
    """The stage does not compile to a device stage loop; the caller uses
    the staged per-batch executor (a verdict, not an error)."""


@dataclass(frozen=True)
class StageProgram:
    """A compiled stage pipeline the stage loop can fold.  `agg` is the
    live FusedPartialAggExec: it owns the source plan, the chain, the
    output schema and the emission helpers."""

    agg: Any                       # FusedPartialAggExec
    kinds: Tuple[str, ...]         # reduce kinds per agg spec
    key_dtypes: Tuple[Any, ...]    # torch dtypes of the group keys
    acc_dtypes: Tuple[Any, ...]    # torch dtypes of the accumulators
    grow: bool                     # exact modes grow the table on overflow
    fingerprint: Tuple             # process-wide program identity

    @property
    def source(self):
        return self.agg._source

    @property
    def out_schema(self):
        return self.agg.schema


def stage_loop_mode() -> str:
    return config.STAGE_DEVICE_LOOP_ENABLE.get().strip().lower()


def stage_loop_active() -> bool:
    """'on' forces the loop wherever it compiles (the CPU tests); 'auto'
    runs it where the port's device is CUDA, where the per-batch dispatch
    it amortizes exists; anything else disables it."""
    if getattr(_retry_local, "decline", 0) > 0:
        return False
    mode = stage_loop_mode()
    if mode == "on":
        return True
    if mode != "auto":
        return False
    from blaze_tpu_torch.device import resolve
    return resolve().type == "cuda"


def _device_expr(e, schema) -> bool:
    """Every node of `e` evaluates to fixed-width device values."""
    t = e.data_type(schema)
    return (t.is_fixed_width and t.id != TypeId.DECIMAL
            and all(_device_expr(c, schema) for c in e.children()))


def _chain_on_device(agg) -> bool:
    schema = agg._source.schema
    for kind, preds, exprs, out_schema in agg._chain:
        for e in (preds if kind == "filter" else exprs):
            if not _device_expr(e, schema):
                return False
        if kind == "project":
            schema = out_schema
    return all(_device_expr(e, agg._in_schema)
               for e in [e for e, _n in agg._group_exprs] +
               [a for _rk, _ok, a in agg._specs if a is not None])


def compile_fused_agg(agg) -> StageProgram:
    """StageProgram for one FusedPartialAggExec, or StageLoopIneligible
    with the reason."""
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec
    if not isinstance(agg, FusedPartialAggExec):
        raise StageLoopIneligible(f"stage root {type(agg).__name__} is "
                                  "not a fused partial agg")
    if agg._ranges is not None:
        raise StageLoopIneligible("dense lane has its own windowed fold")
    if any(not e.data_type(agg._in_schema).is_fixed_width
           for e, _n in agg._group_exprs):
        raise StageLoopIneligible("variable-width group keys")
    if not _chain_on_device(agg):
        raise StageLoopIneligible("filter/project chain did not trace")
    if not agg._group_exprs:
        raise StageLoopIneligible("no group keys")
    if not agg._source.reexecutable:
        raise StageLoopIneligible("source is not re-executable: wholesale "
                                  "fallback could not re-run the partition")
    kinds = tuple(rk for rk, _ok, _a in agg._specs)
    key_dtypes = tuple(e.data_type(agg._in_schema).torch_dtype()
                       for e, _n in agg._group_exprs)
    acc_dtypes = tuple(agg._acc_dtypes())
    chain = tuple((kind, tuple(preds or ()), tuple(exprs or ()), out_schema)
                  for kind, preds, exprs, out_schema in agg._chain)
    fingerprint = (agg._source.schema, chain, tuple(agg._group_exprs),
                   tuple(agg._specs), tuple(map(str, key_dtypes)),
                   tuple(map(str, acc_dtypes)), bool(agg._grow))
    return StageProgram(agg=agg, kinds=kinds, key_dtypes=key_dtypes,
                        acc_dtypes=acc_dtypes, grow=bool(agg._grow),
                        fingerprint=fingerprint)


def try_compile(agg) -> Optional[StageProgram]:
    """compile_fused_agg, with ineligibility as None."""
    try:
        return compile_fused_agg(agg)
    except StageLoopIneligible:
        return None


def compile_task_plan(plan) -> Optional[StageProgram]:
    """Stage-level entry: the stage root's program, or None (the staged
    per-batch executor).  The port has no re-batching node to unwrap."""
    if not stage_loop_active():
        return None
    return try_compile(plan)
