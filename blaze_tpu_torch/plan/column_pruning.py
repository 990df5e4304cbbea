"""Column pruning over a decoded task plan (port of
blaze_tpu/plan/column_pruning.py, the Catalyst ColumnPruning analog).

Plans from Spark arrive pruned: every file scan carries a projection of
exactly the columns referenced above it.  Plans written directly against
the engine's IR (tests, the itest queries) scan whole files.  This pass
recovers Catalyst's behavior in the engine:

  * the REQUIRED column indices flow DOWN the operator tree, each
    operator adding the columns its own expressions read;
  * at a parquet scan the projection narrows to the required columns, in
    schema order;
  * an old -> new index MAPPING flows back UP through the operators that
    keep their child's schema (filter, sort, limit), and every affected
    expression has its BoundReferences rewritten; a join merges its two
    children's mappings, the right one shifted by the left's width.

An operator that is not modelled here is a barrier: its subtree is
visited again with no requirement, so pruning still happens below a
projection or an aggregation deeper down.  A node whose child changed
schema is rebuilt, never patched: several operators cache their output
schema.  `auron.tpu.columnPruning` = false turns the pass off.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

from blaze_tpu_torch.exprs import BoundReference, PhysicalExpr


# ---------------------------------------------------------------------------
# expression helpers
# ---------------------------------------------------------------------------

def expr_columns(e: PhysicalExpr, out: Set[int]) -> None:
    """Add the column indices `e` reads to `out`."""
    if isinstance(e, BoundReference):
        out.add(e.index)
    for c in e.children():
        expr_columns(c, out)


def rewrite_expr(e: PhysicalExpr, mapping: Dict[int, int]) -> PhysicalExpr:
    """`e` rebuilt with its BoundReference indices remapped (expressions
    are frozen dataclasses, rebuilt by exprs/fold.py map_exprs); any other
    expression makes the whole plan unprunable."""
    from blaze_tpu_torch.exprs.fold import map_exprs
    if isinstance(e, BoundReference):
        return BoundReference(mapping[e.index], e.name)
    try:
        return map_exprs(e, lambda c: rewrite_expr(c, mapping))
    except TypeError:
        raise _Unprunable() from None


class _Unprunable(Exception):
    pass


def _cols_of(exprs: Sequence[PhysicalExpr]) -> Set[int]:
    out: Set[int] = set()
    for e in exprs:
        expr_columns(e, out)
    return out


# ---------------------------------------------------------------------------
# the pass
# ---------------------------------------------------------------------------

def prune_columns(plan):
    """The plan with its scans narrowed (rebuilt where a schema changed);
    the plan unchanged when the pass is off or meets an expression it
    cannot rewrite."""
    from blaze_tpu_torch import config
    if not config.COLUMN_PRUNING_ENABLE.get():
        return plan
    try:
        new, _mapping = _prune(plan, None)
        return new
    except _Unprunable:
        return plan


def _identity(n: int) -> Dict[int, int]:
    return {i: i for i in range(n)}


def _prune(plan, required: Optional[Set[int]]):
    """(new_plan, mapping): `mapping` is None when the node's output
    columns are unchanged; otherwise old -> new indices, through which
    the parent must rewrite its expressions."""
    from blaze_tpu_torch.ops.agg.exec import AggExec
    from blaze_tpu_torch.ops.basic import (FilterExec, FilterProjectExec,
                                           LimitExec, ProjectExec)
    from blaze_tpu_torch.ops.joins.exec import BaseJoinExec
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.ops.sort import SortExec

    if isinstance(plan, ParquetScanExec):
        return _prune_scan(plan, required)

    if isinstance(plan, FilterExec):
        child_req = (None if required is None else
                     required | _cols_of(plan._predicates))
        child, m = _prune(plan.children[0], child_req)
        if m is None:
            plan.children[0] = child
            return plan, None
        preds = [rewrite_expr(p, m) for p in plan._predicates]
        return FilterExec(child, preds), m

    if isinstance(plan, LimitExec):
        child, m = _prune(plan.children[0], required)
        plan.children[0] = child
        return plan, m  # the child's schema passes through

    if isinstance(plan, SortExec):
        child_req = (None if required is None else
                     required | _cols_of([s[0] for s in plan._specs]))
        child, m = _prune(plan.children[0], child_req)
        if m is None:
            plan.children[0] = child
            return plan, None
        specs = [(rewrite_expr(e, m), d, nf) for e, d, nf in plan._specs]
        return SortExec(child, specs, fetch=plan._fetch), m

    if isinstance(plan, (ProjectExec, FilterProjectExec)):
        exprs = list(plan._exprs)
        preds = list(getattr(plan, "_predicates", ()))
        child, m = _prune(plan.children[0], _cols_of(exprs + preds))
        if m is None:
            plan.children[0] = child
            return plan, None
        new_exprs = [rewrite_expr(e, m) for e in exprs]
        names = [f.name for f in plan.schema]
        if isinstance(plan, FilterProjectExec):
            return FilterProjectExec(child, [rewrite_expr(p, m)
                                             for p in preds],
                                     new_exprs, names), None
        return ProjectExec(child, new_exprs, names), None

    if isinstance(plan, AggExec):
        group_exprs = [e for e, _n in plan._group_exprs]
        arg_exprs: List[PhysicalExpr] = []
        for fn, _mode, _name in plan._aggs:
            arg_exprs.extend(fn.children)
        child, m = _prune(plan.children[0], _cols_of(group_exprs + arg_exprs))
        if m is None:
            plan.children[0] = child
            return plan, None
        groups = [(rewrite_expr(e, m), n) for e, n in plan._group_exprs]
        aggs = []
        for fn, mode, name in plan._aggs:
            # a copy of the function over the rewritten arguments; AggExec
            # binds it to the narrowed input schema
            new_fn = type(fn).__new__(type(fn))
            new_fn.__dict__.update(fn.__dict__)
            new_fn.children = [rewrite_expr(c, m) for c in fn.children]
            aggs.append((new_fn, mode, name))
        return AggExec(child, groups, aggs, exec_mode=plan._exec_mode), None

    if isinstance(plan, BaseJoinExec):
        return _prune_join(plan, required)

    # any other operator is a barrier: no requirement crosses it, but its
    # subtrees still get their own chances
    for i, child in enumerate(plan.children):
        plan.children[i] = _prune(child, None)[0]
    return plan, None


def _prune_join(plan, required: Optional[Set[int]]):
    from blaze_tpu_torch.ops.joins.exec import BroadcastJoinExec
    n_left = len(plan.children[0].schema)
    n_right = len(plan.children[1].schema)
    if required is None or plan.join_type.value not in ("inner", "left",
                                                         "right", "full"):
        # semi, anti and existence joins shape their output otherwise: no
        # pruning through them, but below them
        plan.children[0] = _prune(plan.children[0], None)[0]
        plan.children[1] = _prune(plan.children[1], None)[0]
        return plan, None
    filt_cols: Set[int] = set()
    if plan.join_filter is not None:
        expr_columns(plan.join_filter, filt_cols)
    left_req = ({i for i in required if i < n_left} |
                _cols_of(plan.left_keys) |
                {i for i in filt_cols if i < n_left})
    right_req = ({i - n_left for i in required if i >= n_left} |
                 _cols_of(plan.right_keys) |
                 {i - n_left for i in filt_cols if i >= n_left})
    lchild, lm = _prune(plan.children[0], left_req)
    rchild, rm = _prune(plan.children[1], right_req)
    if lm is None and rm is None:
        plan.children[0] = lchild
        plan.children[1] = rchild
        return plan, None
    lm = lm or _identity(n_left)
    rm = rm or _identity(n_right)
    new_n_left = len(lchild.schema)
    joined = dict(lm)
    joined.update({n_left + o: new_n_left + n for o, n in rm.items()})
    kwargs = dict(join_type=plan.join_type, build_side=plan.build_side,
                  join_filter=(rewrite_expr(plan.join_filter, joined)
                               if plan.join_filter is not None else None),
                  existence_col=plan._existence_col,
                  null_aware_anti=plan.null_aware_anti)
    if isinstance(plan, BroadcastJoinExec):
        kwargs["broadcast_id"] = plan._broadcast_id
    # the keys as the join holds them (a widened key keeps its Cast); the
    # rebuilt join promotes them again, which leaves equal types alone
    new = type(plan)(lchild, rchild,
                     [rewrite_expr(k, lm) for k in plan.left_keys],
                     [rewrite_expr(k, rm) for k in plan.right_keys],
                     **kwargs)
    return new, joined


def _prune_scan(scan, required: Optional[Set[int]]):
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    # a scan with partition columns keeps its projection, as in the JAX
    # package; a narrowed scan keeps its pruning predicate
    if required is None or scan._partition_schema is not None:
        return scan, None
    n = len(scan.schema)
    req = sorted(i for i in required if i < n)
    if len(req) == n:
        return scan, None
    names = [scan.schema[i].name for i in req]
    new = ParquetScanExec(scan._file_schema, scan._file_groups,
                          projection=names, predicate=scan._predicate,
                          batch_rows=scan._batch_rows)
    return new, {old: new_i for new_i, old in enumerate(req)}
