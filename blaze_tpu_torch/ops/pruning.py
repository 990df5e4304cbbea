"""Row-group pruning with parquet min/max statistics (port of
blaze_tpu/ops/pruning.py).

The reference delegates page and row-group filtering to DataFusion's
parquet source, gated by `auron.parquet.enable.pageFiltering` (ref
conf.rs:43, parquet_exec.rs).  Here, as in the JAX package: interval
analysis of the filter expression against each row group's [min, max]
statistics, a conservative evaluator that says "maybe" unless the
statistics prove a group empty (`prune_with_stats`), and its converse
that says "all" only when they prove every row matches
(`split_covered`, `groups_always_match`).  Statistics only: no row is
read.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from blaze_tpu_torch.exprs.base import BoundReference, Literal, PhysicalExpr
from blaze_tpu_torch.exprs.binary import BinaryExpr
from blaze_tpu_torch.exprs.conditional import InList, IsNotNull, IsNull
from blaze_tpu_torch.schema import Schema

Interval = Tuple[Optional[object], Optional[object], bool]  # (min, max, has_nulls)


def _name_to_col(md):
    return {md.schema.column(i).name: i for i in range(len(md.schema))}


def pred_columns(pred: PhysicalExpr, schema: Schema) -> set:
    """Column names the predicate references (for stats extraction)."""
    out = set()
    stack = [pred]
    while stack:
        e = stack.pop()
        name = _col_name(e, schema)
        if name is not None:
            out.add(name)
        stack.extend(getattr(e, "children", lambda: ())() or ())
    return out


def _group_stats(rg, name_to_col, strict_nulls: bool) -> dict:
    """Per-column (min, max, has_nulls) for one row group.

    strict_nulls: a MISSING null_count counts as "may have nulls" — the
    always-match direction is only sound when absence of nulls is
    PROVEN; the may-match direction stays permissive."""
    stats = {}
    for name, ci in name_to_col.items():
        col = rg.column(ci)
        if col.statistics is not None and col.statistics.has_min_max:
            nc = col.statistics.null_count
            has_nulls = ((nc is None or nc > 0) if strict_nulls
                         else (nc or 0) > 0)
            stats[name] = (col.statistics.min, col.statistics.max,
                           has_nulls)
    return stats


def _pred_cols_map(md, schema: Schema, predicate: PhysicalExpr) -> dict:
    """name->column-index restricted to predicate-referenced columns —
    stats extraction cost scales with the predicate, not the schema."""
    wanted = pred_columns(predicate, schema)
    return {n: i for n, i in _name_to_col(md).items() if n in wanted}


def split_may_match(predicate: PhysicalExpr, schema: Schema,
                    constants: dict) -> bool:
    """Partition pruning for provider scans: a split whose partition
    constants (each a degenerate [v, v] interval) PROVE the predicate
    false can be dropped before any file IO.  Conservative — True
    whenever the predicate references non-partition columns."""
    stats = {k: (v, v, v is None) for k, v in constants.items()}
    return _may_match(predicate, schema, stats)


def prune_with_stats(md, schema: Schema, predicate: PhysicalExpr,
                     groups: List[int]) -> List[int]:
    name_to_col = _pred_cols_map(md, schema, predicate)
    keep = []
    for g in groups:
        stats = _group_stats(md.row_group(g), name_to_col,
                             strict_nulls=False)
        if _may_match(predicate, schema, stats):
            keep.append(g)
    return keep


def groups_always_match(md, schema: Schema, predicate: PhysicalExpr,
                        groups: List[int]) -> bool:
    """True only when stats PROVE every row of every listed group
    satisfies `predicate` — lets the caller elide the filter mask for
    fully-covered groups (the common case for a range predicate over a
    date-clustered fact table).  Conservative: False when unsure."""
    covered, _boundary = split_covered(md, schema, predicate, groups)
    return len(covered) == len(groups)


def split_covered(md, schema: Schema, predicate: PhysicalExpr,
                  groups: List[int]):
    """(covered, boundary): kept groups whose stats PROVE full predicate
    coverage (filter mask elidable) vs the rest — one metadata pass."""
    name_to_col = _pred_cols_map(md, schema, predicate)
    covered, boundary = [], []
    for g in groups:
        stats = _group_stats(md.row_group(g), name_to_col,
                             strict_nulls=True)
        (covered if _always_match(predicate, schema, stats)
         else boundary).append(g)
    return covered, boundary


def _always_match(pred: PhysicalExpr, schema: Schema, stats: dict) -> bool:
    """True only when stats prove ALL rows match (a null comparison
    evaluates null, which a filter drops, so a column with nulls in the
    group can never prove always-match)."""
    if isinstance(pred, BinaryExpr):
        if pred.op == "and":
            return (_always_match(pred.left, schema, stats) and
                    _always_match(pred.right, schema, stats))
        if pred.op == "or":
            return (_always_match(pred.left, schema, stats) or
                    _always_match(pred.right, schema, stats))
        if pred.op in ("==", "<", "<=", ">", ">="):
            name, lit, op = (_col_name(pred.left, schema),
                             _lit_value(pred.right), pred.op)
            if name is None and _col_name(pred.right, schema) is not None:
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=",
                        "==": "=="}
                name, lit, op = (_col_name(pred.right, schema),
                                 _lit_value(pred.left), flip[pred.op])
            if name is None or lit is None or name not in stats:
                return False
            mn, mx, has_nulls = stats[name]
            if has_nulls:
                return False
            # parquet float/double min/max statistics IGNORE NaN rows,
            # and a NaN comparison is false under the filter — floating
            # stats can never PROVE all rows match (DataFusion applies
            # the same restriction)
            if isinstance(mn, float) or isinstance(mx, float):
                return False
            try:
                if op == "==":
                    return mn == lit == mx
                if op == "<":
                    return mx < lit
                if op == "<=":
                    return mx <= lit
                if op == ">":
                    return mn > lit
                if op == ">=":
                    return mn >= lit
            except TypeError:
                return False
        return False
    if isinstance(pred, IsNotNull):
        name = _col_name(pred.child, schema)
        if name is not None and name in stats:
            return not stats[name][2]
        return False
    return False


def _col_name(expr: PhysicalExpr, schema: Schema) -> Optional[str]:
    if isinstance(expr, BoundReference):
        if expr.name:
            return expr.name
        if expr.index < len(schema):
            return schema[expr.index].name
    return None


def _lit_value(expr: PhysicalExpr):
    if isinstance(expr, Literal):
        return expr.value
    return None


def _may_match(pred: PhysicalExpr, schema: Schema, stats: dict) -> bool:
    """Conservative: False only when stats PROVE no row matches."""
    if isinstance(pred, BinaryExpr):
        if pred.op == "and":
            return (_may_match(pred.left, schema, stats) and
                    _may_match(pred.right, schema, stats))
        if pred.op == "or":
            return (_may_match(pred.left, schema, stats) or
                    _may_match(pred.right, schema, stats))
        if pred.op in ("==", "<", "<=", ">", ">="):
            # normalize to col OP lit
            name, lit, op = _col_name(pred.left, schema), _lit_value(pred.right), pred.op
            if name is None and _col_name(pred.right, schema) is not None:
                flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "==": "=="}
                name, lit, op = (_col_name(pred.right, schema),
                                 _lit_value(pred.left), flip[pred.op])
            if name is None or lit is None or name not in stats:
                return True
            mn, mx, _ = stats[name]
            try:
                if op == "==":
                    return mn <= lit <= mx
                if op == "<":
                    return mn < lit
                if op == "<=":
                    return mn <= lit
                if op == ">":
                    return mx > lit
                if op == ">=":
                    return mx >= lit
            except TypeError:
                return True
        return True
    if isinstance(pred, InList) and not pred.negated:
        name = _col_name(pred.child, schema)
        if name is None or name not in stats:
            return True
        mn, mx, _ = stats[name]
        try:
            return any(v is not None and mn <= v <= mx for v in pred.values)
        except TypeError:
            return True
    if isinstance(pred, IsNull):
        name = _col_name(pred.child, schema)
        if name is not None and name in stats:
            return stats[name][2]
        return True
    return True
