"""Result comparison of the integration queries (a copy of
`compare_frames` and `_cell_equal` of blaze_tpu/itest/runner.py, the
QueryResultComparator analog): row count and cell equality with a double
tolerance, order-insensitive.  `same_order` adds the check that two
frames hold equal rows in the same order.
"""

from __future__ import annotations

import math
from typing import Optional

import pandas as pd

DOUBLE_TOL = 1e-6


def compare_frames(got: pd.DataFrame, want: pd.DataFrame) -> Optional[str]:
    """Row-count + cell equality with double tolerance, order-insensitive
    (QueryResultComparator semantics)."""
    if len(got) != len(want):
        return f"row count mismatch: got {len(got)} want {len(want)}"
    if got.shape[1] != want.shape[1]:
        return f"column count mismatch: {got.shape[1]} vs {want.shape[1]}"
    g = got.copy()
    w = want.copy()
    g.columns = list(range(g.shape[1]))
    w.columns = list(range(w.shape[1]))
    g = g.sort_values(by=list(range(g.shape[1]))).reset_index(drop=True)
    w = w.sort_values(by=list(range(w.shape[1]))).reset_index(drop=True)
    for ci in range(g.shape[1]):
        gc, wc = g[ci], w[ci]
        for ri in range(len(g)):
            a, b = gc.iloc[ri], wc.iloc[ri]
            if _cell_equal(a, b):
                continue
            return f"cell mismatch at row {ri} col {ci}: {a!r} != {b!r}"
    return None


def _cell_equal(a, b) -> bool:
    a_null = a is None or (isinstance(a, float) and math.isnan(a)) or a is pd.NA
    b_null = b is None or (isinstance(b, float) and math.isnan(b)) or b is pd.NA
    if a_null or b_null:
        return a_null and b_null
    if isinstance(a, float) or isinstance(b, float):
        fa, fb = float(a), float(b)
        if math.isnan(fa) or math.isnan(fb):
            return math.isnan(fa) and math.isnan(fb)
        if math.isinf(fa) or math.isinf(fb):
            # exact match only: inf <= tol*inf would otherwise pass ANY
            # value against an infinity
            return fa == fb
        return abs(fa - fb) <= DOUBLE_TOL * max(1.0, abs(fa), abs(fb))
    return a == b


def same_order(got: pd.DataFrame, want: pd.DataFrame) -> Optional[str]:
    """None when the two frames hold equal cells row by row in the same
    order (compare_frames' cell rule), else the first difference."""
    if got.shape != want.shape:
        return f"shape mismatch: got {got.shape} want {want.shape}"
    for ri in range(len(got)):
        for ci in range(got.shape[1]):
            a, b = got.iloc[ri, ci], want.iloc[ri, ci]
            if not _cell_equal(a, b):
                return f"row {ri} col {ci}: {a!r} != {b!r}"
    return None
