"""The integration queries' runner and result comparison (a copy of
`QueryResult`, `compare_frames`, `_cell_equal`, `run_query`,
`normalize_plan` and `check_plan_stability` of
blaze_tpu/itest/runner.py, the QueryRunner / QueryResultComparator /
PlanStabilityChecker analogs): row count and cell equality with a double
tolerance, order-insensitive.  `run_query` runs a plan dict through the
port's stage DAG (plan/stages.py `DagScheduler.run_collect`) and times it
beside its oracle.  `same_order` adds the check that two frames hold
equal rows in the same order; both compare float columns as arrays.
`frame` turns a result table into pandas.  `check_plan_stability` holds a
planned tree's text (`ExecutionPlan.pretty`, normalized) to a golden
file; it never writes one: a missing golden is a failure.
"""

from __future__ import annotations

import difflib
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import pandas as pd
from pandas.api.types import is_float_dtype

DOUBLE_TOL = 1e-6


@dataclass
class QueryResult:
    name: str
    rows: int
    engine_seconds: float
    oracle_seconds: float
    passed: bool
    detail: str = ""

    @property
    def speedup(self) -> float:
        return self.oracle_seconds / max(self.engine_seconds, 1e-9)


def compare_frames(got: pd.DataFrame, want: pd.DataFrame,
                   rel: float = DOUBLE_TOL) -> Optional[str]:
    """Row-count + cell equality with double tolerance `rel`,
    order-insensitive (QueryResultComparator semantics)."""
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
    diff = _first_difference(g, w, rel)
    if diff is None:
        return None
    ri, ci, a, b = diff
    return f"cell mismatch at row {ri} col {ci}: {a!r} != {b!r}"


def _cell_equal(a, b, rel: float = DOUBLE_TOL) -> bool:
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
        return abs(fa - fb) <= rel * max(1.0, abs(fa), abs(fb))
    return a == b


def _first_difference(got: pd.DataFrame, want: pd.DataFrame, rel: float
                      ) -> Optional[Tuple[int, int, Any, Any]]:
    """(row, column, got's cell, want's cell) of the first cell, column by
    column, where two frames of one shape differ by _cell_equal's rule,
    else None.  Two float columns are compared as arrays by the same
    rule; any other pair cell by cell."""
    for ci in range(got.shape[1]):
        gc, wc = got.iloc[:, ci], want.iloc[:, ci]
        if is_float_dtype(gc) and is_float_dtype(wc):
            a = gc.to_numpy(dtype=np.float64)
            b = wc.to_numpy(dtype=np.float64)
            finite = np.isfinite(a) & np.isfinite(b)
            with np.errstate(invalid="ignore"):
                close = np.abs(a - b) <= rel * np.maximum(
                    1.0, np.maximum(np.abs(a), np.abs(b)))
            # an infinity equals only itself, a NaN (null) only a NaN
            ok = (a == b) | (np.isnan(a) & np.isnan(b)) | (finite & close)
            bad = np.flatnonzero(~ok)
        else:
            bad = [ri for ri, (a, b) in enumerate(zip(gc.tolist(),
                                                      wc.tolist()))
                   if not _cell_equal(a, b, rel)]
        if len(bad):
            ri = int(bad[0])
            return ri, ci, gc.iloc[ri], wc.iloc[ri]
    return None


def same_order(got: pd.DataFrame, want: pd.DataFrame,
               rel: float = DOUBLE_TOL) -> Optional[str]:
    """None when the two frames have the same columns and hold equal
    cells row by row in the same order (compare_frames' cell rule with
    tolerance `rel`), else the first difference."""
    if got.shape != want.shape:
        return f"shape mismatch: got {got.shape} want {want.shape}"
    if list(got.columns) != list(want.columns):
        return f"columns: got {list(got.columns)} want {list(want.columns)}"
    diff = _first_difference(got, want, rel)
    if diff is None:
        return None
    ri, ci, a, b = diff
    return f"row {ri} col {ci}: {a!r} != {b!r}"


def frame(t) -> pd.DataFrame:
    """A result table (pyarrow) as pandas, with its columns even when it
    has no row."""
    return t.to_pandas() if t.num_rows else pd.DataFrame(
        {n: [] for n in t.schema.names})


def run_query(name: str, plan: Dict[str, Any], oracle) -> QueryResult:
    """Run the plan dict through a fresh DagScheduler (which cleans up
    after its run) and compare its result with the oracle's frame."""
    from blaze_tpu_torch.plan.stages import DagScheduler
    t0 = time.perf_counter()
    got_t = DagScheduler().run_collect(plan)
    engine_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = oracle()
    oracle_s = time.perf_counter() - t1
    err = compare_frames(frame(got_t), want)
    return QueryResult(name, got_t.num_rows, engine_s, oracle_s,
                       err is None, err or "")


# -- plan stability (the PlanStabilityChecker analog) -------------------------

_NORMALIZERS = [
    (re.compile(r"0x[0-9a-f]+"), "<addr>"),
    (re.compile(r"/[\w/.-]*/(blaze-[\w.-]+)"), r"<tmp>/\1"),
    (re.compile(r"shuffle://[0-9a-f]+"), "shuffle://<id>"),
    (re.compile(r"bhj-\d+"), "bhj-<id>"),
]


def normalize_plan(plan) -> str:
    """The operator tree's text with addresses, scratch paths and
    generated ids masked."""
    text = plan.pretty()
    for pat, repl in _NORMALIZERS:
        text = pat.sub(repl, text)
    return text.strip() + "\n"


def check_plan_stability(plan, golden_path: str) -> Optional[str]:
    """None when the normalized tree equals the golden file, else a
    unified diff (or the reason the golden cannot be read)."""
    if not os.path.exists(golden_path):
        return f"no golden at {golden_path}"
    text = normalize_plan(plan)
    with open(golden_path) as f:
        want = f.read()
    if text == want:
        return None
    return "".join(difflib.unified_diff(
        want.splitlines(keepends=True), text.splitlines(keepends=True),
        "golden", "current"))
