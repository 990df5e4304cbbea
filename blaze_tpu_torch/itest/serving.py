"""A mix of TPC-DS queries through the port's query service
(serving/service.py) at a given concurrency.

`tpcds_mix` makes, for each query name, a maker of a fresh plan (each
submission gets its own broadcast ids, so no two runs share a broadcast
build) and its pandas oracle, from `itest/queries.py` over tables and
files the caller made (`itest/tpcds_data.py`).  `run_mix` submits a list
of (name, plan maker) pairs to a fresh `QueryService` of `concurrency`
slots, in order, waits for every handle, shuts the service down and
returns each result with its walls, the walls' p50 and p99, the wall of
the whole mix and its queries a second, the counts by outcome, the
service's `stats()`, every non-empty leak report and the service threads
still alive.  `check_mix` holds each result to its oracle (the plan's
row order, floats within `rel`) and to a serial result of the same
query, bit for bit, where one is given.

From the shell (on the card; `--device cpu` runs it on the CPU):

    python -m blaze_tpu_torch.itest.serving --scale 1 --concurrency 1 4

From Python (on the card; `auron.torch.device=cpu` runs it on the CPU):

    from blaze_tpu_torch.itest import serving, tpcds_data as T
    tables = T.make_tables(0.1, serving.TABLES)
    paths = T.write_splits(tables, "/tmp/mix", 4)
    mix = serving.tpcds_mix(paths, tables, 4, ("q01", "q06", "q95"))
    out = serving.run_mix([(n, mix[n][0]) for n in mix] * 2, 4)
    serving.check_mix(out, {n: o for n, (_, o) in mix.items()})
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from blaze_tpu_torch.itest import q01_dag, q06, q95_windows
from blaze_tpu_torch.itest.runner import compare_frames, frame, same_order

#: the tables of the serving mix (full q01, q06, q95)
TABLES = tuple(dict.fromkeys(q01_dag.TABLES + q06.TABLES
                             + q95_windows.TABLES))

#: the mix of the JAX package's serving soak (BENCH_SERVE.json)
MIX = ("q01", "q06", "q95")


def tpcds_mix(paths, tables, partitions: int, names: Sequence[str]
              ) -> Dict[str, Tuple[Callable[[], dict], Any]]:
    """name -> (a maker of a fresh plan, the pandas oracle's frame)."""
    from blaze_tpu_torch.itest import queries as Q
    out = {}
    for name in names:
        def make(n=name):
            return Q.plans(paths, tables, partitions, [n])[n][0]
        out[name] = (make, Q.plans(paths, tables, partitions,
                                   [name])[name][1]())
    return out


def _percentile(sorted_vals: List[float], q: float) -> float:
    """The nearest-rank percentile of the service's stats()."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def run_mix(mix: Sequence[Tuple[str, Callable[[], dict]]],
            concurrency: int, *, tenant: str = "default",
            deadline_ms: Optional[float] = None,
            mem_quota: Optional[int] = None,
            timeout_s: float = 900.0, **service_kw) -> Dict[str, Any]:
    """Submit `mix` (in order) to a fresh QueryService of `concurrency`
    slots; returns the report (see the module docstring).  Each result
    holds its query's name, id, status, table (None unless done), error
    (its repr, or None), and its walls in seconds: submit to finish,
    queued (submit to the slot's pop) and run (pop to finish)."""
    from blaze_tpu_torch.serving import QueryService
    svc = QueryService(max_concurrent=concurrency,
                       max_queue=max(len(mix), 1), **service_kw)
    plans = [(name, make()) for name, make in mix]
    t0 = time.perf_counter()
    try:
        handles = [(name, svc.submit(plan, tenant=tenant,
                                     deadline_ms=deadline_ms,
                                     mem_quota=mem_quota))
                   for name, plan in plans]
        for _name, h in handles:
            h.exception(timeout_s)  # waits; raises TimeoutError if stuck
        wall = time.perf_counter() - t0
    finally:
        svc.shutdown(wait=True, cancel_running=True)
    results, outcomes = [], {}
    for name, h in handles:
        err = h.exception(0)
        outcomes[h.status] = outcomes.get(h.status, 0) + 1
        results.append({
            "name": name, "query_id": h.query_id, "status": h.status,
            "table": h.result(0) if err is None else None,
            "error": None if err is None else "".join(
                traceback.format_exception(err)[-3:]),
            "wall_s": h.wall_s,
            "queued_s": (h.started_at - h.submitted_at
                         if h.started_at is not None else h.wall_s),
            "run_s": (h.finished_at - h.started_at
                      if h.started_at is not None else 0.0),
            "leak_report": h.leak_report, "work_dir": h.work_dir})
    walls = sorted(r["wall_s"] for r in results if r["status"] == "done")
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("blaze-serve") and t.is_alive()]
    return {"concurrency": concurrency, "submitted": len(mix),
            "completed": outcomes.get("done", 0), "outcomes": outcomes,
            "results": results,
            "p50_ms": _percentile(walls, 0.50) * 1e3,
            "p99_ms": _percentile(walls, 0.99) * 1e3,
            "wall_s": wall, "qps": len(walls) / wall if wall > 0 else 0.0,
            "serial_sum_s": sum(r["run_s"] for r in results),
            "stats": svc.stats(),
            "leaks": {r["query_id"]: r["leak_report"] for r in results
                      if r["leak_report"] and any(
                          r["leak_report"].values())},
            "threads_alive": alive}


def _same_bits(got, want) -> Optional[str]:
    """None when two frames hold the same columns, dtypes and values,
    floats compared by their bits (NaNs by theirs too)."""
    if list(got.columns) != list(want.columns) or len(got) != len(want):
        return f"shape {got.shape} against {want.shape}"
    for c in got.columns:
        a, b = got[c].to_numpy(), want[c].to_numpy()
        if a.dtype != b.dtype:
            return f"{c}: dtype {a.dtype} against {b.dtype}"
        if a.dtype.kind == "f":
            if not np.array_equal(a.view(np.uint8), b.view(np.uint8)):
                return f"{c}: float bits differ"
        elif not all(x == y or (x is None and y is None)
                     or (x != x and y != y) for x, y in zip(a, b)):
            return f"{c}: values differ"
    return None


def check_mix(out: Dict[str, Any], oracles: Dict[str, Any],
              serial: Optional[Dict[str, Any]] = None,
              rel: float = 1e-9) -> Dict[str, Optional[str]]:
    """query id -> None when its result is done, equals its query's
    oracle (rows in the plan's order where it has one: q95's one row and
    q06's and q01's sorted output) and, where `serial` has the query's
    serial frame, equals it bit for bit; else the first difference."""
    errs = {}
    for r in out["results"]:
        name = r["name"]
        if r["status"] != "done":
            errs[r["query_id"]] = f"{name}: {r['status']} {r['error']}"
            continue
        got = frame(r["table"])
        want = oracles[name]
        err = (same_order(*q95_windows.in_plan_order(name, got, want), rel)
               if name in q95_windows.QUERIES
               else compare_frames(got, want, rel) or same_order(got, want,
                                                                  rel))
        if err is None and serial is not None and name in serial:
            err = _same_bits(got, serial[name])
            if err is not None:
                err = f"against the serial run: {err}"
        errs[r["query_id"]] = None if err is None else f"{name}: {err}"
    return errs


def main(argv=None) -> int:
    """Make the mix's tables at `--scale`, run full q01, q06 and q95
    `--repeat` times each through the service at each `--concurrency`,
    check every result against its oracle and print one JSON line a
    level; exit 1 on a wrong or failed result."""
    import argparse
    import json
    import os
    import shutil
    import tempfile

    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import tpcds_data as T
    ap = argparse.ArgumentParser(prog="python -m blaze_tpu_torch.itest."
                                      "serving")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 4])
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--partitions", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    config.conf.set(config.TORCH_DEVICE.key, args.device)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    root = tempfile.mkdtemp(prefix="serving_")
    try:
        tables = T.make_tables(args.scale, TABLES)
        paths = T.write_splits(tables, root, 4)
        mix = tpcds_mix(paths, tables, args.partitions, MIX)
        oracles = {n: want for n, (_make, want) in mix.items()}
        bad = 0
        for c in args.concurrency:
            out = run_mix([(n, mix[n][0]) for n in MIX] * args.repeat, c)
            errs = {q: e for q, e in check_mix(out, oracles).items() if e}
            bad += len(errs) + len(out["leaks"])
            print(json.dumps({
                "concurrency": c, "submitted": out["submitted"],
                "completed": out["completed"],
                "p50_ms": round(out["p50_ms"], 3),
                "p99_ms": round(out["p99_ms"], 3),
                "wall_s": round(out["wall_s"], 3),
                "qps": round(out["qps"], 3), "errors": errs,
                "leaks": out["leaks"]}))
        return 1 if bad else 0
    finally:
        shutil.rmtree(root, ignore_errors=True)
        config.conf.unset(config.DAG_SINGLE_TASK_BYTES.key)
        config.conf.unset(config.TORCH_DEVICE.key)


if __name__ == "__main__":
    raise SystemExit(main())
