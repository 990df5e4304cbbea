"""The checked-in Spark plans through the port's front door.

    python -m blaze_tpu_torch.itest.spark_fixtures [--scale 10]
        [--fixtures q01,q67] [--device cpu]

The seven plans under tests/fixtures/ are Spark `toJSON` physical plans:
six TPC-DS queries (q01, q06, q17, q18, q67, q95; the JAX package's
blaze_tpu/itest/spark_plans.py generated them at scale 0.2) with their
file paths written as `$DATA/<table>/part-NNNNN.parquet`, and a Spark 3.5
plan transcribed by hand (`captured_spark35_q01agg.json`: store_returns
filtered to a 91-day window, summed by customer and store) whose scan
files are the one placeholder `$FILES`.  This module:

  * writes the port's generated tables (itest/tpcds_data.py, the JAX
    generators' copies and seeds) into exactly the file layout the
    fixtures name under `$DATA`: as many parts of a table as the fixtures
    list, rows split as the JAX package's `write_parquet_splits` splits
    them, whatever the scale (the split that function would choose at
    another scale, by its 10,000-row threshold, is not used: at SF10 it
    would split item and store into files the fixtures do not list, and
    their rows would be lost);
  * instantiates a fixture over that directory (`$FILES` becomes
    store_returns' part files);
  * pairs each query with the port's own oracle from itest/queries.py, as
    spark_plans.py takes its oracles from `Q.qXX`, and the captured plan
    with the pandas group-by of tests/test_captured_spark_plan.py;
  * runs a fixture through `plan/stages.py` `execute_spark_plan_json` on
    the configured device and holds it to its oracle as a set
    (`runner.compare_frames`, floats within 1e-6 relative, the JAX
    package's fixture test's rule).

`chip_smoke.py`'s front door phase and tests/test_torch_spark_fixtures.py
share it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import pandas as pd
import pyarrow as pa

from blaze_tpu_torch import config

FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures"
QUERY_FIXTURES = ("q01", "q06", "q17", "q18", "q67", "q95")
CAPTURED = "captured_spark35_q01agg"
FIXTURES = QUERY_FIXTURES + (CAPTURED,)
#: the converter's partition count, and the one the fixtures' oracles
#: were built with (tests/test_spark_fixtures.py)
NUM_PARTITIONS = 2
#: store_returns' files under the captured plan's `$FILES`, when no query
#: fixture sets them (tests/test_captured_spark_plan.py writes two)
CAPTURED_FILES = 2
#: the captured plan's filter on sr_returned_date_sk, both ends inside
CAPTURED_WINDOW = (2450875, 2450965)
ROW_GROUP_SIZE = 1 << 16

_PART = re.compile(r'"\$DATA/([A-Za-z_]+)/part-(\d{5})\.parquet"')


def fixture_path(name: str) -> Path:
    stem = name if name == CAPTURED else f"{name}.spark"
    return FIXTURE_DIR / f"{stem}.json"


def load_text(name: str) -> str:
    return fixture_path(name).read_text()


def data_layout(names: Sequence[str] = FIXTURES) -> Dict[str, int]:
    """table -> the number of part files the named fixtures read of it.
    Raises where a fixture skips a part or two fixtures disagree."""
    parts: Dict[str, set] = {}
    for name in names:
        seen: Dict[str, set] = {}
        for table, idx in _PART.findall(load_text(name)):
            seen.setdefault(table, set()).add(int(idx))
        if name == CAPTURED:
            seen.setdefault("store_returns", set(range(CAPTURED_FILES)))
        for table, idx in seen.items():
            if idx != set(range(len(idx))):
                raise ValueError(f"{name}: {table} parts {sorted(idx)} are "
                                 f"not 0..n-1")
            parts.setdefault(table, set()).add(len(idx))
    bad = {t: sorted(n) for t, n in parts.items() if len(n) > 1}
    if bad:
        raise ValueError(f"fixtures disagree on the parts of {bad}")
    return {t: n.pop() for t, n in sorted(parts.items())}


def write_tables(tables: Dict[str, pa.Table], data_dir: str,
                 layout: Dict[str, int]) -> Dict[str, List[List[str]]]:
    """Each table of `layout` as `data_dir/<table>/part-NNNNN.parquet`, in
    its number of parts, each part `ceil(rows / parts)` rows in order (the
    JAX `write_parquet_splits` slicing), the parts written in parallel
    threads (pyarrow releases the GIL).  Returns the file groups, one file
    a group."""
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq
    paths, parts = {}, []
    for name, n_parts in layout.items():
        t = tables[name]
        d = os.path.join(data_dir, name)
        os.makedirs(d, exist_ok=True)
        per = -(-t.num_rows // n_parts)
        paths[name] = []
        for i in range(n_parts):
            p = os.path.join(d, f"part-{i:05d}.parquet")
            parts.append((t.slice(i * per, per), p))
            paths[name].append([p])
    with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as pool:
        for f in [pool.submit(pq.write_table, t, p,
                              row_group_size=ROW_GROUP_SIZE)
                  for t, p in parts]:
            f.result()
    return paths


def instantiate(name: str, data_dir: str,
                paths: Dict[str, List[List[str]]]) -> List[Dict[str, Any]]:
    """The fixture's plan over `data_dir` (its `$DATA`); the captured
    plan's `$FILES` becomes store_returns' file groups."""
    text = load_text(name)
    if name == CAPTURED:
        text = text.replace('"$FILES"', json.dumps(paths["store_returns"]))
    return json.loads(text.replace("$DATA", data_dir))


def captured_oracle(store_returns: pa.Table) -> pd.DataFrame:
    """The captured plan's answer: store_returns in the window, summed by
    (customer, store) with null keys kept."""
    lo, hi = CAPTURED_WINDOW
    d = store_returns.to_pandas()
    d = d[(d.sr_returned_date_sk >= lo) & (d.sr_returned_date_sk <= hi)]
    return (d.groupby(["sr_customer_sk", "sr_store_sk"], as_index=False,
                      dropna=False)
            .sr_return_amt.sum()
            .sort_values(["sr_customer_sk", "sr_store_sk"])
            .reset_index(drop=True))


def oracle(name: str, tables: Dict[str, pa.Table],
           paths: Dict[str, List[List[str]]]) -> pd.DataFrame:
    """The fixture's expected frame: the port's itest/queries.py oracle of
    the same query (the captured plan's pandas group-by)."""
    if name == CAPTURED:
        return captured_oracle(tables["store_returns"])
    from blaze_tpu_torch.itest import queries as Q
    builder = Q.QUERIES[name][0]
    return builder(paths, tables, NUM_PARTITIONS)[1]()


def make_data(scale: float, data_dir: str,
              names: Sequence[str] = FIXTURES,
              tables: Optional[Dict[str, pa.Table]] = None):
    """(tables, paths, seconds): the tables the named fixtures read, at
    `scale` from their seeds (those in `tables` reused as they are),
    written in the fixtures' layout under `data_dir`."""
    from blaze_tpu_torch.itest import tpcds_data as T
    layout = data_layout(names)
    have = dict(tables or {})
    t0 = time.perf_counter()
    made = T.make_tables(scale, [n for n in layout if n not in have])
    have.update(made)
    t1 = time.perf_counter()
    paths = write_tables(have, data_dir, layout)
    t2 = time.perf_counter()
    return ({n: have[n] for n in layout}, paths,
            {"generate": t1 - t0, "write": t2 - t1, "generated": sorted(made)})


def run_fixture(name: str, data_dir: str,
                paths: Dict[str, List[List[str]]], want: pd.DataFrame,
                scheduler=None) -> Dict[str, Any]:
    """One fixture through `execute_spark_plan_json`; returns its table,
    the converted node classes, exec_mode, stage count, wall and the
    first difference from `want` (None when equal)."""
    from blaze_tpu_torch.convert import convert_spark_plan
    from blaze_tpu_torch.device import resolve
    from blaze_tpu_torch.itest.runner import compare_frames, frame
    from blaze_tpu_torch.plan.stages import DagScheduler, \
        execute_spark_plan_json
    plan_json = instantiate(name, data_dir, paths)
    classes = convert_spark_plan(plan_json, NUM_PARTITIONS).converted_nodes
    sched = scheduler if scheduler is not None else DagScheduler()
    t0 = time.perf_counter()
    got = execute_spark_plan_json(plan_json, NUM_PARTITIONS,
                                  scheduler=sched)
    if resolve().type == "cuda":
        import torch
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"fixture": name, "table": got, "classes": classes,
            "exec_mode": sched.exec_mode,
            "stages": len(sched.stages) or 1, "rows": got.num_rows,
            "wall_s": wall, "error": compare_frames(frame(got), want)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--fixtures", default="",
                    help="comma-separated names (default: all seven)")
    ap.add_argument("--device", default=None,
                    help="auron.torch.device (default: the key's own, "
                    "cuda)")
    args = ap.parse_args(argv)
    names = [n for n in args.fixtures.split(",") if n] or list(FIXTURES)
    if args.device:
        config.conf.set(config.TORCH_DEVICE.key, args.device)
    from blaze_tpu_torch.device import resolve
    resolve()
    root = tempfile.mkdtemp(prefix="blaze-spark-fixtures-")
    try:
        tables, paths, secs = make_data(args.scale, root, names)
        print(f"data: {', '.join(f'{n} {t.num_rows} rows in {len(paths[n])} '
                                 f'file(s)' for n, t in tables.items())}; "
              f"generated in {secs['generate']:.1f} s, written in "
              f"{secs['write']:.1f} s", flush=True)
        missed = []
        for name in names:
            r = run_fixture(name, root, paths, oracle(name, tables, paths))
            verdict = ("equal to its oracle" if r["error"] is None
                       else r["error"])
            print(f"{name}: {r['rows']} rows, {r['exec_mode']}, "
                  f"{r['stages']} stages, {r['wall_s']:.3f} s, {verdict}; "
                  f"converted {r['classes']}", flush=True)
            if r["error"] is not None:
                missed.append(name)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"{len(names) - len(missed)} of {len(names)} fixtures equal to "
          f"their oracle; missed: {missed}")
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
