"""Run the port's TPC-DS queries (itest/queries.py, queries_ext.py and
queries_ext2.py) through the stage DAG against their pandas oracles.

For each named query it generates the query's tables at `--scale` from
the port's generators (itest/tpcds_data.py, once per table), writes them
with `write_splits` (the fact tables in 4 files, every dimension in one),
runs the plan (4 exchange partitions) through plan/stages.py
`DagScheduler` under `auron.tpu.dag.singleTaskBytes`
(`--single-task-bytes`; unset: the default 64 MiB, so a small query runs
as one local task and a large one staged) and compares the result with the oracle's frame as a set
(itest/runner.py `compare_frames`).  It prints a line per query: the
wall, `exec_mode`, the stage count, the rows, the launches on the card
(radix, placement and the row-order float sums of csrc/segment_sum.cu),
and whether the oracle was met.  The queries that wait for a later slice
(`LATER`) are run too and must raise NotImplementedError naming their
item.  q49 is held to `q49_frame`, its
oracle with Spark's division by zero (ROADMAP Queue 3: the reference's
pandas oracle divides to an infinity and counts it).

`--budget-mb N` sets the memory manager's budget to N MiB
(memory/manager.py `MemManager.init`), as the JAX package's
itest/report.py flag does; each query's line and JSON then carry the
manager's `budget_bytes`, `spill_count`, `spilled_bytes` and
`peak_mem_bytes`, and the spills by consumer, counted from zero for
each query.

    python -m blaze_tpu_torch.itest.breadth --scale 1 [--queries q05,q90]
        [--budget-mb 32]

The entry point runs on the card; `--device cpu` runs the plain versions.
The last line is one JSON object with every query's numbers; the exit
code is 1 when a query missed its oracle or raised otherwise.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional

from blaze_tpu_torch import config

#: queries that need a piece of a later slice, with the ROADMAP item
#: their NotImplementedError names
LATER: Dict[str, str] = {}

def q49_frame(tables) -> "pd.DataFrame":
    """q49's expected frame under Spark's division: an order's return
    ratio over zero sales is NULL, which the `ratio > 0.7` filter drops.
    The reference's oracle (itest/queries_ext2.py q49, a copy) divides
    in pandas, where it is an infinity that the filter keeps; from SF1 on
    the generator draws such orders."""
    import pandas as pd
    outs = []
    for sales, rets, sk, sa, rk, ra, tag in [
            ("web_sales", "web_returns", "ws_order_number",
             "ws_ext_sales_price", "wr_order_number", "wr_return_amt",
             "web"),
            ("catalog_sales", "catalog_returns", "cs_order_number",
             "cs_ext_sales_price", "cr_order_number", "cr_return_amount",
             "catalog"),
            ("store_sales", "store_returns", "ss_ticket_number",
             "ss_ext_sales_price", "sr_ticket_number", "sr_return_amt",
             "store")]:
        s = tables[sales].to_pandas().groupby(sk)[sa].sum()
        r = tables[rets].to_pandas().groupby(rk)[ra].sum()
        m = pd.concat([s.rename("sales"), r.rename("returns")], axis=1,
                      join="inner")
        m = m[m.sales != 0]
        m["ratio"] = m["returns"] / m["sales"]
        bad = m[m.ratio > 0.7]
        outs.append((tag, len(bad), bad.ratio.mean() if len(bad) else None))
    out = pd.DataFrame(outs, columns=["channel", "bad_orders", "avg_ratio"])
    return out.sort_values("channel").reset_index(drop=True)


#: the frames that replace a reference oracle the engine rightly departs
#: from (ROADMAP Queue 3)
FRAMES = {"q49": q49_frame}

FILES = 4       # files a fact table is written in
PARTITIONS = 4  # exchange partitions of every plan

#: operator counters each run reports, summed over its stages
COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches", "io_bytes")


def _zero_launches() -> None:
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import sort as K
    HU.placement_launches = 0
    R.partition_launches = 0
    for form in K.form_launches:
        K.form_launches[form] = 0


def _launches() -> Dict[str, int]:
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import sort as K
    return {"radix": R.partition_launches,
            "placement": HU.placement_launches,
            "segment_sum": sum(K.form_launches.values())}


def _reset_memory(mm) -> None:
    """The manager's spill totals and peak counted from zero."""
    mm.total_spill_count = 0
    mm.total_spilled_bytes = 0
    mm.peak_used = 0
    mm.spills_by_consumer = {}


def _memory(mm, sched) -> Dict:
    """The manager's numbers, and the largest `mem_used` of each operator
    kind that charged it (over its tasks and stages)."""
    peaks: Dict[str, int] = {}
    for tree in sched.stage_metrics.values():
        todo = [tree]
        while todo:
            node = todo.pop()
            if node.values.get("mem_used"):
                peaks[node.name] = max(peaks.get(node.name, 0),
                                       node.values["mem_used"])
            todo.extend(node.children)
    return {"budget_bytes": mm.total, "spill_count": mm.total_spill_count,
            "spilled_bytes": mm.total_spilled_bytes,
            "peak_mem_bytes": mm.peak_used,
            "spills_by_consumer": {k: list(v) for k, v in
                                   mm.spills_by_consumer.items()},
            "operator_peaks": peaks}


def run_one(name: str, paths: Dict, tables: Dict, partitions: int
            ) -> Dict:
    """One query: its wall, mode, stages, rows, launches, counters, the
    memory manager's spills and peak, and whether it met its oracle (or,
    for a LATER query, raised naming its item)."""
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.itest.queries import QUERIES
    from blaze_tpu_torch.itest.runner import compare_frames, frame
    from blaze_tpu_torch.memory import MemManager
    from blaze_tpu_torch.plan.stages import DagScheduler
    plan, oracle = QUERIES[name][0](paths, tables, partitions)
    sched = DagScheduler()
    mm = MemManager.get()
    _reset_memory(mm)
    _zero_launches()
    t0 = time.perf_counter()
    try:
        got = frame(sched.run_collect(plan))
    except NotImplementedError as e:
        if name not in LATER:
            raise
        return {"query": name, "later": LATER[name],
                "met": LATER[name] in str(e), "detail": str(e)}
    wall = time.perf_counter() - t0
    launches = _launches()
    memory = _memory(mm, sched)
    t0 = time.perf_counter()
    want = FRAMES[name](tables) if name in FRAMES else oracle()
    oracle_s = time.perf_counter() - t0
    err = compare_frames(got, want)
    counters = {k: sum(c[k] for c in stage_counters(sched, COUNTERS)
                       .values()) for k in COUNTERS}
    return {"query": name, "wall_s": wall, "exec_mode": sched.exec_mode,
            "stages": len(sched.stages), "rows": len(got),
            "launches": launches, "counters": counters, "memory": memory,
            "oracle_s": oracle_s, "met": err is None and name not in LATER,
            "detail": err or ""}


def run(names: List[str], scale: float, root: str) -> List[Dict]:
    """Every query of `names` in turn over one set of tables under
    `root`; a line printed per query."""
    from blaze_tpu_torch.itest.queries import QUERIES
    from blaze_tpu_torch.itest.tpcds_data import make_tables, write_splits
    needed = sorted({t for n in names for t in QUERIES[n][1]})
    t0 = time.perf_counter()
    tables = make_tables(scale, needed)
    paths = write_splits(tables, root, FILES)
    print(f"data: {len(needed)} tables at scale {scale} generated and "
          f"written in {time.perf_counter() - t0:.1f} s: " + ", ".join(
              f"{n} {tables[n].num_rows}" for n in needed), flush=True)
    out = []
    for name in names:
        r = run_one(name, paths, tables, PARTITIONS)
        out.append(r)
        if "later" in r:
            print(f"{name}: raises NotImplementedError naming "
                  f"{r['later']}: {'yes' if r['met'] else 'NO'}",
                  flush=True)
            continue
        print(f"{name}: wall {r['wall_s']:.3f} s, {r['exec_mode']}, "
              f"{r['stages']} stages, {r['rows']} rows, radix "
              f"{r['launches']['radix']}, placement "
              f"{r['launches']['placement']}, segment_sum "
              f"{r['launches']['segment_sum']}, cpu_batches "
              f"{r['counters']['cpu_batches']}, budget "
              f"{r['memory']['budget_bytes']}, spills "
              f"{r['memory']['spill_count']} "
              f"({r['memory']['spilled_bytes']} bytes; "
              f"{r['memory']['spills_by_consumer']}), peak "
              f"{r['memory']['peak_mem_bytes']} (by operator "
              f"{r['memory']['operator_peaks']}), oracle "
              f"{'met' if r['met'] else 'MISSED: ' + r['detail']} "
              f"({r['oracle_s']:.1f} s)", flush=True)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from blaze_tpu_torch.itest.queries import QUERIES
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--single-task-bytes", type=int, default=None,
                    help="auron.tpu.dag.singleTaskBytes (default: the "
                    "key's own, 64 MiB)")
    ap.add_argument("--queries", default="",
                    help="comma-separated names (default: every query)")
    ap.add_argument("--budget-mb", type=int, default=None,
                    help="the memory manager's budget in MiB (default: "
                    "the card's memory x auron.memory.fraction)")
    ap.add_argument("--device", default=None,
                    help="auron.torch.device (default: the key's own, "
                    "cuda)")
    args = ap.parse_args(argv)
    names = [n for n in args.queries.split(",") if n] or sorted(QUERIES)
    if args.device:
        config.conf.set(config.TORCH_DEVICE.key, args.device)
    if args.single_task_bytes is not None:
        config.conf.set(config.DAG_SINGLE_TASK_BYTES.key,
                        args.single_task_bytes)
    from blaze_tpu_torch.device import resolve
    from blaze_tpu_torch.memory import MemManager
    device = resolve()
    MemManager.init(None if args.budget_mb is None
                    else args.budget_mb << 20)
    root = tempfile.mkdtemp(prefix="blaze-breadth-")
    try:
        results = run(names, args.scale, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    missed = [r["query"] for r in results if not r["met"]]
    ran = [r for r in results if "later" not in r]
    walls = sum(r["wall_s"] for r in ran)
    spilled = [r["query"] for r in ran if r["memory"]["spill_count"]]
    print(f"{len(ran)} queries run, {len(ran) - len(missed)} equal to "
          f"their oracle; missed: {missed}; walls {walls:.3f} s in all; "
          f"budget {MemManager.get().total} bytes, {len(spilled)} queries "
          f"spilled, {sum(r['memory']['spill_count'] for r in ran)} spills",
          flush=True)
    if device.type == "cuda":
        import torch
        device = torch.cuda.get_device_name(device)
    print(json.dumps({"device": str(device), "scale": args.scale,
                      "files": FILES, "partitions": PARTITIONS,
                      "single_task_bytes":
                          config.DAG_SINGLE_TASK_BYTES.get(),
                      "budget_bytes": MemManager.get().total,
                      "queries": results}))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
