"""Three paths through the plan kinds the wire and the Spark front door
hand the port, over TPC-DS store_returns (itest/q01.py's files: date
order, 65,536-row row groups).

    python -m blaze_tpu_torch.itest.wire_kinds [--scale 10] [--device cpu]

  W1  a global sort through a range exchange (Spark's plan for an ORDER
      BY without LIMIT), as TaskDefinition bytes: each map task a
      parquet_scan with the pruning predicate `sr_returned_date_sk` in
      q01's [lo, hi], a filter with the same conjuncts and a
      shuffle_writer with range partitioning by (sr_customer_sk ASC
      NULLS FIRST, sr_ticket_number ASC), the bounds from
      `sample_range_bounds` over a seeded 1% sample of the filtered
      rows; each reduce task ipc_reader -> coalesce_batches -> sort on
      the same keys -> ipc_writer into an in-memory sink.  The sinks,
      read in partition order, equal a pandas sort of the filtered rows;
  W2  a round-robin exchange through the front door: the Spark plan of
      `spark.read.parquet(...).repartition(16).groupBy(sr_store_sk)
      .agg(sum(sr_return_amt), count(1))` (FileScan, Exchange
      RoundRobinPartitioning(16), partial HashAggregate, Exchange
      hashpartitioning(16), final HashAggregate) through
      `execute_spark_plan_json`, equal to a pandas group-by;
  W3  q01's inner query over a Hive layout: store_returns rewritten as
      one file per sr_store_sk value without that column
      (`sr_store_sk=<v>/part-00000.parquet`, date order and 65,536-row
      row groups kept), the files in 4 groups; the scan carries the
      partition schema, each file's value and the date predicate; a
      debug node sits at the reduce root.  Equal to itest/q01.py's
      oracle on the original files.  The FFI probe hands one map task's
      scanned batches in again through an ffi_reader and holds its
      `.data` and `.index` bytes to that task's.

Each scan's `pruned_row_groups` is held to the count the footers give
(`footer_pruned`): W1's map tasks scan once; W3's scans also run alone
(`scans_alone`), since a map task that the device stage loop hands back
to the staged path scans twice, its first scan cut where the loop fell
back (`pruning_error`).  `chip_smoke.py`'s wire kinds phase runs the
three at SF10 on the card; tests/test_torch_wire_kinds.py runs them
small on the CPU against the JAX package.
"""

from __future__ import annotations

import argparse
import base64
import io
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from blaze_tpu_torch import config
from blaze_tpu_torch.itest import q01

#: the resources the W1 reduce reads and writes, and W3's shuffle and FFI
W1_SHUFFLE = "wire_kinds_w1_shuffle"
W1_SINK = "wire_kinds_w1_sink"
W3_SHUFFLE = "wire_kinds_w3_shuffle"
W3_FFI = "wire_kinds_w3_ffi"

#: operator counters summed per stage: q01's and the scans' pruning
STAGE_COUNTERS = q01.STAGE_COUNTERS + ("pruned_row_groups",)

#: W1's sort keys: (column of q01.SR_SCHEMA_D, its index there)
W1_KEYS = (("sr_customer_sk", 1), ("sr_ticket_number", 4))
W1_SAMPLE_FRACTION = 0.01
W1_SEED = 19
N_PARTS = 16

#: W3's partition column and the file schema left without it
HIVE_KEY = "sr_store_sk"
HIVE_FILE_SCHEMA_D = {"fields": [f for f in q01.SR_SCHEMA_D["fields"]
                                 if f["name"] != HIVE_KEY]}
HIVE_PARTITION_SCHEMA_D = {"fields": [
    {"name": HIVE_KEY, "type": {"id": "int64"}, "nullable": True}]}


def date_conjuncts(lo: int, hi: int) -> List[Dict[str, Any]]:
    """`sr_returned_date_sk >= lo` and `<= hi`, as q01's filter has them."""
    return q01.stage1_td([], lo, hi, 0, "", 1, 1)["plan"]["input"][
        "input"]["predicates"]


def date_predicate(lo: int, hi: int) -> Dict[str, Any]:
    """The two conjuncts ANDed: the scans' pruning predicate."""
    a, b = date_conjuncts(lo, hi)
    return {"kind": "binary", "op": "and", "l": a, "r": b}


def footer_pruned(paths: Sequence[str], lo: int, hi: int) -> int:
    """Row groups whose date statistics lie wholly outside [lo, hi], read
    from the footers with pyarrow."""
    n = 0
    for p in paths:
        md = pq.ParquetFile(p).metadata
        ci = md.schema.names.index("sr_returned_date_sk")
        for g in range(md.num_row_groups):
            st = md.row_group(g).column(ci).statistics
            if st is not None and st.has_min_max and (st.max < lo
                                                      or st.min > hi):
                n += 1
    return n


def _sum_counters(res: Dict[str, Dict]) -> Dict[str, Dict[str, int]]:
    return {k: v["counters"] for k, v in res.items()}


def pruning_error(map_task_counters: Sequence[Dict[str, int]],
                  groups: Sequence[Sequence[str]], lo: int,
                  hi: int) -> Optional[str]:
    """None when each map task's `pruned_row_groups` agrees with its
    files' footer count: equal to it where the task scanned once; where
    the device stage loop handed the task back to the staged path (which
    scans the partition again from its start, as the JAX package's loop
    does), at least one scan's count and at most one for each scan, the
    first scan having stopped where the loop fell back."""
    for m, (c, g) in enumerate(zip(map_task_counters, groups)):
        once = footer_pruned(g, lo, hi)
        scans = 1 + c.get("stage_loop_fallback", 0)
        got = c.get("pruned_row_groups", 0)
        if not (got == once if scans == 1 else once <= got <= once * scans):
            return (f"map task {m}: pruned_row_groups {got}, footers "
                    f"{once} a scan, {scans} scan(s)")
    return None


# ---------------------------------------------------------------------------
# W1: a global sort through a range exchange
# ---------------------------------------------------------------------------

def _w1_specs():
    return [{"expr": {"kind": "column", "index": i}, "descending": False,
             "nulls_first": True} for _n, i in W1_KEYS]


def filtered_rows(sr_paths: Sequence[str], lo: int, hi: int,
                  columns: Optional[Sequence[str]] = None) -> pa.Table:
    """The q01 schema's columns of the rows in the date window."""
    names = columns or [f["name"] for f in q01.SR_SCHEMA_D["fields"]]
    t = pq.read_table(list(sr_paths), columns=list(names))
    d = t["sr_returned_date_sk"]
    return t.filter(pc.and_(pc.greater_equal(d, lo), pc.less_equal(d, hi)))


def w1_sample(sr_paths: Sequence[str], lo: int, hi: int,
              seed: int = W1_SEED,
              fraction: float = W1_SAMPLE_FRACTION) -> pa.Table:
    """A seeded sample of the filtered rows' key columns, in row order."""
    keys = filtered_rows(sr_paths, lo, hi, [n for n, _ in W1_KEYS]
                         + ["sr_returned_date_sk"])
    rng = np.random.default_rng(seed)
    n = keys.num_rows
    k = max(1, int(n * fraction)) if n else 0
    idx = np.sort(rng.choice(n, size=k, replace=False)) if k else \
        np.zeros(0, dtype=np.int64)
    return keys.select([n for n, _ in W1_KEYS]).take(
        pa.array(idx, type=pa.int64()))


def w1_bounds(sample: pa.Table, n_parts: int = N_PARTS) -> pa.RecordBatch:
    """The range bounds: the port's `sample_range_bounds` over `sample`,
    sorted by W1's keys."""
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.shuffle import sample_range_bounds
    specs = [(BoundReference(i, n), False, True)
             for i, (n, _) in enumerate(W1_KEYS)]
    return sample_range_bounds(sample, specs, n_parts,
                               [n for n, _ in W1_KEYS])


def bounds_ipc(bounds: pa.RecordBatch) -> str:
    """One Arrow IPC batch, base64: the range partitioning's wire form in
    the plan dicts."""
    rb = pa.RecordBatch.from_arrays(
        list(bounds.columns), names=[f"b{i}" for i in range(
            bounds.num_columns)])
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return base64.b64encode(sink.getvalue()).decode("ascii")


def w1_map_td(sr_paths, lo, hi, bounds_b64, map_id, tmpdir, n_maps,
              n_parts) -> Dict:
    groups = [g if i == map_id else []
              for i, g in enumerate(q01.file_groups(sr_paths, n_maps))]
    plan = {
        "kind": "shuffle_writer",
        "partitioning": {"kind": "range", "specs": _w1_specs(),
                         "num_partitions": n_parts,
                         "bounds_ipc": bounds_b64},
        "data_file": os.path.join(tmpdir, f"shuffle_{map_id}.data"),
        "index_file": os.path.join(tmpdir, f"shuffle_{map_id}.index"),
        "input": {
            "kind": "filter", "predicates": date_conjuncts(lo, hi),
            "input": {"kind": "parquet_scan", "schema": q01.SR_SCHEMA_D,
                      "predicate": date_predicate(lo, hi),
                      "file_groups": groups}}}
    return {"stage_id": 1, "partition_id": map_id,
            "num_partitions": n_maps, "plan": plan}


def w1_reduce_td(reduce_id, n_parts) -> Dict:
    plan = {
        "kind": "ipc_writer", "sink_resource_id": W1_SINK,
        "input": {
            "kind": "sort", "specs": _w1_specs(),
            "input": {
                "kind": "coalesce_batches",
                "input": {"kind": "ipc_reader", "resource_id": W1_SHUFFLE,
                          "schema": q01.SR_SCHEMA_D,
                          "num_partitions": n_parts}}}}
    return {"stage_id": 2, "partition_id": reduce_id,
            "num_partitions": n_parts, "plan": plan}


def read_sinks(sinks: Sequence[bytes], schema: pa.Schema) -> pa.Table:
    """The IPC writer's sinks, decoded in partition order."""
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionReader
    batches = [rb for data in sinks for rb in
               IpcCompressionReader(io.BytesIO(data)).read_batches()]
    return pa.Table.from_batches(batches, schema=schema)


def run_w1(sr_paths, lo, hi, bounds: pa.RecordBatch, tmpdir: str,
           n_maps: int, n_parts: int = N_PARTS) -> Dict[str, Any]:
    """W1's map tasks, then its reduce tasks, through the port's runtime;
    returns the sinks' bytes and their rows, the shuffle files, the
    counters and walls per stage."""
    from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
    b64 = bounds_ipc(bounds)
    sinks = [io.BytesIO() for _ in range(n_parts)]
    put_resource(W1_SINK, lambda p: sinks[p])
    try:
        res = q01.run_stages(
            [q01.Stage("map", lambda m: w1_map_td(
                sr_paths, lo, hi, b64, m, tmpdir, n_maps, n_parts),
                n_maps, out_dir=tmpdir, out_partitions=n_parts),
             q01.Stage("reduce", lambda r: w1_reduce_td(r, n_parts),
                       n_parts, reads="map", resource=W1_SHUFFLE)],
            STAGE_COUNTERS)
    finally:
        remove_resource(W1_SINK)
    data = [s.getvalue() for s in sinks]
    from blaze_tpu_torch.plan.types import schema_from_dict
    schema = schema_from_dict(q01.SR_SCHEMA_D).to_arrow()
    return {"sinks": data, "table": read_sinks(data, schema),
            "shuffle": res["map"]["shuffle"],
            "counters": _sum_counters(res),
            "map_task_counters": res["map"]["task_counters"],
            "map_s": res["map"]["seconds"],
            "reduce_s": res["reduce"]["seconds"]}


def w1_oracle(sr_paths, lo, hi) -> pa.Table:
    """The filtered rows sorted by W1's keys with pandas (nulls first)."""
    d = filtered_rows(sr_paths, lo, hi).to_pandas()
    d = d.sort_values([n for n, _ in W1_KEYS], na_position="first",
                      kind="stable").reset_index(drop=True)
    return pa.Table.from_pandas(d, preserve_index=False)


def w1_error(got: pa.Table, want: pa.Table) -> Optional[str]:
    """None when the two hold the same rows in the same order."""
    if got.num_rows != want.num_rows:
        return f"{got.num_rows} rows, want {want.num_rows}"
    for name in want.column_names:
        a, b = got[name].combine_chunks(), want[name].combine_chunks()
        if not a.cast(b.type).equals(b):
            return f"column {name} differs"
    return None


# ---------------------------------------------------------------------------
# W2: a round-robin exchange through the front door
# ---------------------------------------------------------------------------

CAT = "org.apache.spark.sql.catalyst.expressions."
EXEC = "org.apache.spark.sql.execution."


def _attr(name, dt, eid):
    return [{"class": CAT + "AttributeReference", "num-children": 0,
             "name": name, "dataType": dt, "nullable": True,
             "exprId": {"id": eid, "jvmId": "w2"}}]


def _agg_expr(fn, arg, mode, result_id):
    return [{"class": CAT + "aggregate.AggregateExpression",
             "num-children": 1, "mode": mode, "isDistinct": False,
             "resultId": {"id": result_id, "jvmId": "w2"}},
            {"class": CAT + f"aggregate.{fn}",
             "num-children": 1 if arg else 0}] + (arg or [])


def _node(cls, fields, children):
    out = [{"class": EXEC + cls, "num-children": len(children), **fields}]
    for c in children:
        out += c
    return out


def w2_plan_json(file_groups: Sequence[Sequence[str]],
                 n_parts: int = N_PARTS) -> List[Dict[str, Any]]:
    """The Spark `toJSON` plan of `spark.read.parquet(...)
    .repartition(n_parts).groupBy(sr_store_sk).agg(sum(sr_return_amt),
    count(1))`."""
    store = _attr("sr_store_sk", "long", 1)
    amt = _attr("sr_return_amt", "double", 2)
    one = [{"class": CAT + "Literal", "num-children": 0, "value": "1",
            "dataType": "integer"}]

    def aggs(mode):
        return [_agg_expr("Sum", amt if mode == "Partial" else None, mode,
                          10),
                _agg_expr("Count", one if mode == "Partial" else None,
                          mode, 11)]
    scan = _node("FileSourceScanExec", {"output": [store[0], amt[0]],
                                        "files": [list(g)
                                                  for g in file_groups]},
                 [])
    rr = _node("exchange.ShuffleExchangeExec",
               {"outputPartitioning": [
                   {"class": CAT + "RoundRobinPartitioning",
                    "num-children": 0, "numPartitions": n_parts}]}, [scan])
    partial = _node("aggregate.HashAggregateExec",
                    {"groupingExpressions": [store],
                     "aggregateExpressions": aggs("Partial")}, [rr])
    hashed = _node("exchange.ShuffleExchangeExec",
                   {"outputPartitioning": [
                       {"class": CAT + "HashPartitioning", "num-children": 1,
                        "numPartitions": n_parts}, store[0]]}, [partial])
    return _node("aggregate.HashAggregateExec",
                 {"groupingExpressions": [store],
                  "aggregateExpressions": aggs("Final")}, [hashed])


def run_w2(sr_paths, n_parts: int = N_PARTS, scheduler=None
           ) -> Dict[str, Any]:
    """W2 through `execute_spark_plan_json`, one file a group."""
    from blaze_tpu_torch.device import resolve
    from blaze_tpu_torch.plan.stages import DagScheduler, \
        execute_spark_plan_json
    sched = scheduler if scheduler is not None else DagScheduler()
    t0 = time.perf_counter()
    got = execute_spark_plan_json(w2_plan_json([[p] for p in sr_paths],
                                               n_parts), n_parts,
                                  scheduler=sched)
    if resolve().type == "cuda":
        import torch
        torch.cuda.synchronize()
    return {"table": got, "exec_mode": sched.exec_mode,
            "stages": len(sched.stages) or 1,
            "wall_s": time.perf_counter() - t0, "scheduler": sched}


def w2_oracle(sr_paths) -> pa.Table:
    d = pq.read_table(list(sr_paths),
                      columns=["sr_store_sk", "sr_return_amt"]).to_pandas()
    g = d.groupby("sr_store_sk", as_index=False).agg(
        s=("sr_return_amt", "sum"), n=("sr_return_amt", "size"))
    return pa.Table.from_pandas(g, preserve_index=False)


def w2_error(got: pa.Table, want: pa.Table) -> Optional[str]:
    """None when the groups, their counts (exact) and sums (1e-9
    relative) agree."""
    if got.num_columns != 3 or got.num_rows != want.num_rows:
        return f"shape {got.shape}, want {want.shape}"
    a = got.rename_columns(["k", "s", "n"]).sort_by("k")
    b = want.rename_columns(["k", "s", "n"]).sort_by("k")
    if not np.array_equal(np.asarray(a["k"]), np.asarray(b["k"])) or \
            not np.array_equal(np.asarray(a["n"]), np.asarray(b["n"])):
        return "keys or counts differ"
    s, w = np.asarray(a["s"]), np.asarray(b["s"])
    rel = float(np.max(np.abs(s - w) / np.maximum(np.abs(w), 1e-300))) \
        if len(w) else 0.0
    return None if rel <= 1e-9 else f"sums differ (max rel {rel:.3e})"


# ---------------------------------------------------------------------------
# W3: q01's inner query over a Hive layout, and the FFI probe
# ---------------------------------------------------------------------------

def write_hive(sr_paths: Sequence[str], root: str, n_groups: int = 4,
               row_group_size: int = 1 << 16
               ) -> Tuple[List[List[str]], List[List[List[Any]]]]:
    """store_returns as one parquet file per `sr_store_sk` value without
    that column (rows in their order, in row groups of `row_group_size`),
    written in parallel threads; returns the file groups (files dealt
    round-robin into `n_groups`) and each file's partition values."""
    t = pq.read_table(list(sr_paths))
    keys = t[HIVE_KEY]
    values = sorted(v for v in pc.unique(keys).to_pylist() if v is not None)
    rest = t.drop_columns([HIVE_KEY])
    parts = []
    for v in values:
        d = os.path.join(root, f"{HIVE_KEY}={v}")
        os.makedirs(d, exist_ok=True)
        parts.append((rest.filter(pc.equal(keys, v)),
                      os.path.join(d, "part-00000.parquet"), v))
    with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as pool:
        for f in [pool.submit(pq.write_table, sub, p,
                              row_group_size=row_group_size)
                  for sub, p, _v in parts]:
            f.result()
    groups = q01.file_groups([p for _s, p, _v in parts], n_groups)
    by_path = {p: v for _s, p, v in parts}
    pvals = [[[by_path[p]] for p in g] for g in groups]
    return groups, pvals


def w3_scan(groups, pvals, lo, hi, map_id) -> Dict[str, Any]:
    return {"kind": "parquet_scan", "schema": HIVE_FILE_SCHEMA_D,
            "partition_schema": HIVE_PARTITION_SCHEMA_D,
            "partition_values": pvals,
            "projection": ["sr_returned_date_sk", "sr_customer_sk",
                           HIVE_KEY, "sr_return_amt"],
            "predicate": date_predicate(lo, hi),
            "file_groups": [g if i == map_id else []
                            for i, g in enumerate(groups)]}


def w3_map_td(groups, pvals, lo, hi, map_id, tmpdir, n_parts,
              source: Optional[Dict[str, Any]] = None) -> Dict:
    """q01's map task with the Hive scan (or `source` in its place)."""
    td = q01.stage1_td([], lo, hi, map_id, tmpdir, len(groups), n_parts)
    td["plan"]["input"]["input"]["input"] = (
        source if source is not None
        else w3_scan(groups, pvals, lo, hi, map_id))
    return td


def w3_reduce_td(reduce_id, n_parts) -> Dict:
    td = q01.stage2_td(reduce_id, n_parts)
    td["plan"]["input"]["resource_id"] = W3_SHUFFLE
    td["plan"] = {"kind": "debug", "tag": "w3", "input": td["plan"]}
    return td


def run_w3(groups, pvals, lo, hi, tmpdir, n_parts: int = N_PARTS
           ) -> Dict[str, Any]:
    res = q01.run_stages(
        [q01.Stage("map", lambda m: w3_map_td(groups, pvals, lo, hi, m,
                                              tmpdir, n_parts),
                   len(groups), out_dir=tmpdir, out_partitions=n_parts),
         q01.Stage("reduce", lambda r: w3_reduce_td(r, n_parts), n_parts,
                   reads="map", resource=W3_SHUFFLE)], STAGE_COUNTERS)
    out = pa.Table.from_batches(
        [b for bs in res["reduce"]["outputs"] for b in bs])
    return {"table": out, "shuffle": res["map"]["shuffle"],
            "counters": _sum_counters(res),
            "map_task_counters": res["map"]["task_counters"],
            "map_s": res["map"]["seconds"],
            "reduce_s": res["reduce"]["seconds"]}


def q01_error(got: pa.Table, want: pa.Table) -> Optional[str]:
    """q01's comparison: the group keys exact, the sums within 1e-9
    relative (each side adds in its own order)."""
    keys = ["ctr_customer_sk", "ctr_store_sk"]
    order = [(k, "ascending") for k in keys]
    a = got.select(want.column_names).sort_by(order)
    b = want.sort_by(order)
    if a.num_rows != b.num_rows or not a.select(keys).equals(b.select(keys)):
        return "the group set differs"
    x = np.asarray(a["ctr_total_return"].fill_null(np.nan))
    y = np.asarray(b["ctr_total_return"].fill_null(np.nan))
    if not np.array_equal(np.isnan(x), np.isnan(y)):
        return "null sums differ"
    rel = np.abs(x - y) / np.maximum(np.abs(y), 1e-300)
    worst = float(np.nanmax(rel)) if len(rel) else 0.0
    return None if worst <= 1e-9 else f"sums differ (max rel {worst:.3e})"


def scans_alone(groups, pvals, lo, hi
                ) -> List[Tuple[List[pa.RecordBatch], int]]:
    """Each map task's Hive scan alone, once, through the port's runtime:
    its batches and its `pruned_row_groups`."""
    from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime
    out = []
    for m in range(len(groups)):
        rt = NativeExecutionRuntime({
            "stage_id": 1, "partition_id": m, "num_partitions": len(groups),
            "plan": w3_scan(groups, pvals, lo, hi, m)}).start()
        try:
            batches = list(rt.batches())
        finally:
            tree = rt.finalize()
        out.append((batches, tree.values.get("pruned_row_groups", 0)))
    return out


def ffi_probe(groups, pvals, lo, hi, map_id, tmpdir, scanned_dir,
              n_parts: int = N_PARTS,
              batches: Optional[List[pa.RecordBatch]] = None
              ) -> Dict[str, Any]:
    """Map task `map_id` of W3 again with an ffi_reader handing in the
    batches its scan decodes (`batches`, else its scan run alone); the
    bytes of its `.data` and `.index` against those the scan's run wrote
    under `scanned_dir`."""
    from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
    from blaze_tpu_torch.bridge.runtime import execute_plan
    from blaze_tpu_torch.plan.types import schema_to_dict
    from blaze_tpu_torch.schema import Schema
    if batches is None:
        batches = scans_alone(groups, pvals, lo, hi)[map_id][0]
    schema = (Schema.from_arrow(batches[0].schema) if batches else None)
    put_resource(W3_FFI, batches)
    try:
        source = {"kind": "ffi_reader", "resource_id": W3_FFI,
                  "schema": schema_to_dict(schema),
                  "num_partitions": len(groups)}
        execute_plan(w3_map_td(groups, pvals, lo, hi, map_id, tmpdir,
                               n_parts, source=source))
    finally:
        remove_resource(W3_FFI)
    same = {}
    for suffix in ("data", "index"):
        with open(os.path.join(tmpdir, f"shuffle_{map_id}.{suffix}"),
                  "rb") as f, \
                open(os.path.join(scanned_dir, f"shuffle_{map_id}.{suffix}"),
                     "rb") as g:
            same[suffix] = f.read() == g.read()
    return {"batches": len(batches),
            "rows": sum(b.num_rows for b in batches), "same": same}


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def make_data(scale: float, root: str, n_files: int = 4):
    """store_returns and date_dim at `scale` from their seeds, written as
    itest/q01.py writes them; returns (sr_paths, lo, hi)."""
    from blaze_tpu_torch.itest.tpcds_data import (gen_date_dim,
                                                  gen_store_returns)
    sr_paths, dd_path = q01.write_dataset(
        root, gen_store_returns(scale), gen_date_dim(scale), n_files)
    lo, hi = q01.date_sk_range(dd_path)
    return sr_paths, lo, hi


def run_all(sr_paths, lo, hi, root: str, n_maps: int = 4,
            n_parts: int = N_PARTS,
            hive_row_group_size: int = 1 << 16) -> Dict[str, Any]:
    """W1, W2, W3 and the FFI probe, each held to its oracle; returns
    each run's result with its error (None when equal) and its pruning's
    against the footers."""
    out: Dict[str, Any] = {}
    t0 = time.perf_counter()
    bounds = w1_bounds(w1_sample(sr_paths, lo, hi), n_parts)
    d1 = os.path.join(root, "w1")
    os.makedirs(d1)
    w1 = run_w1(sr_paths, lo, hi, bounds, d1, n_maps, n_parts)
    w1["error"] = w1_error(w1["table"], w1_oracle(sr_paths, lo, hi))
    w1["footer_pruned"] = footer_pruned(sr_paths, lo, hi)
    w1["pruning_error"] = pruning_error(
        w1["map_task_counters"], q01.file_groups(sr_paths, n_maps), lo, hi)
    w1["wall_s"] = time.perf_counter() - t0
    out["w1"] = w1
    t0 = time.perf_counter()
    w2 = run_w2(sr_paths, n_parts)
    w2["error"] = w2_error(w2["table"], w2_oracle(sr_paths))
    out["w2"] = w2
    t0 = time.perf_counter()
    hive = os.path.join(root, "hive")
    groups, pvals = write_hive(sr_paths, hive, n_maps, hive_row_group_size)
    write_s = time.perf_counter() - t0
    d3 = os.path.join(root, "w3")
    os.makedirs(d3)
    w3 = run_w3(groups, pvals, lo, hi, d3, n_parts)
    w3["error"] = q01_error(w3["table"], q01.oracle(sr_paths, lo, hi))
    w3["footer_pruned"] = footer_pruned([p for g in groups for p in g],
                                        lo, hi)
    w3["pruning_error"] = pruning_error(w3["map_task_counters"], groups, lo,
                                        hi)
    alone = scans_alone(groups, pvals, lo, hi)
    w3["scans_alone_pruned"] = sum(p for _b, p in alone)
    w3["write_s"] = write_s
    w3["wall_s"] = time.perf_counter() - t0
    out["w3"] = w3
    dffi = os.path.join(root, "ffi")
    os.makedirs(dffi)
    probe_map = n_maps // 2
    out["ffi"] = ffi_probe(groups, pvals, lo, hi, probe_map, dffi, d3,
                           n_parts, alone[probe_map][0])
    out["ffi"]["map_id"] = probe_map
    return out


def failures(out: Dict[str, Any]) -> List[str]:
    """What in `run_all`'s result is wrong."""
    bad = []
    for k in ("w1", "w2", "w3"):
        if out[k]["error"] is not None:
            bad.append(f"{k}: {out[k]['error']}")
    for k in ("w1", "w3"):
        if out[k]["pruning_error"] is not None:
            bad.append(f"{k}: {out[k]['pruning_error']}")
        if out[k]["footer_pruned"] <= 0:
            bad.append(f"{k}: the footers prune no row group")
    if out["w3"]["scans_alone_pruned"] != out["w3"]["footer_pruned"]:
        bad.append(f"w3: the scans alone pruned "
                   f"{out['w3']['scans_alone_pruned']} row groups, the "
                   f"footers {out['w3']['footer_pruned']}")
    if not all(out["ffi"]["same"].values()):
        bad.append(f"ffi: map bytes differ {out['ffi']['same']}")
    return bad


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=10.0)
    ap.add_argument("--device", default=None,
                    help="auron.torch.device (default: the key's own, "
                    "cuda)")
    args = ap.parse_args(argv)
    if args.device:
        config.conf.set(config.TORCH_DEVICE.key, args.device)
    from blaze_tpu_torch.device import resolve
    if resolve().type == "cuda":
        from blaze_tpu_torch.kernels import build
        t0 = time.perf_counter()
        build.build_all()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    root = tempfile.mkdtemp(prefix="blaze-wire-kinds-")
    try:
        t0 = time.perf_counter()
        sr_paths, lo, hi = make_data(args.scale, root)
        print(f"data: store_returns {sum(pq.ParquetFile(p).metadata.num_rows for p in sr_paths)} "
              f"rows in {len(sr_paths)} files, date_sk in [{lo}, {hi}] "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        out = run_all(sr_paths, lo, hi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"w3: scans alone pruned {out['w3']['scans_alone_pruned']} row "
          f"groups; map loop fallbacks "
          f"{out['w3']['counters']['map']['stage_loop_fallback']}")
    for k in ("w1", "w3"):
        r = out[k]
        print(f"{k}: {r['table'].num_rows} rows, map {r['map_s']:.3f} s, "
              f"reduce {r['reduce_s']:.3f} s, pruned_row_groups "
              f"{r['counters']['map']['pruned_row_groups']} (footers "
              f"{r['footer_pruned']}), "
              f"{'equal to its oracle' if r['error'] is None else r['error']}")
    w2 = out["w2"]
    print(f"w2: {w2['table'].num_rows} groups, {w2['exec_mode']}, "
          f"{w2['stages']} stages, {w2['wall_s']:.3f} s (stage walls "
          f"{ {k: round(v, 3) for k, v in w2['scheduler'].stage_walls.items()} }), "
          f"{'equal to its oracle' if w2['error'] is None else w2['error']}")
    print(f"ffi: map task {out['ffi']['map_id']}, {out['ffi']['batches']} "
          f"batches, {out['ffi']['rows']} rows, same bytes "
          f"{out['ffi']['same']}")
    bad = failures(out)
    print("all equal" if not bad else f"failed: {bad}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
