"""TPC-DS q01's inner two-stage query as TaskDefinitions (copies of
`stage1_td`, `stage2_td`, `date_sk_range` and the two schemas of the
repository's `bench.py`), with a driver that runs every map task and then
every reduce task through the port's runtime (`run_two_stage`, which the
rollup path of itest/rollup.py shares, over `run_stages`, which runs any
linear chain of stages: itest/q01_branches.py), and a pyarrow oracle.

  map    parquet_scan (4 columns) -> filter (sr_returned_date_sk in
         [lo, hi]) -> partial hash_agg sum(sr_return_amt) by
         (sr_customer_sk, sr_store_sk) -> shuffle_writer (Spark murmur3
         pmod over both keys into n_reduces partitions)
  reduce ipc_reader -> final hash_agg
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

SHUFFLE_RESOURCE = "bench_q01_shuffle"

#: prefix of the named range (torch.profiler.record_function) that
#: `run_stages` opens around each stage, followed by the stage's name
STAGE_RANGE = "stage "

#: operator counters `run_q01` sums per stage: the fused aggregation's
#: input batches by device type, its partial-skip switches and its table
#: doublings, and the device stage loop's (runtime/loop.py: tasks folded,
#: steps, batches, source rows, regrows, fallbacks to the staged path,
#: graphs captured), and the bytes its scans decoded
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "partial_skipped",
                  "table_grown", "stage_loop_tasks", "stage_loop_chunks",
                  "stage_loop_batches", "stage_loop_rows",
                  "stage_loop_regrows", "stage_loop_fallback",
                  "stage_loop_graph_captures", "io_bytes")

SR_SCHEMA_D = {"fields": [
    {"name": "sr_returned_date_sk", "type": {"id": "int64"},
     "nullable": True},
    {"name": "sr_customer_sk", "type": {"id": "int64"}, "nullable": True},
    {"name": "sr_store_sk", "type": {"id": "int64"}, "nullable": True},
    {"name": "sr_return_amt", "type": {"id": "float64"}, "nullable": True},
    {"name": "sr_ticket_number", "type": {"id": "int64"}, "nullable": True},
]}
PARTIAL_SCHEMA_D = {"fields": [
    {"name": "ctr_customer_sk", "type": {"id": "int64"}, "nullable": True},
    {"name": "ctr_store_sk", "type": {"id": "int64"}, "nullable": True},
    {"name": "ctr_total_return.sum", "type": {"id": "float64"},
     "nullable": True},
]}


def write_dataset(root: str, sr: pa.Table, dd: pa.Table,
                  n_files: int) -> Tuple[List[str], str]:
    """store_returns split into `n_files` parquet files of 65,536-row row
    groups, plus date_dim, as the repository's bench writes them."""
    os.makedirs(root, exist_ok=True)
    sr_paths = [os.path.join(root, f"store_returns_{i}.parquet")
                for i in range(n_files)]
    per = -(-sr.num_rows // n_files)
    for i, p in enumerate(sr_paths):
        pq.write_table(sr.slice(i * per, per), p, row_group_size=1 << 16)
    dd_path = os.path.join(root, "date_dim.parquet")
    pq.write_table(dd, dd_path)
    return sr_paths, dd_path


def file_groups(paths: Sequence[str], n_groups: int) -> List[List[str]]:
    """FilePartition packing: files round-robin into map partitions."""
    groups: List[List[str]] = [[] for _ in range(n_groups)]
    for i, p in enumerate(paths):
        groups[i % n_groups].append(p)
    return groups


def date_sk_range(dd_path: str) -> Tuple[int, int]:
    """The d_year=2000 date-key range (what Spark's dynamic partition
    pruning would push into the fact-table scan)."""
    dd = pq.read_table(dd_path, columns=["d_date_sk", "d_year"])
    keys = dd.filter(pc.equal(dd["d_year"], 2000))["d_date_sk"]
    return int(pc.min(keys).as_py()), int(pc.max(keys).as_py())


def _col(name):
    return {"kind": "column", "name": name}


def _lit(v):
    return {"kind": "literal", "value": v, "type": {"id": "int64"}}


def stage1_td(sr_paths, lo, hi, map_id, tmpdir, n_maps, n_reduces) -> Dict:
    # the wire carries ONE file group per task: this task's group stays,
    # siblings blank out
    groups = [g if i == map_id else []
              for i, g in enumerate(file_groups(sr_paths, n_maps))]
    plan = {
        "kind": "shuffle_writer",
        "partitioning": {"kind": "hash",
                         "exprs": [{"kind": "column", "index": 0},
                                   {"kind": "column", "index": 1}],
                         "num_partitions": n_reduces},
        "data_file": os.path.join(tmpdir, f"shuffle_{map_id}.data"),
        "index_file": os.path.join(tmpdir, f"shuffle_{map_id}.index"),
        "input": {
            "kind": "hash_agg",
            "groupings": [{"expr": _col("sr_customer_sk"),
                           "name": "ctr_customer_sk"},
                          {"expr": _col("sr_store_sk"),
                           "name": "ctr_store_sk"}],
            "aggs": [{"fn": "sum", "mode": "partial",
                      "name": "ctr_total_return",
                      "args": [_col("sr_return_amt")]}],
            "input": {
                "kind": "filter",
                "predicates": [
                    {"kind": "binary", "op": ">=",
                     "l": _col("sr_returned_date_sk"), "r": _lit(lo)},
                    {"kind": "binary", "op": "<=",
                     "l": _col("sr_returned_date_sk"), "r": _lit(hi)}],
                "input": {"kind": "parquet_scan", "schema": SR_SCHEMA_D,
                          "projection": ["sr_returned_date_sk",
                                         "sr_customer_sk", "sr_store_sk",
                                         "sr_return_amt"],
                          "file_groups": groups}}}}
    return {"stage_id": 1, "partition_id": map_id,
            "num_partitions": n_maps, "plan": plan}


def stage2_td(reduce_id, n_reduces) -> Dict:
    plan = {
        "kind": "hash_agg",
        "groupings": [{"expr": {"kind": "column", "index": 0},
                       "name": "ctr_customer_sk"},
                      {"expr": {"kind": "column", "index": 1},
                       "name": "ctr_store_sk"}],
        "aggs": [{"fn": "sum", "mode": "final", "name": "ctr_total_return",
                  "args": [{"kind": "column", "index": 2}]}],
        "input": {"kind": "ipc_reader", "resource_id": SHUFFLE_RESOURCE,
                  "schema": PARTIAL_SCHEMA_D,
                  "num_partitions": n_reduces}}
    return {"stage_id": 2, "partition_id": reduce_id,
            "num_partitions": n_reduces, "plan": plan}


def run_q01(sr_paths, lo, hi, tmpdir, n_maps, n_reduces) -> Dict:
    """q01's map tasks, then its reduce tasks, through `run_two_stage`."""
    return run_two_stage(
        lambda m: stage1_td(sr_paths, lo, hi, m, tmpdir, n_maps, n_reduces),
        lambda r: stage2_td(r, n_reduces), tmpdir, n_maps, n_reduces,
        SHUFFLE_RESOURCE, STAGE_COUNTERS)


@dataclass
class Stage:
    """One stage of a linear chain for `run_stages`: `n_tasks` tasks, task
    t running the TaskDefinition `task_td(t)`.  A stage that writes a
    shuffle has its task t write `shuffle_{t}.data` and `.index` with
    `out_partitions` partitions under `out_dir`; a stage that reads one
    names the stage it reads (`reads`) and the shuffle resource its
    ipc_reader asks for (`resource`)."""

    name: str
    task_td: Callable[[int], Dict]
    n_tasks: int
    out_dir: Optional[str] = None
    out_partitions: int = 0
    reads: Optional[str] = None
    resource: Optional[str] = None


def run_stages(stages: Sequence[Stage],
               stage_counters: Sequence[str]) -> Dict[str, Dict]:
    """Every task of every stage, stage by stage in the given order, as
    TaskDefinition bytes through the port's runtime.  Before a stage that
    reads a shuffle runs, its resource serves the blocks of the stage it
    reads.  Returns per stage name: its tasks' outputs (one list of
    batches per task), the shuffle files it wrote with their offsets, the
    `stage_counters` summed over its tasks and its host wall seconds,
    ending in a device synchronisation."""
    import torch

    from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
    from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime
    from blaze_tpu_torch.plan.proto_serde import task_definition_to_bytes
    from blaze_tpu_torch.shuffle import FileSegmentBlock, read_index_file

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def count(counters, node):
        for k in stage_counters:
            counters[k] = counters.get(k, 0) + node.values.get(k, 0)
        for c in node.children:
            count(counters, c)

    def blocks(written, stage_id):
        def blocks_for(part):
            return [FileSegmentBlock(d, offs[part],
                                     offs[part + 1] - offs[part],
                                     stage_id=stage_id, map_id=m)
                    for m, (d, _i, offs) in enumerate(written)
                    if offs[part + 1] > offs[part]]
        return blocks_for

    results: Dict[str, Dict] = {}
    stage_ids = {st.name: i + 1 for i, st in enumerate(stages)}
    resources = set()
    try:
        for st in stages:
            t0 = time.perf_counter()
            if st.reads is not None:
                put_resource(st.resource, blocks(
                    results[st.reads]["shuffle"], stage_ids[st.reads]))
                resources.add(st.resource)
            counters: Dict[str, int] = {}
            outputs = []
            # a named range per stage, for torch.profiler's per-stage counts
            with torch.profiler.record_function(STAGE_RANGE + st.name):
                for t in range(st.n_tasks):
                    rt = NativeExecutionRuntime(
                        task_definition_to_bytes(st.task_td(t)))
                    try:
                        outputs.append(list(rt.batches()))
                    finally:
                        count(counters, rt.finalize())
                sync()
            written = []
            if st.out_dir is not None:
                for t in range(st.n_tasks):
                    data = os.path.join(st.out_dir, f"shuffle_{t}.data")
                    index = os.path.join(st.out_dir, f"shuffle_{t}.index")
                    written.append((data, index, read_index_file(
                        index, expected_partitions=st.out_partitions,
                        data_file=data)))
            results[st.name] = {"outputs": outputs, "shuffle": written,
                                "counters": counters,
                                "seconds": time.perf_counter() - t0}
    finally:
        for r in resources:
            remove_resource(r)
    return results


def run_two_stage(map_td: Callable[[int], Dict],
                  reduce_td: Callable[[int], Dict], tmpdir: str, n_maps: int,
                  n_reduces: int, resource: str,
                  stage_counters: Sequence[str]) -> Dict:
    """Every map task `map_td(m)` (each writing `shuffle_{m}.data` and
    `.index` under `tmpdir`), then every reduce task `reduce_td(r)`
    (reading them through the shuffle resource `resource`), through
    `run_stages`.  Returns the reduce outputs (one list of batches per
    reduce partition), the shuffle files with their offsets, the
    `stage_counters` summed over each stage's tasks and the host wall
    seconds of each stage, each ending in a device synchronisation."""
    res = run_stages(
        [Stage("map", map_td, n_maps, out_dir=tmpdir,
               out_partitions=n_reduces),
         Stage("reduce", reduce_td, n_reduces, reads="map",
               resource=resource)], stage_counters)
    return {"reduce_outputs": res["reduce"]["outputs"],
            "shuffle": res["map"]["shuffle"],
            "counters": {k: res[k]["counters"] for k in ("map", "reduce")},
            "map_s": res["map"]["seconds"],
            "reduce_s": res["reduce"]["seconds"]}


def oracle(sr_paths, lo, hi) -> pa.Table:
    """The same query as a pyarrow group-by: (customer, store, sum)."""
    t = pq.read_table(list(sr_paths), columns=[
        "sr_returned_date_sk", "sr_customer_sk", "sr_store_sk",
        "sr_return_amt"])
    d = t["sr_returned_date_sk"]
    t = t.filter(pc.and_(pc.greater_equal(d, lo), pc.less_equal(d, hi)))
    g = t.group_by(["sr_customer_sk", "sr_store_sk"]).aggregate(
        [("sr_return_amt", "sum")])
    return g.rename_columns(["ctr_customer_sk", "ctr_store_sk",
                             "ctr_total_return"])
