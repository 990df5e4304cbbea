"""The store-by-day returns rollup as a two-stage query over the wire.

The aggregation of the repository's `bench.py` `device_compute_loop`
(sum and count of `sr_return_amt` by store and return date over q01's date
filter) with q01's wire and shuffle (itest/q01.py):

  map    parquet_scan (q01's 4 columns) -> filter (sr_returned_date_sk in
         [lo, hi]) -> partial hash_agg sum(sr_return_amt) as amt and
         count(sr_return_amt) as cnt by (sr_store_sk as store,
         sr_returned_date_sk as d) -> shuffle_writer (Spark murmur3 pmod
         over both keys into n_reduces partitions)
  reduce ipc_reader -> final hash_agg

Each map task's file statistics bound both keys and the amount, so the map
aggregation plans the dense lane with a window table (plan/fused.py); the
reduce side has no statistics and runs the hash lane.
"""

from __future__ import annotations

import os
from typing import Dict

import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.parquet as pq

from blaze_tpu_torch.itest import q01
from blaze_tpu_torch.itest.q01 import _col, _lit

SHUFFLE_RESOURCE = "bench_rollup_shuffle"

#: q01's stage counters plus the window-table lane's: the rows its table
#: counted and its re-runs through the scatter dense lane
STAGE_COUNTERS = q01.STAGE_COUNTERS + ("mxu_rows", "mxu_verify_fallback")

PARTIAL_SCHEMA_D = {"fields": [
    {"name": "store", "type": {"id": "int64"}, "nullable": True},
    {"name": "d", "type": {"id": "int64"}, "nullable": True},
    {"name": "amt.sum", "type": {"id": "float64"}, "nullable": True},
    {"name": "cnt.count", "type": {"id": "int64"}, "nullable": False},
]}


def stage1_td(sr_paths, lo, hi, map_id, tmpdir, n_maps, n_reduces) -> Dict:
    groups = [g if i == map_id else []
              for i, g in enumerate(q01.file_groups(sr_paths, n_maps))]
    amt = _col("sr_return_amt")
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
            "groupings": [{"expr": _col("sr_store_sk"), "name": "store"},
                          {"expr": _col("sr_returned_date_sk"),
                           "name": "d"}],
            "aggs": [{"fn": "sum", "mode": "partial", "name": "amt",
                      "args": [amt]},
                     {"fn": "count", "mode": "partial", "name": "cnt",
                      "args": [amt]}],
            "input": {
                "kind": "filter",
                "predicates": [
                    {"kind": "binary", "op": ">=",
                     "l": _col("sr_returned_date_sk"), "r": _lit(lo)},
                    {"kind": "binary", "op": "<=",
                     "l": _col("sr_returned_date_sk"), "r": _lit(hi)}],
                "input": {"kind": "parquet_scan", "schema": q01.SR_SCHEMA_D,
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
                       "name": "store"},
                      {"expr": {"kind": "column", "index": 1},
                       "name": "d"}],
        "aggs": [{"fn": "sum", "mode": "final", "name": "amt",
                  "args": [{"kind": "column", "index": 2}]},
                 {"fn": "count", "mode": "final", "name": "cnt",
                  "args": [{"kind": "column", "index": 3}]}],
        "input": {"kind": "ipc_reader", "resource_id": SHUFFLE_RESOURCE,
                  "schema": PARTIAL_SCHEMA_D,
                  "num_partitions": n_reduces}}
    return {"stage_id": 2, "partition_id": reduce_id,
            "num_partitions": n_reduces, "plan": plan}


def run_rollup(sr_paths, lo, hi, tmpdir, n_maps, n_reduces) -> Dict:
    """The rollup's map tasks, then its reduce tasks, through the port's
    runtime (q01.run_two_stage: same return value)."""
    return q01.run_two_stage(
        lambda m: stage1_td(sr_paths, lo, hi, m, tmpdir, n_maps, n_reduces),
        lambda r: stage2_td(r, n_reduces), tmpdir, n_maps, n_reduces,
        SHUFFLE_RESOURCE, STAGE_COUNTERS)


def filtered_rows(sr_paths, lo, hi) -> int:
    """Rows the map-side filter keeps (what the window tables count)."""
    d = pq.read_table(list(sr_paths),
                      columns=["sr_returned_date_sk"])["sr_returned_date_sk"]
    return int(pc.sum(pc.and_(pc.greater_equal(d, lo),
                              pc.less_equal(d, hi))).as_py() or 0)


def oracle(sr_paths, lo, hi) -> pa.Table:
    """The same query as a pyarrow group-by: (store, d, amt, cnt)."""
    t = pq.read_table(list(sr_paths), columns=[
        "sr_returned_date_sk", "sr_store_sk", "sr_return_amt"])
    d = t["sr_returned_date_sk"]
    t = t.filter(pc.and_(pc.greater_equal(d, lo), pc.less_equal(d, hi)))
    g = t.group_by(["sr_store_sk", "sr_returned_date_sk"]).aggregate(
        [("sr_return_amt", "sum"), ("sr_return_amt", "count")])
    return g.select(["sr_store_sk", "sr_returned_date_sk",
                     "sr_return_amt_sum", "sr_return_amt_count"]
                    ).rename_columns(["store", "d", "amt", "cnt"])
