"""TPC-DS q01's inner query with Spark's runtime bloom filter, the card
path of the expression layer:

  build   parquet_scan date_dim (d_date_sk) -> filter (d_date_sk in
          [lo, hi]) -> hash_agg complete bloom_filter(d_date_sk), no
          grouping, sized for hi - lo + 1 items at Spark's fpp of 0.03:
          one filter, registered in the resource map under its uuid;
  map     q01's map stage (itest/q01.py `stage1_td`) whose filter holds
          bloom_filter_might_contain(uuid, sr_returned_date_sk) beside
          the exact range;
  reduce  q01's reduce stage.

The bloom filter cannot drop a row in the range (it has no false
negative) and the range drops every row outside it, so the answer is q01
inner's, held to q01's pyarrow oracle.  `probe_stats` probes every
store_returns key on the card: none in the range may fail, and the share
of keys outside it that pass is the filter's false-positive rate.

A filter may be built over a narrower range than the probe's (`build`):
the probe then drops rows of the probe's range, and `oracle` keeps the
rows whose key the same filter passes on the CPU.  Two runs under one
uuid with two such filters show that a process reads each run's own
filter (the stage loop keys its graphs on it).

    python -m blaze_tpu_torch.itest.runtime_filter --scale 0.05 --device cpu
    python -m blaze_tpu_torch.itest.runtime_filter --scale 10
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch.itest import q01

#: Spark's default false-positive probability of a runtime bloom filter
FPP = 0.03
UUID = "runtime-filter-q01"
DD_SCHEMA_D = {"fields": [
    {"name": "d_date_sk", "type": {"id": "int64"}, "nullable": True}]}


def build_plan(dd_path: str, lo: int, hi: int) -> Dict:
    """The build side: a bloom filter over date_dim's keys in the range."""
    col = {"kind": "column", "name": "d_date_sk"}
    return {
        "kind": "hash_agg", "groupings": [],
        "aggs": [{"fn": "bloom_filter", "mode": "complete", "name": "bloom",
                  "args": [col],
                  "options": {"expected_items": hi - lo + 1}}],
        "input": {"kind": "filter",
                  "predicates": [
                      {"kind": "binary", "op": ">=", "l": col,
                       "r": q01._lit(lo)},
                      {"kind": "binary", "op": "<=", "l": col,
                       "r": q01._lit(hi)}],
                  "input": {"kind": "parquet_scan", "schema": DD_SCHEMA_D,
                            "file_groups": [[dd_path]]}}}


def build_filter(dd_path: str, lo: int, hi: int):
    """Run the build plan on the configured device; returns the filter."""
    from blaze_tpu_torch.kernels.bloom import SparkBloomFilter
    from blaze_tpu_torch.plan.planner import create_plan
    plan = create_plan(build_plan(dd_path, lo, hi))
    out = [b.to_arrow() for b in plan.execute(0)]
    blob = pa.Table.from_batches(out).column("bloom")[0].as_py()
    return SparkBloomFilter.from_bytes(blob)


def map_td(sr_paths, lo, hi, map_id, tmpdir, n_maps, n_reduces,
           uuid: str = UUID) -> Dict:
    """q01's map task with the probe beside the range filter."""
    td = q01.stage1_td(sr_paths, lo, hi, map_id, tmpdir, n_maps, n_reduces)
    filt = td["plan"]["input"]["input"]
    filt["predicates"].append(
        {"kind": "bloom_filter_might_contain", "uuid": uuid,
         "value": {"kind": "column", "name": "sr_returned_date_sk"}})
    return td


def probe_stats(filt, sr_paths: Sequence[str], lo: int, hi: int) -> Dict:
    """Every non-null store_returns date key probed on the configured
    device: the rows and distinct keys in and out of the range, and how
    many of each pass the filter."""
    from blaze_tpu_torch.batch import to_device
    from blaze_tpu_torch.device import resolve
    keys = pq.read_table(list(sr_paths), columns=["sr_returned_date_sk"])
    k = np.asarray(keys.column(0).drop_null(), dtype=np.int64)
    passed = filt.might_contain_longs(to_device(k, resolve())).cpu().numpy()
    inside = (k >= lo) & (k <= hi)
    return {"rows_in_range": int(inside.sum()),
            "rows_in_range_passed": int(passed[inside].sum()),
            "rows_out_of_range": int((~inside).sum()),
            "rows_out_of_range_passed": int(passed[~inside].sum()),
            "keys_out_of_range": len(np.unique(k[~inside])),
            "keys_out_of_range_passed": len(np.unique(k[~inside & passed]))}


def fpp_limit(keys_out: int) -> float:
    """Spark's fpp plus three standard deviations of the share of
    `keys_out` independent keys that pass."""
    return FPP + 3 * math.sqrt(FPP * (1 - FPP) / max(keys_out, 1))


def check(stats: Dict) -> List[str]:
    """What the probe must hold: no key in the range fails it, and the
    out-of-range keys and rows pass at no more than `fpp_limit`."""
    bad = []
    if stats["rows_in_range_passed"] != stats["rows_in_range"]:
        bad.append(f"{stats['rows_in_range'] - stats['rows_in_range_passed']}"
                   f" rows in the range failed the probe")
    limit = fpp_limit(stats["keys_out_of_range"])
    for what in ("keys", "rows"):
        n = stats[f"{what}_out_of_range"]
        share = stats[f"{what}_out_of_range_passed"] / n if n else 0.0
        if share > limit:
            bad.append(f"{share:.4f} of the {what} outside the range "
                       f"passed (limit {limit:.4f})")
    return bad


def run_runtime_filter(sr_paths, dd_path, lo, hi, tmpdir, n_maps,
                       n_reduces, build=None) -> Dict:
    """Build the filter over date_dim's keys in `build` (default: the
    probe's range [lo, hi]), register it, run q01's two stages with it,
    and probe every key against the build range; returns run_two_stage's
    result with `build_s`, `filter` (bits, hashes), `build`, `bloom` (the
    filter) and `probe`."""
    from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
    blo, bhi = build if build is not None else (lo, hi)
    t0 = time.perf_counter()
    filt = build_filter(dd_path, blo, bhi)
    build_s = time.perf_counter() - t0
    put_resource(UUID, filt)
    try:
        res = q01.run_two_stage(
            lambda m: map_td(sr_paths, lo, hi, m, tmpdir, n_maps,
                             n_reduces),
            lambda r: q01.stage2_td(r, n_reduces), tmpdir, n_maps,
            n_reduces, q01.SHUFFLE_RESOURCE, q01.STAGE_COUNTERS)
    finally:
        remove_resource(UUID)
    res["build_s"] = build_s
    res["filter"] = {"num_bits": filt.num_bits,
                     "num_hashes": filt.num_hashes}
    res["build"] = [blo, bhi]
    res["bloom"] = filt
    res["probe"] = probe_stats(filt, sr_paths, blo, bhi)
    return res


def oracle(sr_paths, lo, hi, filt) -> pa.Table:
    """q01's oracle over the rows whose key is in [lo, hi] and passes
    `filt`, probed on the CPU (every key of the build range passes)."""
    import pyarrow.compute as pc
    import torch
    t = pq.read_table(list(sr_paths), columns=[
        "sr_returned_date_sk", "sr_customer_sk", "sr_store_sk",
        "sr_return_amt"])
    d = t["sr_returned_date_sk"]
    t = t.filter(pc.and_(pc.greater_equal(d, lo), pc.less_equal(d, hi)))
    keys = np.unique(np.asarray(t["sr_returned_date_sk"].combine_chunks()
                                .drop_null(), dtype=np.int64))
    passed = filt.might_contain_longs(torch.from_numpy(keys)).numpy()
    t = t.filter(pc.is_in(t["sr_returned_date_sk"],
                          value_set=pa.array(keys[passed])))
    g = t.group_by(["sr_customer_sk", "sr_store_sk"]).aggregate(
        [("sr_return_amt", "sum")])
    return g.rename_columns(["ctr_customer_sk", "ctr_store_sk",
                             "ctr_total_return"])


def same_as_oracle(res: Dict, sr_paths, lo, hi) -> bool:
    """The reduce output equals `oracle` for the run's filter: the same
    groups, sums within 1e-9 relative (the oracle adds in its own
    order)."""
    out = pa.Table.from_batches(
        [b for bs in res["reduce_outputs"] for b in bs])
    ora = oracle(sr_paths, lo, hi, res["bloom"]).select(out.column_names)
    order = [(k, "ascending") for k in ("ctr_customer_sk", "ctr_store_sk")]
    a, b = out.sort_by(order), ora.sort_by(order)
    if a.num_rows != b.num_rows or not a.select([0, 1]).equals(
            b.select([0, 1])):
        return False
    x = np.asarray(a.column(2).fill_null(0.0))
    y = np.asarray(b.column(2).fill_null(0.0))
    return bool((np.asarray(a.column(2).is_null())
                 == np.asarray(b.column(2).is_null())).all()
                and (np.abs(x - y) <= 1e-9 * np.maximum(1.0, np.abs(y))).all())


def main(argv=None) -> int:
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest.tpcds_data import (gen_date_dim,
                                                  gen_store_returns)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--maps", type=int, default=4)
    ap.add_argument("--reduces", type=int, default=16)
    args = ap.parse_args(argv)
    config.conf.set(config.TORCH_DEVICE.key, args.device)
    with tempfile.TemporaryDirectory() as root:
        sr_paths, dd_path = q01.write_dataset(
            root, gen_store_returns(args.scale), gen_date_dim(args.scale),
            args.maps)
        lo, hi = q01.date_sk_range(dd_path)
        shuffle = os.path.join(root, "shuffle")
        os.makedirs(shuffle)
        res = run_runtime_filter(sr_paths, dd_path, lo, hi, shuffle,
                                 args.maps, args.reduces)
        ok = same_as_oracle(res, sr_paths, lo, hi)
    failures = check(res["probe"]) + ([] if ok else ["result != oracle"])
    print(json.dumps({"scale": args.scale, "device": args.device,
                      "build_s": res["build_s"], "map_s": res["map_s"],
                      "reduce_s": res["reduce_s"], "filter": res["filter"],
                      "probe": res["probe"], "counters": res["counters"],
                      "failures": failures}))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
