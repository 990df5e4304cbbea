"""Time the sort-merge join's walk at TPC-DS q51's row counts.

q51 (itest/queries.py) joins two running-sum streams full outer on
(item_sk, date_sk) in one task: 238,180 web and 928,021 store rows of
distinct keys, 1,139,607 rows out at SF10 (PERF.md §4).  This script makes
two sorted inputs of that shape from a seed (two int64 keys, two float64
values, `auron.batch.size` rows a batch on the device) and times the merge
from the sorted batches to the coalesced output batches, as
SortMergeJoinExec runs it.  `--baseline FILE` names another version of
ops/joins/smj.py, timed beside this one in the order baseline, this, this,
baseline; a version with a `_RunCursor` is driven through its run cursors
(the interface of the streaming cursor that walked one run a step).  Every
run must give the same rows in the same order.

    python -m blaze_tpu_torch.itest.smj_walk [--baseline FILE] [--scale S]

The last line is one JSON object with each run's seconds.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np
import pyarrow as pa

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import BoundReference
from blaze_tpu_torch.ops.base import CoalesceStream
from blaze_tpu_torch.ops.joins import smj
from blaze_tpu_torch.ops.joins.exec import JoinType
from blaze_tpu_torch.schema import Schema

LEFT_ROWS, RIGHT_ROWS, OUT_ROWS = 238_180, 928_021, 1_139_607


def make_sides(scale: float, seed: int):
    """Two tables of distinct (item_sk, date_sk) keys sorted ascending,
    sharing LEFT + RIGHT - OUT keys, with rev and cume values."""
    rng = np.random.default_rng(seed)
    nl, nr = int(LEFT_ROWS * scale), int(RIGHT_ROWS * scale)
    shared = nl + nr - int(OUT_ROWS * scale)
    items, days = 18_000, 365
    keys = rng.choice(items * days, nl + nr - shared, replace=False)
    lk = np.sort(keys[:nl])
    rk = np.sort(np.concatenate([keys[nl:], keys[:shared]]))

    def table(k, prefix):
        rev = rng.random(len(k)) * 100.0
        return pa.table({f"{prefix}_item_sk": k // days + 1,
                         f"{prefix}_date_sk": k % days + 2_451_911,
                         f"{prefix}_rev": rev,
                         f"{prefix}_cume": np.cumsum(rev)})
    return table(lk, "w"), table(rk, "s")


def _batches(tbl: pa.Table, device):
    for rb in tbl.to_batches(max_chunksize=config.BATCH_SIZE.get()):
        yield ColumnBatch.from_arrow(rb, device=device)


def _load(path: str):
    spec = importlib.util.spec_from_file_location("smj_baseline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def walk(mod, left: pa.Table, right: pa.Table, device) -> tuple:
    """One merge of `left` and `right` by the smj module `mod`: seconds,
    output rows and a digest of the output in order."""
    schemas = [Schema.from_arrow(t.schema) for t in (left, right)]
    out = Schema.from_arrow(pa.schema(list(left.schema) +
                                      list(right.schema)))
    keys = [BoundReference(0), BoundReference(1)]
    joiner = mod.MergeJoiner(schemas[0], schemas[1], out, JoinType.FULL,
                             None)
    lb, rb_ = list(_batches(left, device)), list(_batches(right, device))
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if hasattr(mod, "_RunCursor"):
        def arrow(batches):
            for b in batches:
                yield b.compact().to_arrow()
        stream = joiner.join(mod._RunCursor(arrow(lb), keys, schemas[0]),
                             mod._RunCursor(arrow(rb_), keys, schemas[1]))
    else:
        stream = joiner.join(mod._Side(iter(lb), keys, schemas[0]),
                             mod._Side(iter(rb_), keys, schemas[1]))
    outs = list(CoalesceStream(ColumnBatch.from_arrow(rb, device=device)
                               for rb in stream))
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    table = pa.Table.from_batches([b.compact().to_arrow() for b in outs])
    digest = hashlib.sha256()
    for col in table.columns:
        digest.update(np.asarray(col.fill_null(-1)).tobytes())
    return seconds, table.num_rows, digest.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", help="another version of smj.py")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of q51's SF10 row counts")
    ap.add_argument("--seed", type=int, default=51)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    import torch
    config.conf.set(config.TORCH_DEVICE.key, args.device)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    left, right = make_sides(args.scale, args.seed)
    runs = [("this", smj)] * 2
    if args.baseline:
        base = _load(args.baseline)
        runs = [("baseline", base)] + runs + [("baseline", base)]
    result, digests = [], set()
    for name, mod in runs:
        seconds, rows, digest = walk(mod, left, right, device)
        digests.add(digest)
        print(f"{name}: {seconds:.3f} s, {rows} rows", flush=True)
        result.append({"version": name, "seconds": seconds, "rows": rows})
    ok = len(digests) == 1
    print(json.dumps({"left_rows": left.num_rows,
                      "right_rows": right.num_rows, "runs": result,
                      "same_rows_in_order": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
