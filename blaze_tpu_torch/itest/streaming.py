"""The two streaming paths over Nexmark's bid stream (itest/nexmark.py),
each held to a pyarrow oracle of the same semantics:

  N1  the Flink front door: Nexmark q2 and a reduced q17 (nexmark.py
      `q2_plan`, `q17_plan`) through convert/flink_runtime.py
      `FlinkMicroBatchOperator` over the stream's partitions, in
      micro-batches of `auron.batch.size` records a partition, each plan
      partition one TaskDefinition through the runtime.  Every
      micro-batch's output is held to its oracle: q2's rows in the
      output's order (partition, then offset), exact; q17 grouped by
      auction within each (micro-batch, partition), as the converted plan
      groups, integers exact and avg equal to the integer sum over the
      count as float64.  q2 runs with a CheckpointManager (an epoch a
      micro-batch); then its epoch 0 is fed again to a fresh operator over
      the same checkpoints, which must run nothing and count one dup
      skip.
  N2  the stream: streaming/executor.py `StreamExecutor.from_flink_plan`
      on `calc_plan` (auction, price) with Nexmark q5's hop window (10 s,
      sliding 2 s) keyed by auction: count(*), max(price), sum(price);
      lateness 0, policy drop, polls of `poll` records a partition,
      through `QueryService(executor=streaming_service_executor(...))` at
      maxConcurrent 1 with one `stream-epoch` and one `checkpoint-commit`
      fault mid-stream (bench.py's soak).  The sink's committed table is
      held to a pyarrow group-by over the generated bids row for row
      (after sorting both by window and key), with the lost and
      duplicated rows counted; late records 0, two recoveries, and the
      stream counters (bridge/device_stats.py `stream_stats`) add up.

From the shell (on the card; `--device cpu` runs it on the CPU):

    python -m blaze_tpu_torch.itest.streaming [--bids-log2 20] [--seed 7]
        [--poll 8192] [--profile-n2]

(`--bids-log2 16 --poll 1024 --device cpu` runs both paths here in a few
seconds, N2 over 16 epochs.)

`run_n1` and `run_n2` return their numbers and a `failures` list (empty
when every check held); `main` exits 1 when one is not empty.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np
import pyarrow as pa

from blaze_tpu_torch import config, faults
from blaze_tpu_torch.itest import nexmark

#: Nexmark q5's hop window: size 10 s, slide 2 s (epoch ms)
WINDOW_MS, SLIDE_MS = 10_000, 2_000
#: the windowed stream's poll: records a partition an epoch
POLL = 8_192


def _micro_batches(stream: nexmark.BidStream, per: int) -> List[list]:
    """The stream's records cut into micro-batches of `per` records a
    partition: [[partition 0's records, partition 1's, ...], ...]."""
    longest = max(len(p) for p in stream.partitions)
    return [[p[lo:lo + per] for p in stream.partitions]
            for lo in range(0, longest, per)]


def _rows(batches) -> pa.Table:
    return pa.Table.from_batches(batches) if batches else None


def _mb_order(stream: nexmark.BidStream, m: int, per: int) -> np.ndarray:
    """The bid indices of micro-batch m in the output's order: partition,
    then offset."""
    sel = np.nonzero(stream.offset // per == m)[0]
    return sel[np.lexsort((stream.offset[sel], stream.partition[sel]))]


def q2_oracle(stream: nexmark.BidStream, m: int, per: int) -> pa.Table:
    idx = _mb_order(stream, m, per)
    idx = idx[stream.auction[idx] % 123 == 0]
    return pa.table({"f0": stream.auction[idx], "f1": stream.price[idx]})


def q17_oracle(stream: nexmark.BidStream, m: int, per: int) -> pa.Table:
    """Grouped by auction within each partition of micro-batch m, sorted
    by every column."""
    idx = np.nonzero(stream.offset // per == m)[0]
    part, auc, price = (stream.partition[idx], stream.auction[idx],
                        stream.price[idx])
    order = np.lexsort((auc, part))
    part, auc, price = part[order], auc[order], price[order]
    starts = np.nonzero(np.r_[True, (part[1:] != part[:-1])
                              | (auc[1:] != auc[:-1])])[0]
    count = np.diff(np.r_[starts, len(auc)])
    total = np.add.reduceat(price, starts)
    t = pa.table({"g0": auc[starts], "total_bids": count.astype(np.int64),
                  "min_price": np.minimum.reduceat(price, starts),
                  "max_price": np.maximum.reduceat(price, starts),
                  "sum_price": total,
                  "avg_price": total.astype(np.float64) / count})
    return t.sort_by([(c, "ascending") for c in t.column_names])


def _same(got: Optional[pa.Table], want: pa.Table) -> bool:
    if got is None:
        return want.num_rows == 0
    got = got.rename_columns(want.column_names)
    return got.cast(want.schema).equals(want)


def run_n1(stream: nexmark.BidStream, work_dir: str) -> Dict[str, Any]:
    """Both plans through FlinkMicroBatchOperator over every micro-batch,
    each held to its oracle; then the replay of q2's epoch 0."""
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.convert.flink_runtime import FlinkMicroBatchOperator
    from blaze_tpu_torch.streaming import CheckpointManager
    per = config.BATCH_SIZE.get()
    mbs = _micro_batches(stream, per)
    n = len(stream.partitions)
    failures: List[str] = []
    out: Dict[str, Any] = {"micro_batches": len(mbs), "per_partition": per}
    ckpt = CheckpointManager(os.path.join(work_dir, "n1-ckpt"))
    for name, plan, oracle in (
            ("q2", nexmark.q2_plan(), q2_oracle),
            ("q17", nexmark.q17_plan(), q17_oracle)):
        op = FlinkMicroBatchOperator(plan, num_partitions=n,
                                     checkpoint=ckpt if name == "q2"
                                     else None)
        walls, rows, equal = [], 0, 0
        h2d = device_stats.snapshot()["h2d_transfers"]
        for m, mb in enumerate(mbs):
            t0 = time.perf_counter()
            got = _rows(op.run_micro_batch(mb, epoch=m if name == "q2"
                                           else None))
            walls.append(time.perf_counter() - t0)
            if name == "q17" and got is not None:
                got = got.sort_by([(c, "ascending")
                                   for c in got.column_names])
            want = oracle(stream, m, per)
            rows += want.num_rows
            if _same(got, want):
                equal += 1
            else:
                failures.append(
                    f"N1 {name} micro-batch {m}: "
                    f"{0 if got is None else got.num_rows} rows against "
                    f"the oracle's {want.num_rows}, not equal")
        want_offsets = {p: len(part) for p, part in
                        enumerate(stream.partitions)}
        if op.offsets != want_offsets:
            failures.append(f"N1 {name}: offsets {op.offsets}, want "
                            f"{want_offsets}")
        out[name] = {"walls_s": walls, "wall_s": sum(walls), "rows": rows,
                     "equal_micro_batches": equal,
                     "h2d_transfers":
                         device_stats.snapshot()["h2d_transfers"] - h2d,
                     "bids_per_s": stream.num_bids / sum(walls),
                     "batches_run": op.batches_run}
    before = device_stats.stream_stats()["stream_sink_dup_skips"]
    replay = FlinkMicroBatchOperator(nexmark.q2_plan(), num_partitions=n,
                                     checkpoint=ckpt)
    got = replay.run_micro_batch(mbs[0], epoch=0)
    skips = device_stats.stream_stats()["stream_sink_dup_skips"] - before
    committed = CheckpointManager.offsets_from(ckpt.load(0))
    out["replay"] = {"batches": len(got), "batches_run": replay.batches_run,
                     "dup_skips": skips, "offsets": replay.offsets}
    if got or replay.batches_run or skips != 1 \
            or replay.offsets != committed:
        failures.append(f"N1 replay of epoch 0 ran or miscounted: "
                        f"{out['replay']}, committed offsets {committed}")
    out["failures"] = failures
    return out


def decode_rate(stream: nexmark.BidStream, records: int = 32_768) -> float:
    """Records a second of the Kafka scan's JSON decode alone
    (ops/kafka.py `JsonDeserializer`) over partition 0's first
    `records` records, on this host."""
    from blaze_tpu_torch.convert.flink import convert_flink_plan
    from blaze_tpu_torch.ops.kafka import JsonDeserializer
    from blaze_tpu_torch.plan.types import schema_from_dict
    from blaze_tpu_torch.streaming.executor import _find_scan
    scan = _find_scan(convert_flink_plan(nexmark.q2_plan()))
    deser = JsonDeserializer(schema_from_dict(scan["schema"]))
    values = [r.value for r in stream.partitions[0][:records]]
    t0 = time.perf_counter()
    deser.deserialize(values)
    return len(values) / (time.perf_counter() - t0)


def n2_oracle(stream: nexmark.BidStream) -> pa.Table:
    """The hop windows of every bid (each bid in size/slide windows),
    grouped by (auction, window start), sorted by window then auction."""
    k = WINDOW_MS // SLIDE_MS
    ts = stream.timestamp_ms
    last = ts - ts % SLIDE_MS
    starts = (last[:, None] - SLIDE_MS * np.arange(k)[None, :]).ravel()
    keep = starts > np.repeat(ts, k) - WINDOW_MS
    flat = pa.table({"f0": np.repeat(stream.auction, k)[keep],
                     "window_start": starts[keep],
                     "f1": np.repeat(stream.price, k)[keep]})
    g = flat.group_by(["f0", "window_start"]).aggregate(
        [("f1", "count"), ("f1", "max"), ("f1", "sum")])
    t = pa.table({"f0": g["f0"], "window_start": g["window_start"],
                  "window_end": pa.compute.add(g["window_start"],
                                               WINDOW_MS),
                  "count": g["f1_count"], "max_f1": g["f1_max"],
                  "sum_f1": g["f1_sum"]})
    return t.sort_by([("window_start", "ascending"), ("f0", "ascending")])


def _lost_and_duplicated(got: pa.Table, want: pa.Table):
    """The oracle's (key, window) panes the sink lacks, and the sink's rows
    beyond one a pane of the oracle (a pane twice, or one the oracle does
    not have)."""
    def panes(t):
        return list(zip(t["f0"].to_pylist(), t["window_start"].to_pylist()))
    g, w = panes(got), set(panes(want))
    seen = set(g)
    return len(w - seen), len(g) - len(seen) + len(seen - w)


#: N2's host work by part, each a function whose cumulative time the
#: profile reads: (label, file suffix, function name)
PROFILE_PARTS = (
    ("decode", "ops/kafka.py", "deserialize"),
    ("plan run", "streaming/executor.py", "_run_plan"),
    ("window fold", "ops/window.py", "add_batch"),
    ("window fire", "ops/window.py", "advance"),
    ("snapshot", "ops/window.py", "snapshot"),
    ("checkpoint commit", "streaming/checkpoint.py", "commit"),
    ("sink write", "streaming/sink.py", "write_attempt"),
    ("epoch", "streaming/executor.py", "_run_epoch"),
)


def _profiled(executor, out: Dict[str, Any]):
    """`executor` run under cProfile in the service slot's thread (the
    thread that runs every epoch); `out` gets the thread's profiled
    seconds, each PROFILE_PARTS function's share of them (cumulative,
    so nested parts overlap: the decode runs inside the plan run) and
    the ten functions of most own time.  The profiler's own cost inflates
    the Python-heavy parts: read shares, not walls."""
    import cProfile
    import pstats

    def run(plan, ctx, handle=None):
        prof = cProfile.Profile()
        prof.enable()
        try:
            return executor(plan, ctx, handle)
        finally:
            prof.disable()
            st = pstats.Stats(prof).stats
            total = sum(v[2] for v in st.values())
            out["profiled_s"] = total
            out["parts"] = {
                label: sum(v[3] for (f, _ln, fn), v in st.items()
                           if f.endswith(suffix) and fn == name) / total
                for label, suffix, name in PROFILE_PARTS}
            out["top_own"] = [
                {"function": f"{os.path.basename(f)}:{ln}:{fn}",
                 "share": v[2] / total}
                for (f, ln, fn), v in sorted(
                    st.items(), key=lambda kv: -kv[1][2])[:10]]
    return run


def run_n2(stream: nexmark.BidStream, work_dir: str, poll: int = POLL,
           fault_seed: int = 24, profile: bool = False) -> Dict[str, Any]:
    """The windowed stream through QueryService with two faults, held to
    its oracle; the counters, walls and sizes of the run (`profile`: the
    epochs under cProfile, `_profiled`; its walls carry the profiler's
    cost)."""
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.bridge.metrics import MetricNode
    from blaze_tpu_torch.ops.window import EventTimeWindowSpec
    from blaze_tpu_torch.serving.service import QueryService
    from blaze_tpu_torch.streaming import (MemoryStreamSource,
                                           StreamExecutor,
                                           StreamWindowConfig,
                                           streaming_service_executor)
    n = len(stream.partitions)
    win = StreamWindowConfig(
        spec=EventTimeWindowSpec(size_ms=WINDOW_MS, slide_ms=SLIDE_MS),
        keys=["f0"], aggs=[("count", None), ("max", "f1"), ("sum", "f1")])
    sink_dir = os.path.join(work_dir, "n2-sink")
    ckpt_dir = os.path.join(work_dir, "n2-ckpt")
    holder: Dict[str, Any] = {}

    def build(plan_json, ctx):
        ex = StreamExecutor.from_flink_plan(
            plan_json, MemoryStreamSource(stream.partitions), win,
            num_partitions=n, sink_dir=sink_dir, checkpoint_dir=ckpt_dir,
            ctx=ctx, max_records_per_poll=poll)
        # the window state's peak bytes land here (MemConsumer.metrics)
        ex._state.metrics = MetricNode(name="EventTimeWindowState")
        holder["ex"] = ex
        return ex

    data_epochs = -(-max(len(p) for p in stream.partitions) // poll)
    mid = max(2, data_epochs // 2)
    before = device_stats.stream_stats()
    failures: List[str] = []
    # the local mode (a kafka-only plan has no scan bytes): the staged
    # route's wire drops the scan's event-time field, as the JAX one does
    keys = {config.STREAM_WATERMARK_LATENESS_MS.key: 0,
            config.STREAM_LATE_SIDE_POLICY.key: "drop",
            config.DAG_SINGLE_TASK_BYTES.key:
                config.DAG_SINGLE_TASK_BYTES.default}
    prev = {k: config.conf.get_raw(k) for k in keys}
    for k, v in keys.items():
        config.conf.set(k, v)
    executor = streaming_service_executor(build)
    host_profile: Dict[str, Any] = {}
    if profile:
        executor = _profiled(executor, host_profile)
    service = QueryService(max_concurrent=1, executor=executor)
    try:
        t0 = time.perf_counter()
        with faults.scoped(("stream-epoch", dict(at=(mid,))),
                           ("checkpoint-commit", dict(at=(mid + 3,))),
                           seed=fault_seed):
            handle = service.submit(nexmark.calc_plan(), tenant="nexmark")
            summary = handle.result(timeout=3600)
            fired = {site: st["fires"]
                     for site, st in faults.stats().items()}
        wall = time.perf_counter() - t0
    finally:
        service.shutdown()
        for k, v in prev.items():
            if v is None:
                config.conf.unset(k)
            else:
                config.conf.set(k, v)
    delta = {k: v - before.get(k, 0)
             for k, v in device_stats.stream_stats().items()
             if not k.endswith("_last")}
    ex = holder["ex"]
    t0 = time.perf_counter()
    want = n2_oracle(stream)
    oracle_s = time.perf_counter() - t0
    got = ex.sink.committed_table().sort_by(
        [("window_start", "ascending"), ("f0", "ascending")])
    lost, duplicated = _lost_and_duplicated(got, want)
    identical = got.cast(want.schema).equals(want)
    walls = sorted(w / 1e6 for w in ex.epoch_walls_ns)
    n_epochs = summary["epochs"]
    if not identical or lost or duplicated:
        failures.append(f"N2 sink: {got.num_rows} rows against the "
                        f"oracle's {want.num_rows}, {lost} lost, "
                        f"{duplicated} duplicated, identical {identical}")
    if summary["recoveries"] != 2 or delta["stream_recoveries"] != 2:
        failures.append(f"N2 recoveries {summary['recoveries']} "
                        f"(counted {delta['stream_recoveries']}), want 2")
    if fired.get("stream-epoch") != 1 or fired.get("checkpoint-commit") != 1:
        failures.append(f"N2 faults fired {fired}, want one a site")
    if summary["late_side_rows"] or delta["stream_late_records"]:
        failures.append(f"N2 late records {delta['stream_late_records']}")
    counts = {"epochs": (delta["stream_epochs"], n_epochs, data_epochs + 1),
              "records": (delta["stream_records"],
                          summary["records_consumed"], stream.num_bids),
              "checkpoints": (delta["stream_checkpoints"], n_epochs),
              "sink commits": (delta["stream_sink_commits"], n_epochs),
              "rows": (delta["stream_rows"], summary["rows_emitted"],
                       got.num_rows),
              "dup skips": (delta["stream_sink_dup_skips"], 0)}
    for what, vals in counts.items():
        if len(set(vals)) != 1:
            failures.append(f"N2 counters: {what} {vals} do not agree")
    return {"wall_s": wall, "bids_per_s": stream.num_bids / wall,
            "epochs": n_epochs, "data_epochs": data_epochs,
            "fault_epochs": {"stream-epoch": mid,
                             "checkpoint-commit": mid + 3},
            "faults_fired": fired, "summary": summary,
            "epoch_ms_p50": statistics.median(walls),
            "epoch_ms_p99": walls[min(len(walls) - 1,
                                      int(0.99 * (len(walls) - 1) + 0.5))],
            "recovery_ms": [w / 1e6 for w in ex.recovery_walls_ns],
            "checkpoint_bytes": delta["stream_checkpoint_bytes"],
            "window_state_peak_bytes":
                ex._state.metrics.values.get("mem_used", 0),
            "sink_rows": got.num_rows, "oracle_rows": want.num_rows,
            "lost": lost, "duplicated": duplicated,
            "oracle_s": oracle_s, "counters": delta,
            "host_profile": host_profile or None, "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bids-log2", type=int, default=20)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--poll", type=int, default=POLL,
                    help="N2's records a partition an epoch")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    ap.add_argument("--profile-n2", action="store_true",
                    help="run N2's epochs under cProfile (its walls then "
                         "carry the profiler's cost) and print the host "
                         "time's shares by part")
    args = ap.parse_args(argv)
    if args.device:
        config.conf.set(config.TORCH_DEVICE.key, args.device)
    t0 = time.perf_counter()
    stream = nexmark.generate_bids(1 << args.bids_log2, seed=args.seed)
    gen_s = time.perf_counter() - t0
    work = tempfile.mkdtemp(prefix="nexmark-stream-")
    try:
        n1 = run_n1(stream, work)
        n2 = run_n2(stream, work, poll=args.poll, profile=args.profile_n2)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    failures = n1.pop("failures") + n2.pop("failures")
    print(json.dumps({"bids": stream.num_bids,
                      "json_bytes_per_bid": stream.json_bytes
                      / stream.num_bids, "generate_s": gen_s,
                      "n1": n1, "n2": n2, "failures": failures},
                     default=str))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
