"""Continuous micro-batch streaming over the stage scheduler (port of
blaze_tpu/streaming/executor.py).

A converted Flink pipeline (Kafka source -> event-time windowed
aggregation -> sink) runs as one long-lived query that reuses ONE
DagScheduler for every epoch, instead of the caller-pumped loop of
convert/flink_runtime.py.

An epoch is a bounded batch job with streaming book-ends:

  1. the ``stream-epoch`` fault site and QueryContext.check(): a cancel,
     a deadline and injected chaos all land at an epoch boundary;
  2. each source partition is polled from the committed offsets and its
     records staged behind the plan's kafka poll resource;
  3. the converted plan runs through DagScheduler.run_collect (on the card
     unless `auron.torch.device` is `cpu`; its output comes back as Arrow
     through `to_arrow`, which waits on the current stream only);
  4. the output folds into EventTimeWindowState on the host, the
     watermark advances from the polled record timestamps, and due panes
     fire;
  5. the fired panes land as a sink ATTEMPT, then the epoch's manifest
     (offsets, watermark, window state, attempt) commits first-wins
     through CheckpointManager.  A commit that wins promotes the attempt;
     one that loses (a replay) discards it and adopts the committed
     manifest's state.  Exactly once either way.

Recovery: a retryable failure restores offsets, watermark and window
state from the latest committed manifest (promoting a committed but
unpromoted sink attempt) and re-runs the in-flight epoch, at most
``auron.tpu.stream.maxRecoveries`` times; past that the failure raises.
The JAX package's history emitters and its flight-recorder dump on an
exhausted budget wait for those subsystems (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import bisect
import copy
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import pyarrow as pa

from blaze_tpu_torch import config, faults
from blaze_tpu_torch.ops.kafka import KafkaRecord
from blaze_tpu_torch.ops.window import (EventTimeWindowSpec,
                                        EventTimeWindowState,
                                        WatermarkTracker)
from blaze_tpu_torch.shuffle.ipc import ShuffleChecksumError
from blaze_tpu_torch.streaming.checkpoint import CheckpointManager
from blaze_tpu_torch.streaming.sink import ExactlyOnceParquetSink

_RETRYABLE = (faults.InjectedFault, faults.FetchFailedError,
              ShuffleChecksumError)


@dataclass
class StreamWindowConfig:
    """The windowed half of a streaming query: the event-time column, the
    key columns and the aggregates each pane carries.  `ts_field` is
    appended to the scan's output by the kafka scan's event_time_field
    (record timestamps, int64 epoch ms)."""

    spec: EventTimeWindowSpec
    ts_field: str = "__event_time"
    keys: List[str] = field(default_factory=list)
    aggs: List[Tuple[str, Optional[str]]] = field(
        default_factory=lambda: [("count", None)])


class MemoryStreamSource:
    """A bounded in-memory Kafka: one record list a partition, polled by
    offset (the records at or past it, in offset order).  ``poll`` returns
    None once a partition is drained."""

    def __init__(self, partitions: Sequence[Sequence[KafkaRecord]]):
        self._parts = [sorted(p, key=lambda r: r.offset)
                       for p in partitions]
        # the sorted offsets: a poll or a lag is a bisection, not a scan
        self._offsets = [[r.offset for r in p] for p in self._parts]

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def poll(self, partition: int, offset: int,
             max_records: int) -> Optional[List[KafkaRecord]]:
        i = bisect.bisect_left(self._offsets[partition], offset)
        if i == len(self._parts[partition]):
            return None
        return self._parts[partition][i:i + max_records]

    def lag(self, offsets: Dict[int, int]) -> int:
        return sum(len(p) - bisect.bisect_left(p, offsets.get(i, 0))
                   for i, p in enumerate(self._offsets))


def _ensure_event_time(ir: Dict[str, Any], ts_field: str) -> None:
    """Thread the scan's event-time column through the converted plan: set
    event_time_field on the kafka_scan and project it through every calc
    node above, so the window sees it at the top.  A converted Flink chain
    is a linear filter/project stack; anything else raises."""
    chain: List[Dict[str, Any]] = []
    node = ir
    while node.get("kind") != "kafka_scan":
        if node.get("kind") not in ("project", "filter"):
            raise ValueError(
                f"event-time streaming supports kafka_scan + calc "
                f"chains; found {node.get('kind')!r}")
        chain.append(node)
        node = node["input"]
    scan = node
    scan["event_time_field"] = ts_field
    ts_index = len(scan["schema"]["fields"])  # after the decoded columns
    for n in reversed(chain):
        if n["kind"] == "filter":
            continue  # a filter passes every column through
        n["exprs"].append({"kind": "column", "index": ts_index})
        n.setdefault("names", [f"f{i}" for i in
                               range(len(n["exprs"]) - 1)])
        n["names"].append(ts_field)
        ts_index = len(n["exprs"]) - 1


def _find_scan(node: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    if node.get("kind") == "kafka_scan":
        return node
    for key in ("input", "left", "right"):
        child = node.get(key)
        if isinstance(child, dict):
            found = _find_scan(child)
            if found is not None:
                return found
    return None


class StreamExecutor:
    """One long-lived streaming query: epochs until the source drains (a
    bounded source) or ``max_epochs``."""

    def __init__(self, plan: Dict[str, Any], source: Any,
                 window: StreamWindowConfig, *,
                 sink_dir: str,
                 checkpoint_dir: Optional[str] = None,
                 ctx: Any = None,
                 num_partitions: Optional[int] = None,
                 max_records_per_poll: Optional[int] = None,
                 scheduler: Any = None):
        from blaze_tpu_torch.plan.planner import create_plan
        from blaze_tpu_torch.plan.stages import DagScheduler

        self._ir = copy.deepcopy(plan)
        scan = _find_scan(self._ir)
        if scan is None:
            raise ValueError("streaming plan has no kafka_scan source")
        scan.pop("mock_data_json_array", None)  # the executor feeds it
        # the source's partition count wins over the scan's default of 1:
        # else a multi-partition source would be polled on partition 0
        # only and end early
        src_n = getattr(source, "num_partitions", None)
        self._n = int(num_partitions or src_n
                      or scan.get("num_partitions", 1) or 1)
        if src_n is not None and int(src_n) != self._n:
            raise ValueError(
                f"num_partitions={self._n} disagrees with "
                f"source.num_partitions={src_n}")
        scan["num_partitions"] = self._n
        _ensure_event_time(self._ir, window.ts_field)
        self._resource_id = (f"kafka://"
                             f"{scan.get('operator_id') or scan.get('topic')}")
        self._plan_schema = create_plan(self._ir).schema.to_arrow()

        self.window = window
        self.source = source
        self._max_poll = int(max_records_per_poll
                             or config.BATCH_SIZE.get())
        self._ctx = ctx
        ckpt_dir = (checkpoint_dir or config.STREAM_CHECKPOINT_DIR.get()
                    or None)
        if ckpt_dir is None:
            import tempfile
            ckpt_dir = tempfile.mkdtemp(prefix="blaze-stream-ckpt-")
        self._ckpt = CheckpointManager(ckpt_dir)
        self.sink = ExactlyOnceParquetSink(sink_dir)
        self._sched = scheduler or DagScheduler(query_ctx=ctx)

        self._tracker = WatermarkTracker(
            config.STREAM_WATERMARK_LATENESS_MS.get())
        self._state = EventTimeWindowState(
            window.spec, self._plan_schema, window.ts_field,
            window.keys, window.aggs,
            late_policy=config.STREAM_LATE_SIDE_POLICY.get())
        if ctx is not None:
            self._state.query = ctx  # the query's memory quota sees it
        self._offsets: Dict[int, int] = {p: 0 for p in range(self._n)}
        self._epoch = 0
        self.epochs_committed = 0
        self.rows_emitted = 0
        self.records_consumed = 0
        self.late_side: List[dict] = []
        self.epoch_walls_ns: List[int] = []
        self.recovery_walls_ns: List[int] = []

    @classmethod
    def from_flink_plan(cls, plan_json: dict, source: Any,
                        window: StreamWindowConfig,
                        num_partitions: Optional[int] = None,
                        **kw) -> "StreamExecutor":
        from blaze_tpu_torch.convert.flink import convert_flink_plan
        n = int(num_partitions
                or getattr(source, "num_partitions", None) or 1)
        ir = convert_flink_plan(plan_json, num_partitions=n)
        return cls(ir, source, window, num_partitions=n, **kw)

    # -- one epoch -------------------------------------------------------
    def _run_plan(self, polled: Dict[int, List[KafkaRecord]]) -> pa.Table:
        from blaze_tpu_torch.bridge.resource import (put_resource,
                                                     remove_resource)

        staged = {p: list(recs) for p, recs in polled.items()}

        def poll(partition: int, max_records: int):
            batch = staged.get(partition, [])[:max_records]
            staged[partition] = staged.get(partition, [])[len(batch):]
            return batch if batch else None

        put_resource(self._resource_id, poll)
        try:
            return self._sched.run_collect(self._ir)
        finally:
            remove_resource(self._resource_id)

    def _restore_from(self, manifest: dict) -> None:
        self._offsets = CheckpointManager.offsets_from(manifest)
        self._tracker.restore(manifest.get("watermark") or {})
        self._state.restore(manifest.get("window") or {})

    def _recover(self) -> None:
        from blaze_tpu_torch.bridge import device_stats, tracing
        t0 = time.perf_counter_ns()
        latest = self._ckpt.latest()
        if latest is None:
            self._offsets = {p: 0 for p in range(self._n)}
            self._tracker.restore({})
            self._state.restore({})
            resume = 0
        else:
            e, manifest = latest
            self._restore_from(manifest)
            self.sink.repair(e, (manifest.get("sink") or {}).get("attempt"))
            resume = e + 1
        replayed = max(0, self._epoch - resume) + 1  # the in-flight epoch
        self._epoch = resume
        self.recovery_walls_ns.append(time.perf_counter_ns() - t0)
        device_stats.note_stream_recovery(replayed_epochs=replayed)
        tracing.instant("stream_recovery", resume_epoch=resume,
                        replayed_epochs=replayed,
                        query=getattr(self._ctx, "query_id", None))

    def _run_epoch(self) -> bool:
        """Execute and commit one epoch; True at the end of the stream."""
        from blaze_tpu_torch.bridge import tracing
        qid = getattr(self._ctx, "query_id", None)
        with tracing.execution_context(query=qid), \
                tracing.span("stream_epoch", epoch=self._epoch, query=qid):
            return self._run_epoch_traced()

    def _run_epoch_traced(self) -> bool:
        from blaze_tpu_torch.bridge import device_stats

        t0 = time.perf_counter_ns()
        if self._ctx is not None:
            self._ctx.check()
        faults.maybe_fail("stream-epoch", epoch=self._epoch)

        polled: Dict[int, List[KafkaRecord]] = {}
        exhausted = True
        nrecs = 0
        for p in range(self._n):
            recs = self.source.poll(p, self._offsets.get(p, 0),
                                    self._max_poll)
            if recs is None:
                polled[p] = []
            else:
                exhausted = False
                polled[p] = list(recs)
                nrecs += len(recs)

        wm_before = self._tracker.watermark()
        if nrecs:
            table = self._run_plan(polled)
            for p, recs in polled.items():
                for r in recs:
                    self._tracker.observe(p, r.timestamp_ms)
            late = 0
            for rb in table.to_batches():
                late += self._state.add_batch(rb, watermark=wm_before)
            side = self._state.take_late()
            self.late_side.extend(side)
            if late:
                device_stats.note_stream_late(late, side_rows=len(side))

        final = exhausted
        wm = self._tracker.watermark()
        emitted = self._state.flush() if final else self._state.advance(wm)

        attempt = self.sink.write_attempt(self._epoch, emitted)
        new_offsets = dict(self._offsets)
        for p, recs in polled.items():
            if recs:
                new_offsets[p] = max(new_offsets.get(p, 0),
                                     max(r.offset for r in recs) + 1)
        manifest = {
            "offsets": {str(p): o for p, o in new_offsets.items()},
            "watermark": self._tracker.snapshot(),
            "window": self._state.snapshot(),
            "sink": {"attempt": attempt, "rows": emitted.num_rows},
            "final": final,
        }
        committed = self._ckpt.commit(self._epoch, manifest)
        if committed:
            self.sink.promote(self._epoch, attempt)
            self._offsets = new_offsets
            self.rows_emitted += emitted.num_rows
            self.records_consumed += nrecs
            device_stats.note_stream_sink(committed=1)
        else:
            # a replay of an epoch that already committed: its manifest is
            # the truth; drop this attempt and adopt the manifest's state
            self.sink.discard(attempt)
            committed = self._ckpt.load(self._epoch)
            self.sink.repair(self._epoch,
                             (committed.get("sink") or {}).get("attempt"))
            self._restore_from(committed)
            final = bool(committed.get("final"))
            device_stats.note_stream_sink(dup_skips=1)

        wall = time.perf_counter_ns() - t0
        self.epoch_walls_ns.append(wall)
        self.epochs_committed += 1
        device_stats.note_stream_epoch(wall, rows=emitted.num_rows,
                                       records=nrecs)
        max_seen = max((t for t in
                        self._tracker.snapshot()["max_ts"].values()),
                       default=None)
        lag = (self.source.lag(self._offsets)
               if hasattr(self.source, "lag") else 0)
        device_stats.note_stream_gauges(
            watermark_delay_ms=(max_seen - wm
                                if wm is not None and max_seen is not None
                                else 0),
            window_state_bytes=self._state.state_bytes(),
            source_lag_records=lag)
        self._epoch += 1
        return final

    # -- the query loop --------------------------------------------------
    def run(self, max_epochs: Optional[int] = None) -> Dict[str, Any]:
        """Drive epochs to the end of the stream (a bounded source) or
        ``max_epochs``; returns the summary.  A retryable failure (injected
        chaos, a fetch failure) recovers from the last committed
        checkpoint; a cancel or a deadline propagates after teardown."""
        interval_s = config.STREAM_EPOCH_INTERVAL_MS.get() / 1e3
        max_recoveries = max(0, config.STREAM_MAX_RECOVERIES.get())
        recoveries = 0
        try:
            while max_epochs is None or self.epochs_committed < max_epochs:
                t0 = time.monotonic()
                try:
                    if self._run_epoch():
                        break
                except _RETRYABLE:
                    recoveries += 1
                    if recoveries > max_recoveries:
                        raise  # the budget is spent: fatal to the stream
                    self._recover()
                    continue
                if interval_s > 0:
                    left = interval_s - (time.monotonic() - t0)
                    if left > 0:
                        if self._ctx is not None:
                            if self._ctx.wait_cancelled(left):
                                self._ctx.check()
                        else:
                            time.sleep(left)
        finally:
            self.close()
        return self.summary()

    def summary(self) -> Dict[str, Any]:
        return {"epochs": self.epochs_committed,
                "rows_emitted": self.rows_emitted,
                "records_consumed": self.records_consumed,
                "recoveries": len(self.recovery_walls_ns),
                "late_side_rows": len(self.late_side),
                "watermark": self._tracker.watermark(),
                "sink_dir": self.sink.dir,
                "checkpoint_dir": self._ckpt.dir}

    def close(self) -> None:
        self._state.close()
        self._sched.cleanup()


def streaming_service_executor(build):
    """The adapter for ``QueryService(executor=...)``: run a streaming
    query under the service's admission, deadline and cancellation.
    ``build(plan, ctx) -> StreamExecutor`` makes the stream bound to the
    admitted QueryContext; the executor drains it and returns the summary
    as the query's result.  On the card the service runs it on the slot's
    leased stream (serving/service.py `_on_own_stream`), so each epoch's
    read of its output waits on that stream alone."""
    return lambda plan, ctx, handle=None: build(plan, ctx).run()
