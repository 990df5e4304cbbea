"""The Flink runtime operator: a converted COMPILE PLAN driven as
micro-batches (port of blaze_tpu/convert/flink_runtime.py).

Parity: auron-flink-runtime's FlinkAuronCalcOperator / FlinkAuronOperator
and AuronKafkaSourceFunction, the stream operator that owns a fused native
plan (Calc + Kafka source) and pumps records through it.  Here:

  1. `FlinkMicroBatchOperator(plan_json)` converts the plan once
     (convert_flink_plan) and keeps the OFFSET a Kafka partition, the
     operator state a Flink checkpoint snapshots.
  2. `run_micro_batch(records_by_partition)` stages the records behind the
     kafka poll resource, ships the converted plan a partition as protobuf
     TaskDefinition bytes through NativeExecutionRuntime (on the card
     unless `auron.torch.device` is `cpu`) and returns the output's Arrow
     batches.
  3. Offsets advance only AFTER the output reached the caller:
     `run_micro_batch` commits every consumed partition together once the
     last task succeeded (a mid-batch failure rewinds the whole batch);
     `iter_micro_batch` yields (partition, batches) and commits a
     partition's offset when the caller resumes it.  With a streaming
     CheckpointManager a micro-batch whose epoch manifest is committed
     restores the committed offsets and runs nothing, so a recovering
     caller may re-feed epochs blindly.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa

from blaze_tpu_torch.convert.flink import convert_flink_plan
from blaze_tpu_torch.ops.kafka import KafkaRecord
from blaze_tpu_torch.streaming.executor import _find_scan


class FlinkMicroBatchOperator:
    """One operator a converted plan (the FlinkAuronCalcOperator analog),
    for one caller at a time, like a Flink task."""

    def __init__(self, plan_json: dict, num_partitions: int = 1,
                 checkpoint=None):
        self._ir = convert_flink_plan(plan_json,
                                      num_partitions=num_partitions)
        self._num_partitions = num_partitions
        scan = _find_scan(self._ir)
        if scan is None:
            raise ValueError("converted plan has no kafka_scan source")
        # the loop feeds records itself: inline mock data would shadow the
        # poll resource
        scan.pop("mock_data_json_array", None)
        self._topic = scan.get("topic", "")
        self._resource_id = f"kafka://{scan.get('operator_id') or self._topic}"
        # operator state: the next offset a Kafka partition (ref
        # AuronKafkaSourceFunction snapshotState)
        self.offsets: Dict[int, int] = {p: 0
                                        for p in range(num_partitions)}
        self.batches_run = 0
        # optional streaming.CheckpointManager: epoch-keyed manifests make
        # a replay idempotent
        self._checkpoint = checkpoint

    def snapshot_state(self) -> Dict[int, int]:
        """Checkpoint: the offsets a restore resumes from."""
        return dict(self.offsets)

    def restore_state(self, offsets: Dict[int, int]) -> None:
        self.offsets = dict(offsets)

    def _replay_of_committed(self, epoch: Optional[int]) -> bool:
        """A committed epoch's manifest restores its offsets and skips the
        run."""
        if (self._checkpoint is None or epoch is None
                or not self._checkpoint.committed(epoch)):
            return False
        manifest = self._checkpoint.load(epoch)
        self.offsets.update(self._checkpoint.offsets_from(manifest))
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_stream_sink(dup_skips=1)
        return True

    def _stage_polls(self,
                     records_by_partition: Sequence[Sequence[KafkaRecord]]
                     ) -> None:
        from blaze_tpu_torch.bridge.resource import put_resource

        staged = [list(p) for p in records_by_partition]

        def poll(partition: int, max_records: int):
            batch = staged[partition][:max_records]
            staged[partition] = staged[partition][len(batch):]
            return batch if batch else None

        put_resource(self._resource_id, poll)

    def _run_partition(self, p: int) -> List[pa.RecordBatch]:
        from blaze_tpu_torch.bridge import runtime
        from blaze_tpu_torch.plan.proto_serde import task_definition_to_bytes

        td = task_definition_to_bytes(
            {"stage_id": 0, "partition_id": p,
             "num_partitions": self._num_partitions,
             "plan": self._ir})
        rt = runtime.NativeExecutionRuntime(td).start()
        try:
            return list(rt.batches())
        finally:
            rt.finalize()

    def _advance_offset(self, p: int,
                        records_by_partition: Sequence[Sequence[KafkaRecord]]
                        ) -> None:
        recs = (records_by_partition[p]
                if p < len(records_by_partition) else [])
        if recs:
            self.offsets[p] = max(self.offsets.get(p, 0),
                                  max(r.offset for r in recs) + 1)

    def _commit_epoch(self, epoch: Optional[int]) -> None:
        self.batches_run += 1
        if self._checkpoint is not None and epoch is not None:
            self._checkpoint.commit(
                epoch, {"offsets": {str(p): o
                                    for p, o in self.offsets.items()}})

    def run_micro_batch(self,
                        records_by_partition: Sequence[Sequence[KafkaRecord]],
                        epoch: Optional[int] = None
                        ) -> List[pa.RecordBatch]:
        """Run ONE micro-batch through the wire path and return its
        batches.  The output reaches the caller only at the return, so
        every consumed partition's offset commits together after the last
        task succeeded (at-least-once: a failure replays all of it).  With
        a CheckpointManager and an ``epoch`` the call is idempotent: a
        committed epoch restores its manifest's offsets and runs
        nothing."""
        if self._replay_of_committed(epoch):
            return []
        self._stage_polls(records_by_partition)
        out: List[pa.RecordBatch] = []
        for p in range(self._num_partitions):
            out.extend(self._run_partition(p))
        for p in range(self._num_partitions):
            self._advance_offset(p, records_by_partition)
        self._commit_epoch(epoch)
        return out

    def iter_micro_batch(self,
                         records_by_partition: Sequence[Sequence[KafkaRecord]],
                         epoch: Optional[int] = None
                         ) -> Iterator[Tuple[int, List[pa.RecordBatch]]]:
        """Yields ``(partition, batches)`` and commits THAT partition's
        offset once the caller resumes the generator: a failure leaves
        exactly the delivered partitions committed."""
        if self._replay_of_committed(epoch):
            return
        self._stage_polls(records_by_partition)
        for p in range(self._num_partitions):
            yield p, self._run_partition(p)
            self._advance_offset(p, records_by_partition)
        self._commit_epoch(epoch)

    def run_stream(self,
                   micro_batches: Iterable[Sequence[Sequence[KafkaRecord]]]
                   ) -> List[pa.RecordBatch]:
        """Drain a bounded stream of micro-batches."""
        out: List[pa.RecordBatch] = []
        for mb in micro_batches:
            out.extend(self.run_micro_batch(mb))
        return out
