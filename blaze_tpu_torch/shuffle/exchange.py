"""Shuffle index reading and the in-process exchange (port of
`read_index_file` and `LocalShuffleExchange`,
blaze_tpu/shuffle/exchange.py).

`LocalShuffleExchange` is a stage boundary without a cluster: on the
first pull it runs every map task of its child through the port's
`ShuffleWriterExec` (real `.data`/`.index` files, the same frames and
index contract as the staged route, the radix kernel grouping every
writer's rows), registers the blocks as a `shuffle://` resource and
reads each reduce partition back through `IpcReaderExec`.  The
single-task local mode (plan/stages.py `_run_single_task`) runs a query
with its exchanges as these; `cleanup()` removes the files, the resource
and the exchange's own scratch directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import uuid
from typing import List, Optional

import numpy as np

from blaze_tpu_torch.bridge.context import TaskContext, task_scope
from blaze_tpu_torch.bridge.resource import put_resource, remove_resource
from blaze_tpu_torch.faults import FetchFailedError
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.shuffle.partitioning import Partitioning
from blaze_tpu_torch.shuffle.reader import FileSegmentBlock, IpcReaderExec
from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec


class ShuffleIndexError(FetchFailedError):
    """A `.index` file that is missing, truncated or inconsistent with its
    `.data`: a fetch failure, which the stage scheduler re-raises with the
    producer's stage and map id."""

    def __init__(self, reason: str):
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_fetch_failure()
        super().__init__(reason=reason)


def read_index_file(path: str, expected_partitions: Optional[int] = None,
                    data_file: Optional[str] = None) -> List[int]:
    """Cumulative offsets of one map output.  Validates the shape up front
    (length a multiple of 8, `expected_partitions` + 1 entries when given,
    monotone offsets from 0, last offset within the `.data` file) and
    raises ShuffleIndexError instead of slicing garbage."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ShuffleIndexError(f"bad shuffle index {path}: {e}") from e
    if len(data) == 0 or len(data) % 8:
        raise ShuffleIndexError(f"bad shuffle index {path}: {len(data)} "
                                f"bytes is not a whole number of offsets")
    offsets = np.frombuffer(data, dtype="<i8")
    if expected_partitions is not None \
            and len(offsets) != expected_partitions + 1:
        raise ShuffleIndexError(
            f"bad shuffle index {path}: {len(offsets)} offsets, want "
            f"{expected_partitions + 1}")
    if offsets[0] != 0 or bool(np.any(np.diff(offsets) < 0)):
        raise ShuffleIndexError(f"bad shuffle index {path}: offsets do not "
                                f"start at 0 or are not monotone")
    if data_file is not None and (not os.path.exists(data_file) or int(
            offsets[-1]) > os.path.getsize(data_file)):
        raise ShuffleIndexError(f"bad shuffle index {path}: last offset "
                                f"exceeds the size of {data_file}")
    return offsets.tolist()


class LocalShuffleExchange(ExecutionPlan):
    """Materializing exchange: runs all map tasks on the first reduce
    pull."""

    def __init__(self, child: ExecutionPlan, partitioning: Partitioning,
                 stage_id: int = 0):
        super().__init__([child])
        self.partitioning = partitioning
        self.stage_id = stage_id
        self._dir: Optional[str] = None
        self._shuffle_id = uuid.uuid4().hex[:12]
        self._map_outputs: List[tuple] = []  # (data_file, offsets)
        self._materialized = False
        self.reader = IpcReaderExec(f"shuffle://{self._shuffle_id}",
                                    child.schema, partitioning.num_partitions)
        self.reader.metrics = self.metrics  # shuffle reads counted here

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def _materialize(self) -> None:
        if self._materialized:
            return
        child = self.children[0]
        self._dir = tempfile.mkdtemp(prefix="blaze-exchange-")
        for map_id in range(child.num_partitions):
            data = os.path.join(self._dir,
                                f"shuffle-{self._shuffle_id}-{map_id}.data")
            index = data[:-5] + ".index"
            writer = ShuffleWriterExec(child, self.partitioning, data, index)
            writer.metrics = self.metrics  # the writes counted here too
            with task_scope(TaskContext(stage_id=self.stage_id,
                                        partition_id=map_id,
                                        num_partitions=child.num_partitions)):
                list(writer.execute(map_id))
            self._map_outputs.append((data, read_index_file(
                index, expected_partitions=self.partitioning.num_partitions,
                data_file=data)))

        def blocks_for(reduce_id: int):
            for map_id, (data, offsets) in enumerate(self._map_outputs):
                length = offsets[reduce_id + 1] - offsets[reduce_id]
                if length:
                    yield FileSegmentBlock(data, offsets[reduce_id], length,
                                           stage_id=self.stage_id,
                                           map_id=map_id)
        put_resource(f"shuffle://{self._shuffle_id}", blocks_for)
        self._materialized = True

    def execute(self, partition: int) -> BatchIterator:
        self._materialize()
        return self.reader.execute(partition)

    def cleanup(self) -> None:
        """Remove the resource, every map output and the exchange's
        scratch directory; idempotent."""
        remove_resource(f"shuffle://{self._shuffle_id}")
        for data, _ in self._map_outputs:
            for p in (data, data[:-5] + ".index"):
                try:
                    os.unlink(p)
                except OSError:
                    pass
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
        self._dir = None
        self._map_outputs = []
        self._materialized = False
