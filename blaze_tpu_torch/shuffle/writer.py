"""Shuffle write: staged repartitioning into `.data`/`.index` files (port
of ShuffleWriterExec and the staging part of ShuffleRepartitioner,
blaze_tpu/shuffle/writer.py).

Each inserted batch is compacted on the device; its partition ids are
computed there (murmur3 + pmod) and stay there, while its rows go to the
host as an Arrow batch, as in the JAX package.  At write time the staged
pid columns are concatenated on the device and grouped by the radix
partition kernel (kernels/radix.py); only the resulting row order and
partition counts come back to the host (one copy, one sync), which takes
the staged rows in that order and writes one run of framed IPC per
partition.  The layout, frame boundaries and
`.index` offsets are those of the JAX package: `.data` is
partition-major, `.index` holds n_parts + 1 little-endian int64
cumulative offsets.

Spill, remote shuffle (RSS), speculative-attempt commits and the
single-partition streaming mode belong to later slices.
"""

from __future__ import annotations

import os
import struct
from typing import BinaryIO, List, Optional

import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.kernels import radix
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.shuffle.ipc import IpcCompressionWriter
from blaze_tpu_torch.shuffle.partitioning import Partitioning


class ShuffleRepartitioner:
    """Stages a map task's rows and writes them partition-major."""

    def __init__(self, partitioning: Partitioning):
        self.partitioning = partitioning
        self._staged: List[pa.RecordBatch] = []
        self._pids: List[torch.Tensor] = []  # on the device, one per batch

    def insert_batch(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        if batch.num_rows == 0:
            return
        current_task().check_running()
        rb = batch.to_arrow()
        if self.partitioning.num_partitions == 1:
            # one reduce partition: the batch as it is, as the JAX
            # package stages it (its schema's nullability kept)
            self._staged.append(rb)
            return
        self._pids.append(self.partitioning.partition_ids(batch))
        # names only, as the JAX package stages rows beside their pids:
        # every field nullable
        self._staged.append(pa.RecordBatch.from_arrays(
            list(rb.columns), names=list(rb.schema.names)))

    def _write_partitioned(self, sink: BinaryIO,
                           codec_name: Optional[str] = None) -> List[int]:
        """Group staged rows by partition id and write per-partition
        frames; returns the n_parts + 1 cumulative offsets."""
        n_parts = self.partitioning.num_partitions
        if n_parts == 1:
            w = IpcCompressionWriter(sink, codec_name=codec_name)
            for staged in self._staged:
                w.write_batch(staged)
            w.finish()
            return [0, sink.tell()]
        rb = pa.Table.from_batches(self._staged).combine_chunks() \
            .to_batches()[0]
        pids = self._pids[0] if len(self._pids) == 1 else torch.cat(
            self._pids)
        order, starts, ends = radix.partition_order(pids, n_parts)
        payload = rb.take(pa.array(order, type=pa.int64()))
        offsets = [0]
        bs = config.BATCH_SIZE.get()
        for p in range(n_parts):
            s, e = int(starts[p]), int(ends[p])
            if e > s:
                w = IpcCompressionWriter(sink, codec_name=codec_name)
                for off in range(s, e, bs):
                    w.write_batch(payload.slice(off, min(bs, e - off)))
                w.finish()
            offsets.append(sink.tell())
        return offsets

    def write(self, data_file: str, index_file: str) -> List[int]:
        """Write `.data` through a task-private temp file committed with
        os.replace, then `.index`; returns the partition lengths."""
        tmp = f"{data_file}.inprogress.{os.getpid()}.{id(self):x}"
        try:
            with open(tmp, "wb") as out:
                if self._staged:
                    offsets = self._write_partitioned(
                        out, codec_name=config.SHUFFLE_FILE_CODEC.get())
                else:  # empty input: empty .data, zero offsets
                    offsets = [0] * (self.partitioning.num_partitions + 1)
            os.replace(tmp, data_file)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        finally:
            self._staged, self._pids = [], []
        with open(index_file, "wb") as idx:
            for off in offsets:
                idx.write(struct.pack("<q", off))
        return [offsets[i + 1] - offsets[i] for i in range(len(offsets) - 1)]


class ShuffleWriterExec(ExecutionPlan):
    """Map-side shuffle write: consumes the child partition, writes
    `.data`/`.index`, emits nothing."""

    def __init__(self, child: ExecutionPlan, partitioning: Partitioning,
                 data_file: str, index_file: str):
        super().__init__([child])
        self.partitioning = partitioning
        self.data_file = data_file
        self.index_file = index_file
        self.partition_lengths: Optional[List[int]] = None

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        rep = ShuffleRepartitioner(self.partitioning)
        for batch in self.children[0].execute(partition):
            self.metrics.add("output_rows", batch.num_rows)
            self.metrics.add("output_batches")
            rep.insert_batch(batch)
        self.partition_lengths = rep.write(self.data_file, self.index_file)
        self.metrics.add("data_size", sum(self.partition_lengths))
        self.metrics.add("io_bytes", sum(self.partition_lengths))
        return iter(())
