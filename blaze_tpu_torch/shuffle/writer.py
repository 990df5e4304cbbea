"""Shuffle write: staged repartitioning into `.data`/`.index` files (port
of ShuffleWriterExec and ShuffleRepartitioner, blaze_tpu/shuffle/
writer.py).

Each inserted batch is compacted on the device; its partition ids are
computed there (murmur3 + pmod) and stay there, while its rows go to the
host as an Arrow batch, as in the JAX package.  Writing groups the staged
rows: the staged pid columns are concatenated on the device and grouped
by the radix partition kernel (kernels/radix.py); only the resulting row
order and partition counts come back to the host (one copy, one sync),
which takes the staged rows in that order and writes one run of framed
IPC per partition.  The layout, frame boundaries and `.index` offsets are
those of the JAX package: `.data` is partition-major, `.index` holds
n_parts + 1 little-endian int64 cumulative offsets.

The repartitioner is a `MemConsumer`.  It charges what the JAX package
charges for a staged batch: the batch's Arrow bytes plus 4 bytes a row,
the int32 `__pid` column the JAX package stages beside the rows (the
port keeps the pids on the device instead).  Charging less would move
the spill points and with them the `.data` bytes.  A spill groups the
rows staged so far, with their pids, through the radix kernel into a
partition-major file with an offset table (`_PartitionedSpill`), in the
wire codec (`io.compression.codec`), and drops them; the final write
groups only what remains, in `auron.tpu.shuffle.localFileCodec`, and
copies each partition's segment of the staged rows and then of every
spill, oldest first, into `.data` (`_merge_spills_into`).

A write to one reduce partition streams each batch into the `.data`
file's temporary path as it arrives (`open_stream`): nothing is staged,
charged or spilled, as in the JAX package.  `close()` removes the
temporary file and the spill files of a write that never finished.

Remote shuffle (RSS) and speculative-attempt commits belong to later
slices (ROADMAP item 16).
"""

from __future__ import annotations

import io
import os
import struct
import tempfile
from typing import BinaryIO, List, Optional

import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.kernels import radix
from blaze_tpu_torch.memory import MemConsumer, MemManager
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.shuffle.ipc import IpcCompressionWriter
from blaze_tpu_torch.shuffle.partitioning import Partitioning


class _PartitionedSpill:
    """A spill file laid out partition-major, with its offset table."""

    def __init__(self):
        fd, self.path = tempfile.mkstemp(prefix="blaze-shuffle-",
                                         suffix=".spill")
        os.close(fd)
        self.offsets: List[int] = []

    def release(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass


class ShuffleRepartitioner(MemConsumer):
    """Stages a map task's rows, spills them under pressure and writes
    them partition-major."""

    def __init__(self, partitioning: Partitioning, metrics=None):
        super().__init__("shuffle")
        self.partitioning = partitioning
        self.metrics = metrics
        self._staged: List[pa.RecordBatch] = []
        self._staged_bytes = 0
        self._pids: List[torch.Tensor] = []  # on the device, one per batch
        self._spills: List[_PartitionedSpill] = []
        self._stream_sink: Optional[BinaryIO] = None
        self._stream_writer: Optional[IpcCompressionWriter] = None
        self._stream_file: Optional[str] = None
        self._stream_tmp: Optional[str] = None

    # -- the one-partition streaming mode --------------------------------
    def open_stream(self, data_file: str) -> bool:
        """With one reduce partition, frames go straight into a private
        temporary file as batches arrive (committed by `write` with
        os.replace); only before the first insert."""
        if (self.partitioning.num_partitions != 1 or self._staged
                or self._spills):
            return False
        self._stream_tmp = (f"{data_file}.inprogress"
                            f".{os.getpid()}.{id(self):x}")
        self._stream_sink = open(self._stream_tmp, "wb")
        self._stream_file = data_file
        return True

    def _stream_write(self, rb: pa.RecordBatch) -> None:
        if self._stream_writer is None:
            self._stream_writer = IpcCompressionWriter(
                self._stream_sink,
                codec_name=config.SHUFFLE_FILE_CODEC.get())
        self._stream_writer.write_batch(rb)

    def close(self) -> None:
        """Abandon a write that never finished: the stream's temporary
        file and every spill file are removed."""
        if self._stream_sink is not None:
            self._stream_sink.close()
            try:
                os.unlink(self._stream_tmp)
            except OSError:
                pass
            self._stream_sink = None
            self._stream_writer = None
        spills, self._spills = self._spills, []
        for s in spills:
            s.release()

    # -- insert ------------------------------------------------------------
    def insert_batch(self, batch: ColumnBatch) -> None:
        batch = batch.compact()
        if batch.num_rows == 0:
            return
        current_task().check_running()
        rb = batch.to_arrow()
        if self.partitioning.num_partitions == 1:
            # one reduce partition: the batch as it is, as the JAX
            # package writes it (its schema's nullability kept)
            if self._stream_sink is not None:
                self._stream_write(rb)
            else:
                self._stage(rb, rb.nbytes)
            return
        self._pids.append(self.partitioning.partition_ids(batch))
        # names only, as the JAX package stages rows beside their pids:
        # every field nullable; charged with the int32 pid column the
        # JAX package stages beside them
        self._stage(pa.RecordBatch.from_arrays(
            list(rb.columns), names=list(rb.schema.names)),
            rb.nbytes + 4 * rb.num_rows)

    def _stage(self, rb: pa.RecordBatch, nbytes: int) -> None:
        self._staged.append(rb)
        self._staged_bytes += nbytes
        self.update_mem_used(self._staged_bytes)

    # -- spill (MemConsumer) -------------------------------------------------
    def spill(self) -> int:
        if not self._staged:
            return 0
        # spill frames keep the wire codec, as in the JAX package (its
        # spills may be copied verbatim into a remote shuffle push)
        spill = _PartitionedSpill()
        with open(spill.path, "wb") as f:
            spill.offsets = self._write_partitioned(f)
        self._spills.append(spill)
        released = self._staged_bytes
        self._staged, self._pids = [], []
        self._staged_bytes = 0
        self._mem_used = 0
        if self.metrics is not None:
            self.metrics.add("spill_count")
            self.metrics.add("spilled_bytes", released)
        return released

    def _write_partitioned(self, sink: BinaryIO,
                           codec_name: Optional[str] = None) -> List[int]:
        """Group the staged rows by partition id and write per-partition
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

    # -- the final write -----------------------------------------------------
    def write(self, data_file: str, index_file: str) -> List[int]:
        """Write `.data` (the stream's file, or the staged rows and the
        spills through a task-private temporary file) committed with
        os.replace, then `.index`; returns the partition lengths."""
        if self._stream_sink is not None:
            assert data_file == self._stream_file
            if self._stream_writer is not None:
                self._stream_writer.finish()
            offsets = [0, self._stream_sink.tell()]
            self._stream_sink.close()
            self._stream_sink = None
            self._stream_writer = None
            os.replace(self._stream_tmp, data_file)
        else:
            tmp = f"{data_file}.inprogress.{os.getpid()}.{id(self):x}"
            try:
                with open(tmp, "wb") as out:
                    if self._spills:
                        offsets = self._merge_spills_into(out)
                    elif self._staged:
                        offsets = self._write_partitioned(
                            out, codec_name=config.SHUFFLE_FILE_CODEC.get())
                    else:  # empty input: empty .data, zero offsets
                        offsets = [0] * (self.partitioning.num_partitions
                                         + 1)
                self._staged, self._pids = [], []
                self._staged_bytes = 0
                self.update_mem_used(0)
                os.replace(tmp, data_file)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        with open(index_file, "wb") as idx:
            for off in offsets:
                idx.write(struct.pack("<q", off))
        return [offsets[i + 1] - offsets[i] for i in range(len(offsets) - 1)]

    def _merge_spills_into(self, out: BinaryIO) -> List[int]:
        """The staged rows and the spill files, partition-major, into
        `out`: each partition's staged segment, then its segment of every
        spill, oldest first."""
        mem_offsets: List[int] = []
        mem_buf = io.BytesIO()
        if self._staged:
            mem_offsets = self._write_partitioned(
                mem_buf, codec_name=config.SHUFFLE_FILE_CODEC.get())
        offsets = [0]
        spill_files = [open(s.path, "rb") for s in self._spills]
        try:
            mem_view = mem_buf.getbuffer()
            for p in range(self.partitioning.num_partitions):
                if mem_offsets:
                    out.write(mem_view[mem_offsets[p]:mem_offsets[p + 1]])
                for s, f in zip(self._spills, spill_files):
                    seg_len = s.offsets[p + 1] - s.offsets[p]
                    if seg_len:
                        f.seek(s.offsets[p])
                        out.write(f.read(seg_len))
                offsets.append(out.tell())
            del mem_view
        finally:
            for f in spill_files:
                f.close()
            for s in self._spills:
                s.release()
            self._spills = []
        return offsets


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
        rep = ShuffleRepartitioner(self.partitioning, self.metrics)
        rep.set_spillable(MemManager.get())
        try:
            rep.open_stream(self.data_file)
            for batch in self.children[0].execute(partition):
                self.metrics.add("output_rows", batch.num_rows)
                self.metrics.add("output_batches")
                rep.insert_batch(batch)
            self.partition_lengths = rep.write(self.data_file,
                                               self.index_file)
            self.metrics.add("data_size", sum(self.partition_lengths))
            self.metrics.add("io_bytes", sum(self.partition_lengths))
        finally:
            rep.close()
            rep.unregister()
        return iter(())
