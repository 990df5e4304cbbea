"""Shuffle read (port of FileSegmentBlock and IpcReaderExec,
blaze_tpu/shuffle/reader.py).

`IpcReaderExec` pulls the blocks registered for its partition in the
resource map: a list of blocks, or a callable `partition -> blocks`.  A
block is a file segment `(path, offset, length)` of a map task's `.data`
file, or the bytes of one.  Block reads and decode run on the IO
prefetch worker (ops/base.py).  Decoded Arrow batches cross to the device
and are re-batched by the same CoalesceStream rules as the JAX package,
so the reduce side sees the same batches.  A file segment that cannot be
read back intact (a failed CRC32C, a short read, a lost file) raises
`FetchFailedError` naming the map task that wrote it (its `stage_id` and
`map_id`), so the stage scheduler re-runs only that task.

`FFIReaderExec` imports host Arrow batches (the ConvertToNative path; in
process the "FFI" is a handoff of pyarrow batches through the resource
map), one ColumnBatch per batch, not re-batched.  `IpcWriterExec` is the
collect path (results back to Spark): it writes the child's compacted,
non-empty batches as framed IPC into the sink its resource id names (a
callable `partition -> binary file`), and emits nothing.
"""

from __future__ import annotations

import io
import mmap
import struct
from dataclasses import dataclass
from typing import BinaryIO, Callable, Iterator, Union

import pyarrow as pa

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.bridge.resource import get_resource
from blaze_tpu_torch.ops.base import BatchIterator, CoalesceStream, ExecutionPlan
from blaze_tpu_torch.schema import Schema
from blaze_tpu_torch.faults import FetchFailedError
from blaze_tpu_torch.shuffle.ipc import (IpcCompressionReader,
                                         IpcCompressionWriter,
                                         ShuffleChecksumError,
                                         read_frames_from_buffer)


@dataclass
class FileSegmentBlock:
    """(path, offset, length) of one map task's output for one reduce
    partition; stage_id/map_id name the map task that wrote it."""

    path: str
    offset: int
    length: int
    stage_id: int = -1
    map_id: int = -1


Block = Union[FileSegmentBlock, bytes]


def read_block(block: Block) -> Iterator[pa.RecordBatch]:
    if isinstance(block, FileSegmentBlock):
        if block.length == 0:
            return
        try:
            yield from _read_segment(block)
        except (ShuffleChecksumError, EOFError, OSError,
                struct.error) as e:  # struct.error: a short frame header
            from blaze_tpu_torch.bridge import device_stats
            device_stats.note_fetch_failure()
            raise FetchFailedError(
                block.stage_id, block.map_id,
                f"{block.path}@{block.offset}+{block.length}: {e}") from e
    elif isinstance(block, (bytes, bytearray, memoryview)):
        yield from IpcCompressionReader(io.BytesIO(block)).read_batches()
    else:
        raise TypeError(f"unsupported shuffle block {type(block).__name__}")


def _read_segment(block: FileSegmentBlock) -> Iterator[pa.RecordBatch]:
    with open(block.path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    if block.offset + block.length > len(mm):
        raise EOFError(f"segment ends past the {len(mm)}-byte file")
    # the pa.py_buffer keeps the mapping alive while a batch uses it
    yield from read_frames_from_buffer(
        pa.py_buffer(mm).slice(block.offset, block.length))


class IpcReaderExec(ExecutionPlan):
    """Reads the shuffle blocks of one reduce partition."""

    def __init__(self, resource_id: str, schema: Schema,
                 num_partitions: int = 1):
        super().__init__()
        self.resource_id = resource_id
        self._schema = schema
        self._num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def execute(self, partition: int) -> BatchIterator:
        def gen():
            for rb in self.arrow_batches(partition):
                yield ColumnBatch.from_arrow(rb)
        return iter(CoalesceStream(gen(), metrics=self.metrics))

    def arrow_batches(self, partition: int):
        """Arrow-resident read: the block reads and the IPC decode run on
        the prefetch worker, so reduce-side compute overlaps them
        (kill-switch auron.tpu.io.prefetch)."""
        from blaze_tpu_torch.ops.base import prefetch
        return prefetch(self._read_blocks(partition), name="ipc_reader")

    def _read_blocks(self, partition: int):
        source = get_resource(self.resource_id)
        if source is None:
            raise KeyError(f"shuffle resource {self.resource_id!r} not found")
        blocks = source(partition) if callable(source) else source
        ctx = current_task()
        for block in blocks:
            ctx.check_running()
            for rb in read_block(block):
                self.metrics.add("io_bytes", rb.nbytes)
                yield rb


class IpcWriterExec(ExecutionPlan):
    """Writes the child stream as framed IPC into a host sink."""

    def __init__(self, child: ExecutionPlan,
                 sink_factory: Callable[[int], BinaryIO]):
        super().__init__([child])
        self._sink_factory = sink_factory

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        sink = self._sink_factory(partition)
        w = IpcCompressionWriter(sink)
        for batch in self.children[0].execute(partition):
            rb = batch.compact().to_arrow()
            if rb.num_rows:
                w.write_batch(rb)
                self.metrics.add("output_rows", rb.num_rows)
                self.metrics.add("io_bytes", rb.nbytes)
        w.finish()
        return iter(())


class FFIReaderExec(ExecutionPlan):
    """Imports the host Arrow batches its resource holds: a list of
    batches, or a callable `partition -> batches`."""

    def __init__(self, resource_id: str, schema: Schema,
                 num_partitions: int = 1):
        super().__init__()
        self.resource_id = resource_id
        self._schema = schema
        self._num_partitions = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._num_partitions

    def execute(self, partition: int) -> BatchIterator:
        source = get_resource(self.resource_id)
        if source is None:
            raise KeyError(f"ffi resource {self.resource_id!r} not found")
        batches = source(partition) if callable(source) else source
        for rb in batches:
            yield ColumnBatch.from_arrow(rb)
