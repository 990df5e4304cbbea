"""Table sinks: Parquet and ORC writes (port of blaze_tpu/ops/sink.py).

Parity: parquet_sink_exec.rs:532 (the native write of Hive-insert data)
and orc_sink_exec.rs:568; pyarrow's C++ writers play the native writer.
A sink pulls its child's batches to the host (`to_arrow`) and writes one
file a partition, or a Hive-partitioned layout under `partition_cols`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema


def write_parquet_atomic(table: pa.Table, path: str,
                         compression: str = "zstd") -> int:
    """Crash-safe single-file write: the whole file lands under a dot-tmp
    name, then renames into place, so a reader (or a streaming recovery
    scan) never sees a torn footer.  Returns the bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp-{os.getpid()}")
    pq.write_table(table, tmp, compression=compression)
    nbytes = os.path.getsize(tmp)
    os.replace(tmp, path)
    return nbytes


def _child_table(child: ExecutionPlan, partition: int) -> Optional[pa.Table]:
    batches = [b.compact().to_arrow() for b in child.execute(partition)]
    batches = [b for b in batches if b.num_rows]
    return pa.Table.from_batches(batches) if batches else None


class ParquetSinkExec(ExecutionPlan):

    def __init__(self, child: ExecutionPlan, path: str,
                 partition_cols: Optional[Sequence[str]] = None,
                 compression: str = "zstd"):
        super().__init__([child])
        self.path = path
        self.partition_cols = list(partition_cols or [])
        self.compression = compression

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        table = _child_table(self.children[0], partition)
        if table is None:
            return iter(())
        if self.partition_cols:
            pq.write_to_dataset(table, self.path,
                                partition_cols=self.partition_cols,
                                compression=self.compression,
                                basename_template=(
                                    f"part-{partition}-{{i}}.parquet"))
        else:
            os.makedirs(self.path, exist_ok=True)
            out = os.path.join(self.path, f"part-{partition:05d}.parquet")
            pq.write_table(table, out, compression=self.compression)
        self.metrics.add("output_rows", table.num_rows)
        self.metrics.add("io_bytes", table.nbytes)
        return iter(())


class OrcSinkExec(ExecutionPlan):
    """(ref orc_sink_exec.rs:568)"""

    def __init__(self, child: ExecutionPlan, path: str):
        super().__init__([child])
        self.path = path

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        from pyarrow import orc
        table = _child_table(self.children[0], partition)
        if table is None:
            return iter(())
        os.makedirs(self.path, exist_ok=True)
        out = os.path.join(self.path, f"part-{partition:05d}.orc")
        orc.write_table(table, out)
        self.metrics.add("output_rows", table.num_rows)
        self.metrics.add("io_bytes", table.nbytes)
        return iter(())
