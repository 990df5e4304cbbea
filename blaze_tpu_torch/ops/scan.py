"""Parquet scan (port of ParquetScanExec, blaze_tpu/ops/scan.py).

Parquet decoding is host work (pyarrow's C++ reader) producing Arrow
batches that cross to the device as padded columns.  The batch boundaries
follow the JAX package's rules (one multithreaded read for a multi-file
group, per-file eager reads up to `auron.tpu.scan.eagerFileBytes`, else
`iter_batches`), so both packages see the same batches.  Predicate
pruning, partition constants, scan sharing and dictionary encoding
belong to later slices: a plan built with `auron.tpu.encoding.dict.enable`
set raises.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema


def parquet_metadata(path: str):
    """Footer metadata of one local parquet file (row counts and the
    row-group statistics that fused-agg bounds discovery reads)."""
    return pq.ParquetFile(path).metadata


class ParquetScanExec(ExecutionPlan):
    """Parquet scan over file groups, one group per partition."""

    def __init__(self, schema: Schema, file_groups: Sequence[Sequence[str]],
                 projection: Optional[Sequence[str]] = None,
                 predicate=None, batch_rows: Optional[int] = None,
                 partition_schema: Optional[Schema] = None):
        super().__init__()
        if predicate is not None or partition_schema is not None:
            raise NotImplementedError(
                "parquet predicate pruning and partition columns belong to "
                "a later slice of the PyTorch port (ROADMAP Queue 1 item 4)")
        if config.ENCODING_DICT_ENABLE.get():
            raise NotImplementedError(
                f"{config.ENCODING_DICT_ENABLE.key}: the scan's dictionary "
                f"encoder and DictColumn belong to the strings slice of the "
                f"PyTorch port (ROADMAP Queue 1 item 13)")
        self._file_schema = schema
        self._projection = list(projection) if projection is not None \
            else None
        if self._projection is not None:
            self._schema = Schema([schema.field(n) for n in self._projection])
        else:
            self._schema = schema
        self._file_groups = [list(g) for g in file_groups]
        self._batch_rows = batch_rows or config.BATCH_SIZE.get()

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._file_groups)

    def execute(self, partition: int) -> BatchIterator:
        for rb in self._decode_batches(partition):
            yield ColumnBatch.from_arrow(rb)

    def _decode_batches(self, partition: int):
        eager_limit = config.SCAN_EAGER_FILE_BYTES.get()
        group = self._file_groups[partition]
        columns = (list(self._projection) if self._projection is not None
                   else None)
        if (len(group) > 1 and all(os.path.exists(p) for p in group)
                and sum(os.path.getsize(p) for p in group) <= eager_limit):
            tbl = pq.read_table(group, columns=columns, use_threads=True)
            for rb in tbl.to_batches(max_chunksize=self._batch_rows):
                if rb.num_rows:
                    self.metrics.add("io_bytes", rb.nbytes)
                    yield _align_schema(rb, self._schema)
            return
        for path in group:
            f = pq.ParquetFile(path)
            row_groups = list(range(f.metadata.num_row_groups))
            if not row_groups:
                continue
            if os.path.getsize(path) <= eager_limit:
                tbl = f.read_row_groups(row_groups, columns=columns,
                                        use_threads=True)
                batches = tbl.to_batches(max_chunksize=self._batch_rows)
            else:
                batches = f.iter_batches(batch_size=self._batch_rows,
                                         row_groups=row_groups,
                                         columns=columns)
            for rb in batches:
                if rb.num_rows == 0:
                    continue
                self.metrics.add("io_bytes", rb.nbytes)
                yield _align_schema(rb, self._schema)


def _align_schema(rb: pa.RecordBatch, schema: Schema) -> pa.RecordBatch:
    """Cast physical file types to the plan's logical schema (missing
    columns -> nulls, widened ints, timestamp units)."""
    target = schema.to_arrow()
    if rb.schema.equals(target):
        return rb
    arrays = []
    for field in target:
        idx = rb.schema.get_field_index(field.name)
        if idx < 0:
            arrays.append(pa.nulls(rb.num_rows, type=field.type))
        else:
            c = rb.column(idx)
            arrays.append(c if c.type.equals(field.type)
                          else c.cast(field.type, safe=False))
    return pa.RecordBatch.from_arrays(arrays, schema=target)
