"""Parquet and memory scans (port of ParquetScanExec, MemoryScanExec,
`open_source`, the footer cache and `assemble_partition_constants`,
blaze_tpu/ops/scan.py).

Parquet decoding is host work (pyarrow's C++ reader) producing Arrow
batches that cross to the device as padded columns, one copy a batch;
decode and copy run on the IO prefetch worker (ops/base.py
`PrefetchIterator`), as does the Arrow-resident stream.  The batch boundaries
follow the JAX package's rules, so both packages see the same batches:
one multithreaded read for a multi-file group with no pruning predicate
and no partition column, else per-file reads (eager up to
`auron.tpu.scan.eagerFileBytes`, else `iter_batches`) of the row groups
that survive pruning.

A scan's `predicate` prunes row groups by their footer statistics
(ops/pruning.py, gated by `auron.parquet.enable.pageFiltering`; the
`pruned_row_groups` metric counts the dropped ones); an unprojected scan
ANDs the predicate's row mask into each decoded batch on the prefetch
worker when the predicate is traceable (`_post_decode_filter`), and the
Filter above the scan still filters every row.  Hive partition columns
(`partition_schema`, with `partition_values[group][file][field]`) are
per-file constants assembled after decoding, null where a file's list is
short; the file holds only its own columns (`_file_part`).  Footers are
cached (`parquet_metadata`, an LRU of `auron.parquet.metadataCacheSize`
entries keyed by path, refreshed when the file's mtime moves).

Later slices: a scheme'd path (`hdfs://`, `s3://`: bridge/fs.py, ROADMAP
Queue 1 item 16), scan sharing (the cache, item 16), a join's runtime
pruning filter (step 13), and dictionary encoding: a plan built with
`auron.tpu.encoding.dict.enable` set raises.
"""

from __future__ import annotations

import collections
import os
import threading
from typing import List, Optional, Sequence

import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceStager
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import Schema


_DICT_LATER = (f"{config.ENCODING_DICT_ENABLE.key}: the scan's dictionary "
               f"encoder and DictColumn belong to a later slice of the "
               f"PyTorch port (ROADMAP Queue 1 item 13)")


def open_source(path: str):
    """Local paths pass through; a scheme'd path (hdfs://, s3://...)
    would open through the host engine's file system bridge, which
    belongs to a later slice."""
    if "://" in path and not path.startswith("file://"):
        raise NotImplementedError(
            f"{path}: remote file systems (bridge/fs.py) belong to a later "
            f"slice of the PyTorch port (ROADMAP Queue 1 item 16)")
    return path


class _MetaLru:
    """Bounded LRU of parquet footers keyed by path, with the file's mtime
    as its validity stamp: a rewritten file refreshes in place, a touch
    moves an entry to the most-recent end, and an insert evicts from the
    least-recent end down to `auron.parquet.metadataCacheSize`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # path -> (mtime, md)

    def get(self, path: str, mtime: float):
        with self._lock:
            entry = self._entries.get(path)
            if entry is None or entry[0] != mtime:
                if entry is not None:
                    del self._entries[path]  # stale: the mtime moved
                return None
            self._entries.move_to_end(path)
            return entry[1]

    def put(self, path: str, mtime: float, md) -> None:
        limit = max(1, config.PARQUET_METADATA_CACHE_SIZE.get())
        with self._lock:
            self._entries[path] = (mtime, md)
            self._entries.move_to_end(path)
            while len(self._entries) > limit:
                self._entries.popitem(last=False)

    def __len__(self):
        with self._lock:
            return len(self._entries)

    def clear(self):
        with self._lock:
            self._entries.clear()


_META_CACHE = _MetaLru()


def parquet_metadata(path: str):
    """Footer metadata of one local parquet file (row counts and the
    row-group statistics that pruning and fused-agg bounds discovery
    read), cached by path and mtime."""
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0
    md = _META_CACHE.get(path, mtime)
    if md is None:
        md = pq.ParquetFile(open_source(path)).metadata
        _META_CACHE.put(path, mtime, md)
    return md


class MemoryScanExec(ExecutionPlan):
    """Fixed batches per partition: an Arrow table cut into batches of
    at most `auron.batch.size` rows, dealt round-robin over the
    partitions (the JAX package's rule)."""

    def __init__(self, schema: Schema,
                 partitions: Sequence[Sequence[ColumnBatch]]):
        super().__init__()
        self._schema = schema
        self._partitions = [list(p) for p in partitions]

    @staticmethod
    def from_arrow(table, num_partitions: int = 1,
                   batch_rows: Optional[int] = None) -> "MemoryScanExec":
        if isinstance(table, pa.RecordBatch):
            table = pa.Table.from_batches([table])
        if config.ENCODING_DICT_ENABLE.get():
            raise NotImplementedError(_DICT_LATER)
        batches = table.to_batches(
            max_chunksize=batch_rows or config.BATCH_SIZE.get())
        parts: List[List[ColumnBatch]] = [[] for _ in range(num_partitions)]
        for i, rb in enumerate(batches):
            parts[i % num_partitions].append(ColumnBatch.from_arrow(rb))
        return MemoryScanExec(Schema.from_arrow(table.schema), parts)

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def execute(self, partition: int) -> BatchIterator:
        yield from self._partitions[partition]


class ParquetScanExec(ExecutionPlan):
    """Parquet scan over file groups, one group per partition.

    The output is the projection over file columns and partition columns
    combined, in projection order (the reference's relation schema is
    file columns + partition columns); unprojected, the file columns and
    then every partition column."""

    def __init__(self, schema: Schema, file_groups: Sequence[Sequence[str]],
                 projection: Optional[Sequence[str]] = None,
                 predicate=None, batch_rows: Optional[int] = None,
                 partition_schema: Optional[Schema] = None,
                 partition_values: Optional[Sequence[Sequence[Sequence]]]
                 = None):
        super().__init__()
        if config.ENCODING_DICT_ENABLE.get():
            raise NotImplementedError(_DICT_LATER)
        self._file_schema = schema
        self._partition_schema = partition_schema
        self._partition_values = partition_values  # [group][file][field]
        part_names = ({f.name for f in partition_schema}
                      if partition_schema is not None else set())
        self._projection = list(projection) if projection is not None \
            else None
        if self._projection is not None:
            file_part = Schema([schema.field(n) for n in self._projection
                                if n not in part_names])
            self._out_partition_fields = [
                partition_schema.field(n) for n in self._projection
                if n in part_names] if partition_schema is not None else []
            combined = {f.name: f for f in schema}
            if partition_schema is not None:
                combined.update({f.name: f for f in partition_schema})
            self._schema = Schema([combined[n] for n in self._projection])
        else:
            file_part = schema
            self._out_partition_fields = (list(partition_schema)
                                          if partition_schema is not None
                                          else [])
            self._schema = (Schema(list(schema) + list(partition_schema))
                            if partition_schema is not None else schema)
        self._file_part = file_part
        self._file_groups = [list(g) for g in file_groups]
        self._predicate = predicate
        self._batch_rows = batch_rows or config.BATCH_SIZE.get()

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._file_groups)

    def execute(self, partition: int) -> BatchIterator:
        """Decode AND the batch's one host-to-device copy run on the
        prefetch worker (kill-switch auron.tpu.io.prefetch): the next
        batch's pyarrow decode and copy overlap downstream compute.  On
        the card the copy goes through a `DeviceStager` of this stream's
        own, on the consumer's current stream.  The post-decode filter
        (`_post_decode_filter`) runs there too, on the consumer's stream,
        after the copy."""
        from blaze_tpu_torch.device import resolve
        from blaze_tpu_torch.ops.base import prefetch
        device = resolve()
        stager = None
        if device.type == "cuda":
            import torch
            stager = DeviceStager(device, torch.cuda.current_stream(device))
        post = self._post_decode_filter()

        def transform(rb):
            cb = ColumnBatch.from_arrow(rb, device=device, stager=stager)
            if post is None:
                return cb
            if stager is None:
                return post(cb)
            import torch
            with torch.cuda.stream(stager.consumer):
                return post(cb)
        return prefetch(self._decode_batches(partition),
                        depth=self._prefetch_depth(), transform=transform,
                        name="parquet_scan")

    def _post_decode_filter(self):
        """The predicate's exact row mask ANDed into each decoded batch on
        the prefetch worker (exprs/program.py `fused_filter`), so the
        mask's work overlaps downstream compute; the Filter above, which
        evaluates the same conjuncts, ANDs an identical mask again.  Only
        an unprojected scan without partition columns takes it: the
        predicate is bound to the file's column ordinals.  None where the
        predicate is not wholly traceable."""
        if self._predicate is None or self._projection is not None \
                or self._partition_schema is not None:
            return None
        from blaze_tpu_torch.exprs.program import fused_filter
        return fused_filter([self._predicate], self._schema)

    @staticmethod
    def _prefetch_depth() -> int:
        """The configured depth, widened to one stage-loop chunk while the
        device loop is active: the loop takes a whole chunk of batches a
        step, so a depth-2 queue would stall it on decode every chunk."""
        if not config.IO_PREFETCH_ENABLE.get():
            return 0
        depth = config.IO_PREFETCH_DEPTH.get()
        from blaze_tpu_torch.plan.stage_compiler import stage_loop_active
        if stage_loop_active():
            depth = max(depth, config.STAGE_DEVICE_LOOP_CHUNK.get())
        return depth

    def arrow_batches(self, partition: int):
        """The prefetched Arrow-resident scan stream (_decode_batches)."""
        from blaze_tpu_torch.ops.base import prefetch
        return prefetch(self._decode_batches(partition),
                        name="parquet_scan")

    def _decode_batches(self, partition: int):
        """Arrow-resident scan stream.  (The JAX package's joins also pass
        a build-side key range here to prune by: ROADMAP Queue 1 step
        13.)"""
        prune_pred = self._predicate
        eager_limit = config.SCAN_EAGER_FILE_BYTES.get()
        group = self._file_groups[partition]
        columns = ([f.name for f in self._file_part]
                   if self._projection is not None else None)
        # whole-group fast path: one multithreaded read across all files
        if (len(group) > 1 and prune_pred is None
                and not self._out_partition_fields
                and all(os.path.exists(p) for p in group)
                and sum(os.path.getsize(p) for p in group) <= eager_limit):
            try:
                tbl = pq.read_table(group, columns=columns,
                                    use_threads=True)
            except Exception:
                pass  # schema evolution across files: the per-file loop
            else:
                for rb in tbl.to_batches(max_chunksize=self._batch_rows):
                    if rb.num_rows:
                        rb = _align_schema(rb, self._file_part)
                        self.metrics.add("io_bytes", rb.nbytes)
                        yield rb
                return
        # the JAX package's scan sharing (the cache) belongs to ROADMAP
        # Queue 1 item 16
        for fidx, path in enumerate(group):
            f = pq.ParquetFile(open_source(path))
            row_groups = self._prune_row_groups(f, prune_pred)
            self.metrics.add("pruned_row_groups",
                             f.metadata.num_row_groups - len(row_groups))
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
                rb = _align_schema(rb, self._file_part)
                self.metrics.add("io_bytes", rb.nbytes)
                yield self._assemble_output(rb, partition, fidx)

    def _assemble_output(self, rb: pa.RecordBatch, partition: int,
                         fidx: int) -> pa.RecordBatch:
        """File columns and the projected partition constants, in the
        output schema's order."""
        if not self._out_partition_fields:
            return rb
        return assemble_partition_constants(
            rb, self._schema, self._partition_schema,
            self._partition_values, partition, fidx)

    def _prune_row_groups(self, f: pq.ParquetFile,
                          prune_pred=None) -> List[int]:
        md = f.metadata
        all_groups = list(range(md.num_row_groups))
        if (prune_pred is None or
                not config.PARQUET_ENABLE_PAGE_FILTERING.get()):
            return all_groups
        from blaze_tpu_torch.ops.pruning import prune_with_stats
        return prune_with_stats(md, self._file_schema, prune_pred,
                                all_groups)


def assemble_partition_constants(rb: pa.RecordBatch, out_schema: Schema,
                                 partition_schema: Optional[Schema],
                                 partition_values, partition: int,
                                 fidx: int) -> pa.RecordBatch:
    """File columns merged with Hive partition constants into
    `out_schema` order: a missing or short per-file value list
    null-fills."""
    values: dict = {}
    if partition_values is not None and partition < len(partition_values):
        group = partition_values[partition]
        if fidx < len(group):
            values = {f.name: v for f, v in
                      zip(partition_schema, group[fidx])}
    by_name = {rb.schema.field(i).name: rb.column(i)
               for i in range(rb.num_columns)}
    arrays = []
    for fld in out_schema:
        if fld.name in by_name:
            arrays.append(by_name[fld.name])
            continue
        v = values.get(fld.name)
        at = fld.data_type.to_arrow()
        arrays.append(pa.nulls(rb.num_rows, type=at) if v is None
                      else pa.array([v] * rb.num_rows, type=at))
    return pa.RecordBatch.from_arrays(arrays, schema=out_schema.to_arrow())


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
