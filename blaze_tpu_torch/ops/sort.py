"""The sort operator (port of SortExec, blaze_tpu/ops/sort.py).

Each input batch is staged on the host as Arrow with its evaluated sort
keys in front as `__key{i}` columns, so that a spilled run keeps its keys.
The staged bytes are charged to the memory manager (`_SortState` is a
`MemConsumer`); under pressure the staged rows are sorted into one run
and spilled through `try_new_spill` (host RAM, then a file).  A run,
spilled or the last in memory, is sorted thus:

  * from 1024 rows up, with fixed-width keys, the keys go to the device,
    become order operands (kernels/compare.py) and are lexsorted there;
    only the permutation comes back, and the host takes the rows in that
    order (counted in the `sort_device_runs` metric);
  * below 1024 rows, or with a utf8 key at any size, the host sorts
    numpy order keys (`host_sort_keys`, `lexsort_host`; a utf8 key is an
    object column of its UTF-8 bytes), as the JAX package does.

With no spill the sorted run leaves in `auron.batch.size` slices; with
spills, the in-memory run and the spilled runs (in that order) go through
`merge_sorted_batches`, the JAX package's batch-vectorised k-way merge on
the host.  With `fetch`, only the first `fetch` rows leave.  Ties keep
their input order (the sort and the merge are stable), so a fetch cuts
where the JAX package cuts.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn, bucket_capacity
from blaze_tpu_torch.device import resolve
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import compare
from blaze_tpu_torch.memory import (MemConsumer, MemManager, Spill,
                                    try_new_spill)
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import DataType, Schema

SortSpec = Tuple[PhysicalExpr, bool, bool]  # (expr, descending, nulls_first)

#: staged rows from which a run with fixed-width keys sorts on the device
DEVICE_SORT_MIN_ROWS = 1024


# ---------------------------------------------------------------------------
# host order keys
# ---------------------------------------------------------------------------

def _host_order_key(arr: pa.Array, descending: bool, nulls_first: bool
                    ) -> List[np.ndarray]:
    """[bucket u8, key] whose joint lexicographic order equals the SQL
    order, as the JAX package's host keys: key is u64 for numerics
    (sign-biased or IEEE-flipped), two u64s for a decimal (its unscaled
    int128) or an object column of UTF-8 bytes for strings."""
    n = len(arr)
    valid = np.ones(n, dtype=bool) if arr.null_count == 0 else \
        np.asarray(arr.is_valid())
    t = arr.type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        bucket = np.where(valid, 2, 0 if nulls_first else 4).astype(np.uint8)
        return [bucket] + _string_sort_keys(arr, descending)
    if pa.types.is_floating(t):
        f = np.asarray(arr.fill_null(0.0), dtype=np.float64)
        nan = np.isnan(f)
        f = np.where(nan, 0.0, f) + 0.0
        bits = f.view(np.uint64)
        key = np.where(f < 0, ~bits, bits | np.uint64(1 << 63))
        if descending:
            key = ~key
        bucket = np.where(nan, 1 if descending else 3, 2).astype(np.uint8)
    elif pa.types.is_boolean(t):
        key = np.asarray(arr.fill_null(False)).astype(np.uint64)
        if descending:
            key = np.uint64(1) - key
        bucket = np.full(n, 2, dtype=np.uint8)
    elif pa.types.is_integer(t) or pa.types.is_timestamp(t) \
            or pa.types.is_date(t):
        if pa.types.is_timestamp(t) or pa.types.is_date(t):
            arr = arr.cast(pa.int64() if pa.types.is_timestamp(t)
                           else pa.int32())
        v = np.asarray(arr.fill_null(0)).astype(np.int64)
        key = v.view(np.uint64) ^ np.uint64(1 << 63)
        if descending:
            key = ~key
        bucket = np.full(n, 2, dtype=np.uint8)
    elif pa.types.is_decimal(t):
        # the unscaled two's-complement int128 at one scale: a sign-biased
        # high u64 then the low u64, exact at any precision
        filled = arr.fill_null(0).cast(pa.decimal128(38, t.scale))
        u = np.frombuffer(filled.buffers()[1], dtype=np.uint64,
                          count=2 * (filled.offset + n))[2 * filled.offset:]
        lokey = u[0::2].copy()
        hikey = u[1::2].copy() ^ np.uint64(1 << 63)
        if descending:
            hikey, lokey = ~hikey, ~lokey
        bucket = np.where(valid, 2, 0 if nulls_first else 4).astype(np.uint8)
        return [bucket, np.where(valid, hikey, np.uint64(0)),
                np.where(valid, lokey, np.uint64(0))]
    else:
        raise TypeError(f"no sort order for {t} keys")
    bucket = np.where(valid, bucket, 0 if nulls_first else 4).astype(np.uint8)
    key = np.where(valid, key, np.zeros_like(key))
    return [bucket, key]


_INVERT_TABLE = bytes(255 - i for i in range(256))


def _string_sort_keys(arr: pa.Array, descending: bool) -> List[np.ndarray]:
    """UTF-8 bytewise keys as one object column of `bytes` (byte order is
    code-point order, Spark's string order).  Descending maps every string
    through a 256-entry invert table plus an 0xFF sentinel."""
    bin_t = (pa.large_binary() if pa.types.is_large_string(arr.type)
             else pa.binary())
    raw = arr.cast(bin_t).fill_null(b"").to_pylist()
    key = np.empty(len(raw), dtype=object)
    key[:] = ([b.translate(_INVERT_TABLE) + b"\xff" for b in raw]
              if descending else raw)
    return [key]


def host_sort_keys(rb: pa.RecordBatch, key_cols: Sequence[int],
                   descending: Sequence[bool], nulls_first: Sequence[bool]
                   ) -> List[np.ndarray]:
    keys: List[np.ndarray] = []
    for ci, desc, nf in zip(key_cols, descending, nulls_first):
        keys.extend(_host_order_key(rb.column(ci), desc, nf))
    return keys


def lexsort_host(keys: List[np.ndarray]) -> np.ndarray:
    # np.lexsort sorts by the LAST key first
    return np.lexsort(tuple(reversed(keys)))


def _is_fixed(t: pa.DataType) -> bool:
    """A key with a device form: not var-width, not a decimal of
    precision > 18 (a host column)."""
    if pa.types.is_decimal(t):
        return t.precision <= 18
    return not (pa.types.is_string(t) or pa.types.is_large_string(t) or
                pa.types.is_binary(t) or pa.types.is_nested(t))


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

class SortExec(ExecutionPlan):

    def __init__(self, child: ExecutionPlan, sort_specs: Sequence[SortSpec],
                 fetch: Optional[int] = None):
        super().__init__([child])
        self._specs = list(sort_specs)
        self._fetch = fetch

    @property
    def schema(self) -> Schema:
        return self.children[0].schema

    def execute(self, partition: int) -> BatchIterator:
        state = _SortState(self)
        state.set_spillable(MemManager.get())
        try:
            for batch in self.children[0].execute(partition):
                state.insert(batch)
            out_rows = 0
            for rb in state.merged_output():
                if self._fetch is not None:
                    if out_rows >= self._fetch:
                        break
                    if out_rows + rb.num_rows > self._fetch:
                        rb = rb.slice(0, self._fetch - out_rows)
                out_rows += rb.num_rows
                yield ColumnBatch.from_arrow(rb)
        finally:
            state.unregister()
            state.release_spills()


class _SortState(MemConsumer):
    """Per-partition sort state: the staged Arrow batches and the spilled
    sorted runs."""

    def __init__(self, op: SortExec):
        super().__init__("sort")
        self._op = op
        self.metrics = op.metrics
        self._schema = op.schema
        self._specs = op._specs
        self._num_keys = len(op._specs)
        self._staged: List[pa.RecordBatch] = []
        self._staged_bytes = 0
        self._spills: List[Spill] = []
        #: the staged rows became the in-memory run being emitted
        self._output_started = False

    def insert(self, batch: ColumnBatch) -> None:
        rb = self._with_key_columns(batch)
        if rb.num_rows == 0:
            return
        self._staged.append(rb)
        self._staged_bytes += rb.nbytes  # the keys' bytes included
        self.update_mem_used(self._staged_bytes)

    def _with_key_columns(self, batch: ColumnBatch) -> pa.RecordBatch:
        """The payload (selected rows) with the evaluated sort keys
        prepended as __key{i} columns."""
        sel = None
        if batch.selection is not None:
            sel = batch.row_mask()[:batch.num_rows].cpu().numpy()
        arrays, names = [], []
        for i, (expr, _, _) in enumerate(self._specs):
            key = expr.evaluate(batch).to_host(batch.num_rows)
            arrays.append(key if sel is None else
                          key.filter(pa.array(sel[:batch.num_rows])))
            names.append(f"__key{i}")
        payload = batch.to_arrow()
        arrays.extend(payload.columns)
        names.extend(self._schema.names)
        return pa.RecordBatch.from_arrays(arrays, names=names)

    # -- spill (MemConsumer) -------------------------------------------------
    def spill(self) -> int:
        if self._output_started:
            # the in-memory run is being emitted: its charge is released
            # as a spill of its bytes, as the JAX package releases it
            # (which also writes the rows to a run it never reads)
            released, self._staged_bytes = self._staged_bytes, 0
            self._mem_used = 0
            if released:
                self._count_spill(released)
            return released
        if not self._staged:
            return 0
        spill = try_new_spill()
        spill.write_batches(iter(self._sort_staged()))
        self._spills.append(spill)
        released = self._staged_bytes
        self._staged = []
        self._staged_bytes = 0
        self._mem_used = 0
        self._count_spill(released)
        return released

    def _count_spill(self, released: int) -> None:
        self.spill_metrics.spill_count += 1
        self.spill_metrics.spilled_bytes += released
        self._op.metrics.add("spill_count")
        self._op.metrics.add("spilled_bytes", released)

    def release_spills(self) -> None:
        spills, self._spills = self._spills, []
        for s in spills:
            s.release()

    def _sort_staged(self) -> List[pa.RecordBatch]:
        """The staged rows as one sorted run (keys kept) in
        `auron.batch.size` slices; the staged list is emptied."""
        if not self._staged:
            return []
        rb = pa.Table.from_batches(self._staged).combine_chunks() \
            .to_batches()[0]
        self._staged = []
        rb = rb.take(pa.array(self._sort_permutation(rb), type=pa.int64()))
        bs = config.BATCH_SIZE.get()
        return [rb.slice(i, min(bs, rb.num_rows - i))
                for i in range(0, rb.num_rows, bs)]

    def _sort_permutation(self, rb: pa.RecordBatch) -> np.ndarray:
        key_cols = list(range(self._num_keys))
        desc = [d for _, d, _ in self._specs]
        nf = [f for _, _, f in self._specs]
        fixed = all(_is_fixed(rb.column(i).type) for i in key_cols)
        if fixed and rb.num_rows >= DEVICE_SORT_MIN_ROWS:
            dev = resolve()
            n = rb.num_rows
            cap = bucket_capacity(n)
            cols = []
            for i in key_cols:
                dt = DataType.from_arrow(rb.column(i).type)
                dc = DeviceColumn.from_arrow(rb.column(i), dt, cap, dev)
                cols.append((dc.data, dc.validity, dt))
            keys = compare.order_keys(cols, desc, nf)
            valid = torch.arange(cap, device=dev) < n
            perm = compare.lexsort_indices(keys, valid)
            self._op.metrics.add("sort_device_runs", 1)
            return perm[:n].cpu().numpy()
        return lexsort_host(host_sort_keys(rb, key_cols, desc, nf))

    # -- output --------------------------------------------------------------
    def merged_output(self) -> Iterator[pa.RecordBatch]:
        """Every row in sort order, keys stripped: the sorted in-memory
        run alone, or merged with the spilled runs (in-memory run
        first, then the spills oldest first)."""
        runs: List[Iterator[pa.RecordBatch]] = []
        in_mem = self._sort_staged()
        self._output_started = True
        if in_mem:
            runs.append(iter(in_mem))
        runs.extend(s.read_batches() for s in self._spills)
        if len(runs) > 1:
            desc = [d for _, d, _ in self._specs]
            nf = [f for _, _, f in self._specs]
            runs = [merge_sorted_batches(runs, list(range(self._num_keys)),
                                         desc, nf)]
        for run in runs:
            for rb in run:
                yield self._strip_keys(rb)

    def _strip_keys(self, rb: pa.RecordBatch) -> pa.RecordBatch:
        return pa.RecordBatch.from_arrays(rb.columns[self._num_keys:],
                                          schema=self._schema.to_arrow())


def merge_sorted_batches(runs: List[Iterator[pa.RecordBatch]],
                         key_cols: Sequence[int], desc: Sequence[bool],
                         nf: Sequence[bool]) -> Iterator[pa.RecordBatch]:
    """Vectorised k-way merge of sorted batch streams (the sort's and the
    aggregation's spill merge): each round merges every buffered row whose
    key is <= the smallest of the runs' head-batch maxima (no row not yet
    read can precede it) in one host lexsort, runs in list order breaking
    ties.  Output chunks hold at most `auron.batch.size` rows and about
    `auron.suggested.batch.memSize.multiwayMerging` bytes."""
    heads: List[Optional[pa.RecordBatch]] = []
    keys: List[Optional[List[np.ndarray]]] = []
    for r in runs:
        rb = next(r, None)
        heads.append(rb)
        keys.append(host_sort_keys(rb, key_cols, desc, nf) if rb is not None
                    else None)

    def _advance(i):
        rb = next(runs[i], None)
        heads[i] = rb
        keys[i] = (host_sort_keys(rb, key_cols, desc, nf)
                   if rb is not None else None)

    bs = config.BATCH_SIZE.get()
    while True:
        live = [i for i in range(len(runs)) if heads[i] is not None]
        if not live:
            return
        if len(live) == 1:
            i = live[0]
            yield heads[i]
            _advance(i)
            continue
        # each run is sorted, so its head batch's last row is its max
        last_tuples = {i: _key_tuple(keys[i], heads[i].num_rows - 1)
                       for i in live}
        threshold = last_tuples[min(live, key=lambda i: last_tuples[i])]
        take_parts: List[pa.RecordBatch] = []
        take_keys: List[List[np.ndarray]] = []
        for i in live:
            k = keys[i]
            cnt = _count_leq(k, threshold)
            if cnt == 0:
                continue
            take_parts.append(heads[i].slice(0, cnt))
            take_keys.append([col[:cnt] for col in k])
            if cnt == heads[i].num_rows:
                _advance(i)
            else:
                heads[i] = heads[i].slice(cnt)
                keys[i] = [col[cnt:] for col in keys[i]]
        merged = pa.Table.from_batches(take_parts).combine_chunks()
        mk = [np.concatenate([tk[j] for tk in take_keys])
              for j in range(len(take_keys[0]))]
        perm = lexsort_host(mk)
        out = merged.to_batches()[0].take(pa.array(perm, type=pa.int64()))
        mem_target = config.SUGGESTED_MERGING_BATCH_MEM_SIZE.get()
        row_bytes = max(1, out.nbytes // max(1, out.num_rows))
        chunk = max(1, min(bs, mem_target // row_bytes))
        for off in range(0, out.num_rows, chunk):
            yield out.slice(off, min(chunk, out.num_rows - off))


def _key_tuple(keys: List[np.ndarray], row: int) -> tuple:
    return tuple(k[row] for k in keys)


def compare_scalar(k: np.ndarray, t):
    """The comparison scalar wrapped so numpy never coerces it: a raw
    `bytes` against an object array would become an S-dtype scalar and
    lose its trailing NUL bytes, so that a row would be neither < nor ==
    its own threshold."""
    if k.dtype == object:
        w = np.empty((), dtype=object)
        w[()] = t
        return w
    return t


def _count_leq(keys: List[np.ndarray], threshold: tuple) -> int:
    """Rows at the front of a sorted run whose key is <= threshold
    (lexicographic)."""
    leq = np.ones(len(keys[0]), dtype=bool)
    for j in range(len(keys) - 1, -1, -1):
        k = keys[j]
        t = compare_scalar(k, threshold[j])
        leq = (k < t) | ((k == t) & leq)
    return int(leq.sum())
