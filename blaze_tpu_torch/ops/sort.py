"""The sort operator (port of the in-memory part of SortExec,
blaze_tpu/ops/sort.py).

Each input batch is staged on the host as Arrow with its evaluated sort
keys in front as `__key{i}` columns (the JAX package keeps them there so
spilled runs carry their keys).  At the end the staged rows form one run:

  * from 1024 rows up, with fixed-width keys, the keys go to the device,
    become order operands (kernels/compare.py) and are lexsorted there;
    only the permutation comes back, and the host takes the rows in that
    order (counted in the `sort_device_runs` metric);
  * below 1024 rows, or with a utf8 key at any size, the host sorts
    numpy order keys (`host_sort_keys`, `lexsort_host`; a utf8 key is an
    object column of its UTF-8 bytes), as the JAX package does.

The sorted run leaves in `auron.batch.size` slices; with `fetch`, only the
first `fetch` rows leave.  Ties keep their input order (the sort is
stable), so a fetch cuts where the JAX package cuts.  Spill and the k-way
merge of spilled runs (`merge_sorted_batches`) belong to the memory
manager's slice (ROADMAP Queue 1 item 8).
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
    (sign-biased or IEEE-flipped) or an object column of UTF-8 bytes for
    strings."""
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
    else:
        raise NotImplementedError(
            f"sorting by {t} keys belongs to the strings/decimals slice of "
            f"the PyTorch port (ROADMAP Queue 1 item 13)")
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
        for batch in self.children[0].execute(partition):
            state.insert(batch)
        out_rows = 0
        for rb in state.sorted_output():
            if self._fetch is not None:
                if out_rows >= self._fetch:
                    break
                if out_rows + rb.num_rows > self._fetch:
                    rb = rb.slice(0, self._fetch - out_rows)
            out_rows += rb.num_rows
            yield ColumnBatch.from_arrow(rb)


class _SortState:
    """Per-partition sort state: the staged Arrow batches."""

    def __init__(self, op: SortExec):
        self._op = op
        self._schema = op.schema
        self._specs = op._specs
        self._num_keys = len(op._specs)
        self._staged: List[pa.RecordBatch] = []

    def insert(self, batch: ColumnBatch) -> None:
        rb = self._with_key_columns(batch)
        if rb.num_rows:
            self._staged.append(rb)
            # the JAX package charges the staged bytes to its memory
            # manager here and may spill a sorted run (ROADMAP item 8)

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

    def sorted_output(self) -> Iterator[pa.RecordBatch]:
        """The staged rows in sort order, keys stripped, in
        `auron.batch.size` slices."""
        if not self._staged:
            return
        rb = pa.Table.from_batches(self._staged).combine_chunks() \
            .to_batches()[0]
        self._staged = []
        perm = self._sort_permutation(rb)
        rb = rb.take(pa.array(perm, type=pa.int64()))
        rb = pa.RecordBatch.from_arrays(rb.columns[self._num_keys:],
                                        schema=self._schema.to_arrow())
        bs = config.BATCH_SIZE.get()
        for i in range(0, rb.num_rows, bs):
            yield rb.slice(i, min(bs, rb.num_rows - i))
