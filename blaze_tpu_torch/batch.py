"""Columnar batches bridging Arrow (host) and padded device tensors (port
of blaze_tpu/batch.py).

  * every device buffer is padded to a static `capacity` on the
    `bucket_capacity` ladder, so batch shapes, and with them the row
    indices inside `hash_agg_step`, equal the JAX package's;
  * nullability is a separate bool `validity` tensor per column;
  * filters do not compact: they AND a row `selection` mask, and
    `compact` packs rows at the operator boundaries that need it;
  * host<->device copies go through numpy, host-to-device through pinned
    memory.

The batch's device is the device of its tensors; constructors take it
from `device.resolve()` unless told otherwise.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.schema import DataType, Schema, TypeId

LANE = 128  # device buffers are padded to a multiple of this


def round_capacity(n: int) -> int:
    return max(LANE, -(-n // LANE) * LANE)


def _bucket_policy() -> tuple:
    base = max(LANE, round_capacity(config.BATCH_BUCKET_MIN.get()))
    growth = max(1.125, config.BATCH_BUCKET_GROWTH.get())
    return base, growth


def _next_rung(cap: int, growth: float) -> int:
    return max(round_capacity(int(cap * growth)), cap + LANE)


def bucket_capacity(n: int) -> int:
    """Quantize a requested row capacity onto the geometric bucket ladder
    (plain lane rounding when bucketing is off)."""
    if not config.BATCH_BUCKETING_ENABLE.get():
        return round_capacity(n)
    cap, growth = _bucket_policy()
    while cap < n:
        cap = _next_rung(cap, growth)
    return cap


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host numpy -> tensor on `device`; CUDA copies go through pinned
    memory."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.clone()


def to_host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _unpack_validity(arr: pa.Array) -> np.ndarray:
    """Arrow validity bitmap -> bool array of len(arr)."""
    if arr.null_count == 0:
        return np.ones(len(arr), dtype=bool)
    buf = arr.buffers()[0]
    bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8), bitorder="little")
    return bits[arr.offset:arr.offset + len(arr)].astype(bool)


def _arrow_fixed_values(arr: pa.Array, dtype: DataType) -> np.ndarray:
    """The data buffer of a fixed-width Arrow array as numpy.  A decimal
    of precision <= 18 gives its unscaled int64 values: the low 8 bytes
    of each little-endian decimal128, read as every other int64 of the
    buffer; an int64 array (an accumulator column) is already unscaled."""
    if dtype.id == TypeId.DECIMAL:
        buf = arr.buffers()[1]
        if pa.types.is_decimal(arr.type):
            if dtype.precision > 18 or arr.type.precision > 18:
                # the low 8 bytes would silently truncate wide values
                raise TypeError(
                    f"decimal(p>18) has no int64 device form (got "
                    f"{arr.type}); it stays a host column")
            pairs = np.frombuffer(buf, dtype=np.int64).reshape(-1, 2)
            return pairs[arr.offset:arr.offset + len(arr), 0].copy()
        vals = np.frombuffer(buf, dtype=np.int64)
        return vals[arr.offset:arr.offset + len(arr)]
    if dtype.id == TypeId.TIMESTAMP_MICROS and pa.types.is_timestamp(arr.type) \
            and arr.type.unit != "us":
        arr = arr.cast(pa.timestamp("us", tz=arr.type.tz), safe=False)
    if dtype.id == TypeId.BOOL:
        buf = arr.buffers()[1]
        bits = np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                             bitorder="little")
        return bits[arr.offset:arr.offset + len(arr)].astype(bool)
    vals = np.frombuffer(arr.buffers()[1], dtype=dtype.np_dtype())
    return vals[arr.offset:arr.offset + len(arr)]


def decimal_from_unscaled(values: np.ndarray, valid: Optional[np.ndarray],
                          t: pa.DataType) -> pa.Array:
    """Unscaled int64/int32 values -> a decimal128 Arrow array, without an
    Arrow cast (which would rescale): the 16-byte little-endian limbs are
    built directly, the high limb the low one's sign extension."""
    v = np.ascontiguousarray(values).astype(np.int64, copy=False)
    limbs = np.empty((len(v), 2), dtype=np.int64)
    limbs[:, 0] = v
    limbs[:, 1] = v >> 63  # arithmetic shift: 0 or -1
    if valid is None or bool(np.asarray(valid).all()):
        validity_buf, null_count = None, 0
    else:
        valid = np.asarray(valid, dtype=bool)
        validity_buf = pa.py_buffer(np.packbits(
            valid.astype(np.uint8), bitorder="little").tobytes())
        null_count = int((~valid).sum())
    return pa.Array.from_buffers(t, len(v), [validity_buf,
                                             pa.py_buffer(limbs.tobytes())],
                                 null_count=null_count)


def _decimal_store(dtype: DataType):
    """Storage of a decimal column on the device: int64, or int32 for
    p <= 9 under auron.tpu.encoding.decimal.enable and .int32."""
    if dtype.precision <= 9 and config.ENCODING_DECIMAL_ENABLE.get() \
            and config.ENCODING_DECIMAL_INT32.get():
        return np.int32
    return np.int64


@dataclass
class DeviceColumn:
    """Fixed-width column on the device: padded data + validity."""

    dtype: DataType
    data: torch.Tensor      # (capacity,)
    validity: torch.Tensor  # (capacity,) bool; False in padding

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @staticmethod
    def from_numpy(values: np.ndarray, valid: Optional[np.ndarray],
                   dtype: DataType, capacity: int,
                   device: torch.device) -> "DeviceColumn":
        n = len(values)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} rows")
        np_dtype = dtype.np_dtype()
        if dtype.id == TypeId.DECIMAL and values.dtype == np.int32:
            np_dtype = np.int32  # the scaled-int32 tier
        data = np.zeros(capacity, dtype=np_dtype)
        data[:n] = values
        v = np.zeros(capacity, dtype=bool)
        v[:n] = True if valid is None else valid
        return DeviceColumn(dtype, to_device(data, device),
                            to_device(v, device))

    @staticmethod
    def from_arrow(arr: pa.Array, dtype: DataType, capacity: int,
                   device: torch.device) -> "DeviceColumn":
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        values = _arrow_fixed_values(arr, dtype)
        if dtype.id == TypeId.DECIMAL:
            values = values.astype(_decimal_store(dtype), copy=False)
        return DeviceColumn.from_numpy(values, _unpack_validity(arr), dtype,
                                       capacity, device)

    def to_arrow(self, num_rows: int, selection: Optional[np.ndarray] = None,
                 prefetched: Optional[tuple] = None) -> pa.Array:
        """`prefetched` = (values, validity) numpy arrays already copied to
        the host."""
        if prefetched is not None:
            values, valid = prefetched
        else:
            values, valid = to_host(self.data), to_host(self.validity)
        values = values[:num_rows]
        valid = valid[:num_rows]
        if selection is not None:
            values = values[selection[:num_rows]]
            valid = valid[selection[:num_rows]]
        mask = None if valid.all() else ~valid  # no nulls -> no bitmap
        at = self.dtype.to_arrow()
        if self.dtype.id == TypeId.DECIMAL:
            return decimal_from_unscaled(values, valid, at)
        if self.dtype.id == TypeId.BOOL:
            return pa.array(values.astype(bool), type=at, mask=mask)
        return pa.array(values, type=at, mask=mask)

    def take(self, indices: torch.Tensor, capacity: int) -> "DeviceColumn":
        """Gather rows on the device into a buffer of `capacity`."""
        n = indices.shape[0]
        data = torch.zeros(capacity, dtype=self.data.dtype,
                           device=self.data.device)
        valid = torch.zeros(capacity, dtype=torch.bool,
                            device=self.data.device)
        data[:n] = self.data.index_select(0, indices)
        valid[:n] = self.validity.index_select(0, indices)
        return DeviceColumn(self.dtype, data, valid)


@dataclass
class HostColumn:
    """Variable-width / nested column kept on the host as an Arrow array
    (utf8 in the port): compaction, concatenation and row takes work on
    it with Arrow's kernels, as in the JAX package."""

    dtype: DataType
    array: pa.Array  # exactly num_rows long (never padded)

    @property
    def capacity(self) -> int:
        return len(self.array)

    def to_arrow(self, num_rows: int,
                 selection: Optional[np.ndarray] = None) -> pa.Array:
        arr = self.array.slice(0, num_rows)
        if selection is not None:
            arr = arr.filter(pa.array(selection[:num_rows]))
        return arr

    def take(self, indices, capacity: int = 0) -> "HostColumn":
        """Rows at `indices` (a tensor on any device, or numpy); a host
        column is never padded, so `capacity` is not used."""
        if isinstance(indices, torch.Tensor):
            indices = indices.cpu().numpy()
        return HostColumn(self.dtype, self.array.take(
            pa.array(np.asarray(indices, dtype=np.int64), type=pa.int64())))


Column = Union[DeviceColumn, HostColumn]


@dataclass
class ColumnBatch:
    """Schema + per-column device/host storage.  `selection` (bool tensor
    over capacity, or None) marks surviving rows after filters; padding
    rows are always deselected via `row_mask()`."""

    schema: Schema
    columns: List[Column]
    num_rows: int
    selection: Optional[torch.Tensor] = None

    @staticmethod
    def from_arrow(rb: Union[pa.RecordBatch, pa.Table],
                   capacity: Optional[int] = None,
                   device: Optional[torch.device] = None) -> "ColumnBatch":
        if device is None:
            from blaze_tpu_torch.device import resolve
            device = resolve()
        if isinstance(rb, pa.Table):
            rb = rb.combine_chunks()
            arrays = [c.chunk(0) if c.num_chunks else
                      pa.array([], type=c.type) for c in rb.columns]
        else:
            arrays = list(rb.columns)
        schema = Schema.from_arrow(rb.schema)
        n = rb.num_rows
        cap = capacity if capacity is not None else bucket_capacity(n)
        cols: List[Column] = []
        for arr, f in zip(arrays, schema):
            if f.data_type.is_fixed_width:
                cols.append(DeviceColumn.from_arrow(arr, f.data_type, cap,
                                                    device))
            else:
                cols.append(HostColumn(f.data_type, arr))
        return ColumnBatch(schema, cols, n)

    @property
    def capacity(self) -> int:
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                return c.capacity
        return round_capacity(self.num_rows)

    @property
    def device(self) -> torch.device:
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                return c.data.device
        if self.selection is not None:
            return self.selection.device
        from blaze_tpu_torch.device import resolve
        return resolve()

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def row_mask(self) -> torch.Tensor:
        """Bool mask over capacity: in range AND selected."""
        base = torch.arange(self.capacity, device=self.device) < self.num_rows
        if self.selection is not None:
            base = base & self.selection
        return base

    def selected_count(self) -> int:
        """Surviving row count (one scalar device-to-host copy, cached)."""
        if self.selection is None:
            return self.num_rows
        c = getattr(self, "_sel_count", None)
        if c is None:
            c = int(self.row_mask().sum())
            self._sel_count = c  # dataclasses.replace drops the cache
        return c

    def with_selection(self, sel: torch.Tensor) -> "ColumnBatch":
        new = sel if self.selection is None else (self.selection & sel)
        return replace(self, selection=new)

    def compact(self) -> "ColumnBatch":
        """Pack surviving rows to the front, in order, into a buffer on the
        bucket ladder; drops the selection mask."""
        if self.selection is None:
            return self
        count = self.selected_count()
        if count == self.num_rows:
            return replace(self, selection=None)
        idx = torch.nonzero(self.row_mask()).squeeze(1)
        cap = bucket_capacity(count)
        # device columns gather on the device; host (utf8) columns take
        # the same rows on the host (one copy of the indices)
        host_idx = (idx.cpu().numpy() if any(
            isinstance(c, HostColumn) for c in self.columns) else None)
        cols = [c.take(host_idx if isinstance(c, HostColumn) else idx, cap)
                for c in self.columns]
        return ColumnBatch(self.schema, cols, count, None)

    def to_arrow(self) -> pa.RecordBatch:
        sel = (to_host(self.row_mask()) if self.selection is not None
               else None)
        arrays = []
        for c in self.columns:
            if isinstance(c, DeviceColumn):
                arrays.append(c.to_arrow(
                    self.num_rows, sel,
                    prefetched=(to_host(c.data), to_host(c.validity))))
            else:
                arrays.append(c.to_arrow(self.num_rows, sel))
        return pa.RecordBatch.from_arrays(arrays,
                                          schema=self.schema.to_arrow())

    @staticmethod
    def concat(batches: Sequence["ColumnBatch"],
               capacity: Optional[int] = None) -> "ColumnBatch":
        """Concatenate after compacting each batch; device columns stay on
        the device, host columns concatenate through Arrow."""
        if not batches:
            raise ValueError("concat of no batches")
        batches = [b.compact() for b in batches]
        schema = batches[0].schema
        total = sum(b.num_rows for b in batches)
        cap = capacity or bucket_capacity(total)
        cols: List[Column] = []
        for i, f in enumerate(schema):
            if not f.data_type.is_fixed_width:
                at = f.data_type.to_arrow()
                cols.append(HostColumn(f.data_type, pa.concat_arrays(
                    [b.columns[i].to_arrow(b.num_rows).cast(at)
                     for b in batches])))
                continue
            vals = torch.cat([b.columns[i].data[:b.num_rows]
                              for b in batches])
            valid = torch.cat([b.columns[i].validity[:b.num_rows]
                               for b in batches])
            pad = cap - total
            if pad > 0:
                vals = torch.cat([vals, vals.new_zeros(pad)])
                valid = torch.cat([valid, valid.new_zeros(pad)])
            cols.append(DeviceColumn(f.data_type, vals, valid))
        return ColumnBatch(schema, cols, total, None)

    def __repr__(self):
        return (f"ColumnBatch(rows={self.num_rows}, cap={self.capacity}, "
                f"cols={[f.name for f in self.schema]})")
