"""Columnar batches bridging Arrow (host) and padded device tensors (port
of blaze_tpu/batch.py).

  * every device buffer is padded to a static `capacity` on the
    `bucket_capacity` ladder, so batch shapes, and with them the row
    indices inside `hash_agg_step`, equal the JAX package's;
  * nullability is a separate bool `validity` tensor per column;
  * filters do not compact: they AND a row `selection` mask, and
    `compact` packs rows at the operator boundaries that need it;
  * a batch crosses to the device in ONE copy: every fixed-width
    column's values and validity are packed into one staging buffer
    (pinned, on the card) at aligned offsets, copied once, and the
    columns are views of the one device buffer (`_stage_columns`,
    `DeviceStager`); `to_arrow` reads the mask and every column back in
    one copy.  `bridge/device_stats.py` counts the bytes each way
    (`note_h2d`, `note_d2h`), as the JAX package's transfer counters do.

The batch's device is the device of its tensors; constructors take it
from `device.resolve()` unless told otherwise.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.bridge import device_stats
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
        cap = round_capacity(n)
    else:
        cap, growth = _bucket_policy()
        while cap < n:
            cap = _next_rung(cap, growth)
    device_stats.note_bucket(cap, cap - min(int(n), cap))
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


#: byte alignment of each column region in a batch's staging buffer
#: (cudaMalloc's, so every view is as aligned as a tensor of its own)
_ALIGN = 256
_TORCH_DTYPES: dict = {}


def _torch_dtype(np_dtype) -> torch.dtype:
    np_dtype = np.dtype(np_dtype)
    t = _TORCH_DTYPES.get(np_dtype)
    if t is None:
        t = _TORCH_DTYPES[np_dtype] = torch.from_numpy(
            np.empty(0, dtype=np_dtype)).dtype
    return t


class DeviceStager:
    """The host-to-device lane of one prefetcher, or of one thread's
    synchronous calls: a copy stream of its own, a ring of pinned staging
    buffers, and the stream that consumes the batches.

    `stage` packs a batch into the next pinned buffer (after the event of
    that buffer's previous copy has completed), issues ONE copy into a
    fresh device buffer on the copy stream, records an event there, makes
    the consumer's stream wait on it, and marks the device buffer as used
    by the consumer's stream (`record_stream`), so the caching allocator
    does not hand it out again before the consumer's work on it is done.

    A graph capture in global mode (runtime/loop.py) forbids another
    thread's allocations, event waits and syncs while it runs: every CUDA
    call here is made under `device.CAPTURE_LOCK`, which the capture
    holds; the host packing runs outside it."""

    RING = 4

    def __init__(self, device: torch.device, consumer=None):
        self.device = device
        # None: the calling thread's current stream at each call
        self.consumer = consumer
        self._copy = None
        self._ring: list = [None] * self.RING  # (pinned buffer, event)
        self._next = 0

    def stage(self, nbytes: int, pack) -> torch.Tensor:
        """`pack(host_bytes)` fills a uint8 numpy view of `nbytes` staging
        bytes; returns the device uint8 buffer they were copied into."""
        from blaze_tpu_torch.device import CAPTURE_LOCK
        consumer = (self.consumer if self.consumer is not None
                    else torch.cuda.current_stream(self.device))
        slot = self._next
        with CAPTURE_LOCK:
            if self._copy is None:
                self._copy = torch.cuda.Stream(self.device)
            held = self._ring[slot]
            if held is not None:
                held[1].synchronize()  # its last copy has landed
            if held is None or held[0].numel() < nbytes:
                size = max(nbytes, 1 << 20)
                pinned = torch.empty(-(-size // (1 << 20)) << 20,
                                     dtype=torch.uint8, pin_memory=True)
            else:
                pinned = held[0]
        pack(pinned.numpy()[:nbytes])
        with CAPTURE_LOCK:
            with torch.cuda.stream(self._copy):
                dev = torch.empty(nbytes, dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(pinned[:nbytes], non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy)
            consumer.wait_event(event)
            dev.record_stream(consumer)
            self._ring[slot] = (pinned, event)
            self._next = (slot + 1) % self.RING
        return dev


_stagers = threading.local()


def _thread_stager(device: torch.device) -> DeviceStager:
    """The calling thread's own lane, for batches placed synchronously."""
    by_dev = getattr(_stagers, "by_dev", None)
    if by_dev is None:
        by_dev = _stagers.by_dev = {}
    st = by_dev.get(device)
    if st is None:
        st = by_dev[device] = DeviceStager(device)
    return st


def _stage_columns(specs, device: torch.device,
                   stager: Optional["DeviceStager"] = None) -> list:
    """Place fixed-width columns with ONE host-to-device copy.

    `specs`: (values, valid, capacity) per column, `values` a numpy array
    of the column's storage dtype and `valid` a bool array or None (no
    nulls).  Every column's padded values and validity go into one
    staging buffer at `_ALIGN`-aligned offsets; returns (data, validity)
    tensor pairs, views of the one buffer on `device` (on the card they
    share the one block `DeviceStager.stage` marked as used by the
    consumer's stream).  The transfer counter gets the padded bytes
    (values and validity over capacity), as the JAX package's batched put
    counts them.  No column, no copy: [] without touching the stager."""
    if not specs:
        return []
    layout, off, moved = [], 0, 0
    for values, _valid, cap in specs:
        nb = cap * values.dtype.itemsize
        layout.append((off, nb, off + -(-nb // _ALIGN) * _ALIGN))
        off = layout[-1][2] + -(-cap // _ALIGN) * _ALIGN
        moved += nb + cap
    total = max(off, _ALIGN)

    def pack(buf: np.ndarray) -> None:
        for (values, valid, cap), (d_off, nb, v_off) in zip(specs, layout):
            n = len(values)
            d = buf[d_off:d_off + nb].view(values.dtype)
            d[:n] = values
            d[n:] = 0
            v = buf[v_off:v_off + cap].view(np.bool_)
            v[:n] = True if valid is None else valid
            v[n:] = False

    if device.type == "cuda":
        if stager is None:
            stager = _thread_stager(device)
        flat = stager.stage(total, pack)
    else:
        flat = torch.empty(total, dtype=torch.uint8)
        pack(flat.numpy())
    device_stats.note_h2d(moved)
    return [(flat[d_off:d_off + nb].view(_torch_dtype(values.dtype)),
             flat[v_off:v_off + cap].view(torch.bool))
            for (values, _valid, cap), (d_off, nb, v_off)
            in zip(specs, layout)]


def _fetch_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> numpy arrays; from the card in ONE device-to-host copy
    (their bytes concatenated on the device, then one copy and one wait),
    CPU tensors viewed as they are.  Counts the bytes fetched."""
    if not tensors:
        return []
    device_stats.note_d2h(sum(t.numel() * t.element_size()
                              for t in tensors))
    if tensors[0].device.type != "cuda":
        return [to_host(t) for t in tensors]
    raw = torch.cat([t.detach().contiguous().view(-1).view(torch.uint8)
                     for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        nb = t.numel() * t.element_size()
        out.append(raw[off:off + nb].view(_np_dtype(t.dtype)))
        off += nb
    return out


_NP_DTYPES: dict = {}


def _np_dtype(t: torch.dtype):
    d = _NP_DTYPES.get(t)
    if d is None:
        d = _NP_DTYPES[t] = torch.empty(0, dtype=t).numpy().dtype
    return d


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
        """One column from host arrays: padded values and validity in one
        copy (`_stage_columns`), the values in the column's storage dtype
        (the scaled-int32 tier keeps int32)."""
        n = len(values)
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} rows")
        if valid is not None and len(valid) != n:
            raise ValueError(f"{len(valid)} validity flags for {n} rows")
        np_dtype = dtype.np_dtype()
        if dtype.id == TypeId.DECIMAL and values.dtype == np.int32:
            np_dtype = np.int32  # the scaled-int32 tier
        values = np.asarray(values).astype(np_dtype, copy=False)
        (data, v), = _stage_columns([(values, valid, capacity)], device)
        return DeviceColumn(dtype, data, v)

    @staticmethod
    def host_arrow(arr: pa.Array, dtype: DataType) -> tuple:
        """(values, valid) host arrays of a fixed-width Arrow array: the
        values in the column's storage dtype (its buffer read as that
        dtype), valid None when it has no nulls."""
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        values = _arrow_fixed_values(arr, dtype)
        if dtype.id == TypeId.DECIMAL:
            values = values.astype(_decimal_store(dtype), copy=False)
        return values, (_unpack_validity(arr) if arr.null_count else None)

    @staticmethod
    def from_arrow(arr: pa.Array, dtype: DataType, capacity: int,
                   device: torch.device) -> "DeviceColumn":
        values, valid = DeviceColumn.host_arrow(arr, dtype)
        return DeviceColumn.from_numpy(values, valid, dtype, capacity,
                                       device)

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
                   device: Optional[torch.device] = None,
                   stager: Optional[DeviceStager] = None) -> "ColumnBatch":
        """A batch from Arrow: every fixed-width column crosses to the
        device in one copy (`_stage_columns`; on the card through
        `stager`, the prefetcher's lane, else the calling thread's).
        This is the JAX package's `from_arrow` and `place_device` in one
        pass: the port never holds a column as numpy, so there is no
        second pass over staged columns to make."""
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
        if cap < n:
            raise ValueError(f"capacity {cap} < {n} rows")
        specs, fixed = [], []
        for i, (arr, f) in enumerate(zip(arrays, schema)):
            if f.data_type.is_fixed_width:
                specs.append((*DeviceColumn.host_arrow(arr, f.data_type),
                              cap))
                fixed.append(i)
        placed = dict(zip(fixed, _stage_columns(specs, device, stager)))
        cols: List[Column] = [
            DeviceColumn(f.data_type, *placed[i]) if i in placed
            else HostColumn(f.data_type, arr)
            for i, (arr, f) in enumerate(zip(arrays, schema))]
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
        """Host Arrow batch of the surviving rows: the row mask and every
        device column's values and validity come back in one fetch."""
        fetch = [self.row_mask()] if self.selection is not None else []
        dev_idx = [i for i, c in enumerate(self.columns)
                   if isinstance(c, DeviceColumn)]
        for i in dev_idx:
            fetch.append(self.columns[i].data)
            fetch.append(self.columns[i].validity)
        fetched = _fetch_host(fetch)
        sel = fetched.pop(0) if self.selection is not None else None
        pre = {i: (fetched[2 * j], fetched[2 * j + 1])
               for j, i in enumerate(dev_idx)}
        arrays = [c.to_arrow(self.num_rows, sel, prefetched=pre[i])
                  if i in pre else c.to_arrow(self.num_rows, sel)
                  for i, c in enumerate(self.columns)]
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
