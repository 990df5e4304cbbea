"""Partitioning schemes (port of blaze_tpu/shuffle/partitioning.py: hash,
round-robin, single and range, and `sample_range_bounds`).

The partition id is Spark's `pmod(murmur3(keys, seed=42), n)`, bit-exact
with Spark's HashPartitioning, computed on the batch's device by the
port's hashing (kernels/hashing.py); a utf8 key's bytes cross to the
device as a padded byte matrix.  A decimal key of precision <= 18 hashes
as its unscaled long on the device; a wider one (a host column) as the
minimal big-endian bytes of its unscaled value, as Spark does.

Round-robin ids are an `arange` plus a running cursor, mod n, on the
batch's device; the cursor lives on the instance and runs on across
batches, and across the map tasks that share one instance (the local
mode's `LocalShuffleExchange`).  A task that decodes its own plan starts
at 0, as in the JAX package (Spark seeds the start from the partition
id; the port keeps the reference's start).

A range id is the count of bounds strictly below the row in the sort
order (ties stay in the bound's own partition, as Spark's
RangePartitioner), counted key by key as the JAX package counts it.
Where every key is fixed-width and not a decimal, and each bound column
is of the key's kind, the rows' and the bounds' order operands
(kernels/compare.py) are compared on the batch's device; otherwise (a
utf8 or decimal key) the JAX package's host order keys decide
(ops/sort.py `host_sort_keys`, `compare_scalar`).  Both give the same
ids: the operands order nulls, NaN and -0.0 as the host keys do.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import compare
from blaze_tpu_torch.kernels import hashing as H
from blaze_tpu_torch.schema import DataType, TypeId


class Partitioning:
    num_partitions: int = 1

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        """int32 partition id per row, on the batch's device; the batch
        must be compact."""
        raise NotImplementedError


class SinglePartitioning(Partitioning):
    num_partitions = 1

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        return torch.zeros(batch.num_rows, dtype=torch.int32,
                           device=batch.device)


class HashPartitioning(Partitioning):
    def __init__(self, exprs: Sequence[PhysicalExpr], num_partitions: int):
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        n = batch.num_rows
        if self.num_partitions == 1:
            # pmod(h, 1) == 0 for every row: skip the hash chain
            return torch.zeros(n, dtype=torch.int32, device=batch.device)
        flat_cols, tids = [], []
        for e in self.exprs:
            v = e.evaluate(batch)
            if v.is_device:
                flat_cols.append((v.data[:n], v.validity[:n]))
            elif v.dtype.id == TypeId.DECIMAL:
                flat_cols.append(H.wide_decimal_key(v.to_host(n), n,
                                                    batch.device))
                tids.append("binary")
                continue
            else:
                # utf8: the byte matrix crosses to the batch's device
                (mat, lens), valid = H.padded_string_key(
                    v.to_host(n), n, batch.device)
                flat_cols.append(((mat, lens), valid))
            tids.append(v.dtype.id.value)
        return H.spark_partition_ids(flat_cols, tids, self.num_partitions)


class RoundRobinPartitioning(Partitioning):
    def __init__(self, num_partitions: int):
        self.num_partitions = num_partitions
        self._next = 0

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        n = batch.num_rows
        ids = (torch.arange(n, dtype=torch.int64, device=batch.device)
               + self._next) % self.num_partitions
        self._next = int((self._next + n) % self.num_partitions)
        return ids.to(torch.int32)


_INT_KINDS = (TypeId.INT8, TypeId.INT16, TypeId.INT32, TypeId.INT64,
              TypeId.DATE32, TypeId.TIMESTAMP_MICROS)


def _kind(tid: TypeId) -> Optional[str]:
    """The comparison kind of a key type on the device route (None: the
    host route)."""
    if tid in _INT_KINDS:
        return "int"
    if tid in (TypeId.FLOAT32, TypeId.FLOAT64):
        return "float"
    if tid == TypeId.BOOL:
        return "bool"
    return None


def _arrow_kind(t: pa.DataType) -> Optional[str]:
    if (pa.types.is_integer(t) or pa.types.is_date32(t)
            or pa.types.is_timestamp(t)):
        return "int"
    if pa.types.is_floating(t):
        return "float"
    if pa.types.is_boolean(t):
        return "bool"
    return None


def _operands(data: torch.Tensor, validity: Optional[torch.Tensor],
              kind: str, descending: bool, nulls_first: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket, key) of one key column in one dtype per kind (int64,
    float64, bool), so rows and bounds of different widths compare."""
    if kind == "float":
        data, dtype = data.to(torch.float64), DataType(TypeId.FLOAT64)
    elif kind == "int":
        data, dtype = data.to(torch.int64), DataType(TypeId.INT64)
    else:
        dtype = DataType(TypeId.BOOL)
    return compare.order_key(data, validity, dtype, descending, nulls_first)


class RangePartitioning(Partitioning):
    """Bounds rows (num_partitions - 1 of them, sorted, one column per
    sort key) decide each row's partition id."""

    def __init__(self, sort_exprs: Sequence[Tuple[PhysicalExpr, bool, bool]],
                 num_partitions: int, bounds: pa.RecordBatch):
        from blaze_tpu_torch.ops.sort import host_sort_keys
        self.sort_exprs = list(sort_exprs)
        self.num_partitions = num_partitions
        self.bounds = bounds
        self._desc = [d for _, d, _ in self.sort_exprs]
        self._nf = [f for _, _, f in self.sort_exprs]
        self._bound_keys = host_sort_keys(
            bounds, list(range(bounds.num_columns)), self._desc, self._nf)
        self._bound_kinds = [_arrow_kind(bounds.column(j).type)
                             for j in range(bounds.num_columns)]
        # device -> the bounds' operands, flattened (bucket, key) per key
        self._device_bounds: Dict[torch.device, List[torch.Tensor]] = {}

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        n = batch.num_rows
        vals = [e.evaluate(batch) for e, _, _ in self.sort_exprs]
        kinds = [_kind(v.dtype.id) if v.is_device else None for v in vals]
        if all(k is not None and k == bk
               for k, bk in zip(kinds, self._bound_kinds)):
            return self._device_ids(vals, kinds, n, batch.device)
        return torch.from_numpy(self._host_ids(vals, n)).to(batch.device)

    def _device_ids(self, vals, kinds, n: int,
                    device: torch.device) -> torch.Tensor:
        rows: List[torch.Tensor] = []
        for v, kind, desc, nf in zip(vals, kinds, self._desc, self._nf):
            rows.extend(_operands(v.data[:n], v.validity[:n], kind, desc,
                                  nf))
        bounds = self._bounds_on(device, kinds)
        nb = self.bounds.num_rows
        # (row, bound): the row sorts strictly after the bound, decided
        # from the last operand to the first as the host loop does
        gt = torch.zeros((n, nb), dtype=torch.bool, device=device)
        for rk, bk in zip(reversed(rows), reversed(bounds)):
            r, b = rk.unsqueeze(1), bk.unsqueeze(0)
            gt = (r > b) | ((r == b) & gt)
        return gt.sum(dim=1, dtype=torch.int32)

    def _bounds_on(self, device: torch.device,
                   kinds: List[str]) -> List[torch.Tensor]:
        ops = self._device_bounds.get(device)
        if ops is None:
            ops = []
            for j, (kind, desc, nf) in enumerate(zip(kinds, self._desc,
                                                     self._nf)):
                col = self.bounds.column(j)
                if pa.types.is_date32(col.type):
                    col = col.cast(pa.int32())
                elif pa.types.is_timestamp(col.type):
                    col = col.cast(pa.int64())
                np_dtype = {"int": np.int64, "float": np.float64,
                            "bool": np.bool_}[kind]
                data = np.asarray(col.fill_null(False if kind == "bool"
                                                else 0)).astype(np_dtype)
                valid = np.asarray(col.is_valid())
                ops.extend(_operands(torch.from_numpy(data).to(device),
                                     torch.from_numpy(valid).to(device),
                                     kind, desc, nf))
            self._device_bounds[device] = ops
        return ops

    def _host_ids(self, vals, n: int) -> np.ndarray:
        from blaze_tpu_torch.ops.sort import compare_scalar, host_sort_keys
        arrays = [v.to_host(n) for v in vals]
        rb = pa.RecordBatch.from_arrays(
            arrays, names=[f"k{i}" for i in range(len(arrays))])
        row_keys = host_sort_keys(rb, list(range(len(arrays))), self._desc,
                                  self._nf)
        ids = np.zeros(n, dtype=np.int32)
        for b in range(self.bounds.num_rows):
            gt = np.zeros(n, dtype=bool)
            for j in range(len(row_keys) - 1, -1, -1):
                rk = row_keys[j]
                bk = compare_scalar(rk, self._bound_keys[j][b])
                gt = (rk > bk) | ((rk == bk) & gt)
            ids += gt.astype(np.int32)
        return ids


def sample_range_bounds(sample: pa.Table,
                        sort_exprs: Sequence[Tuple[PhysicalExpr, bool, bool]],
                        num_partitions: int,
                        key_names: Sequence[str]) -> pa.RecordBatch:
    """Bounds sampled before the map tasks run (Spark's
    rangePartitioningBound): sort the sample with the port's SortExec and
    take num_partitions - 1 evenly spaced rows of the key columns."""
    from blaze_tpu_torch.ops.scan import MemoryScanExec
    from blaze_tpu_torch.ops.sort import SortExec
    plan = SortExec(MemoryScanExec.from_arrow(sample), sort_exprs)
    sorted_rb = plan.execute_collect().to_arrow()
    n = sorted_rb.num_rows
    cuts = [min(int(n * (i + 1) / num_partitions), n - 1)
            for i in range(num_partitions - 1)]
    idx = pa.array(cuts, type=pa.int64())
    cols = [sorted_rb.column(sorted_rb.schema.get_field_index(k)).take(idx)
            for k in key_names]
    return pa.RecordBatch.from_arrays(cols, names=list(key_names))
