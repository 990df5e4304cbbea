"""Spark-specific expressions (port of blaze_tpu/exprs/special.py):
row numbers and ids, random numbers, nested-field access, named_struct
and the scalar-subquery wrapper.

  * `RowNum`, `SparkPartitionId` and `MonotonicallyIncreasingId`
    (partition_id << 33 | row) run on the batch's device, the partition
    from the current task;
  * `Rand` draws from a `torch.Generator` seeded with seed +
    partition_id, one stream per task that runs on across its batches:
    deterministic for a task, uniform in [0, 1) (or standard normal for
    randn).  Neither this stream nor the JAX package's (jax.random's
    threefry, one key per task) is Spark's XORShiftRandom, so their
    values differ from each other and from Spark's (ROADMAP, "Decisions
    kept");
  * `GetIndexedField` (a list element by 0-based ordinal, or a struct
    field by index), `GetMapValue` (a literal key; the last duplicate
    wins) and `NamedStruct` work on the host over Arrow's nested arrays
    (host columns of the batch); a fixed-width result is uploaded;
  * `ScalarSubqueryWrapper` reads its value from the resource map.

  * `BloomFilterMightContain` probes the Spark bloom filter registered
    in the resource map under its uuid (kernels/bloom.py, built by the
    `bloom_filter` aggregate) on the batch's device; with no filter
    there, every row might match.

The UDF wrapper waits for the host bridge (ROADMAP Queue 1 item 16): the
decoder raises for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.exprs.base import ColVal, Literal, PhysicalExpr
from blaze_tpu_torch.schema import (BOOL, DataType, Field, FLOAT64, INT32,
                                    INT64, TypeId)


def _rows(batch: ColumnBatch) -> torch.Tensor:
    return torch.arange(batch.capacity, dtype=torch.int64,
                        device=batch.device)


def _uploaded(cv: ColVal, batch: ColumnBatch) -> ColVal:
    if cv.dtype.is_fixed_width:
        return cv.to_device(batch.capacity, batch.device)
    return cv


@dataclass(frozen=True, repr=False)
class RowNum(PhysicalExpr):
    """The row's number within the batch (the JAX package adds a running
    offset that nothing sets)."""

    def data_type(self, schema):
        return INT64

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        return ColVal.device(INT64, _rows(batch))


@dataclass(frozen=True, repr=False)
class SparkPartitionId(PhysicalExpr):
    def data_type(self, schema):
        return INT32

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        return ColVal.device(INT32, torch.full(
            (batch.capacity,), current_task().partition_id,
            dtype=torch.int32, device=batch.device))


@dataclass(frozen=True, repr=False)
class MonotonicallyIncreasingId(PhysicalExpr):
    """partition_id << 33 | row (Spark's contract)."""

    def data_type(self, schema):
        return INT64

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        pid = int(current_task().partition_id)
        return ColVal.device(INT64, _rows(batch) | (pid << 33))


@dataclass(frozen=True, repr=False)
class Rand(PhysicalExpr):
    """rand(seed) / randn(seed): one generator per task, seeded with
    seed + partition_id, advancing across the task's batches."""

    seed: int
    normal: bool = False

    def data_type(self, schema):
        return FLOAT64

    def _generator(self, device: torch.device) -> torch.Generator:
        task = current_task()
        streams = task.__dict__.setdefault("rand_streams", {})
        key = (id(self), str(device))
        gen = streams.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(self.seed) + int(task.partition_id))
            streams[key] = gen
        return gen

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        gen = self._generator(batch.device)
        draw = torch.randn if self.normal else torch.rand
        data = draw(batch.capacity, generator=gen, dtype=torch.float64,
                    device=batch.device)
        return ColVal.device(FLOAT64, data)

    def cache_key(self):
        return ("rand", id(self))  # a stream: never shared


@dataclass(frozen=True, repr=False)
class GetIndexedField(PhysicalExpr):
    """list[ordinal] (0-based) or struct.field by index."""

    child: PhysicalExpr
    index: int
    out_type: DataType

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.out_type

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        arr = self.child.evaluate(batch).to_host(batch.num_rows)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks()
        if pa.types.is_struct(arr.type):
            out = arr.field(self.index)
            if arr.null_count:
                # a null struct's field is null (Spark's GetStructField);
                # .field() alone keeps the child's stale values
                out = pc.if_else(arr.is_valid(), out,
                                 pa.nulls(len(arr), out.type))
        else:
            # Spark GetArrayItem: out of bounds is NULL, or raises under
            # ANSI for a selected row
            off = np.asarray(arr.offsets)
            idx = off[:-1] + self.index
            present = (arr.is_valid().to_numpy(zero_copy_only=False)
                       if arr.null_count else np.ones(len(arr), bool))
            in_bounds = (self.index >= 0) & (idx < off[1:])
            if config.ANSI_ENABLED.get():
                from blaze_tpu_torch.funcs.common import selected_mask
                sel = selected_mask(batch, len(arr))
                if bool((present & ~in_bounds & sel).any()):
                    raise ValueError(
                        f"[INVALID_ARRAY_INDEX] index {self.index} out "
                        f"of bounds (ANSI mode)")
            valid = present & in_bounds
            take = pa.array(np.where(valid, idx, 0), pa.int64(),
                            mask=~valid)
            out = arr.values.take(take)
        return _uploaded(ColVal.host(self.out_type, out), batch)


@dataclass(frozen=True, repr=False)
class GetMapValue(PhysicalExpr):
    """map[key] with a literal key; the last duplicate key wins."""

    child: PhysicalExpr
    key: object
    out_type: DataType

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return self.out_type

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        arr = self.child.evaluate(batch).to_host(batch.num_rows)
        py = []
        for row in arr.to_pylist():
            val = None
            for k, v in row or []:
                if k == self.key:
                    val = v
            py.append(val)
        out = pa.array(py, type=self.out_type.to_arrow())
        return _uploaded(ColVal.host(self.out_type, out), batch)


@dataclass(frozen=True, repr=False)
class NamedStruct(PhysicalExpr):
    """named_struct(name1, v1, ...)."""

    names: Tuple[str, ...]
    args: Tuple[PhysicalExpr, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        return DataType(TypeId.STRUCT, children=tuple(
            Field(n, a.data_type(schema))
            for n, a in zip(self.names, self.args)))

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        n = batch.num_rows
        arrays = [a.evaluate(batch).to_host(n) for a in self.args]
        out = pa.StructArray.from_arrays(arrays, names=list(self.names))
        return ColVal.host(self.data_type(batch.schema), out)


@dataclass(frozen=True, repr=False)
class ScalarSubqueryWrapper(PhysicalExpr):
    """A scalar subquery's value, computed elsewhere and put into the
    resource map under `uuid`, as a literal."""

    uuid: str
    out_type: DataType

    def data_type(self, schema):
        return self.out_type

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        from blaze_tpu_torch.bridge.resource import get_resource
        return Literal(get_resource(self.uuid),
                       self.out_type).evaluate(batch)


@dataclass(frozen=True, repr=False)
class BloomFilterMightContain(PhysicalExpr):
    """might_contain(filter, value): TRUE where the row's int64 value may
    be in the filter, FALSE where it surely is not, NULL for a NULL
    value.  The filter (a `SparkBloomFilter`) comes from the resource map
    under `uuid`; none there means the build side was empty, and every
    row passes (the JAX package's rule)."""

    uuid: str
    value: PhysicalExpr

    def children(self):
        return (self.value,)

    def data_type(self, schema):
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        from blaze_tpu_torch.bridge.resource import get_resource
        filt = get_resource(self.uuid)
        if filt is None:
            return ColVal.device(BOOL, torch.ones(
                batch.capacity, dtype=torch.bool, device=batch.device))
        v = self.value.evaluate(batch).to_device(batch.capacity,
                                                 batch.device)
        hit = filt.might_contain_longs(v.data.to(torch.int64))
        return ColVal(BOOL, hit & v.validity, v.validity)
