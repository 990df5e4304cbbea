"""Generate: explode, posexplode and json_tuple (port of Generator,
ExplodeGenerator, JsonTupleGenerator and GenerateExec,
blaze_tpu/ops/generate.py).

Fan-out sizes depend on the data, so the rows multiply on the host with a
numpy repeat over the Arrow list offsets, as in the JAX package (no
Pallas kernel is behind it there); the generated batch re-enters the
pipeline as an ordinary batch, its fixed-width columns uploaded once.
`json_tuple` parses each row's JSON on the host.  The UDTF wrapper
belongs to item 16: the planner raises for it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.base import (BatchIterator, CoalesceStream,
                                      ExecutionPlan)
from blaze_tpu_torch.schema import INT32, UTF8, Field, Schema, TypeId


class Generator:
    """Produces (repeat_counts, generated_columns) for one input batch."""

    def out_fields(self, in_schema: Schema) -> List[Field]:
        raise NotImplementedError

    def generate(self, batch: ColumnBatch) -> tuple:
        raise NotImplementedError


@dataclass
class ExplodeGenerator(Generator):
    """explode / posexplode over a list or map column; `outer` keeps a
    null or empty row as one row of nulls (explode_outer)."""

    child: PhysicalExpr
    position: bool = False
    outer: bool = False

    def out_fields(self, in_schema: Schema) -> List[Field]:
        t = self.child.data_type(in_schema)
        fields = []
        if self.position:
            fields.append(Field("pos", INT32, False))
        if t.id == TypeId.LIST:
            fields.append(Field("col", t.children[0].data_type))
        elif t.id == TypeId.MAP:
            fields.append(Field("key", t.children[0].data_type))
            fields.append(Field("value", t.children[1].data_type))
        else:
            raise TypeError(f"explode over non-list/map {t}")
        return fields

    def generate(self, batch: ColumnBatch):
        n = batch.num_rows
        arr = self.child.evaluate(batch).to_host(n)
        is_map = pa.types.is_map(arr.type)
        lengths = np.asarray(list_lengths(arr))
        if self.outer:
            counts = np.where(lengths <= 0, 1, lengths)
            empty = lengths <= 0
        else:
            counts = np.where(lengths < 0, 0, lengths)
            empty = np.zeros(n, dtype=bool)
        if is_map:
            flat = arr.values  # the entries: a struct array (key, value)
            keys, vals = flat.field(0), flat.field(1)
        else:
            flat = arr.flatten()  # the values of every list, end to end
        total = int(counts.sum())
        # each output row's position within its input row
        pos = np.arange(total, dtype=np.int64) - \
            np.repeat(np.cumsum(counts) - counts, counts)
        # its index into the flattened values; an outer row of an empty or
        # null list is null
        starts = np.zeros(n, dtype=np.int64)
        starts[1:] = np.cumsum(np.where(lengths < 0, 0, lengths))[:-1]
        src = np.repeat(starts, counts) + pos
        null_out = np.repeat(empty, counts)
        src_safe = np.clip(src, 0, max(len(flat) - 1, 0))
        cols: List[pa.Array] = []
        if self.position:
            p = np.where(null_out, 0, pos).astype(np.int32)
            cols.append(pa.array(p, mask=null_out, type=pa.int32()))
        idx = pa.array(src_safe, type=pa.int64())
        for part in ((keys, vals) if is_map else (flat,)):
            taken = (part.take(idx) if len(part) else
                     pa.nulls(total, part.type))
            cols.append(_mask_nulls(taken, null_out))
        return counts, cols


@dataclass
class JsonTupleGenerator(Generator):
    """json_tuple(json, f1, f2, ...): one output row per input row, a
    utf8 column per field (NULL where the row is not a JSON object or
    lacks the field; a nested value as its JSON text)."""

    child: PhysicalExpr
    fields: Sequence[str] = ()

    def out_fields(self, in_schema: Schema) -> List[Field]:
        return [Field(f"c{i}", UTF8) for i in range(len(self.fields))]

    def generate(self, batch: ColumnBatch):
        n = batch.num_rows
        outs: List[List[Optional[str]]] = [[] for _ in self.fields]
        for x in self.child.evaluate(batch).to_host(n).to_pylist():
            doc = None
            if x is not None:
                try:
                    doc = json.loads(x)
                except (ValueError, TypeError):
                    doc = None
            for i, f in enumerate(self.fields):
                v = None
                if isinstance(doc, dict) and f in doc:
                    raw = doc[f]
                    v = (json.dumps(raw) if isinstance(raw, (dict, list))
                         else None if raw is None else str(raw))
                outs[i].append(v)
        return (np.ones(n, dtype=np.int64),
                [pa.array(o, type=pa.utf8()) for o in outs])


def list_lengths(arr: pa.Array) -> pa.Array:
    """Each row's list (or map) length, -1 for a null row."""
    if pa.types.is_map(arr.type):
        # a map array has the list offset layout: read the offsets
        offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32)[
            arr.offset:arr.offset + len(arr) + 1]
        lengths = np.diff(offsets).astype(np.int64)
        valid = (np.ones(len(arr), dtype=bool) if arr.null_count == 0
                 else np.asarray(arr.is_valid()))
        return pa.array(np.where(valid, lengths, -1))
    return pc.list_value_length(arr).fill_null(-1)


def _mask_nulls(arr: pa.Array, mask: np.ndarray) -> pa.Array:
    if not mask.any():
        return arr
    return pc.if_else(pa.array(~mask), arr, pa.nulls(len(arr), arr.type))


class GenerateExec(ExecutionPlan):
    """Each input row repeated once per generated row, its `required_cols`
    kept beside the generator's columns."""

    def __init__(self, child: ExecutionPlan, generator: Generator,
                 required_cols: Optional[Sequence[int]] = None):
        super().__init__([child])
        self.generator = generator
        self._required = (list(required_cols) if required_cols is not None
                          else list(range(len(child.schema))))
        in_schema = child.schema
        kept = [in_schema[i] for i in self._required]
        self._out_schema = Schema(kept + generator.out_fields(in_schema))

    @property
    def schema(self) -> Schema:
        return self._out_schema

    def execute(self, partition: int) -> BatchIterator:
        """Counter: `output_rows`, the generated rows."""
        def gen():
            out_schema = self.schema.to_arrow()
            for batch in self.children[0].execute(partition):
                batch = batch.compact()
                if batch.num_rows == 0:
                    continue
                counts, gen_cols = self.generator.generate(batch)
                rb = batch.to_arrow()
                idx = pa.array(np.repeat(np.arange(batch.num_rows), counts),
                               type=pa.int64())
                arrays = [rb.column(i).take(idx) for i in self._required]
                arrays += list(gen_cols)
                arrays = [a if a.type.equals(f.type)
                          else a.cast(f.type, safe=False)
                          for a, f in zip(arrays, out_schema)]
                self.metrics.add("output_rows", len(idx))
                yield ColumnBatch.from_arrow(
                    pa.RecordBatch.from_arrays(arrays, schema=out_schema))
        return iter(CoalesceStream(gen(), metrics=self.metrics))
