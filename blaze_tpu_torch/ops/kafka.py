"""The Kafka scan of the Flink front end, its broker-less mock and the
record deserializers (port of blaze_tpu/ops/kafka.py).

Parity: datafusion-ext-plans/src/flink/kafka_scan_exec.rs:81 (native Kafka
consumer), kafka_mock_scan_exec.rs (the broker-less test variant) and
flink/serde/{json,pb}_deserializer.rs (record bytes -> columns).

No Kafka client ships with the engine, so the real consumer is a
host-registered poll callback in the resource map (the inversion the
reference uses for its JVM-backed sources); `MockKafkaScanExec` serves
framed records from memory.  Decoding is the JAX package's per-record
Python loop, on the host; each decoded Arrow batch then crosses to the
device as a parquet batch does, every fixed-width column in ONE copy
(`ColumnBatch.from_arrow`, batch.py `_stage_columns`), the string columns
staying host columns.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import pyarrow as pa

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.ops.base import BatchIterator, ExecutionPlan
from blaze_tpu_torch.schema import INT64, DataType, Field, Schema, TypeId


class RecordDeserializer:
    """bytes records -> Arrow arrays of the scan schema."""

    def __init__(self, schema: Schema):
        self.schema = schema

    def deserialize(self, records: List[Optional[bytes]]) -> pa.RecordBatch:
        raise NotImplementedError


class JsonDeserializer(RecordDeserializer):
    """(ref flink/serde/json_deserializer.rs) One JSON object a record; a
    missing or invalid field is null (non-strict mode)."""

    def deserialize(self, records: List[Optional[bytes]]) -> pa.RecordBatch:
        fields = [(f.name, _coercer(f.data_type), []) for f in self.schema]
        for rec in records:
            doc = None
            if rec is not None:
                try:
                    doc = json.loads(rec)
                except (ValueError, UnicodeDecodeError):
                    doc = None
            if isinstance(doc, dict):
                for name, coerce, col in fields:
                    col.append(coerce(doc.get(name)))
            else:
                for _name, _coerce, col in fields:
                    col.append(None)
        arrays = [pa.array(col, type=f.data_type.to_arrow())
                  for (_n, _c, col), f in zip(fields, self.schema)]
        return pa.RecordBatch.from_arrays(arrays,
                                          schema=self.schema.to_arrow())


def _coercer(t: DataType):
    """The JAX package's `_coerce_json` for one column type, its type
    tests made once a column instead of once a value: None stays None, a
    value that does not convert is None."""
    if t.is_integer:
        conv = int
    elif t.is_floating:
        conv = float
    elif t.id == TypeId.BOOL:
        conv = bool
    elif t.id == TypeId.UTF8:
        def conv(v):
            return v if isinstance(v, str) else json.dumps(v)
    else:
        return lambda v: v

    def coerce(v):
        if v is None:
            return None
        try:
            return conv(v)
        except (ValueError, TypeError):
            return None
    return coerce


class PbDeserializer(RecordDeserializer):
    """(ref flink/serde/pb_deserializer.rs) Protobuf messages decoded
    through a host-supplied message factory; a record that fails to
    parse is a row of nulls."""

    def __init__(self, schema: Schema, message_factory: Callable):
        super().__init__(schema)
        self._factory = message_factory

    def deserialize(self, records: List[Optional[bytes]]) -> pa.RecordBatch:
        coercers = [_coercer(f.data_type) for f in self.schema]
        cols: List[List] = [[] for _ in self.schema]
        for rec in records:
            msg = None
            if rec is not None:
                try:
                    msg = self._factory()
                    msg.ParseFromString(rec)
                except Exception:
                    msg = None
            for i, f in enumerate(self.schema):
                v = getattr(msg, f.name, None) if msg is not None else None
                cols[i].append(coercers[i](v))
        arrays = [pa.array(c, type=f.data_type.to_arrow())
                  for c, f in zip(cols, self.schema)]
        return pa.RecordBatch.from_arrays(arrays,
                                          schema=self.schema.to_arrow())


@dataclass
class KafkaRecord:
    value: Optional[bytes]
    key: Optional[bytes] = None
    offset: int = 0
    partition: int = 0
    timestamp_ms: int = 0


def schema_with_event_time(schema: Schema,
                           event_time_field: Optional[str]) -> Schema:
    """The scan's output schema when record timestamps are surfaced: the
    deserialized columns plus one int64 event-time column (epoch ms, from
    KafkaRecord.timestamp_ms, Flink's StreamRecord timestamp)."""
    if not event_time_field:
        return schema
    if event_time_field in schema.names:
        raise ValueError(
            f"event-time field {event_time_field!r} collides with a "
            "deserialized column")
    return Schema(list(schema) + [Field(event_time_field, INT64, False)])


def _append_event_time(rb: pa.RecordBatch, recs: Sequence[KafkaRecord],
                       out_schema: Schema) -> pa.RecordBatch:
    ts = pa.array([int(r.timestamp_ms) for r in recs], type=pa.int64())
    return pa.RecordBatch.from_arrays(list(rb.columns) + [ts],
                                      schema=out_schema.to_arrow())


class MockKafkaScanExec(ExecutionPlan):
    """Broker-less source (ref kafka_mock_scan_exec.rs): serves records
    staged in memory, one Kafka partition a plan partition, in batches of
    `auron.batch.size` records."""

    def __init__(self, schema: Schema, deserializer: RecordDeserializer,
                 partitions: Sequence[Sequence[KafkaRecord]],
                 event_time_field: Optional[str] = None):
        super().__init__()
        self._event_time_field = event_time_field
        self._schema = schema_with_event_time(schema, event_time_field)
        self._deser = deserializer
        self._partitions = [list(p) for p in partitions]

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def execute(self, partition: int) -> BatchIterator:
        bs = config.BATCH_SIZE.get()
        recs = self._partitions[partition]
        for off in range(0, len(recs), bs):
            chunk = recs[off:off + bs]
            rb = self._deser.deserialize([r.value for r in chunk])
            if self._event_time_field:
                rb = _append_event_time(rb, chunk, self._schema)
            self.metrics.add("io_bytes", rb.nbytes)
            yield ColumnBatch.from_arrow(rb)


class KafkaScanExec(ExecutionPlan):
    """Streaming source driven by a host-registered poll callback
    `poll(partition, max_records) -> List[KafkaRecord] | None` under the
    resource id (None: the end; the unbounded case is paced by the
    streaming runtime's epochs)."""

    def __init__(self, schema: Schema, deserializer: RecordDeserializer,
                 poll_resource_id: str, num_partitions: int = 1,
                 event_time_field: Optional[str] = None):
        super().__init__()
        self._event_time_field = event_time_field
        self._schema = schema_with_event_time(schema, event_time_field)
        self._deser = deserializer
        self._poll_id = poll_resource_id
        self._n = num_partitions

    @property
    def schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._n

    def execute(self, partition: int) -> BatchIterator:
        from blaze_tpu_torch.bridge.resource import get_resource
        poll = get_resource(self._poll_id)
        if poll is None:
            raise KeyError(f"kafka poll resource {self._poll_id!r}")
        bs = config.BATCH_SIZE.get()
        while True:
            recs = poll(partition, bs)
            if recs is None:
                return
            if not recs:
                continue
            rb = self._deser.deserialize([r.value for r in recs])
            if self._event_time_field:
                rb = _append_event_time(rb, recs, self._schema)
            self.metrics.add("io_bytes", rb.nbytes)
            yield ColumnBatch.from_arrow(rb)
