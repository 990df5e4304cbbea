"""The port's Kafka scan, record deserializers and table sinks
(blaze_tpu_torch/ops/kafka.py, ops/sink.py, the planner's kafka_scan,
parquet_sink and orc_sink nodes and their wire) against the JAX package's
on the CPU: the same records decode to equal Arrow tables (invalid and
missing fields null, the event-time column appended), the three node
kinds encode to the JAX package's protobuf bytes and decode to its dicts,
and the sinks write the JAX package's rows."""

import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pyarrow.parquet as pq
import pytest

from blaze_tpu.bridge.resource import put_resource as j_put
from blaze_tpu.bridge.resource import remove_resource as j_remove
from blaze_tpu.memory import MemManager as JMemManager
from blaze_tpu.ops import kafka as JK
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import create_plan as j_create
from blaze_tpu.plan.types import schema_from_dict as j_schema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge.resource import put_resource as t_put
from blaze_tpu_torch.bridge.resource import remove_resource as t_remove
from blaze_tpu_torch.memory import MemManager
from blaze_tpu_torch.ops import kafka as TK
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.planner import create_plan as t_create
from blaze_tpu_torch.plan.proto import auron_pb2 as pb
from blaze_tpu_torch.plan.types import schema_from_dict as t_schema

SCHEMA = {"fields": [
    {"name": "i", "type": {"id": "int64"}, "nullable": True},
    {"name": "s", "type": {"id": "utf8"}, "nullable": True},
    {"name": "f", "type": {"id": "float64"}, "nullable": True},
    {"name": "b", "type": {"id": "bool"}, "nullable": True},
    {"name": "n", "type": {"id": "int32"}, "nullable": True},
    {"name": "t", "type": {"id": "timestamp_us"}, "nullable": True}]}

#: valid, invalid and partial records: a missing field, a string number,
#: a number for a string, a nested object, a bool, a float for an int, an
#: unparsable field, a JSON array, broken JSON, bad UTF-8, and None
RECORDS = [
    b'{"i": 1, "s": "a", "f": 1.5, "b": true, "n": 7, "t": 1436918400000000}',
    b'{"i": "12", "s": 5, "f": "2.25", "b": 0, "t": 17}',
    b'{"s": {"x": [1, 2]}, "f": 3, "n": 3.7}',
    b'{"i": "x", "f": "nan?", "b": "yes", "n": null, "t": "late"}',
    b'[1, 2, 3]',
    b'{"i": 4, ',
    b'\xff\xfe{"i": 5}',
    None,
    b'{"i": -9223372036854775808, "s": "\\u00e9\\u4e2d", "f": -0.0}',
]


@pytest.fixture(autouse=True)
def confs():
    MemManager.init(4 << 30)
    JMemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    tconf.conf.unset(tconf.BATCH_SIZE.key)


def _recs(values, ts0=1000):
    return [dict(value=v, offset=i, partition=0, timestamp_ms=ts0 + 10 * i)
            for i, v in enumerate(values)]


def _collect(plan, partition=0):
    return [b.compact().to_arrow() for b in plan.execute(partition)]


def _table(batches):
    return pa.Table.from_batches(batches)


def test_json_deserializer_equals_the_jax_one():
    got = TK.JsonDeserializer(t_schema(SCHEMA)).deserialize(RECORDS)
    want = JK.JsonDeserializer(j_schema(SCHEMA)).deserialize(RECORDS)
    assert got.equals(want)
    assert got.column("i").to_pylist()[:4] == [1, 12, None, None]
    assert got.column("s").to_pylist()[:3] == ["a", "5",
                                               '{"x": [1, 2]}']
    assert got.column("n").to_pylist()[2] == 3
    assert got.num_rows == len(RECORDS)


def test_protobuf_deserializer_equals_the_jax_one():
    """Messages of one protobuf class through a host-supplied factory:
    fields by name, a field the message lacks null, an unparsable record
    a row of nulls."""
    schema = {"fields": [
        {"name": "kafka_topic", "type": {"id": "utf8"}, "nullable": True},
        {"name": "batch_size", "type": {"id": "int64"}, "nullable": True},
        {"name": "missing", "type": {"id": "int32"}, "nullable": True}]}
    msgs = []
    for i in range(5):
        m = pb.KafkaScanExecNode()
        m.kafka_topic = f"topic-{i}"
        m.batch_size = 10 * i
        msgs.append(m.SerializeToString())
    msgs += [b"\x0a\xff", None, b""]
    got = TK.PbDeserializer(t_schema(schema),
                            pb.KafkaScanExecNode).deserialize(msgs)
    want = JK.PbDeserializer(j_schema(schema),
                             pb.KafkaScanExecNode).deserialize(msgs)
    assert got.equals(want)
    assert got.column("batch_size").to_pylist()[:5] == [0, 10, 20, 30, 40]
    assert got.column("missing").null_count == len(msgs)


@pytest.mark.parametrize("batch", [3, 4, 100])
def test_mock_scan_with_event_time_equals_the_jax_one(batch):
    tconf.conf.set(tconf.BATCH_SIZE.key, batch)
    from blaze_tpu import config as jconf
    recs = _recs(RECORDS)
    t = TK.MockKafkaScanExec(t_schema(SCHEMA),
                             TK.JsonDeserializer(t_schema(SCHEMA)),
                             [[TK.KafkaRecord(**r) for r in recs]],
                             event_time_field="et")
    j = JK.MockKafkaScanExec(j_schema(SCHEMA),
                             JK.JsonDeserializer(j_schema(SCHEMA)),
                             [[JK.KafkaRecord(**r) for r in recs]],
                             event_time_field="et")
    with jconf.scoped(**{jconf.BATCH_SIZE.key: batch}):
        want = _collect(j)
    got = _collect(t)
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    assert _table(got).equals(_table(want))
    assert _table(got).column("et").to_pylist() == [
        r["timestamp_ms"] for r in recs]
    assert t.metrics.values["io_bytes"] > 0


def test_event_time_field_collision_raises_in_both():
    for mod, sch in ((TK, t_schema), (JK, j_schema)):
        with pytest.raises(ValueError, match="collides"):
            mod.schema_with_event_time(sch(SCHEMA), "i")
        assert mod.schema_with_event_time(sch(SCHEMA), None).names == \
            sch(SCHEMA).names


def _kafka_node(**kw):
    d = {"kind": "kafka_scan", "topic": "orders", "format": "json",
         "schema": SCHEMA, "num_partitions": 2}
    d.update(kw)
    return d


def test_planner_mock_data_scan_equals_the_jax_one():
    rows = [{"i": k, "s": f"r{k}", "f": k / 4, "b": k % 2 == 0}
            for k in range(7)] + [{"i": None}]
    node = _kafka_node(mock_data_json_array=json.dumps(rows),
                       event_time_field="et")
    got, want = _collect(t_create(node)), _collect(j_create(node))
    assert _table(got).equals(_table(want))
    assert _table(got).num_rows == len(rows)


def test_planner_poll_scan_equals_the_jax_one():
    """The poll resource: a callback per partition, None at the end, an
    empty poll skipped."""
    parts = {0: [_recs(RECORDS[:4]), [], _recs(RECORDS[4:], 5000)],
             1: [_recs(RECORDS[::-1])]}

    def poller(mod):
        left = {p: list(v) for p, v in parts.items()}

        def poll(partition, max_records):
            if not left[partition]:
                return None
            return [mod.KafkaRecord(**r) for r in left[partition].pop(0)]
        return poll

    node = _kafka_node(operator_id="poll-op", event_time_field="et")
    t_put("kafka://poll-op", poller(TK))
    j_put("kafka://poll-op", poller(JK))
    try:
        tplan, jplan = t_create(node), j_create(node)
        for p in (0, 1):
            got, want = _collect(tplan, p), _collect(jplan, p)
            assert [b.num_rows for b in got] == [b.num_rows for b in want]
            assert _table(got).equals(_table(want))
    finally:
        t_remove("kafka://poll-op")
        j_remove("kafka://poll-op")
    with pytest.raises(KeyError, match="kafka poll resource"):
        _collect(t_create(node))


def test_planner_protobuf_format_equals_the_jax_one():
    """The planner hands the format config dict to the protobuf
    deserializer as its factory, as the JAX planner does: every record
    decodes to a row of nulls in both (ROADMAP Queue 3)."""
    node = _kafka_node(format="protobuf", format_config_json='{"m": 1}',
                       mock_data_json_array=json.dumps([{"i": 1}] * 3))
    got, want = _collect(t_create(node)), _collect(j_create(node))
    assert _table(got).equals(_table(want))
    assert _table(got).column("i").null_count == 3
    with pytest.raises(ValueError, match="unknown kafka format"):
        t_create(_kafka_node(format="avro"))


WIRE = {
    "kafka_scan": _kafka_node(operator_id="op-1", batch_size=64,
                              startup_mode="earliest",
                              format_config_json="{}",
                              properties_json='{"a": "b"}',
                              mock_data_json_array="[]"),
    "kafka_scan_protobuf": _kafka_node(format="protobuf",
                                       startup_mode="latest"),
    "parquet_sink": {"kind": "parquet_sink", "input": _kafka_node(),
                     "fs_resource_id": "fs://out", "num_dyn_parts": 1,
                     "props": {"compression": "zstd", "k": "v"}},
    "orc_sink": {"kind": "orc_sink", "input": _kafka_node(),
                 "path": "/tmp/out", "num_dyn_parts": 0, "props": {}},
}


@pytest.mark.parametrize("name", list(WIRE))
def test_wire_bytes_and_dicts_equal_the_jax_ones(name):
    td = {"stage_id": 3, "partition_id": 1, "num_partitions": 2,
          "plan": WIRE[name]}
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    got = TP.task_definition_from_bytes(data)
    assert got == JP.task_definition_from_bytes(data)
    assert TP.task_definition_to_bytes(got) == data


def _sink_input(tmp_path):
    rng = np.random.default_rng(3)
    n = 50
    t = pa.table({"k": pa.array(rng.integers(0, 3, n)),
                  "v": pa.array(rng.normal(size=n)),
                  "s": pa.array([f"x{i % 4}" for i in range(n)])})
    t_put("sink-src", t)
    j_put("sink-src", t)
    return {"kind": "memory_scan", "resource_id": "sink-src",
            "num_partitions": 2,
            "schema": {"fields": [
                {"name": "k", "type": {"id": "int64"}, "nullable": True},
                {"name": "v", "type": {"id": "float64"}, "nullable": True},
                {"name": "s", "type": {"id": "utf8"}, "nullable": True}]}}


def _run_all(plan):
    for p in range(plan.num_partitions):
        assert list(plan.execute(p)) == []


@pytest.mark.parametrize("kind,partition_cols", [
    ("parquet_sink", None), ("parquet_sink", ["k"]), ("orc_sink", None)])
def test_sinks_write_the_jax_rows(tmp_path, kind, partition_cols):
    src = _sink_input(tmp_path)
    outs = {}
    for name, create in (("torch", t_create), ("jax", j_create)):
        t_put("fs://sink", str(tmp_path / name))
        j_put("fs://sink", str(tmp_path / name))
        node = {"kind": kind, "input": src, "fs_resource_id": "fs://sink"}
        if partition_cols:
            node["partition_cols"] = partition_cols
        plan = create(node)
        _run_all(plan)
        outs[name] = plan
    files = {name: sorted(os.path.relpath(os.path.join(d, f), tmp_path / name)
                          for d, _, fs in os.walk(tmp_path / name)
                          for f in fs)
             for name in outs}
    assert files["torch"] == files["jax"] and files["torch"]
    read = orc.read_table if kind == "orc_sink" else pq.read_table
    for f in files["torch"]:
        assert read(str(tmp_path / "torch" / f)).equals(
            read(str(tmp_path / "jax" / f)))
    assert outs["torch"].metrics.values["output_rows"] == \
        outs["jax"].metrics.values["output_rows"] == 50
    assert outs["torch"].schema.names == ["k", "v", "s"]


def test_write_parquet_atomic_leaves_no_temporary(tmp_path):
    from blaze_tpu_torch.ops.sink import write_parquet_atomic
    t = pa.table({"a": [1, 2, 3]})
    path = str(tmp_path / "d" / "x.parquet")
    n = write_parquet_atomic(t, path)
    assert n == os.path.getsize(path) and pq.read_table(path).equals(t)
    assert os.listdir(tmp_path / "d") == ["x.parquet"]
