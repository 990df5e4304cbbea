"""Generate and RenameColumns of the port (blaze_tpu_torch/ops/generate.py,
ops/basic.py RenameColumnsExec) against the JAX package's
(blaze_tpu/ops/generate.py, blaze_tpu/ops/basic.py) on the same
numpy-seeded batches, with `blaze_tpu.bridge.placement.host_resident`
patched to False (the JAX package's device route), and their wire nodes
against the JAX `proto_serde`.

  * explode and posexplode over a list<int64> column holding null lists,
    empty lists and lists with null elements, `outer` true and false,
    keeping every input column or only `required_cols` (which drop the
    list); over a map<utf8, int64> column; at batch sizes that make the
    coalescing stream pass batches through, stage them and concatenate
    them: the same output batches, rows in order;
  * RenameColumnsExec over a generator's output: the same batches under
    the new names;
  * the wire: a generate node (by index and by name, outer or not) under
    a rename_columns node over a scan with a LIST field encodes to the
    JAX package's bytes and decodes to its dicts, and the decoded dicts
    plan the same schema in both packages; json_tuple plans, the UDTF
    generator raises naming ROADMAP item 16, each node kind the port
    does not plan yet names its ROADMAP item, and the five kinds of the
    plan-kinds slice (ffi_reader, coalesce_batches, empty_partitions,
    debug, ipc_writer) plan and run as the JAX package's.

Tolerance: exact (Arrow equality of every output batch)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu import exprs as JE
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.ops.basic import RenameColumnsExec as JRename
from blaze_tpu.ops.generate import ExplodeGenerator as JExplode
from blaze_tpu.ops.generate import GenerateExec as JGenerate
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import create_plan as j_create
from blaze_tpu.plan.planner import decode_task_definition as j_decode
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import exprs as TE
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import RenameColumnsExec as TRename
from blaze_tpu_torch.ops.generate import ExplodeGenerator as TExplode
from blaze_tpu_torch.ops.generate import GenerateExec as TGenerate
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.planner import create_plan as t_create
from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode
from blaze_tpu_torch.plan.types import schema_to_dict
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
LIST_SCHEMA = pa.schema([("sk", pa.int64()), ("items", pa.list_(pa.int64())),
                         ("x", pa.float64())])
MAP_SCHEMA = pa.schema([("sk", pa.int64()),
                        ("m", pa.map_(pa.string(), pa.int64()))])


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.BATCH_SIZE.key)


def _list_batches(rng, n_batches, rows):
    """Lists of 0-4 values, some of them null; some rows null."""
    out = []
    for b in range(n_batches):
        n = rows + b
        lists = []
        for i in range(n):
            if rng.random() < 0.1:
                lists.append(None)
                continue
            vals = rng.integers(0, 1000, rng.integers(0, 5)).tolist()
            lists.append([None if rng.random() < 0.1 else v for v in vals])
        out.append(pa.record_batch({
            "sk": pa.array(np.arange(n, dtype=np.int64) + 1000 * b),
            "items": pa.array(lists, type=pa.list_(pa.int64())),
            "x": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.1)},
            schema=LIST_SCHEMA))
    return out


def _map_batches(rng, n_batches, rows):
    out = []
    for b in range(n_batches):
        n = rows + b
        maps = []
        for i in range(n):
            if rng.random() < 0.1:
                maps.append(None)
                continue
            k = int(rng.integers(0, 4))
            maps.append([(f"k{j}", int(rng.integers(0, 99)))
                         for j in range(k)])
        out.append(pa.record_batch({
            "sk": pa.array(np.arange(n, dtype=np.int64)),
            "m": pa.array(maps, type=MAP_SCHEMA.field("m").type)},
            schema=MAP_SCHEMA))
    return out


class _Source(ExecutionPlan):
    """Fixed Arrow batches as port batches on the CPU (one partition)."""

    def __init__(self, batches, schema):
        super().__init__()
        self._batches = list(batches)
        self._schema = TSchema.from_arrow(schema)

    @property
    def schema(self):
        return self._schema

    def execute(self, partition):
        for rb in self._batches:
            yield TBatch.from_arrow(rb, device=CPU)


def _run(pkg, batches, schema, position, outer, required, rename=None):
    col = schema.get_field_index("items" if "items" in schema.names
                                 else "m")
    if pkg == "jax":
        src = MemoryScanExec(JSchema.from_arrow(schema),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        op = JGenerate(src, JExplode(JE.BoundReference(col),
                                     position=position, outer=outer),
                       required)
        if rename:
            op = JRename(op, rename)
    else:
        op = TGenerate(_Source(batches, schema),
                       TExplode(TE.BoundReference(col), position=position,
                                outer=outer), required)
        if rename:
            op = TRename(op, rename)
    return op, [b.compact().to_arrow() for b in op.execute(0)]


def _same(got, want):
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    tg, tw = pa.Table.from_batches(got), pa.Table.from_batches(want)
    assert tg.schema == tw.schema
    assert tg.equals(tw)
    return tg


@pytest.mark.parametrize("required", [None, [0], [2, 0]])
@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("position", [False, True])
@pytest.mark.parametrize("n_batches,rows,batch_size", [
    (1, 50, 32768), (4, 300, 1024), (2, 1500, 2048)])
def test_explode_list_equals_jax(n_batches, rows, batch_size, position,
                                 outer, required):
    for c in (jconf, tconf):
        c.conf.set(c.BATCH_SIZE.key, batch_size)
    batches = _list_batches(np.random.default_rng(rows), n_batches, rows)
    t_op, got = _run("torch", batches, LIST_SCHEMA, position, outer,
                     required)
    _j, want = _run("jax", batches, LIST_SCHEMA, position, outer, required)
    tg = _same(got, want)
    lists = pa.Table.from_batches(batches).column("items").to_pylist()
    expected = sum(max(len(v or []), 1 if outer else 0) for v in lists)
    assert tg.num_rows == expected
    assert t_op.metrics.values["output_rows"] == expected
    if required == [0]:
        assert tg.schema.names == ["sk"] + (["pos"] if position else []) \
            + ["col"]


@pytest.mark.parametrize("outer", [False, True])
@pytest.mark.parametrize("position", [False, True])
def test_explode_map_equals_jax(position, outer):
    batches = _map_batches(np.random.default_rng(5), 3, 200)
    _t, got = _run("torch", batches, MAP_SCHEMA, position, outer, [0])
    _j, want = _run("jax", batches, MAP_SCHEMA, position, outer, [0])
    tg = _same(got, want)
    assert tg.schema.names[-2:] == ["key", "value"]


def test_rename_over_generate_equals_jax():
    names = ["wc_session_sk", "pos", "item_sk"]
    batches = _list_batches(np.random.default_rng(9), 3, 400)
    t_op, got = _run("torch", batches, LIST_SCHEMA, True, False, [0], names)
    _j, want = _run("jax", batches, LIST_SCHEMA, True, False, [0], names)
    tg = _same(got, want)
    assert tg.schema.names == names
    assert [f.name for f in t_op.schema] == names


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _scan(tmp_path):
    import pyarrow.parquet as pq
    path = str(tmp_path / "wc.parquet")
    pq.write_table(pa.Table.from_batches(
        _list_batches(np.random.default_rng(3), 1, 100)), path)
    return {"kind": "parquet_scan",
            "schema": schema_to_dict(TSchema.from_arrow(LIST_SCHEMA)),
            "file_groups": [[path]]}


def _generate_td(tmp_path, kind, outer, required):
    gen = {"kind": "generate", "input": _scan(tmp_path),
           "generator": {"kind": kind, "outer": outer,
                         "child": {"kind": "column", "name": "items"}}}
    if required is not None:
        gen["required_cols"] = required
    names = [n for n in ("sk", "items", "x")
             if required is None or ["sk", "items", "x"].index(n)
             in required]
    names += ["pos", "item"] if kind == "posexplode" else ["item"]
    return {"stage_id": 1, "partition_id": 0,
            "plan": {"kind": "rename_columns", "names": names,
                     "input": gen}}


@pytest.mark.parametrize("kind,outer,required", [
    ("posexplode", False, [0]), ("explode", True, None),
    ("explode", False, [2, 0])])
def test_wire_equals_jax(tmp_path, kind, outer, required):
    td = _generate_td(tmp_path, kind, outer, required)
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    decoded = t_decode(data)
    assert decoded == j_decode(data)
    assert TP.task_definition_to_bytes(decoded) == data
    fields = decoded["plan"]["input"]["input"]["schema"]["fields"]
    assert fields[1]["type"] == {"id": "list", "children": [
        {"name": "item", "type": {"id": "int64"}, "nullable": True}]}
    t_plan = t_create(decoded["plan"])
    j_plan = j_create(j_decode(data)["plan"])
    assert [(f.name, f.data_type.id.value) for f in t_plan.schema] == \
        [(f.name, f.data_type.id.value) for f in j_plan.schema]
    got = pa.Table.from_batches(list(t_plan.arrow_batches(0)))
    want = pa.Table.from_batches([b.compact().to_arrow()
                                  for b in j_plan.execute(0)])
    assert got.equals(want)


def test_json_tuple_raises_naming_its_item(tmp_path):
    """json_tuple plans since the strings slice (its rows are held to the
    JAX generator in test_torch_funcs.py); the UDTF generator still
    raises, naming ROADMAP item 16."""
    plan = {"kind": "generate", "input": _scan(tmp_path),
            "generator": {"kind": "json_tuple", "fields": ["a"],
                          "child": {"kind": "column", "name": "sk"}}}
    assert [f.name for f in t_create(plan).schema][-1] == "c0"
    plan["generator"] = {"kind": "udtf", "name": "f", "args": [],
                         "fields": []}
    with pytest.raises(NotImplementedError, match="item 16"):
        t_create(plan)


@pytest.mark.parametrize("kind,item", [
    ("orc_scan", "item 16"), ("rss_shuffle_writer", "item 16")])
def test_unported_kinds_name_their_item(kind, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        t_create({"kind": kind})


@pytest.mark.parametrize("kind", ["ffi_reader", "coalesce_batches",
                                  "empty_partitions", "debug",
                                  "ipc_writer"])
def test_ported_kinds_plan_and_run_as_the_jax_package(kind, tmp_path):
    """The five node kinds that named ROADMAP item 4 (and ipc_writer,
    item 16) until the plan-kinds slice: each plans in both packages over
    a generator's list batches (an FFI resource, or the scan) and gives
    the JAX node's batches, in order; the IPC writer's sink bytes equal
    the JAX writer's."""
    import io
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    tconf.conf.set(tconf.BATCH_SIZE.key, 64)
    jconf.conf.set(jconf.BATCH_SIZE.key, 64)
    batches = _list_batches(np.random.default_rng(9), 5, 40)
    schema = schema_to_dict(TSchema.from_arrow(LIST_SCHEMA))
    ffi = {"kind": "ffi_reader", "resource_id": "gen-ffi", "schema": schema,
           "num_partitions": 1}
    plan = {"ffi_reader": ffi,
            "coalesce_batches": {"kind": "coalesce_batches", "input": ffi},
            "empty_partitions": {"kind": "empty_partitions",
                                 "schema": schema, "num_partitions": 2},
            "debug": {"kind": "debug", "tag": "g", "input": _scan(tmp_path)},
            "ipc_writer": {"kind": "ipc_writer",
                           "sink_resource_id": "gen-sink",
                           "input": ffi}}[kind]
    sinks = {"jax": io.BytesIO(), "torch": io.BytesIO()}
    for put, side in ((j_put, "jax"), (t_put, "torch")):
        put("gen-ffi", batches)
        put("gen-sink", lambda p, _s=sinks[side]: _s)
    j_plan, t_plan = j_create(plan), t_create(plan)
    assert t_plan.num_partitions == j_plan.num_partitions
    assert [f.name for f in t_plan.schema] == \
        [f.name for f in j_plan.schema]
    for p in range(t_plan.num_partitions):
        want = [b.compact().to_arrow() for b in j_plan.execute(p)]
        got = [b.compact().to_arrow() for b in t_plan.execute(p)]
        assert [b.num_rows for b in got] == [b.num_rows for b in want]
        assert all(g.equals(w) for g, w in zip(got, want))
        if kind in ("ffi_reader", "debug"):
            assert got
    if kind == "ipc_writer":
        assert sinks["torch"].getvalue() == sinks["jax"].getvalue() != b""
