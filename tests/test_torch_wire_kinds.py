"""The plan kinds the wire and the Spark front door hand the port
(blaze_tpu_torch/plan/proto_serde.py, plan/planner.py, ops/basic.py,
shuffle/reader.py, itest/wire_kinds.py) against the JAX package's, on the
CPU:

  * every new kind and field round-trips through protobuf to the JAX
    package's bytes and dict: ffi_reader, empty_partitions, debug,
    ipc_writer, coalesce_batches, a parquet scan with its pruning
    predicate, partition schema and per-file values, and round-robin and
    range partitionings (one key, and several as struct scalars);
  * each node's output equals the JAX node's, batch for batch: the FFI
    reader, empty partitions, the debug node (and its log lines),
    coalesce_batches with and without a batch size; the IPC writer's sink
    bytes equal the JAX writer's;
  * the three paths of itest/wire_kinds.py at scale 0.05 (W3's Hive files
    in 512-row row groups, so that the date window prunes): W1 (a range
    exchange into a sort and an IPC writer) and W3 (q01 over a Hive
    layout) as TaskDefinitions through both runtimes, W2 (a round-robin
    exchange) through both front doors, local and staged: rows and order
    equal, every map output's `.data` and `.index` bytes equal, the sinks'
    bytes equal; each path equal to its oracle; the FFI probe's map bytes
    equal the scan's.

The JAX package runs its device route
(`blaze_tpu.bridge.placement.host_resident` patched to False), with its
host-vectorized Arrow lane off and, where it stages, its device exchange
off, so it writes shuffle files to compare."""

import base64
import io
import logging
import os

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu import config as jconf
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import decode_task_definition as j_decode
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q01
from blaze_tpu_torch.itest import wire_kinds as W
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode

SCALE = 0.05
N_MAPS, N_PARTS = 4, 16
HIVE_ROW_GROUP = 512
JAX_ONLY = {"auron.tpu.fused.hostVectorized": False,
            "auron.tpu.stage.deviceLoop.enable": "off",
            "auron.tpu.shuffle.device": "off"}


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    for k, v in JAX_ONLY.items():
        jconf.conf.set(k, v)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for k in JAX_ONLY:
        jconf.conf.unset(k)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _ipc(rb):
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return base64.b64encode(sink.getvalue()).decode("ascii")


SCHEMA_D = {"fields": [
    {"name": "k", "type": {"id": "int64"}, "nullable": True},
    {"name": "s", "type": {"id": "utf8"}, "nullable": True},
    {"name": "v", "type": {"id": "float64"}, "nullable": True}]}
PART_D = {"fields": [
    {"name": "region", "type": {"id": "utf8"}, "nullable": True},
    {"name": "n", "type": {"id": "int32"}, "nullable": True}]}


def _ffi(rid="ffi-x", n=2):
    return {"kind": "ffi_reader", "resource_id": rid, "schema": SCHEMA_D,
            "num_partitions": n}


def _writer(part, inp):
    return {"kind": "shuffle_writer", "partitioning": part,
            "data_file": "/tmp/x.data", "index_file": "/tmp/x.index",
            "input": inp}


def _tds():
    one = pa.record_batch({"b0": pa.array([3, 10, 10], type=pa.int64())})
    two = pa.record_batch({"b0": pa.array([None, 5]),
                           "b1": pa.array(["a", "é"])})
    dates = pa.record_batch({"b0": pa.array([1.5, float("nan")])})
    scan = {"kind": "parquet_scan", "schema": SCHEMA_D,
            "partition_schema": PART_D,
            "partition_values": [[["eu", 3], ["us", None]], []],
            "projection": ["n", "k", "region"],
            "predicate": {"kind": "binary", "op": "and",
                          "l": {"kind": "binary", "op": ">=",
                                "l": {"kind": "column", "index": 0},
                                "r": {"kind": "literal", "value": 4,
                                      "type": {"id": "int64"}}},
                          "r": {"kind": "is_not_null",
                                "child": {"kind": "column", "index": 1}}},
            "file_groups": [["/d/region=eu/a.parquet",
                             "/d/region=us/b.parquet"], []]}
    plans = {
        "ffi_reader": _ffi(),
        "empty_partitions": {"kind": "empty_partitions", "schema": SCHEMA_D,
                             "num_partitions": 3},
        "debug": {"kind": "debug", "tag": "t", "input": _ffi()},
        "ipc_writer": {"kind": "ipc_writer", "sink_resource_id": "sink-x",
                       "input": _ffi()},
        "coalesce_batches": {"kind": "coalesce_batches", "batch_size": 100,
                             "input": _ffi()},
        "coalesce_batches default": {"kind": "coalesce_batches",
                                     "batch_size": None, "input": _ffi()},
        "scan predicate and partitions": scan,
        "scan predicate only": dict(
            {k: v for k, v in scan.items()
             if k not in ("partition_schema", "partition_values")},
            projection=["s", "k"]),
        "round robin": _writer({"kind": "round_robin", "num_partitions": 7},
                               _ffi()),
        "range one key": _writer(
            {"kind": "range", "num_partitions": 4,
             "specs": [{"expr": {"kind": "column", "index": 0},
                        "descending": True, "nulls_first": False}],
             "bounds_ipc": _ipc(one)}, _ffi()),
        "range two keys": _writer(
            {"kind": "range", "num_partitions": 3,
             "specs": [{"expr": {"kind": "column", "index": 0},
                        "descending": False, "nulls_first": True},
                       {"expr": {"kind": "column", "index": 1},
                        "descending": True, "nulls_first": False}],
             "bounds_ipc": _ipc(two)}, _ffi()),
        "range float": _writer(
            {"kind": "range", "num_partitions": 3,
             "specs": [{"expr": {"kind": "column", "index": 2},
                        "descending": False, "nulls_first": True}],
             "bounds_ipc": _ipc(dates)}, _ffi()),
    }
    return {k: {"stage_id": 2, "partition_id": 0, "plan": p}
            for k, p in plans.items()}


@pytest.mark.parametrize("name", list(_tds()))
def test_new_kinds_round_trip_to_the_jax_dict(name):
    td = _tds()[name]
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    got = t_decode(data)
    assert got == j_decode(data)
    assert TP.task_definition_to_bytes(got) == data


def test_a_kind_still_unported_raises_on_the_wire():
    td = {"plan": {"kind": "rss_shuffle_writer", "rss_resource_id": "rss",
                   "partitioning": {"kind": "single", "num_partitions": 1},
                   "input": _ffi()}}
    with pytest.raises(NotImplementedError, match="later slice"):
        TP.task_definition_to_bytes(td)
    with pytest.raises(NotImplementedError, match="later slice"):
        t_decode(JP.task_definition_to_bytes(td))


# ---------------------------------------------------------------------------
# each node against the JAX node
# ---------------------------------------------------------------------------

def _batches(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for n in (30, 7, 200, 1, 64, 0, 90):
        out.append(pa.record_batch({
            "k": pa.array(rng.integers(-5, 50, n), mask=rng.random(n) < .1),
            "s": pa.array(rng.choice(["a", "", "é", "zz"], n).tolist(),
                          type=pa.string()),
            "v": pa.array(rng.random(n))}))
    return out


def _put(rid, value):
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    j_put(rid, value)
    t_put(rid, value)


def _node_both(plan):
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    jp, tp = j_create(plan), t_create(plan)
    assert tp.num_partitions == jp.num_partitions
    assert [f.name for f in tp.schema] == [f.name for f in jp.schema]
    out = []
    for p in (jp, tp):
        out.append([[b.compact().to_arrow() for b in p.execute(i)]
                    for i in range(p.num_partitions)])
    return out


@pytest.mark.parametrize("name", ["ffi_reader", "ffi_reader by partition",
                                  "empty_partitions", "debug",
                                  "coalesce_batches",
                                  "coalesce_batches default"])
def test_nodes_equal_the_jax_nodes(name, caplog):
    batches = _batches()
    if name == "ffi_reader by partition":
        _put("ffi-x", lambda p: batches[p::2])
    else:
        _put("ffi-x", batches)
    plan = _tds()[name.replace(" by partition", "")]["plan"]
    with caplog.at_level(logging.INFO, logger="blaze_tpu_torch.debug"):
        want, got = _node_both(plan)
    assert [[b.num_rows for b in p] for p in got] == \
        [[b.num_rows for b in p] for p in want]
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            assert g.equals(w)
    if name == "empty_partitions":
        assert got == [[], [], []]
    if name == "debug":
        lines = [r.getMessage() for r in caplog.records
                 if r.name == "blaze_tpu_torch.debug"]
        assert len(lines) == 2 * len(batches)
        assert lines[2] == "[t] partition=0 batch=2 rows=200"
    if name.startswith("coalesce"):
        assert len(got[0]) < len(batches)


def test_the_ipc_writer_writes_the_jax_bytes():
    batches = _batches(4)
    _put("ffi-x", batches)
    sinks = {"jax": {}, "torch": {}}
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    for side, put, create in (("jax", j_put, j_create),
                              ("torch", t_put, t_create)):
        def factory(p, _d=sinks[side]):
            return _d.setdefault(p, io.BytesIO())
        put("sink-x", factory)
        plan = create(_tds()["ipc_writer"]["plan"])
        for p in range(plan.num_partitions):
            assert list(plan.execute(p)) == []
        assert plan.metrics.values["output_rows"] == \
            2 * sum(b.num_rows for b in batches)
    assert sorted(sinks["jax"]) == sorted(sinks["torch"]) == [0, 1]
    for p in (0, 1):
        assert sinks["torch"][p].getvalue() == sinks["jax"][p].getvalue()
    got = W.read_sinks([sinks["torch"][0].getvalue()],
                       pa.Table.from_batches(batches).schema)
    assert got.equals(pa.Table.from_batches(batches))


# ---------------------------------------------------------------------------
# the three paths through both packages
# ---------------------------------------------------------------------------

def _jax_stages(stages):
    """itest/q01.py run_stages through the JAX package's runtime: each
    stage's task outputs and its shuffle files with their offsets."""
    from blaze_tpu.bridge.resource import put_resource, remove_resource
    from blaze_tpu.bridge.runtime import NativeExecutionRuntime
    from blaze_tpu.plan.proto_serde import task_definition_to_bytes
    from blaze_tpu.shuffle import FileSegmentBlock, read_index_file
    results = {}
    for i, st in enumerate(stages):
        if st.reads is not None:
            written = results[st.reads]["shuffle"]
            sid = [s.name for s in stages].index(st.reads) + 1

            def blocks_for(part, written=written, sid=sid):
                return [FileSegmentBlock(d, offs[part],
                                         offs[part + 1] - offs[part],
                                         stage_id=sid, map_id=m)
                        for m, (d, _i, offs) in enumerate(written)
                        if offs[part + 1] > offs[part]]
            put_resource(st.resource, blocks_for)
        outputs = []
        for t in range(st.n_tasks):
            rt = NativeExecutionRuntime(
                task_definition_to_bytes(st.task_td(t))).start()
            try:
                outputs.append(list(rt.batches()))
            finally:
                rt.finalize()
        written = []
        if st.out_dir is not None:
            for t in range(st.n_tasks):
                d = os.path.join(st.out_dir, f"shuffle_{t}.data")
                ix = os.path.join(st.out_dir, f"shuffle_{t}.index")
                written.append((d, ix, read_index_file(
                    ix, expected_partitions=st.out_partitions,
                    data_file=d)))
        results[st.name] = {"outputs": outputs, "shuffle": written}
        if st.reads is not None:
            remove_resource(st.resource)
    return results


def _files(written):
    out = []
    for d, ix, _offs in written:
        for p in (d, ix):
            with open(p, "rb") as f:
                out.append(f.read())
    return out


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wire_kinds"))
    sr_paths, lo, hi = W.make_data(SCALE, root)
    return root, sr_paths, lo, hi


def test_w1_range_sort_equals_the_jax_package(data, tmp_path):
    from blaze_tpu.bridge.resource import put_resource as j_put
    root, sr_paths, lo, hi = data
    sample = W.w1_sample(sr_paths, lo, hi)
    bounds = W.w1_bounds(sample, N_PARTS)
    assert bounds.num_rows == N_PARTS - 1
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = W.run_w1(sr_paths, lo, hi, bounds, str(tmp_path / "t"), N_MAPS,
                   N_PARTS)
    assert W.w1_error(got["table"], W.w1_oracle(sr_paths, lo, hi)) is None
    assert W.pruning_error(got["map_task_counters"],
                           q01.file_groups(sr_paths, N_MAPS), lo, hi) is None
    assert got["counters"]["map"]["pruned_row_groups"] == \
        W.footer_pruned(sr_paths, lo, hi) > 0
    # the same TaskDefinitions through the JAX runtime
    b64 = W.bounds_ipc(bounds)
    sinks = [io.BytesIO() for _ in range(N_PARTS)]
    j_put(W.W1_SINK, lambda p: sinks[p])
    jd = str(tmp_path / "j")
    res = _jax_stages([
        q01.Stage("map", lambda m: W.w1_map_td(sr_paths, lo, hi, b64, m, jd,
                                               N_MAPS, N_PARTS),
                  N_MAPS, out_dir=jd, out_partitions=N_PARTS),
        q01.Stage("reduce", lambda r: W.w1_reduce_td(r, N_PARTS), N_PARTS,
                  reads="map", resource=W.W1_SHUFFLE)])
    assert _files(got["shuffle"]) == _files(res["map"]["shuffle"])
    assert got["sinks"] == [s.getvalue() for s in sinks]
    assert sum(len(s) > 0 for s in got["sinks"]) >= N_PARTS - 1


def _jax_front_door(plan_json, staged):
    import blaze_tpu.plan.stages as JST
    made = []
    real = JST.DagScheduler

    class Recording(real):
        def __init__(self, work_dir=None):
            super().__init__(work_dir)
            self.outputs = {}
            made.append(self)

        def _run_map_task(self, stage, part, m):
            super()._run_map_task(stage, part, m)
            d = self._map_data_path(stage.sid, m)
            for sfx, p in (("data", d), ("index", d[:-5] + ".index")):
                with open(p, "rb") as f:
                    self.outputs[(stage.sid, m, sfx)] = f.read()
    JST.DagScheduler = Recording
    if staged:
        jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    try:
        out = JST.execute_spark_plan_json(plan_json, N_PARTS)
    finally:
        JST.DagScheduler = real
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
    return out, made[0]


@pytest.mark.parametrize("staged", [False, True])
def test_w2_round_robin_equals_the_jax_package(staged, data):
    from blaze_tpu_torch.plan.stages import DagScheduler
    root, sr_paths, lo, hi = data
    outputs = {}

    class Recording(DagScheduler):
        def _run_map_task(self, stage, part, m):
            super()._run_map_task(stage, part, m)
            d = self._map_data_path(stage.sid, m)
            for sfx, p in (("data", d), ("index", d[:-5] + ".index")):
                with open(p, "rb") as f:
                    outputs[(stage.sid, m, sfx)] = f.read()
    if staged:
        tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    try:
        got = W.run_w2(sr_paths, N_PARTS, scheduler=Recording())
    finally:
        tconf.conf.unset(tconf.DAG_SINGLE_TASK_BYTES.key)
    assert got["exec_mode"] == ("staged" if staged else "local")
    assert W.w2_error(got["table"], W.w2_oracle(sr_paths)) is None
    plan_json = W.w2_plan_json([[p] for p in sr_paths], N_PARTS)
    want, jsched = _jax_front_door(plan_json, staged)
    assert jsched.exec_mode == got["exec_mode"]
    assert got["table"].num_rows == want.num_rows > 0
    # rows in order: keys and counts exact, sums as the JAX run's
    for i in range(3):
        a = np.asarray(got["table"].column(i))
        b = np.asarray(want.column(i))
        assert np.array_equal(a, b) if i != 1 else np.allclose(
            a, b, rtol=1e-12, atol=0)
    if staged:
        assert outputs and sorted(outputs) == sorted(jsched.outputs)
        for key in sorted(outputs):
            assert outputs[key] == jsched.outputs[key], key


def test_w3_hive_layout_equals_the_jax_package(data, tmp_path):
    root, sr_paths, lo, hi = data
    hive = str(tmp_path / "hive")
    groups, pvals = W.write_hive(sr_paths, hive, N_MAPS, HIVE_ROW_GROUP)
    assert sum(len(g) for g in groups) == 12
    for name in ("t", "j", "ffi"):
        (tmp_path / name).mkdir()
    got = W.run_w3(groups, pvals, lo, hi, str(tmp_path / "t"), N_PARTS)
    assert W.q01_error(got["table"], q01.oracle(sr_paths, lo, hi)) is None
    assert W.pruning_error(got["map_task_counters"], groups, lo, hi) is None
    assert got["counters"]["map"]["pruned_row_groups"] > 0
    jd = str(tmp_path / "j")
    res = _jax_stages([
        q01.Stage("map", lambda m: W.w3_map_td(groups, pvals, lo, hi, m, jd,
                                               N_PARTS),
                  N_MAPS, out_dir=jd, out_partitions=N_PARTS),
        q01.Stage("reduce", lambda r: W.w3_reduce_td(r, N_PARTS), N_PARTS,
                  reads="map", resource=W.W3_SHUFFLE)])
    assert _files(got["shuffle"]) == _files(res["map"]["shuffle"])
    want = pa.Table.from_batches(
        [b for bs in res["reduce"]["outputs"] for b in bs])
    assert got["table"].equals(want)
    probe = W.ffi_probe(groups, pvals, lo, hi, 2, str(tmp_path / "ffi"),
                        str(tmp_path / "t"), N_PARTS)
    assert probe["rows"] > 0 and probe["same"] == {"data": True,
                                                   "index": True}


def test_run_all_runs_every_path(tmp_path):
    """itest/wire_kinds.py `run_all` and `failures` at the test's scale
    (W3's Hive files in small row groups)."""
    sr_paths, lo, hi = W.make_data(SCALE, str(tmp_path / "data"))
    out = W.run_all(sr_paths, lo, hi, str(tmp_path), N_MAPS, N_PARTS,
                    hive_row_group_size=HIVE_ROW_GROUP)
    assert W.failures(out) == []
    assert out["w2"]["exec_mode"] == "local"
