"""The port's round-robin and range partitionings
(blaze_tpu_torch/shuffle/partitioning.py) against the JAX package's, on
the CPU with seeded numpy inputs:

  * round-robin ids across batches of one instance, across map tasks
    that share one (the local mode's LocalShuffleExchange) and across
    tasks that each decode their own plan (the staged DAG and the
    runtime's TaskDefinitions, each starting at 0: the JAX package's
    start, which Spark seeds from the partition id instead);
  * range ids over ints, floats (NaN, -0.0, nulls), float32 rows against
    float64 bounds, dates, timestamps, booleans, utf8 (multi-byte, empty,
    null), decimals and multi-key bounds, ascending and descending,
    nulls first and last, with rows equal to a bound, over several
    batches of one instance: the device route and the host route (utf8,
    decimal) both;
  * `sample_range_bounds` on the same sample;
  * the range and round-robin writers' `.data` and `.index` bytes, each
    map task's plan run through both packages' runtimes, and the local
    mode's rows in order.

Ids are exact; bytes are identical.  The JAX package runs its device
route (`blaze_tpu.bridge.placement.host_resident` patched to False)."""

import base64
import datetime
import decimal
import io
import os

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu import config as jconf
from blaze_tpu_torch import config as tconf

BATCH = 512


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    for c in (jconf, tconf):
        c.conf.set("auron.batch.size", BATCH)
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset("auron.batch.size")


def _ipc(rb: pa.RecordBatch) -> str:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, rb.schema) as w:
        w.write_batch(rb)
    return base64.b64encode(sink.getvalue()).decode("ascii")


def _both(d, rb: pa.RecordBatch):
    """The partitioning dict `d` planned by both packages over `rb`'s
    schema."""
    from blaze_tpu.plan.planner import partitioning_from_dict as j_part
    from blaze_tpu.schema import Schema as JSchema
    from blaze_tpu_torch.plan.planner import partitioning_from_dict as t_part
    from blaze_tpu_torch.schema import Schema as TSchema
    return (j_part(d, JSchema.from_arrow(rb.schema)),
            t_part(d, TSchema.from_arrow(rb.schema)))


def _ids_equal(d, batches):
    """Each batch's ids from one instance of each package, in turn."""
    from blaze_tpu.batch import ColumnBatch as JB
    from blaze_tpu_torch.batch import ColumnBatch as TB
    jp, tp = _both(d, batches[0])
    for rb in batches:
        want = np.asarray(jp.partition_ids(JB.from_arrow(rb)))
        got = tp.partition_ids(TB.from_arrow(rb))
        assert got.dtype.is_floating_point is False
        assert np.array_equal(got.numpy().astype(np.int32),
                              want.astype(np.int32)), (d["kind"], rb)
    return tp


def _same_bits(a: pa.RecordBatch, b: pa.RecordBatch) -> bool:
    """Equal schemas, nulls and values, floats bit for bit (NaN equal to
    its own bits, -0.0 apart from 0.0)."""
    if not a.schema.equals(b.schema):
        return False
    for x, y in zip(a.columns, b.columns):
        if not x.is_null().equals(y.is_null()):
            return False
        if pa.types.is_floating(x.type):
            xv = np.asarray(x.fill_null(0.0)).view(np.int64)
            yv = np.asarray(y.fill_null(0.0)).view(np.int64)
            if not np.array_equal(xv, yv):
                return False
        elif not x.equals(y):
            return False
    return True


# ---------------------------------------------------------------------------
# round-robin
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_parts", [1, 3, 16])
def test_round_robin_ids_run_on_across_batches(n_parts):
    rng = np.random.default_rng(n_parts)
    batches = [pa.record_batch({"x": rng.integers(0, 9, n)})
               for n in (7, 1, 300, 33, 0, 5)]
    tp = _ids_equal({"kind": "round_robin", "num_partitions": n_parts},
                    batches)
    assert tp._next == sum(b.num_rows for b in batches) % n_parts


# ---------------------------------------------------------------------------
# range
# ---------------------------------------------------------------------------

def _spec(i, desc=False, nf=True):
    return {"expr": {"kind": "column", "index": i}, "descending": desc,
            "nulls_first": nf}


def _range(specs, bounds: pa.RecordBatch):
    return {"kind": "range", "specs": specs,
            "num_partitions": bounds.num_rows + 1,
            "bounds_ipc": _ipc(bounds)}


def _batches(table: pa.Table, rng, pieces=3):
    cuts = sorted(rng.choice(np.arange(1, table.num_rows), pieces - 1,
                             replace=False))
    edges = [0, *cuts, table.num_rows]
    return [table.slice(a, b - a).combine_chunks().to_batches()[0]
            for a, b in zip(edges[:-1], edges[1:]) if b > a]


def _ints(rng, n, nulls=0.1):
    v = rng.integers(-20, 20, n)
    return pa.array(v, mask=rng.random(n) < nulls)


def _floats(rng, n, dtype=pa.float64()):
    v = rng.choice([-1.5, -0.0, 0.0, 0.5, 2.0, np.nan, np.inf, -np.inf,
                    7.25], n)
    return pa.array(v, mask=rng.random(n) < 0.1).cast(dtype)


WORDS = ["", "a", "ab", "b", "é", "ü", "z", "日本", "a\x00", "zz"]


def _case(name, rng, n=700):
    """(table, specs, bounds) of one range case; the table holds every
    bound value among its rows."""
    if name == "int asc nulls first":
        t = pa.table({"k": _ints(rng, n)})
        return t, [_spec(0)], pa.record_batch(
            {"b0": pa.array([None, -5, 0, 0, 11], type=pa.int64())})
    if name == "int desc nulls last":
        t = pa.table({"k": _ints(rng, n).cast(pa.int32())})
        return t, [_spec(0, True, False)], pa.record_batch(
            {"b0": pa.array([15, 3, -2, -2, None], type=pa.int64())})
    if name == "int asc nulls last":
        t = pa.table({"k": _ints(rng, n).cast(pa.int16())})
        return t, [_spec(0, False, False)], pa.record_batch(
            {"b0": pa.array([-7, 1, None], type=pa.int64())})
    if name == "float asc nulls last":
        t = pa.table({"k": _floats(rng, n)})
        return t, [_spec(0, False, False)], pa.record_batch(
            {"b0": pa.array([-np.inf, -0.0, 0.5, np.nan, None])})
    if name == "float desc nulls first":
        t = pa.table({"k": _floats(rng, n)})
        return t, [_spec(0, True, True)], pa.record_batch(
            {"b0": pa.array([None, np.nan, 7.25, 0.0, -1.5])})
    if name == "float32 rows, float64 bounds":
        t = pa.table({"k": _floats(rng, n, pa.float32())})
        return t, [_spec(0)], pa.record_batch(
            {"b0": pa.array([-1.5, 0.0, 2.0, np.nan])})
    if name == "date":
        days = rng.integers(10950, 10970, n).astype(np.int32)
        t = pa.table({"k": pa.array(days, type=pa.date32(),
                                    mask=rng.random(n) < 0.05)})
        return t, [_spec(0, True, False)], pa.record_batch(
            {"b0": pa.array([datetime.date(2000, 1, 15),
                             datetime.date(2000, 1, 3)])})
    if name == "timestamp":
        us = rng.integers(0, 50, n) * 1_000_000
        t = pa.table({"k": pa.array(us, type=pa.timestamp("us"))})
        return t, [_spec(0)], pa.record_batch(
            {"b0": pa.array([10_000_000, 25_000_000],
                            type=pa.timestamp("us"))})
    if name == "bool":
        t = pa.table({"k": pa.array(rng.random(n) < 0.5,
                                    mask=rng.random(n) < 0.1)})
        return t, [_spec(0, False, False)], pa.record_batch(
            {"b0": pa.array([False, True])})
    if name == "utf8":
        t = pa.table({"k": pa.array(rng.choice(WORDS, n).tolist(),
                                    mask=rng.random(n) < 0.1)})
        return t, [_spec(0)], pa.record_batch(
            {"b0": pa.array([None, "", "ab", "é", "日本"])})
    if name == "utf8 desc":
        t = pa.table({"k": pa.array(rng.choice(WORDS, n).tolist())})
        return t, [_spec(0, True, False)], pa.record_batch(
            {"b0": pa.array(["zz", "é", "a\x00", "a"])})
    if name == "decimal":
        v = [decimal.Decimal(int(x)).scaleb(-2)
             for x in rng.integers(-900, 900, n)]
        t = pa.table({"k": pa.array(v, type=pa.decimal128(7, 2))})
        return t, [_spec(0)], pa.record_batch(
            {"b0": pa.array([decimal.Decimal("-3.00"),
                             decimal.Decimal("4.50")],
                            type=pa.decimal128(7, 2))})
    if name == "multi-key":
        t = pa.table({"a": _ints(rng, n).cast(pa.int32()),
                      "b": _floats(rng, n)})
        bounds = pa.record_batch({
            "b0": pa.array([None, -3, -3, 4, 4, 12], type=pa.int64()),
            "b1": pa.array([0.5, None, 2.0, np.nan, -0.0, 1.0])})
        return t, [_spec(0, False, True), _spec(1, True, False)], bounds
    if name == "multi-key utf8 and int":
        t = pa.table({"s": pa.array(rng.choice(WORDS, n).tolist()),
                      "i": _ints(rng, n)})
        bounds = pa.record_batch({"b0": pa.array(["a", "é", "é"]),
                                  "b1": pa.array([3, None, 0],
                                                 type=pa.int64())})
        return t, [_spec(0, True, True), _spec(1, False, False)], bounds
    raise KeyError(name)


RANGE_CASES = ["int asc nulls first", "int desc nulls last",
               "int asc nulls last", "float asc nulls last",
               "float desc nulls first", "float32 rows, float64 bounds",
               "date", "timestamp", "bool", "utf8", "utf8 desc", "decimal",
               "multi-key", "multi-key utf8 and int"]


def _with_bounds(table: pa.Table, bounds: pa.RecordBatch, rng):
    """The table with each bound row among its rows (where the column
    types let it), shuffled in."""
    rows = pa.Table.from_batches([bounds]).rename_columns(table.column_names)
    rows = rows.cast(table.schema, safe=False)
    t = pa.concat_tables([table, rows]).combine_chunks()
    return t.take(pa.array(rng.permutation(t.num_rows)))


@pytest.mark.parametrize("name", RANGE_CASES)
def test_range_ids_equal_the_jax_package(name):
    rng = np.random.default_rng(abs(hash(name)) % (1 << 31))
    table, specs, bounds = _case(name, rng)
    table = _with_bounds(table, bounds, rng)
    _ids_equal(_range(specs, bounds), _batches(table, rng))


@pytest.mark.parametrize("name", ["int asc nulls first", "float asc nulls "
                                  "last", "multi-key", "utf8"])
def test_range_routes(name):
    """Fixed-width keys of the bounds' kind take the device route, utf8
    the host route; both routes give the same ids on a fixed-width
    case."""
    from blaze_tpu_torch.batch import ColumnBatch as TB
    rng = np.random.default_rng(5)
    table, specs, bounds = _case(name, rng)
    _jp, tp = _both(_range(specs, bounds), bounds)
    b = TB.from_arrow(table.combine_chunks().to_batches()[0])
    vals = [e.evaluate(b) for e, _, _ in tp.sort_exprs]
    device = name != "utf8"
    assert all(v.is_device for v in vals) == device
    if device:
        kinds = [v.dtype.id for v in vals]
        from blaze_tpu_torch.shuffle.partitioning import _kind
        got = tp._device_ids(vals, [_kind(k) for k in kinds], b.num_rows,
                             b.device)
        assert np.array_equal(got.numpy(), tp._host_ids(vals, b.num_rows))


def test_sample_range_bounds_equal_the_jax_package():
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.shuffle import sample_range_bounds as j_bounds
    from blaze_tpu_torch.exprs import BoundReference as TRef
    from blaze_tpu_torch.shuffle import sample_range_bounds as t_bounds
    rng = np.random.default_rng(11)
    n = 3000
    sample = pa.table({"c": _ints(rng, n, 0.02),
                       "t": pa.array(rng.permutation(n).astype(np.int64)),
                       "f": _floats(rng, n)})
    for parts in (2, 16, 5000):
        for keys, desc in (((0, 1), (False, False)),
                           ((2, 0), (True, False))):
            names = [sample.column_names[i] for i in keys]
            want = j_bounds(sample, [(JRef(i, nm), d, not d) for i, nm, d in
                                     zip(keys, names, desc)], parts, names)
            got = t_bounds(sample, [(TRef(i, nm), d, not d) for i, nm, d in
                                    zip(keys, names, desc)], parts, names)
            assert _same_bits(got, want)


# ---------------------------------------------------------------------------
# the writers and the exchanges
# ---------------------------------------------------------------------------

N_MAPS = 3


def _table(rng, n=2500):
    return pa.table({
        "k": _ints(rng, n, 0.05),
        "t": pa.array(rng.permutation(n).astype(np.int64)),
        "s": pa.array(rng.choice(WORDS, n).tolist(),
                      mask=rng.random(n) < 0.05),
        "v": pa.array(rng.random(n)),
    })


def _register(rid, table):
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    j_put(rid, table)
    t_put(rid, table)


def _schema_d(table):
    from blaze_tpu_torch.plan.types import schema_to_dict
    from blaze_tpu_torch.schema import Schema
    return schema_to_dict(Schema.from_arrow(table.schema))


def _partitionings(rng, table):
    bounds = pa.record_batch({
        "b0": pa.array([-10, -10, 0, None, 9], type=pa.int64()),
        "b1": pa.array([5, 900, 4, 100, 2000], type=pa.int64())})
    sbounds = pa.record_batch({"b0": pa.array(["a", "ab", "é"])})
    return {
        "round robin": {"kind": "round_robin", "num_partitions": 3},
        "range int": {"kind": "range", "num_partitions": 6,
                      "specs": [_spec(0, False, False), _spec(1, True)],
                      "bounds_ipc": _ipc(bounds)},
        "range utf8": {"kind": "range", "num_partitions": 4,
                       "specs": [_spec(2)], "bounds_ipc": _ipc(sbounds)},
    }


def _writer_td(part, table, rid, out_dir, m):
    data = os.path.join(out_dir, f"map-{m}.data")
    return {"stage_id": 1, "partition_id": m, "num_partitions": N_MAPS,
            "plan": {"kind": "shuffle_writer", "partitioning": part,
                     "data_file": data, "index_file": data[:-5] + ".index",
                     "input": {"kind": "memory_scan", "resource_id": rid,
                               "schema": _schema_d(table),
                               "num_partitions": N_MAPS}}}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("kind", ["round robin", "range int", "range utf8"])
def test_writers_write_the_jax_bytes(kind, tmp_path):
    """Each map task's TaskDefinition (its own plan, so a round-robin
    cursor from 0; a dict, since the wire has no memory scan) through
    both runtimes: `.data` and `.index` equal byte
    for byte."""
    from blaze_tpu.bridge.runtime import execute_plan as j_exec
    from blaze_tpu_torch.bridge.runtime import execute_plan as t_exec
    rng = np.random.default_rng(3)
    table = _table(rng)
    rid = f"parts-kinds-{kind}"
    _register(rid, table)
    part = _partitionings(rng, table)[kind]
    for side, run in (("jax", j_exec), ("torch", t_exec)):
        d = tmp_path / side
        d.mkdir()
        for m in range(N_MAPS):
            run(_writer_td(part, table, rid, str(d), m))
    for m in range(N_MAPS):
        for suffix in ("data", "index"):
            name = f"map-{m}.{suffix}"
            assert _read(tmp_path / "torch" / name) == \
                _read(tmp_path / "jax" / name), name
    # every partition received rows
    offs = np.frombuffer(_read(tmp_path / "torch" / "map-0.index"), "<i8")
    assert (np.diff(offs) > 0).sum() >= 3


@pytest.mark.parametrize("kind", ["round robin", "range int"])
def test_local_exchange_shares_one_instance_as_the_jax_package(kind):
    """The local mode's exchange runs every map task with one
    partitioning instance: the round-robin cursor runs on from one map
    task into the next, in both packages.  Rows of each reduce partition
    equal in order."""
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    rng = np.random.default_rng(8)
    table = _table(rng, 1201)
    rid = f"parts-local-{kind}"
    _register(rid, table)
    d = {"kind": "local_exchange",
         "partitioning": _partitionings(rng, table)[kind],
         "input": {"kind": "memory_scan", "resource_id": rid,
                   "schema": _schema_d(table), "num_partitions": N_MAPS}}
    jp, tp = j_create(d), t_create(d)
    try:
        for r in range(tp.num_partitions):
            want = [b.compact().to_arrow() for b in jp.execute(r)]
            got = [b.compact().to_arrow() for b in tp.execute(r)]
            assert pa.Table.from_batches(got, schema=want[0].schema
                                         ).equals(pa.Table.from_batches(want))
        if kind == "round robin":
            # the shared cursor ran on over all 1201 rows (512 + 512 +
            # 177): one reset per map task would leave 177 % 3 == 0
            assert tp.partitioning._next == table.num_rows % 3 == 1
    finally:
        jp.cleanup()
        tp.cleanup()


def test_staged_dag_round_robin_starts_each_task_at_zero(tmp_path):
    """The staged DAG sends each map task its own TaskDefinition: every
    task's round-robin cursor starts at 0 (the JAX package's start; Spark
    seeds it from the partition id).  Rows in order and every map
    output's bytes equal the JAX DagScheduler's."""
    import pyarrow.parquet as pq
    from blaze_tpu.plan.stages import DagScheduler as JDag
    from blaze_tpu_torch.plan.stages import DagScheduler as TDag
    rng = np.random.default_rng(21)
    table = _table(rng, 1500).drop_columns(["s"])
    paths = []
    for i in range(N_MAPS):
        p = str(tmp_path / f"f{i}.parquet")
        pq.write_table(table.slice(i * 500, 500), p)
        paths.append([p])
    plan = {"kind": "local_exchange",
            "partitioning": {"kind": "round_robin", "num_partitions": 4},
            "input": {"kind": "parquet_scan", "schema": _schema_d(table),
                      "file_groups": paths}}
    outs = {}
    for name, cls, c in (("jax", JDag, jconf), ("torch", TDag, tconf)):
        c.conf.set("auron.tpu.dag.singleTaskBytes", 0)
        if name == "jax":
            c.conf.set("auron.tpu.shuffle.device", "off")

        class Rec(cls):
            def _run_map_task(self, stage, part, m):
                super()._run_map_task(stage, part, m)
                data = self._map_data_path(stage.sid, m)
                for sfx, pth in (("data", data),
                                 ("index", data[:-5] + ".index")):
                    outs[(name, m, sfx)] = _read(pth)
        try:
            sched = Rec()
            outs[name] = sched.run_collect(plan)
            assert sched.exec_mode == "staged"
        finally:
            c.conf.unset("auron.tpu.dag.singleTaskBytes")
            c.conf.unset("auron.tpu.shuffle.device")
    assert outs["torch"].equals(outs["jax"])
    for m in range(N_MAPS):
        for sfx in ("data", "index"):
            assert outs[("torch", m, sfx)] == outs[("jax", m, sfx)]
        # 500 rows from 0: partition 0 holds rows 0, 4, ..., 496
        offs = np.frombuffer(outs[("torch", m, "index")], "<i8")
        assert offs[1] > offs[0]
