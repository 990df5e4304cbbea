"""Spark's bloom filter in the port (blaze_tpu_torch/kernels/bloom.py,
the `bloom_filter` aggregate in ops/agg/functions.py, the
`bloom_filter_might_contain` expression in exprs/special.py) against the
JAX package's:

  * `SparkBloomFilter` over seeded longs (int64's ends, duplicates, an
    empty filter) serializes to the JAX bytes, merges to them, reads back
    from them, and its probe gives the JAX probe (no false negative);
    `optimal_num_bits` and `optimal_num_hashes` equal the JAX sizing;
  * `BloomFilterAgg` through AggExec, partial over raw rows with NULLs
    and then final over the partial output, by group and global: the
    same accumulator bytes as the JAX AggExec's;
  * a TaskDefinition holding a parquet scan under a filter on
    `bloom_filter_might_contain(uuid, k)`, encoded by the port's
    proto_serde and planned by both packages: the same rows, with the
    filter registered and (everything passes) without it; the decoder no
    longer raises for the kind or the aggregate.

Tolerance: exact (bytes, booleans, rows)."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.kernels import bloom as JB
from blaze_tpu.ops.agg import exec as JA
from blaze_tpu.ops.agg.functions import make_agg as j_make_agg
from blaze_tpu.ops.scan import MemoryScanExec as JMem
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.exprs import BoundReference as TRef
from blaze_tpu_torch.kernels import bloom as TB
from blaze_tpu_torch.ops.agg import exec as TA
from blaze_tpu_torch.ops.agg.functions import make_agg as t_make_agg
from blaze_tpu_torch.ops.scan import MemoryScanExec as TMem
from blaze_tpu_torch.schema import Schema as TSchema


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _longs(seed, n):
    rng = np.random.default_rng(seed)
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    ends = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    v[:min(n, 4)] = ends[:min(n, 4)]
    return np.concatenate([v, v[: n // 4]])  # duplicates


@pytest.mark.parametrize("n,expected,fpp", [(0, 10, 0.03), (1, 1, 0.03),
                                            (2000, 1000, 0.03),
                                            (50000, 100000, 0.01)])
def test_filter_bytes_and_probe_equal_jax(n, expected, fpp):
    import jax.numpy as jnp
    nb = JB.optimal_num_bits(expected, fpp)
    k = JB.optimal_num_hashes(expected, nb)
    assert (nb, k) == (TB.optimal_num_bits(expected, fpp),
                       TB.optimal_num_hashes(expected, nb))
    vals = _longs(n, n)
    j, t = JB.SparkBloomFilter(nb, k), TB.SparkBloomFilter(nb, k)
    j.put_longs(vals)
    t.put_longs(vals)
    data = t.to_bytes()
    assert data == j.to_bytes()
    assert TB.SparkBloomFilter.from_bytes(data).to_bytes() == data
    probe = np.concatenate([vals, _longs(n + 1, 3000)])
    got = t.might_contain_longs(torch.from_numpy(probe)).numpy()
    want = np.asarray(j.might_contain_longs(jnp.asarray(probe)))
    assert (got == want).all()
    assert got[:len(vals)].all()  # no false negative
    # merge: the OR of two halves is the whole
    a, b = TB.SparkBloomFilter(nb, k), TB.SparkBloomFilter(nb, k)
    a.put_longs(vals[::2])
    b.put_longs(vals[1::2])
    a.merge(b)
    assert a.to_bytes() == data
    with pytest.raises(ValueError, match="cannot merge"):
        a.merge(TB.SparkBloomFilter(nb + 64, k))


def test_the_probe_passes_null_rows_as_the_jax_one():
    import jax.numpy as jnp
    t, j = TB.SparkBloomFilter(1024, 3), JB.SparkBloomFilter(1024, 3)
    t.put_longs(np.arange(10))
    j.put_longs(np.arange(10))
    probe = np.arange(100, 120)
    valid = np.arange(20) % 3 == 0
    got = t.might_contain_longs(torch.from_numpy(probe),
                                torch.from_numpy(valid)).numpy()
    want = np.asarray(j.might_contain_longs(jnp.asarray(probe),
                                            jnp.asarray(valid)))
    assert (got == want).all() and got[~valid].all()


SCHEMA = pa.schema([("g", pa.int64()), ("v", pa.int32())])


def _raw(seed, batches=3, rows=400):
    rng = np.random.default_rng(seed)
    return [pa.record_batch({
        "g": pa.array(rng.integers(0, 4, rows)),
        "v": pa.array(rng.integers(-10 ** 6, 10 ** 6, rows).astype(np.int32),
                      mask=rng.random(rows) < 0.1)}, schema=SCHEMA)
        for _ in range(batches)]


def _agg(pkg, batches, schema, keys, arg, mode):
    if pkg == "jax":
        src = JMem(JSchema.from_arrow(schema),
                   [[JBatch.from_arrow(rb) for rb in batches]])
        from blaze_tpu.exprs import BoundReference as ref
        make, Agg, Mode = j_make_agg, JA.AggExec, JA.AggMode
    else:
        src = TMem.from_arrow(pa.Table.from_batches(batches, schema=schema))
        ref, make, Agg, Mode = TRef, t_make_agg, TA.AggExec, TA.AggMode
    groups = [(ref(k), f"g{k}") for k in keys]
    fn = make("bloom_filter", [ref(arg)], expected_items=500)
    op = Agg(src, groups, [(fn, Mode(mode), "bloom")])
    out = [b.to_arrow() for b in op.execute(0)]
    return pa.Table.from_batches(out, schema=op.schema.to_arrow())


@pytest.mark.parametrize("keys", [[0], []])
def test_the_bloom_aggregate_equals_the_jax_aggexec(keys):
    raw = _raw(len(keys))
    t = _agg("torch", raw, SCHEMA, keys, 1, "partial")
    j = _agg("jax", raw, SCHEMA, keys, 1, "partial")
    assert t.equals(j)
    # final over the partials of two chunks, whose groups repeat
    parts = pa.concat_tables([t, _agg("torch", _raw(7), SCHEMA, keys, 1,
                                      "partial")])
    pb = parts.to_batches(max_chunksize=3)
    n = len(keys)
    tf = _agg("torch", pb, parts.schema, list(range(n)), n, "final")
    jf = _agg("jax", pb, parts.schema, list(range(n)), n, "final")
    assert tf.equals(jf)
    assert tf.num_rows == (4 if keys else 1)
    # the final filter of a group holds every value of that group
    blob = tf.column("bloom")[0].as_py()
    f = TB.SparkBloomFilter.from_bytes(blob)
    rows = pa.concat_tables([pa.Table.from_batches(_raw(len(keys))),
                             pa.Table.from_batches(_raw(7))])
    if keys:
        rows = rows.filter(pa.compute.equal(rows.column("g"),
                                            tf.column("g0")[0]))
    vals = np.asarray(rows.column("v").drop_null(), dtype=np.int64)
    assert f.might_contain_longs(torch.from_numpy(vals)).all()


def _td(path, uuid):
    from blaze_tpu_torch.plan.types import schema_to_dict
    schema = pa.schema([("k", pa.int64()), ("x", pa.float64())])
    probe = {"kind": "bloom_filter_might_contain", "uuid": uuid,
             "value": {"kind": "column", "index": 0}}
    return {"stage_id": 1, "partition_id": 0, "plan": {
        "kind": "filter", "predicates": [probe],
        "input": {"kind": "parquet_scan",
                  "schema": schema_to_dict(TSchema.from_arrow(schema)),
                  "file_groups": [[path]]}}}


@pytest.mark.parametrize("registered", [True, False])
def test_a_wire_plan_with_the_probe_equals_jax(tmp_path, registered):
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu.plan import create_plan as j_create
    from blaze_tpu.plan.planner import decode_task_definition as j_decode
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    from blaze_tpu_torch.plan import create_plan as t_create
    from blaze_tpu_torch.plan import proto_serde as TP
    from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode
    rng = np.random.default_rng(5)
    n = 3000
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "k": pa.array(rng.integers(0, 20000, n), mask=rng.random(n) < 0.05),
        "x": pa.array(rng.normal(size=n))}), path)
    uuid = f"bloom-{registered}"
    if registered:
        build = np.arange(0, 20000, 7)
        nb = TB.optimal_num_bits(len(build), 0.03)
        k = TB.optimal_num_hashes(len(build), nb)
        tf, jf = TB.SparkBloomFilter(nb, k), JB.SparkBloomFilter(nb, k)
        tf.put_longs(build)
        jf.put_longs(build)
        t_put(uuid, tf)
        j_put(uuid, jf)
    data = TP.task_definition_to_bytes(_td(path, uuid))
    t_plan = t_create(t_decode(data)["plan"])
    j_plan = j_create(j_decode(data)["plan"])
    got = pa.Table.from_batches(
        [b.compact().to_arrow() for b in t_plan.execute(0)])
    want = pa.Table.from_batches(
        [b.compact().to_arrow() for b in j_plan.execute(0)])
    assert got.equals(want)
    kept = got.column("k").to_numpy()
    if registered:
        # every row whose key is on the build side passes, NULL keys do
        # not, and most others are cut
        ks = pq.read_table(path).column("k").drop_null().to_numpy()
        assert (kept % 7 == 0).sum() == (ks % 7 == 0).sum()
        assert got.column("k").null_count == 0
        assert got.num_rows < 0.5 * n
    else:
        assert got.num_rows == n  # no filter: every row might match


def test_the_bloom_aggregate_rides_the_wire_as_the_jax_one():
    """A partial and a final bloom_filter aggregation encode to the JAX
    package's TaskDefinition bytes and decode to its dicts (the wire
    carries no sizing: both take the default of 10^6 items)."""
    from blaze_tpu.plan import proto_serde as JP
    from blaze_tpu.plan.planner import decode_task_definition as j_decode
    from blaze_tpu_torch.plan import proto_serde as TP
    from blaze_tpu_torch.plan.planner import create_plan
    from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode
    from blaze_tpu_torch.plan.types import schema_to_dict
    scan = {"kind": "parquet_scan",
            "schema": schema_to_dict(TSchema.from_arrow(SCHEMA)),
            "file_groups": [["/data/t.parquet"]]}
    partial = {"kind": "hash_agg",
               "groupings": [{"expr": {"kind": "column", "index": 0},
                              "name": "g"}],
               "aggs": [{"fn": "bloom_filter", "mode": "partial",
                         "name": "bloom",
                         "args": [{"kind": "column", "index": 1}]}],
               "input": scan}
    final = dict(partial, input=partial,
                 aggs=[dict(partial["aggs"][0], mode="final",
                            args=[{"kind": "column", "index": 1}])])
    for plan in (partial, final):
        td = {"stage_id": 1, "partition_id": 0, "plan": plan}
        data = TP.task_definition_to_bytes(td)
        assert data == JP.task_definition_to_bytes(td)
        assert t_decode(data) == j_decode(data)
        fn = create_plan(t_decode(data)["plan"])._aggs[0][0]
        bits = TB.optimal_num_bits(1_000_000, 0.03)
        assert (fn.num_bits, fn.num_hashes) == (
            bits, TB.optimal_num_hashes(1_000_000, bits))
