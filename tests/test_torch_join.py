"""The port's joins (blaze_tpu_torch/kernels/join.py, ops/joins/) against
the JAX package's device route (blaze_tpu/kernels/join.py, ops/joins/,
with `blaze_tpu.bridge.placement.host_resident` patched to False, as
tests/test_join_device.py does), on the same numpy-seeded inputs.

  * the probe kernels: `build_runs`, `probe_counts`, `expand_pairs` (at a
    cap that holds every pair and one that cuts them) and
    `probe_expand_device`, including the cap regrowth past 1024 pairs and
    an empty probe;
  * `JoinMap.lookup`: int64 keys with NULLs, float64 keys with NaN, -0.0
    and NULLs, utf8 keys, two keys at once;
  * BroadcastJoinExec, SortMergeJoinExec and ShuffledHashJoinExec for
    inner, left, right, full, left semi and left anti (and existence)
    joins over keys with NULLs and NaN, through both packages' planners;
  * the join nodes of the protobuf wire in both directions.

Tolerance: exact.  Rows are compared IN ORDER in every join case: the JAX
device route is ordered on every one (probe batches in order, each probe
row's matches in build order, unmatched probe rows after a batch's pairs,
unmatched build rows last; the merge join emits runs in key order), and
the port keeps that order."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.kernels import join as JK
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.kernels import join as TK

CPU = torch.device("cpu")
BATCH = 256


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    for c in (jconf, tconf):
        c.conf.set("auron.batch.size", BATCH)
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset("auron.batch.size")


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the probe kernels
# ---------------------------------------------------------------------------

def _build(rng, n, hi):
    build = rng.integers(0, hi, n).astype(np.int64)
    order = np.argsort(build, kind="stable")
    return build, order


@pytest.mark.parametrize("n,hi", [(300, 40), (1, 1), (5000, 7)])
def test_build_runs_exact(n, hi):
    build, order = _build(np.random.default_rng(n), n, hi)
    want = JK.build_runs(build[order])
    got = TK.build_runs(t(build[order]))
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_counts_exact(seed):
    rng = np.random.default_rng(seed)
    build, order = _build(rng, 300, 40)
    probe = rng.integers(0, 60, 500).astype(np.int64)
    null = rng.random(500) < 0.1
    uh, st, ct = JK.build_runs(build[order])
    ws, wc = JK.probe_counts(jnp.asarray(uh), jnp.asarray(st),
                             jnp.asarray(ct), jnp.asarray(probe),
                             jnp.asarray(null))
    gs, gc = TK.probe_counts(t(uh), t(st), t(ct), t(probe), t(null))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("cap", [4096, 1024, 8])
def test_expand_pairs_exact(cap):
    """At a cap past the total the pairs are complete; below it they are
    cut at `cap`, with the true total returned."""
    rng = np.random.default_rng(3)
    build, order = _build(rng, 300, 40)
    probe = rng.integers(0, 60, 500).astype(np.int64)
    null = rng.random(500) < 0.1
    uh, st, ct = JK.build_runs(build[order])
    s, c = JK.probe_counts(jnp.asarray(uh), jnp.asarray(st),
                           jnp.asarray(ct), jnp.asarray(probe),
                           jnp.asarray(null))
    want = JK.expand_pairs(s, c, cap)
    got = TK.expand_pairs(t(np.asarray(s)), t(np.asarray(c)), cap)
    assert int(got[3]) == int(want[3]) > 1024
    for g, w in zip(got[:3], want[:3]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _probe_both(build, probe, null):
    order = np.argsort(build, kind="stable")
    uh, st, ct = JK.build_runs(build[order])
    want = JK.probe_expand_device(jnp.asarray(uh), jnp.asarray(st),
                                  jnp.asarray(ct), order.astype(np.int32),
                                  jnp.asarray(probe), jnp.asarray(null))
    tuh, tst, tct = TK.build_runs(t(build[order]))
    got = TK.probe_expand_device(tuh, tst, tct, t(order.astype(np.int32)),
                                 t(probe), t(null))
    return got, want


def test_probe_expand_device_exact_in_order():
    rng = np.random.default_rng(0)
    build = rng.integers(0, 40, 300).astype(np.int64)
    probe = rng.integers(0, 60, 500).astype(np.int64)
    null = rng.random(500) < 0.1
    before = dict(TK.probe_calls)
    (gp, gb), (wp, wb) = _probe_both(build, probe, null)
    assert len(gp) > 0
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gb, wb)
    assert TK.probe_calls["cpu"] == before["cpu"] + 1
    assert TK.probe_calls["cuda"] == before["cuda"]


def test_probe_expand_cap_regrowth():
    """64 x 64 matches: 4096 pairs, past the first 1024-slot bucket."""
    build = np.zeros(64, dtype=np.int64)
    probe = np.zeros(64, dtype=np.int64)
    (gp, gb), (wp, wb) = _probe_both(build, probe, np.zeros(64, bool))
    assert len(gp) == 64 * 64
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gb, wb)


@pytest.mark.parametrize("probe_n", [0, 7])
def test_probe_expand_empty(probe_n):
    """An empty probe, and a probe that matches nothing."""
    build = np.arange(10, dtype=np.int64)
    probe = np.arange(100, 100 + probe_n, dtype=np.int64)
    (gp, gb), (wp, wb) = _probe_both(build, probe,
                                     np.zeros(probe_n, bool))
    assert len(gp) == len(wp) == 0 and len(gb) == len(wb) == 0


# ---------------------------------------------------------------------------
# JoinMap.lookup
# ---------------------------------------------------------------------------

def _key_tables(rng, kind):
    nb, npr = 400, 700
    if kind == "int":
        b = pa.array(rng.integers(0, 50, nb), mask=rng.random(nb) < 0.05)
        p = pa.array(rng.integers(0, 70, npr), mask=rng.random(npr) < 0.05)
        return pa.table({"k": b}), pa.table({"k": p})
    if kind == "float":
        pool = np.array([np.nan, -0.0, 0.0, 1.5, 2.5, -3.0, 7.0])
        b = pa.array(pool[rng.integers(0, len(pool), nb)],
                     mask=rng.random(nb) < 0.05)
        p = pa.array(pool[rng.integers(0, len(pool), npr)],
                     mask=rng.random(npr) < 0.05)
        return pa.table({"k": b}), pa.table({"k": p})
    if kind == "utf8":
        pool = np.array(["", "a", "ab", "天地", "x\x00y", "ü" * 20])
        b = pa.array(pool[rng.integers(0, len(pool), nb)].tolist(),
                     mask=rng.random(nb) < 0.05)
        p = pa.array(pool[rng.integers(0, len(pool), npr)].tolist(),
                     mask=rng.random(npr) < 0.05)
        return pa.table({"k": b}), pa.table({"k": p})
    bk = rng.integers(0, 5, nb)
    pk = rng.integers(0, 6, npr)
    return (pa.table({"k": pa.array(bk), "k2": pa.array(bk % 3 * 1.0)}),
            pa.table({"k": pa.array(pk), "k2": pa.array(pk % 2 * 1.0)}))


@pytest.mark.parametrize("kind", ["int", "float", "utf8", "two"])
def test_joinmap_lookup_exact(kind):
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.ops.joins.exec import JoinMap as JMap
    from blaze_tpu.ops.joins.exec import _device_hash_keys as jhash
    from blaze_tpu.schema import Schema as JSchema
    from blaze_tpu_torch.batch import ColumnBatch as TBatch
    from blaze_tpu_torch.exprs import BoundReference as TRef
    from blaze_tpu_torch.ops.joins.exec import JoinMap as TMap
    from blaze_tpu_torch.ops.joins.exec import _device_hash_keys as thash
    from blaze_tpu_torch.schema import Schema as TSchema
    build_t, probe_t = _key_tables(np.random.default_rng(11), kind)
    nkeys = build_t.num_columns
    jmap = JMap(build_t, [JRef(i) for i in range(nkeys)],
                JSchema.from_arrow(build_t.schema))
    h, nn, keys = jhash(JBatch.from_arrow(probe_t),
                        [JRef(i) for i in range(nkeys)])
    wp, wb = jmap.lookup(h, nn, keys)
    tmap = TMap(build_t, [TRef(i) for i in range(nkeys)],
                TSchema.from_arrow(build_t.schema))
    th, tnn, tkeys = thash(TBatch.from_arrow(probe_t, device=CPU),
                           [TRef(i) for i in range(nkeys)])
    np.testing.assert_array_equal(th.numpy(), np.asarray(h))
    np.testing.assert_array_equal(tnn.numpy(), np.asarray(nn))
    gp, gb = tmap.lookup(th, tnn, tkeys)
    assert len(gp) > 0
    np.testing.assert_array_equal(gp, np.asarray(wp))
    np.testing.assert_array_equal(gb, np.asarray(wb))
    assert tmap.has_null_keys == jmap.has_null_keys


# ---------------------------------------------------------------------------
# the join operators through both planners
# ---------------------------------------------------------------------------

def _schema_d(tbl):
    from blaze_tpu_torch.plan.types import schema_to_dict
    from blaze_tpu_torch.schema import Schema
    return schema_to_dict(Schema.from_arrow(tbl.schema))


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Left (2 files) and right (1 file) tables: int keys with NULLs,
    float keys with NaN, -0.0 and NULLs, utf8 payloads."""
    root = tmp_path_factory.mktemp("joins")
    rng = np.random.default_rng(2027)
    fpool = np.array([np.nan, -0.0, 0.0, 1.5, 2.5, -3.0])

    def table(n, hi, prefix):
        return pa.table({
            f"{prefix}k": pa.array(rng.integers(0, hi, n),
                                   mask=rng.random(n) < 0.08),
            f"{prefix}f": pa.array(fpool[rng.integers(0, len(fpool), n)],
                                   mask=rng.random(n) < 0.08),
            f"{prefix}v": pa.array(np.arange(n, dtype=np.int64)),
            f"{prefix}s": pa.array([f"s{i % 17}" for i in range(n)]),
        })
    left, right = table(900, 60, "l"), table(300, 45, "r")
    paths = {}
    for name, tbl, parts in (("left", left, 2), ("right", right, 1)):
        per = -(-tbl.num_rows // parts)
        groups = []
        for i in range(parts):
            p = str(root / f"{name}-{i}.parquet")
            pq.write_table(tbl.slice(i * per, per), p, row_group_size=200)
            groups.append([p])
        paths[name] = {"kind": "parquet_scan", "schema": _schema_d(tbl),
                       "file_groups": groups}
    return paths


def _collect(plan):
    out = []
    for p in range(plan.num_partitions):
        for b in plan.execute(p):
            rb = b.compact().to_arrow()
            if rb.num_rows:
                out.append(rb)
    return pa.Table.from_batches(out).combine_chunks()


def _run_both(d):
    from blaze_tpu.plan import create_plan as jcreate
    from blaze_tpu_torch.plan import create_plan as tcreate
    want = _collect(jcreate(d))
    got = _collect(tcreate(d))
    return got, want


def _assert_same_rows(got, want):
    assert got.num_rows == want.num_rows > 0
    assert got.column_names == want.column_names
    for name in got.column_names:
        g = got.column(name).to_pylist()
        w = want.column(name).to_pylist()
        same = [a == b or (a != a and b != b) for a, b in zip(g, w)]
        assert all(same), (name, same.index(False))


JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti",
              "existence"]


def _join(kind, sides, jt, key):
    lk = {"kind": "column", "name": "l" + key}
    rk = {"kind": "column", "name": "r" + key}
    d = {"kind": kind, "left": sides["left"], "right": sides["right"],
         "left_keys": [lk], "right_keys": [rk], "join_type": jt}
    if kind != "sort_merge_join":
        d["build_side"] = "right"
    return d


@pytest.mark.parametrize("key", ["k", "f"])
@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_broadcast_join_same_rows_in_order(sides, jt, key):
    got, want = _run_both(_join("broadcast_join", sides, jt, key))
    _assert_same_rows(got, want)


@pytest.mark.parametrize("jt,key", [(jt, "k") for jt in JOIN_TYPES]
                         + [(jt, "f") for jt in ("inner", "full",
                                                 "left_anti")])
def test_sort_merge_join_same_rows_in_order(sides, jt, key):
    one = dict(sides, left=dict(sides["left"], file_groups=[
        [f for g in sides["left"]["file_groups"] for f in g]]))
    got, want = _run_both(_join("sort_merge_join", one, jt, key))
    _assert_same_rows(got, want)


@pytest.mark.parametrize("jt", JOIN_TYPES)
def test_sort_merge_join_two_keys_and_a_filter(sides, jt):
    """The merge over a two-column key (the int key, then the float key
    with NaN, -0.0 and NULLs) with a join filter over both sides: the run
    walk's rows and order."""
    one = dict(sides, left=dict(sides["left"], file_groups=[
        [f for g in sides["left"]["file_groups"] for f in g]]))
    d = _join("sort_merge_join", one, jt, "k")
    d["left_keys"].append({"kind": "column", "name": "lf"})
    d["right_keys"].append({"kind": "column", "name": "rf"})
    d["join_filter"] = {"kind": "binary", "op": "<",
                        "l": {"kind": "column", "index": 2},
                        "r": {"kind": "column", "index": 6}}
    got, want = _run_both(d)
    _assert_same_rows(got, want)


@pytest.fixture(scope="module")
def hot(tmp_path_factory):
    """One hot key: 64 left and 4,000 right rows share key 5, among 60
    rows a side of keys 0-9 with NULLs, in shuffled order."""
    root = tmp_path_factory.mktemp("hot")
    rng = np.random.default_rng(2028)
    paths = {}
    for prefix, name, n_hot in (("l", "left", 64), ("r", "right", 4000)):
        k = np.concatenate([np.full(n_hot, 5), rng.integers(0, 10, 60)])
        perm = rng.permutation(len(k))
        tbl = pa.table({
            f"{prefix}k": pa.array(k[perm], mask=(perm >= n_hot + 50)),
            f"{prefix}v": pa.array(rng.integers(0, 1000, len(k))),
        })
        p = str(root / f"{name}.parquet")
        pq.write_table(tbl, p, row_group_size=500)
        paths[name] = {"kind": "parquet_scan", "schema": _schema_d(tbl),
                       "file_groups": [[p]]}
    return paths


def _lit(v):
    return {"kind": "literal", "value": v, "type": {"id": "int64"}}


@pytest.mark.parametrize("jt", ["inner", "full", "left_semi", "existence"])
def test_sort_merge_join_hot_key_in_bounded_memory(hot, jt):
    """A key run of 64 x 4,000 rows (256,000 candidate pairs) at a batch
    size of 256, through a join filter ((lv + rv) % 8 == 0): rows and
    order equal the JAX cursor's; a second run emits no batch of twice the
    batch size (the coalescing stream's bound), and the host arrays the
    merge holds at once (numpy's, as tracemalloc sees them) stay under
    1 MiB, where one int64 array over the candidate pairs is 2 MB."""
    import tracemalloc
    from blaze_tpu.plan import create_plan as jcreate
    from blaze_tpu_torch.plan import create_plan as tcreate
    d = _join("sort_merge_join", hot, jt, "k")
    col = lambda i: {"kind": "column", "index": i}  # noqa: E731
    d["join_filter"] = {
        "kind": "binary", "op": "==", "r": _lit(0),
        "l": {"kind": "binary", "op": "%", "r": _lit(8),
              "l": {"kind": "binary", "op": "+", "l": col(1),
                    "r": col(3)}}}
    got, want = _run_both(d)
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows > 64
    for name in got.column_names:
        assert got.column(name).equals(want.column(name)), name
    plan = tcreate(d)
    rows = 0
    tracemalloc.start()
    try:
        for p in range(plan.num_partitions):
            for b in plan.execute(p):
                assert b.num_rows < 2 * BATCH
                rows += b.selected_count()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert rows == want.num_rows
    assert peak < 1 << 20, peak


@pytest.mark.parametrize("jt", ["full", "left_anti"])
def test_merge_reads_its_sides_a_batch_at_a_time(jt):
    """The merge of two sorted inputs of 40 batches each emits its first
    rows after reading a few of their batches, and holds no more than two
    batches of a side at once."""
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.joins.exec import JoinType
    from blaze_tpu_torch.ops.joins.smj import MergeJoiner, _Side
    from blaze_tpu_torch.schema import Schema
    rng = np.random.default_rng(7)
    read = {"left": 0, "right": 0}

    def side(name, step):
        keys = np.sort(rng.integers(0, 40 * BATCH // step, 40 * BATCH))
        tbl = pa.table({name[0] + "k": keys,
                        name[0] + "v": np.arange(len(keys))})
        for rb in tbl.to_batches(max_chunksize=BATCH):
            read[name] += 1
            yield ColumnBatch.from_arrow(rb)

    schemas = [Schema.from_arrow(pa.schema([(p + "k", pa.int64()),
                                             (p + "v", pa.int64())]))
               for p in "lr"]
    out = Schema.from_arrow(pa.schema(
        [f.to_arrow() for s in (schemas if jt == "full" else schemas[:1])
         for f in s]))
    left = _Side(side("left", 2), [BoundReference(0)], schemas[0])
    right = _Side(side("right", 3), [BoundReference(0)], schemas[1])
    joiner = MergeJoiner(schemas[0], schemas[1], out, JoinType(jt), None)
    stream = joiner.join(left, right)
    next(stream)
    assert read["left"] <= 2 and read["right"] <= 2
    held = 0
    for _ in stream:
        held = max(held, left.num_rows, right.num_rows)
    assert read == {"left": 40, "right": 40}
    assert held <= 2 * BATCH


def test_smj_walk_script_at_a_small_scale(capsys):
    """`python -m blaze_tpu_torch.itest.smj_walk` at 0.2% of q51's rows
    on the CPU: both runs give the full outer join's row count, the same
    rows in order."""
    import json
    from blaze_tpu_torch.itest import smj_walk
    assert smj_walk.main(["--scale", "0.002", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["same_rows_in_order"]
    assert [r["rows"] for r in out["runs"]] == [
        int(smj_walk.OUT_ROWS * 0.002)] * 2


@pytest.mark.parametrize("jt", ["inner", "full", "left_anti"])
def test_shuffled_hash_join_same_rows_in_order(sides, jt):
    one = dict(sides, left=dict(sides["left"], file_groups=[
        [f for g in sides["left"]["file_groups"] for f in g]]))
    got, want = _run_both(_join("hash_join", one, jt, "k"))
    _assert_same_rows(got, want)


@pytest.mark.parametrize("kind", ["broadcast_join", "hash_join",
                                  "sort_merge_join"])
@pytest.mark.parametrize("jt", ["left_semi", "left_anti", "existence",
                                "full"])
def test_joins_count_the_rows_they_emit(sides, kind, jt):
    """`output_rows` of a semi, anti, existence and full join equals the
    rows it emits, and the JAX operator's output length."""
    from blaze_tpu.plan import create_plan as jcreate
    from blaze_tpu_torch.plan import create_plan as tcreate
    one = dict(sides, left=dict(sides["left"], file_groups=[
        [f for g in sides["left"]["file_groups"] for f in g]]))
    d = _join(kind, one, jt, "k")
    plan = tcreate(d)
    got = _collect(plan)
    assert plan.metrics.values["output_rows"] == got.num_rows \
        == _collect(jcreate(d)).num_rows > 0


def test_broadcast_join_with_filter_and_utf8_key(sides):
    """A join filter over both sides, and a utf8 join key."""
    d = _join("broadcast_join", sides, "inner", "s")
    d["right_keys"] = [{"kind": "column", "name": "rs"}]
    d["join_filter"] = {"kind": "binary", "op": "<",
                        "l": {"kind": "column", "index": 2},
                        "r": {"kind": "column", "index": 6}}
    got, want = _run_both(d)
    _assert_same_rows(got, want)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _wire_cases(sides):
    flt = {"kind": "binary", "op": ">", "l": {"kind": "column", "index": 0},
           "r": {"kind": "literal", "value": 3, "type": {"id": "int64"}}}
    bj = _join("broadcast_join", sides, "left", "k")
    bj["broadcast_id"] = "bhj-wire-1"
    bj["build_side"] = "left"
    hj = _join("hash_join", sides, "full", "k")
    hj["join_filter"] = flt
    smj = _join("sort_merge_join", sides, "left_anti", "f")
    smj["join_filter"] = flt
    ex = _join("broadcast_join", sides, "existence", "k")
    bhm = {"kind": "broadcast_join_build_hash_map", "input": sides["right"],
           "keys": [{"kind": "column", "index": 0}]}
    return {"broadcast": bj, "hash": hj, "smj": smj, "existence": ex,
            "build_hash_map": bhm}


@pytest.mark.parametrize("case", ["broadcast", "hash", "smj", "existence",
                                  "build_hash_map"])
def test_join_wire_round_trip(sides, case):
    """The JAX package's bytes decode in the port to the dict the JAX
    package decodes, and the port's bytes decode in the JAX package to
    the same dict."""
    from blaze_tpu.plan import proto_serde as JS
    from blaze_tpu_torch.plan import proto_serde as TS
    d = _wire_cases(sides)[case]
    for k in ("left", "right", "input"):
        if k in d:  # the wire carries one file group per task
            d[k] = dict(d[k], file_groups=[d[k]["file_groups"][0]])
    jbytes = JS.plan_to_proto(d).SerializeToString()
    want = JS.plan_from_proto(JS.pb.PhysicalPlanNode.FromString(jbytes))
    got = TS.plan_from_proto(TS.pb.PhysicalPlanNode.FromString(jbytes))
    assert got == want
    tbytes = TS.plan_to_proto(d).SerializeToString()
    assert JS.plan_from_proto(JS.pb.PhysicalPlanNode.FromString(tbytes)) \
        == want
    assert tbytes == jbytes


def test_keyless_join_raises_naming_bnlj(sides):
    """A keyless broadcast join is the wire's nested-loop join: the port
    encodes it to the JAX package's bytes and both decode it as a
    broadcast_nested_loop_join (ops/joins/bnlj.py), while an equi-join
    operator built with no keys raises, naming that node."""
    from blaze_tpu.plan import proto_serde as JS
    from blaze_tpu_torch.ops.joins import BroadcastJoinExec, JoinType
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan import proto_serde as TS
    d = _join("broadcast_join", sides, "inner", "k")
    d["left_keys"], d["right_keys"] = [], []
    for k in ("left", "right"):  # the wire carries one file group per task
        d[k] = dict(d[k], file_groups=[d[k]["file_groups"][0]])
    tbytes = TS.plan_to_proto(d).SerializeToString()
    assert tbytes == JS.plan_to_proto(d).SerializeToString()
    got = TS.plan_from_proto(TS.pb.PhysicalPlanNode.FromString(tbytes))
    assert got == JS.plan_from_proto(JS.pb.PhysicalPlanNode.FromString(
        tbytes))
    assert got["kind"] == "broadcast_nested_loop_join"
    left, right = create_plan(d["left"]), create_plan(d["right"])
    with pytest.raises(ValueError, match="broadcast_nested_loop_join"):
        BroadcastJoinExec(left, right, [], [], JoinType.INNER)
