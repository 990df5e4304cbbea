"""The port's generic aggregation engine (blaze_tpu_torch/ops/agg/exec.py
`AggExec`, with ops/agg/functions.py) against the JAX package's
(blaze_tpu/ops/agg/exec.py) on the same numpy-seeded batches: partial,
partial_merge, final and complete modes with sum, count, count(*), min,
max and avg over int and float columns (NULL values, NaN, -0.0, NULL and
NaN keys, rows masked by a filter); global aggregation, also over empty
input; the partial-skipping probe in both of its outcomes (pass-through
and not); and buffer combining over more than 8 batches.

Output must equal the reference's row for row: keys, counts and integer
results exact, float results within 1e-12 relative (the same summation
order on both CPUs, so they come out equal in practice), NULLs where
NULLs."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import BinaryExpr as JBinary
from blaze_tpu.exprs import BoundReference as JRef
from blaze_tpu.exprs import Literal as JLit
from blaze_tpu.ops.agg import exec as JA
from blaze_tpu.ops.agg.functions import make_agg as j_make_agg
from blaze_tpu.ops.basic import FilterExec as JFilter
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import BinaryExpr as TBinary
from blaze_tpu_torch.exprs import BoundReference as TRef
from blaze_tpu_torch.exprs import Literal as TLit
from blaze_tpu_torch.ops.agg import exec as TA
from blaze_tpu_torch.ops.agg.functions import make_agg as t_make_agg
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import FilterExec as TFilter
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
#: (fn, input column) of the aggregations under test; None is count(*)
FNS = [("sum", 2), ("count", 2), ("count", None), ("min", 2), ("max", 2),
       ("avg", 2), ("avg", 3), ("sum", 3), ("min", 3), ("max", 3)]


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


@pytest.fixture(autouse=True)
def _cpu():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _set_both(confs):
    for c in (jconf, tconf):
        for k, v in confs.items():
            c.conf.set(k, v)


def _unset_both(confs):
    for c in (jconf, tconf):
        for k in confs:
            c.conf.unset(k)


def _raw_batches(rng, n_batches, rows, distinct=6):
    """(k0 int64 with NULLs, k1 float64 with NaN/-0.0/NULL, x float64 with
    NULL/NaN/-0.0, i int32 with NULL, m bool filter column)."""
    out = []
    for _ in range(n_batches):
        k0 = rng.integers(0, distinct, rows)
        k1 = (rng.integers(0, 3, rows) - 1).astype(np.float64)
        k1[rng.random(rows) < 0.1] = np.nan
        k1[rng.random(rows) < 0.1] = -0.0
        x = np.round(rng.normal(size=rows) * 100, 2)
        x[rng.random(rows) < 0.03] = np.nan
        x[rng.random(rows) < 0.05] = -0.0
        cols = {"k0": pa.array(k0, mask=rng.random(rows) < 0.08),
                "k1": pa.array(k1, mask=rng.random(rows) < 0.08),
                "x": pa.array(x, mask=rng.random(rows) < 0.1),
                "i": pa.array(rng.integers(-1000, 1000, rows)
                              .astype(np.int32), mask=rng.random(rows) < 0.1),
                "m": pa.array(rng.random(rows) < 0.8)}
        out.append(pa.record_batch(cols))
    return out


def _run(pkg, batches, schema, keys, fns, mode, filtered=False):
    """One AggExec over `batches` in package `pkg` ("jax" or "torch");
    returns its output as one Arrow table and its metrics."""
    if pkg == "jax":
        src = MemoryScanExec(JSchema.from_arrow(schema),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        ref, lit, binary, make, Filter, Agg, Mode = (
            JRef, JLit, JBinary, j_make_agg, JFilter, JA.AggExec, JA.AggMode)
    else:
        src = _Source(batches, schema)
        ref, lit, binary, make, Filter, Agg, Mode = (
            TRef, TLit, TBinary, t_make_agg, TFilter, TA.AggExec, TA.AggMode)
    if filtered:
        # rows where m is true survive; the rest stay masked in the batch
        src = Filter(src, [binary("==", ref(schema.get_field_index("m")),
                                  lit(True, _bool(pkg)))])
    groups = [(ref(k), f"g{k}") for k in keys]
    aggs = []
    for j, (fn, args) in enumerate(fns):
        children = [ref(a) for a in args]
        aggs.append((make(fn, children), Mode(mode), f"a{j}"))
    op = Agg(src, groups, aggs)
    out = [b.to_arrow() for b in op.execute(0)]
    tbl = (pa.Table.from_batches(out) if out else
           op.schema.to_arrow().empty_table())
    return tbl.combine_chunks(), op.metrics


def _bool(pkg):
    if pkg == "jax":
        from blaze_tpu.schema import BOOL
    else:
        from blaze_tpu_torch.schema import BOOL
    return BOOL


def _assert_same_table(t, j):
    assert t.schema.names == j.schema.names
    assert t.num_rows == j.num_rows
    for name in j.schema.names:
        a, b = t[name], j[name]
        assert a.type == b.type, name
        assert np.array_equal(np.asarray(a.is_null()),
                              np.asarray(b.is_null())), name
        if pa.types.is_floating(b.type):
            x = np.asarray(a.fill_null(0.0))
            y = np.asarray(b.fill_null(0.0))
            assert np.array_equal(np.isnan(x), np.isnan(y)), name
            ok = ~np.isnan(y)
            np.testing.assert_allclose(x[ok], y[ok], rtol=1e-12, atol=0,
                                       err_msg=name)
        else:
            assert a.equals(b), name


def _both(batches, keys, fns, mode, filtered=False):
    schema = batches[0].schema if batches else _SCHEMA
    t, tm = _run("torch", batches, schema, keys, fns, mode, filtered)
    j, jm = _run("jax", batches, schema, keys, fns, mode, filtered)
    _assert_same_table(t, j)
    return t, tm, jm


_SCHEMA = pa.schema([("k0", pa.int64()), ("k1", pa.float64()),
                     ("x", pa.float64()), ("i", pa.int32()),
                     ("m", pa.bool_())])


def _fn_args(fns):
    return [(fn, [] if col is None else [col]) for fn, col in fns]


@pytest.mark.parametrize("mode", ["partial", "complete"])
@pytest.mark.parametrize("keys", [[0], [0, 1], [1]])
@pytest.mark.parametrize("filtered", [False, True])
def test_raw_modes_match_jax(mode, keys, filtered):
    rng = np.random.default_rng(len(keys) * 10 + filtered)
    batches = _raw_batches(rng, 4, 300)
    t, _tm, _jm = _both(batches, keys, _fn_args(FNS), mode, filtered)
    assert t.num_rows > 0


def _partials(rng, keys, chunks=3):
    """JAX partial outputs of several chunks of raw batches, concatenated:
    accumulator batches whose groups repeat across chunks."""
    outs = []
    for _ in range(chunks):
        batches = _raw_batches(rng, 2, 250)
        j, _m = _run("jax", batches, batches[0].schema, keys, _fn_args(FNS),
                     "partial")
        outs.append(j)
    tbl = pa.concat_tables(outs)
    return tbl.to_batches(max_chunksize=200), tbl.schema


def _merge_fns(keys):
    """The merge-mode argument columns of FNS: each agg's accumulator
    columns, positionally after the keys (avg has two)."""
    out, pos = [], len(keys)
    for fn, _col in FNS:
        nacc = 2 if fn == "avg" else 1
        out.append((fn, list(range(pos, pos + nacc))))
        pos += nacc
    return out


@pytest.mark.parametrize("mode", ["partial_merge", "final"])
@pytest.mark.parametrize("keys", [[0], [0, 1]])
def test_merge_modes_match_jax(mode, keys):
    rng = np.random.default_rng(40 + len(keys))
    batches, schema = _partials(rng, keys)
    merge_keys = list(range(len(keys)))
    t, _ = _run("torch", batches, schema, merge_keys, _merge_fns(keys), mode)
    j, _ = _run("jax", batches, schema, merge_keys, _merge_fns(keys), mode)
    _assert_same_table(t, j)
    assert t.num_rows < sum(b.num_rows for b in batches)


@pytest.mark.parametrize("mode", ["partial", "complete"])
@pytest.mark.parametrize("empty", [False, True])
def test_global_aggregation_matches_jax(mode, empty):
    rng = np.random.default_rng(9)
    batches = [] if empty else _raw_batches(rng, 3, 200)
    t, _tm, _jm = _both(batches, [], _fn_args(FNS), mode)
    assert t.num_rows == 1


def test_global_aggregation_all_rows_filtered():
    rng = np.random.default_rng(10)
    batches = [rb.set_column(4, "m", pa.array(np.zeros(rb.num_rows, bool)))
               for rb in _raw_batches(rng, 2, 100)]
    t, _tm, _jm = _both(batches, [], _fn_args(FNS), "complete",
                        filtered=True)
    assert t.num_rows == 1
    row = t.to_pylist()[0]
    assert row["a1"] == row["a2"] == 0 and row["a0"] is None


def test_global_final_over_empty_input():
    schema = pa.schema([("s", pa.float64()), ("c", pa.int64())])
    fns = [("sum", [0]), ("count", [1]), ("avg", [0, 1])]
    t, _ = _run("torch", [], schema, [], fns, "final")
    j, _ = _run("jax", [], schema, [], fns, "final")
    _assert_same_table(t, j)
    assert t.to_pylist() == [{"a0": None, "a1": 0, "a2": None}]


@pytest.mark.parametrize("distinct,skips", [(100_000, True), (5, False)])
def test_partial_skipping_probe_matches_jax(distinct, skips):
    confs = {"auron.tpu.partialAgg.skipping.minRows": 500,
             "auron.tpu.partialAgg.skipping.ratio": 0.5}
    _set_both(confs)
    try:
        rng = np.random.default_rng(distinct)
        batches = _raw_batches(rng, 6, 200, distinct=distinct)
        t, tm, jm = _both(batches, [0], _fn_args(FNS), "partial")
    finally:
        _unset_both(confs)
    assert tm.get("partial_skipped") == jm.get("partial_skipped") == int(
        skips)
    assert tm.get("passthrough_rows") == jm.get("passthrough_rows")
    assert (tm.get("passthrough_rows") > 0) == skips


def test_buffer_combining_over_many_batches_matches_jax():
    """auron.batch.size 16: the buffer re-merges whenever it holds 128
    group rows, several times over 12 batches."""
    confs = {"auron.batch.size": 16}
    _set_both(confs)
    try:
        rng = np.random.default_rng(77)
        batches = _raw_batches(rng, 12, 60, distinct=40)
        t, _tm, _jm = _both(batches, [0], _fn_args(FNS), "partial")
    finally:
        _unset_both(confs)
    assert len(batches) > 8 and 0 < t.num_rows <= 41


def test_avg_result_type_and_decimal_raise():
    from blaze_tpu_torch.ops.agg import AvgAgg
    from blaze_tpu_torch.schema import DataType, Field, TypeId
    schema = TSchema([Field("d", DataType(TypeId.DECIMAL, 10, 2)),
                      Field("i", DataType(TypeId.INT32))])
    assert AvgAgg([TRef(1)]).output_type(schema).id == TypeId.FLOAT64
    assert [f.data_type.id for f in AvgAgg([TRef(1)]).acc_fields(schema)] \
        == [TypeId.INT64, TypeId.INT64]
    # a decimal no longer raises (the decimal slice): the JAX package's
    # decimal(p + 10, s) sum and decimal(p + 4, s + 4) result
    assert [f.data_type for f in AvgAgg([TRef(0)]).acc_fields(schema)] \
        == [DataType(TypeId.DECIMAL, 18, 2), DataType(TypeId.INT64)]
    assert AvgAgg([TRef(0)]).output_type(schema) == \
        DataType(TypeId.DECIMAL, 14, 6)
    with pytest.raises(NotImplementedError, match="item 16"):
        t_make_agg("udaf", [TRef(1)])
    # first and collect_list are ported with the strings slice
    assert t_make_agg("first", [TRef(1)]).output_type(schema).id == \
        TypeId.INT32
    assert t_make_agg("collect_list", [TRef(1)]).is_host


@pytest.mark.parametrize("case", ["avg", "global", "avg_final", "mixed"])
def test_fuse_plan_leaves_avg_and_global_aggregations_to_aggexec(tmp_path,
                                                                  case):
    """avg never fuses and a global aggregation never fuses, in either
    package: the node stays the generic AggExec (and a keyed sum beside it
    fuses, as before)."""
    import pyarrow.parquet as pq
    from blaze_tpu.plan.fused import fuse_plan as j_fuse
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec, fuse_plan
    from blaze_tpu_torch.plan.planner import create_plan

    rng = np.random.default_rng(1)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"k": rng.integers(0, 1 << 40, 500),
                             "x": rng.random(500)}), path)
    scan = {"kind": "parquet_scan", "file_groups": [[path]],
            "schema": {"fields": [
                {"name": "k", "type": {"id": "int64"}, "nullable": True},
                {"name": "x", "type": {"id": "float64"}, "nullable": True}]}}
    col = {"k": {"kind": "column", "name": "k"},
           "x": {"kind": "column", "name": "x"}}
    groups = [] if case == "global" else [{"expr": col["k"], "name": "k"}]
    fns = {"avg": [("avg", "partial", [col["x"]])],
           "global": [("sum", "partial", [col["x"]]),
                      ("count", "partial", [col["x"]])],
           "avg_final": [("avg", "final", [{"kind": "column", "index": 1},
                                           {"kind": "column", "index": 1}])],
           "mixed": [("sum", "partial", [col["x"]]),
                     ("avg", "partial", [col["x"]])]}[case]
    plan = {"kind": "hash_agg", "input": scan, "groupings": groups,
            "aggs": [{"fn": f, "mode": m, "name": f"a{i}", "args": a}
                     for i, (f, m, a) in enumerate(fns)]}
    fused = fuse_plan(create_plan(plan))
    assert type(fused) is TA.AggExec
    assert not isinstance(fused, FusedPartialAggExec)
    assert type(j_fuse(j_create(plan))) is JA.AggExec
    if case == "avg":
        plan["aggs"] = [{"fn": "sum", "mode": "partial", "name": "s",
                         "args": [col["x"]]}]
        assert isinstance(fuse_plan(create_plan(plan)), FusedPartialAggExec)
