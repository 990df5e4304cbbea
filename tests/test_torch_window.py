"""The port's window operator (blaze_tpu_torch/ops/window.py) against the
JAX package's (blaze_tpu/ops/window.py WindowExec) on the same sorted
Arrow batches, made from numpy seeds, and the window node of the wire
against the JAX `proto_serde`.

  * the rank family (row_number, rank, dense_rank, percent_rank,
    cume_dist), a window group limit, lead/lag (with a default, over int
    and utf8), nth_value with and without IGNORE NULLS, and running and
    whole-partition sum, count, count(*), avg, min and max over int64 and
    float64 columns with nulls and a NaN; no partition key, a utf8
    partition key with nulls, no order key;
  * partitions that span batches, and the flush at 4 x `auron.batch.size`,
    against the JAX package at the same batch size and against the port
    in one batch;
  * the JAX package as its own tests run it on the CPU (its host route)
    and, for two cases, on its device route
    (`blaze_tpu.bridge.placement.host_resident` patched to False);
  * the wire: every function kind and `group_limit` encode to the JAX
    package's bytes, and the same bytes decode to equal dicts in both;
    a whole-partition aggregate with an order refuses to encode in both;
  * a decimal argument raises, naming ROADMAP item 13.

Tolerance: integer and rank columns, validity and row order exact;
float64 columns within the runner's cell rule |a - b| <= rel * max(1,
|a|, |b|) with rel 1e-9 (a NaN equals only a NaN): the JAX device
route's cumulative sum adds in another order than numpy's and torch's."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu import exprs as JE
from blaze_tpu import schema as JS
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.ops import make_agg as j_make_agg
from blaze_tpu.ops import window as JW
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import decode_task_definition as j_decode
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import exprs as TE
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.ops import window as TW
from blaze_tpu_torch.ops.agg import make_agg as t_make_agg
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.sort import host_sort_keys, lexsort_host
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.planner import create_plan
from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode
from blaze_tpu_torch.plan.types import schema_to_dict
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
REL = 1e-9
G, O, V, X, S, U = range(6)  # group, order, int, float, utf8 key,
#                              utf8 payload


@pytest.fixture(autouse=True)
def confs():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.BATCH_SIZE.key)


def _sorted(t, part, order, desc=False):
    """`t` sorted by the partition column `part` (ascending, nulls first)
    and then `order` (ascending nulls first, or descending nulls last);
    None skips a key."""
    cols, descs, nfs = [], [], []
    for c, d in ((part, False), (order, desc)):
        if c is not None:
            cols.append(c)
            descs.append(d)
            nfs.append(not d)
    if not cols:
        return t
    rb = t.combine_chunks().to_batches()[0]
    return t.take(pa.array(lexsort_host(host_sort_keys(rb, cols, descs,
                                                       nfs))))


def _table(seed, n, n_groups, part, order, desc=False):
    """n rows sorted as `_sorted` says, with a NaN in column x in the
    last partition (a NaN in an earlier one spoils the JAX package's
    float sums of every later partition: test_a_nan_stays_in_its_partition
    pins that)."""
    rng = np.random.default_rng(seed)
    names = np.array(["TX", "OH", "", "ß€", "IL"], dtype=object)
    t = _sorted(pa.table({
        "g": pa.array(rng.integers(0, n_groups, n), mask=rng.random(n) < 0.05),
        "o": pa.array(rng.integers(0, 8, n).astype(np.int32)),
        "v": pa.array(rng.integers(-50, 100, n), mask=rng.random(n) < 0.15),
        "x": pa.array(np.round(rng.normal(size=n) * 50, 2),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(names[rng.integers(0, len(names), n)],
                      type=pa.string(), mask=rng.random(n) < 0.1),
        "w": pa.array([f"w{i}" for i in rng.integers(0, 30, n)],
                      mask=rng.random(n) < 0.1),
    }), part, order, desc)
    x = t.column("x").combine_chunks()
    vals = x.fill_null(0).to_numpy(zero_copy_only=False).copy()
    vals[-1] = np.nan
    t = t.set_column(X, "x", pa.array(vals, mask=~np.asarray(x.is_valid())
                                      & (np.arange(n) < n - 1)))
    return _sorted(t, part, order, desc)


class _Source(ExecutionPlan):
    """Fixed Arrow batches as port batches on the CPU (one partition)."""

    def __init__(self, schema, batches):
        super().__init__()
        self._schema = TSchema.from_arrow(schema)
        self._batches = list(batches)

    @property
    def schema(self):
        return self._schema

    def execute(self, partition):
        for rb in self._batches:
            yield TBatch.from_arrow(rb, device=CPU)


def _funcs(case, W, E, make_agg):
    """The window functions of `case` for a package (window module W,
    exprs E, its make_agg)."""
    R = W.WindowRankType
    ref = E.BoundReference
    if case in ("rank family", "no partition", "utf8 partition",
                "no order"):
        return [W.RankFunc("rn", R.ROW_NUMBER), W.RankFunc("rk", R.RANK),
                W.RankFunc("dr", R.DENSE_RANK),
                W.RankFunc("pr", R.PERCENT_RANK),
                W.RankFunc("cd", R.CUME_DIST),
                W.WindowAggFunc("rs", make_agg("sum", [ref(V)]), True),
                W.WindowAggFunc("wx", make_agg("max", [ref(X)]), False)]
    if case == "group limit":
        return [W.RankFunc("rk", R.RANK), W.RankFunc("rn", R.ROW_NUMBER)]
    if case == "lead lag nth":
        return [W.LeadLagFunc("ld", ref(V), 1),
                W.LeadLagFunc("lg", ref(V), -2, -99),
                W.LeadLagFunc("lds", ref(U), 3),
                W.NthValueFunc("n2", ref(V), 2),
                W.NthValueFunc("n3i", ref(V), 3, ignore_nulls=True),
                W.NthValueFunc("n1s", ref(U), 1, ignore_nulls=True)]
    running = case == "running aggs"
    out = []
    for fn in ("sum", "count", "avg", "min", "max"):
        for col, tag in ((V, "v"), (X, "x")):
            out.append(W.WindowAggFunc(f"{fn}_{tag}",
                                       make_agg(fn, [ref(col)]), running))
    out.append(W.WindowAggFunc("count_star", make_agg("count", []), running))
    return out


#: case -> (partition column, order column, order descending, group limit)
CASES = {
    "rank family": (G, O, False, None),
    "group limit": (G, O, False, 2),
    "lead lag nth": (G, O, False, None),
    "running aggs": (G, O, False, None),
    "whole aggs": (G, O, False, None),
    "no partition": (None, O, False, None),
    "utf8 partition": (S, X, True, None),
    "no order": (G, None, False, None),
}


def _specs(E, case):
    part, order, desc, limit = CASES[case]
    ref = E.BoundReference
    return ([ref(part)] if part is not None else [],
            [(ref(order), desc, not desc)] if order is not None else [],
            limit)


def _run(pkg, case, table, chunk):
    batches = table.to_batches(max_chunksize=chunk)
    if pkg == "jax":
        src = MemoryScanExec(JS.Schema.from_arrow(table.schema),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        part, order, limit = _specs(JE, case)
        op = JW.WindowExec(src, _funcs(case, JW, JE, j_make_agg), part,
                           order, group_limit=limit)
    else:
        part, order, limit = _specs(TE, case)
        op = TW.WindowExec(_Source(table.schema, batches),
                           _funcs(case, TW, TE, t_make_agg), part, order,
                           group_limit=limit)
    out = [b.compact().to_arrow() for b in op.execute(0)]
    return op, pa.Table.from_batches(out).combine_chunks()


def _assert_same(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows > 0
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_valid().equals(w.is_valid()), name
        if pa.types.is_floating(w.type):
            a = g.fill_null(0).to_numpy()
            b = w.fill_null(0).to_numpy()
            close = np.abs(a - b) <= REL * np.maximum(
                1.0, np.maximum(np.abs(a), np.abs(b)))
            assert ((a == b) | (np.isnan(a) & np.isnan(b)) | close).all(), \
                name
        else:
            assert g.equals(w), name


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_equals_jax(case):
    part, order, desc, _ = CASES[case]
    table = _table(len(case), 600, 12, part, order, desc)
    t_op, got = _run("torch", case, table, 128)
    _j_op, want = _run("jax", case, table, 128)
    _assert_same(got, want)
    assert t_op.metrics.values["cpu_batches"] == 1
    assert t_op.metrics.values["output_rows"] == got.num_rows


@pytest.mark.parametrize("case", ["rank family", "running aggs"])
def test_window_equals_the_jax_device_route(case, monkeypatch):
    import blaze_tpu.bridge.placement as P
    monkeypatch.setattr(P, "host_resident", lambda: False)
    part, order, desc, _ = CASES[case]
    table = _table(7, 300, 6, part, order, desc)
    _assert_same(_run("torch", case, table, 100)[1],
                 _run("jax", case, table, 100)[1])


def test_group_limit_keeps_ranks_up_to_k():
    table = _table(3, 600, 12, G, O)
    _op, got = _run("torch", "group limit", table, 128)
    assert max(got.column("rk").to_pylist()) <= 2
    _op, whole = _run("torch", "rank family", table, 128)
    assert got.num_rows == sum(r <= 2 for r in whole.column("rk")
                               .to_pylist())


@pytest.mark.parametrize("case", ["rank family", "running aggs",
                                  "lead lag nth"])
@pytest.mark.parametrize("batch_size", [64, 200])
def test_streaming_flush_equals_jax_and_one_shot(case, batch_size):
    """4,000 rows in 150 partitions arrive in batches of 50: partitions
    span batches, and the buffer flushes at every 4 x batch_size rows at
    the last partition start."""
    table = _table(11, 4000, 150, G, O)
    for c in (jconf, tconf):
        c.conf.set(c.BATCH_SIZE.key, batch_size)
    t_op, got = _run("torch", case, table, 50)
    _j_op, want = _run("jax", case, table, 50)
    _assert_same(got, want)
    assert t_op.metrics.values["cpu_batches"] > 1
    tconf.conf.set(tconf.BATCH_SIZE.key, 1 << 20)
    one_op, one = _run("torch", case, table, 50)
    assert one_op.metrics.values["cpu_batches"] == 1
    _assert_same(got, one)


@pytest.mark.parametrize("value", [float("nan"), float("inf")])
def test_a_nan_stays_in_its_partition(value):
    """A NaN (or an infinity) in the first of two partitions of one batch:
    the port's running and whole-partition sums of the second partition
    equal pandas' sums of its own rows, where the JAX package's are NaN
    (its `_segmented_cumsum` subtracts a base from a global cumsum that
    the NaN has poisoned; ROADMAP Queue 3)."""
    t = pa.table({"g": pa.array([1, 1, 2, 2, 2]),
                  "o": pa.array(np.arange(5, dtype=np.int32)),
                  "v": pa.array([1, 2, 3, 4, 5]),
                  "x": pa.array([1.5, value, 2.0, 3.25, -1.0]),
                  "s": pa.array(["a"] * 5), "w": pa.array(["b"] * 5)})
    _op, got = _run("torch", "running aggs", t, 5)
    _op, whole = _run("torch", "whole aggs", t, 5)
    _op, want = _run("jax", "running aggs", t, 5)
    second = slice(2, 5)
    assert got.column("sum_x").to_pylist()[second] == [2.0, 5.25, 4.25]
    assert got.column("avg_x").to_pylist()[second] == [2.0, 2.625,
                                                       4.25 / 3]
    assert whole.column("sum_x").to_pylist()[second] == [4.25] * 3
    first = got.column("sum_x").to_pylist()[:2]
    assert first[0] == 1.5 and (first[1] != first[1] if value != value
                                else first[1] == value)
    assert all(v != v for v in want.column("sum_x").to_pylist()[second])
    # int sums, counts and min/max agree either way
    names = ["sum_v", "count_x", "count_star", "max_x", "min_x"]
    _assert_same(got.select(names), want.select(names))


@pytest.mark.parametrize("running", [True, False])
def test_min_max_at_the_ends_of_int64(running):
    """Running and whole-partition min and max over int64 values at the
    type's ends, with NULLs, in two partitions of one batch: each equals
    numpy's over the partition's valid rows up to the row (or all of
    them).  (The JAX package's min negates its values, and -(-2**63)
    wraps back to -2**63, so it is not the reference here.)"""
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    vals = [5, lo, None, 7, None, hi, lo + 1, lo, 3]
    g = [1, 1, 1, 1, 2, 2, 2, 2, 2]
    t = pa.table({"g": pa.array(g),
                  "o": pa.array(np.arange(len(g), dtype=np.int32)),
                  "v": pa.array(vals, type=pa.int64()),
                  "x": pa.array(np.arange(len(g), dtype=np.float64)),
                  "s": pa.array(["a"] * len(g)),
                  "w": pa.array(["b"] * len(g))})
    _op, got = _run("torch", "running aggs" if running else "whole aggs",
                    t, len(g))
    for fn, ext in (("min", min), ("max", max)):
        want = []
        for i, gi in enumerate(g):
            rows = [j for j in range(len(g)) if g[j] == gi
                    and (j <= i or not running) and vals[j] is not None]
            want.append(ext(vals[j] for j in rows) if rows else None)
        assert got.column(f"{fn}_v").to_pylist() == want, fn


def test_window_of_no_rows():
    table = _table(1, 10, 3, G, O).slice(0, 0)
    op = TW.WindowExec(
        _Source(table.schema, []),
        _funcs("rank family", TW, TE, t_make_agg), [TE.BoundReference(G)],
        [(TE.BoundReference(O), False, True)])
    assert list(op.execute(0)) == []
    assert [f.name for f in op.schema][-7:] == ["rn", "rk", "dr", "pr", "cd",
                                               "rs", "wx"]


def test_decimal_argument_names_item_13():
    """A decimal argument no longer raises (the decimal slice, once
    ROADMAP item 13): max and lag keep the decimal(12,2) type and values
    (tests/test_torch_decimal_paths.py holds sums and averages against a
    Decimal reference)."""
    schema = pa.schema([("g", pa.int64()), ("d", pa.decimal128(12, 2))])
    d = TE.BoundReference(1)
    import decimal
    vals = [decimal.Decimal(v) for v in ("1.25", "-3.50", "2.00", "0.01")]
    rb = pa.record_batch([pa.array([1, 1, 2, 2]),
                          pa.array(vals, pa.decimal128(12, 2))],
                         schema=schema)
    src = _Source(schema, [rb])
    op = TW.WindowExec(src, [TW.WindowAggFunc("s", t_make_agg("max", [d]),
                                              running=False),
                             TW.LeadLagFunc("l", d, -1)],
                       [TE.BoundReference(0)], [])
    out = pa.Table.from_batches([b.to_arrow() for b in op.execute(0)])
    assert out.schema.field("s").type == pa.decimal128(12, 2)
    assert out.column("s").to_pylist() == [vals[0], vals[0], vals[2],
                                           vals[2]]
    assert out.column("l").to_pylist() == [None, vals[0], None, vals[2]]


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _c(i):
    return {"kind": "column", "index": i}


def _scan_d():
    t = _table(0, 10, 3, None, None)
    return {"kind": "parquet_scan",
            "schema": schema_to_dict(TSchema.from_arrow(t.schema)),
            "file_groups": [["/data/part-0.parquet"]]}


def _sort_spec(i, desc=False):
    return {"expr": _c(i), "descending": desc, "nulls_first": not desc}


WIRE_FUNCS = {
    "ranks": [{"kind": k, "name": k} for k in
              ("row_number", "rank", "dense_rank", "percent_rank",
               "cume_dist")],
    "lead lag": [{"kind": "lead", "name": "ld", "expr": _c(V), "offset": 2},
                 {"kind": "lag", "name": "lg", "expr": _c(V), "offset": 1,
                  "default": -99},
                 {"kind": "lag", "name": "lgs", "expr": _c(U), "offset": 3,
                  "default": "none"}],
    "nth value": [{"kind": "nth_value", "name": "n2", "expr": _c(V), "n": 2},
                  {"kind": "nth_value", "name": "n1i", "expr": _c(X),
                   "n": 1, "ignore_nulls": True}],
    "running aggs": [{"kind": "agg", "fn": fn, "name": fn, "args": [_c(X)]}
                     for fn in ("sum", "count", "avg", "min", "max")],
}


def _window_td(funcs, order=True, group_limit=None):
    d = {"kind": "window", "input": _scan_d(), "functions": funcs,
         "partition_by": [_c(G)],
         "order_by": [_sort_spec(O), _sort_spec(X, True)] if order else []}
    if group_limit is not None:
        d["group_limit"] = group_limit
    return {"stage_id": 3, "partition_id": 0, "task_attempt_id": 1,
            "plan": d}


WIRE_CASES = dict(
    {name: _window_td(f) for name, f in WIRE_FUNCS.items()},
    **{"rank with group limit": _window_td(WIRE_FUNCS["ranks"][1:2],
                                           group_limit=10),
       "whole aggs": _window_td([{"kind": "agg", "fn": fn, "name": fn,
                                  "args": [_c(V)]}
                                 for fn in ("sum", "min")]
                                + [{"kind": "agg", "fn": "count",
                                    "name": "n", "args": []}],
                                order=False)})


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_window_wire_equals_jax(case):
    td = WIRE_CASES[case]
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    assert t_decode(data) == j_decode(data)
    assert TP.task_definition_to_bytes(t_decode(data)) == data
    assert JP.task_definition_to_bytes(t_decode(data)) == data
    plan = create_plan(t_decode(data)["plan"])
    assert isinstance(plan, TW.WindowExec)
    assert plan.group_limit == td["plan"].get("group_limit")
    assert len(plan.funcs) == len(td["plan"]["functions"])


def test_whole_partition_agg_with_order_refuses_to_encode():
    td = _window_td([{"kind": "agg", "fn": "sum", "name": "s",
                      "args": [_c(V)], "running": False}])
    for serde in (JP, TP):
        with pytest.raises(ValueError, match="no wire encoding"):
            serde.task_definition_to_bytes(td)


def test_planned_window_kinds():
    """Every function kind of the planner's window node: rank types,
    lead (positive offset), lag (negative), nth_value and agg."""
    funcs = [f for fs in WIRE_FUNCS.values() for f in fs]
    plan = create_plan(_window_td(funcs)["plan"])
    kinds = [type(f).__name__ for f in plan.funcs]
    assert kinds == ["RankFunc"] * 5 + ["LeadLagFunc"] * 3 + \
        ["NthValueFunc"] * 2 + ["WindowAggFunc"] * 5
    assert [f.offset for f in plan.funcs[5:8]] == [2, -1, -3]
    assert plan.funcs[9].ignore_nulls and not plan.funcs[8].ignore_nulls
    with pytest.raises(ValueError, match="unknown window function"):
        create_plan(_window_td([{"kind": "ntile", "name": "t"}])["plan"])
