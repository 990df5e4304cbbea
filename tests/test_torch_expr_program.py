"""The port's expression programs (blaze_tpu_torch/exprs/program.py)
against the JAX package's (blaze_tpu/exprs/program.py) on the same
numpy-seeded batches, the JAX package on its device route
(`blaze_tpu.bridge.placement.host_resident` patched to False):

  * FusedExprsEvaluator's filter, project and filter_project over int64,
    int32, float64 (NaN, -0.0 and NULLs), date32 and bool columns:
    arithmetic, comparisons, AND/OR, CASE WHEN, IF, COALESCE, Cast, IN
    with and without a null member, NOT, IS NULL; the same selection and
    columns as the JAX fused program and as both packages' eager
    evaluators (fuse off);
  * a traceable filter under a host projection (the fused mask, an eager
    projection), a host filter (eager), a batch whose capacity is off
    the bucket ladder;
  * FilterExec, ProjectExec and FilterProjectExec through the evaluator.

Tolerance: bit for bit (validity, and each value's bits where valid;
float64 compared as its int64 bits) against both packages' eager
evaluators; against the JAX fused program the same, but a NaN's sign
(XLA rewrites x * -1.0 as a negation, which flips it; the eager product
keeps the NaN operand's sign)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import program as JPROG
from blaze_tpu.plan.exprs import expr_from_dict as j_expr
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import program as TPROG
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
SCHEMA = pa.schema([("k", pa.int64()), ("q", pa.int32()),
                    ("x", pa.float64()), ("d", pa.date32()),
                    ("b", pa.bool_()), ("s", pa.string())])
K, Q, X, D, B, S = range(6)


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.EXPR_FUSE.key)


def col(i):
    return {"kind": "column", "index": i}


def lit(v, t):
    return {"kind": "literal", "value": v, "type": {"id": t}}


def bin_(op, a, b):
    return {"kind": "binary", "op": op, "l": a, "r": b}


def cast(e, t):
    return {"kind": "cast", "child": e, "type": {"id": t}}


def batches(seed, n_batches=3, rows=700):
    """Seeded Arrow batches: a float column with NaN, -0.0 and NULLs,
    dates around q01's window, NULLs everywhere."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        n = rows + 37 * b
        x = np.round(rng.normal(size=n) * 10, 3)
        x[rng.random(n) < 0.05] = np.nan
        x[rng.random(n) < 0.05] = -0.0
        x[rng.random(n) < 0.05] = 0.0
        out.append(pa.record_batch({
            "k": pa.array(rng.integers(-3, 8, n), mask=rng.random(n) < 0.1),
            "q": pa.array(rng.integers(-50, 100, n).astype(np.int32),
                          mask=rng.random(n) < 0.05),
            "x": pa.array(x, mask=rng.random(n) < 0.08),
            "d": pa.array(rng.integers(2450800, 2451200, n).astype(np.int32),
                          mask=rng.random(n) < 0.05).cast(pa.date32()),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
            "s": pa.array([f"v{v}" for v in rng.integers(0, 9, n)],
                          mask=rng.random(n) < 0.1)}, schema=SCHEMA))
    return out


DATE_FILTER = [bin_("and", bin_(">=", col(D), lit(2451000, "date32")),
                    bin_("<=", col(D), lit(2451090, "date32")))]
FLOAT_FILTER = [bin_("or", bin_(">", col(X), lit(0.5, "float64")),
                     {"kind": "is_null", "child": col(K)})]
PROJECTIONS = [
    bin_("+", bin_("*", col(X), lit(2.5, "float64")),
         cast(col(Q), "float64")),
    bin_("/", col(X), col(X)),
    bin_("-", col(K), cast(col(Q), "int64")),
    bin_("%", col(Q), lit(7, "int32")),
    {"kind": "case", "branches": [[bin_(">", col(K), lit(2, "int64")),
                                   col(X)],
                                  [{"kind": "is_null", "child": col(Q)},
                                   lit(-1.0, "float64")]],
     "else": bin_("*", col(X), lit(-1.0, "float64"))},
    {"kind": "if", "cond": col(B), "then": col(K),
     "else": lit(None, "int64")},
    {"kind": "coalesce", "args": [col(K), cast(col(Q), "int64"),
                                  lit(0, "int64")]},
    {"kind": "in_list", "child": col(K), "values": [1, None, 3]},
    {"kind": "in_list", "child": col(Q), "values": list(range(0, 90, 2)),
     "negated": True},
    {"kind": "in_list", "child": col(X), "values": [0.0, float("nan"), 1.5]},
    {"kind": "not", "child": col(B)},
    cast(col(X), "int32"),
    cast(col(D), "timestamp_us"),
    bin_("<=>", col(X), lit(0.0, "float64")),
    bin_("and", col(B), bin_("<", col(X), lit(1.0, "float64"))),
]
CHAINS = {
    "filter date": (DATE_FILTER, []),
    "filter float": (FLOAT_FILTER, []),
    "project": ([], PROJECTIONS),
    "filter_project": (DATE_FILTER + FLOAT_FILTER, PROJECTIONS),
    "fused mask, host projection": (
        DATE_FILTER, [col(S), bin_("==", col(S), lit("v3", "utf8")),
                      col(K)]),
    "host filter": ([bin_("==", col(S), lit("v1", "utf8"))],
                    [col(X), col(S)]),
}


def _evaluate(pkg, filters, projections, rbs, fuse=True):
    """Every batch through the package's FusedExprsEvaluator, compacted to
    Arrow."""
    if pkg == "jax":
        conf, prog, decode, schema = jconf, JPROG, j_expr, \
            JSchema.from_arrow(SCHEMA)
        to_batch = JBatch.from_arrow
    else:
        conf, prog, decode, schema = tconf, TPROG, t_expr, \
            TSchema.from_arrow(SCHEMA)

        def to_batch(rb):
            return TBatch.from_arrow(rb, device=CPU)
    conf.conf.set(conf.EXPR_FUSE.key, fuse)
    fs = [decode(f, schema) for f in filters]
    ps = [decode(p, schema) for p in projections]
    out_schema = type(schema)([
        type(schema[0])(f"c{i}", p.data_type(schema))
        for i, p in enumerate(ps)])
    ev = prog.FusedExprsEvaluator(filters=fs, projections=ps,
                                  in_schema=schema)
    out = []
    for rb in rbs:
        b = to_batch(rb)
        if fs and ps:
            b = ev.filter_project(b, out_schema)
        elif fs:
            b = ev.filter(b)
        else:
            b = ev.project(b, out_schema)
        out.append(b.compact().to_arrow())
    return pa.Table.from_batches(out)


def assert_same_bits(got: pa.Table, want: pa.Table, nan_bits=True):
    """Equal validity, and equal values where valid: floats as their
    int64 bits, or, with `nan_bits` False, any NaN equal to any NaN."""
    assert got.num_rows == want.num_rows
    assert got.column_names == want.column_names
    for name in got.column_names:
        g = got.column(name).combine_chunks()
        w = want.column(name).combine_chunks()
        assert g.type == w.type, name
        gv, wv = np.asarray(g.is_valid()), np.asarray(w.is_valid())
        assert (gv == wv).all(), name
        if pa.types.is_floating(g.type):
            gf = np.asarray(g.fill_null(0.0))[gv]
            wf = np.asarray(w.fill_null(0.0))[wv]
            if not nan_bits:
                nan = np.isnan(gf)
                assert (nan == np.isnan(wf)).all(), name
                gf, wf = gf[~nan], wf[~nan]
            assert (gf.view(np.int64) == wf.view(np.int64)).all(), name
        else:
            assert g.filter(g.is_valid()).equals(w.filter(w.is_valid())), \
                name


@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_fused_evaluator_equals_jax(chain):
    filters, projections = CHAINS[chain]
    rbs = batches(len(chain))
    got = _evaluate("torch", filters, projections, rbs)
    # both eager evaluators (fuse off), bit for bit
    assert_same_bits(got, _evaluate("torch", filters, projections, rbs,
                                    fuse=False))
    assert_same_bits(got, _evaluate("jax", filters, projections, rbs,
                                    fuse=False))
    # the JAX fused program: XLA rewrites x * -1.0 as -x, which flips a
    # NaN's sign bit where the eager product keeps the NaN operand's;
    # every other bit is the same
    assert_same_bits(got, _evaluate("jax", filters, projections, rbs),
                     nan_bits=False)
    if filters:
        assert 0 < got.num_rows < sum(rb.num_rows for rb in rbs)


def test_the_fused_route_is_the_one_taken():
    from blaze_tpu_torch.bridge import device_stats
    rbs = batches(5)
    for chain, fused in (("filter_project", 3), ("host filter", 0),
                         ("fused mask, host projection", 3)):
        before = device_stats.snapshot()
        _evaluate("torch", *CHAINS[chain], rbs)
        d = device_stats.delta(before)
        assert d["expr_fused_batches"] == fused, chain
        assert d["expr_eager_batches"] == 3 - fused, chain


def test_a_capacity_off_the_ladder_is_padded_onto_it():
    """A batch of capacity 640 (not a rung) runs at the rung above and
    comes back at that capacity, the padding rows deselected."""
    from blaze_tpu_torch.batch import bucket_capacity
    from blaze_tpu_torch.schema import Field
    rb = batches(9, 1, 600)[0]
    schema = TSchema.from_arrow(SCHEMA)
    b = TBatch.from_arrow(rb, capacity=640, device=CPU)
    assert bucket_capacity(640) != 640
    fs = [t_expr(f, schema) for f in DATE_FILTER]
    ps = [t_expr(p, schema) for p in PROJECTIONS[:3]]
    out_schema = TSchema([Field(f"c{i}", p.data_type(schema))
                          for i, p in enumerate(ps)])
    ev = TPROG.FusedExprsEvaluator(filters=fs, projections=ps,
                                   in_schema=schema)
    got = ev.filter_project(b, out_schema)
    assert got.capacity == bucket_capacity(640)
    assert got.selection.shape[0] == got.capacity
    tconf.conf.set(tconf.EXPR_FUSE.key, False)
    want = TPROG.FusedExprsEvaluator(
        filters=fs, projections=ps, in_schema=schema).filter_project(
        TBatch.from_arrow(rb, device=CPU), out_schema)
    assert_same_bits(pa.Table.from_batches([got.compact().to_arrow()]),
                     pa.Table.from_batches([want.compact().to_arrow()]))


@pytest.mark.parametrize("kind", ["filter", "project", "filter_project"])
def test_operators_run_the_evaluator(kind):
    """FilterExec, ProjectExec and FilterProjectExec over a memory scan:
    the same rows as the JAX operators, and fused batches counted."""
    from blaze_tpu.ops import basic as JB
    from blaze_tpu.ops.scan import MemoryScanExec as JMem
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.ops import basic as TB
    from blaze_tpu_torch.ops.scan import MemoryScanExec as TMem
    rbs = batches(11)
    tbl = pa.Table.from_batches(rbs)
    out = []
    for pkg, basic, mem, decode, sch in (
            ("torch", TB, TMem, t_expr, TSchema.from_arrow(SCHEMA)),
            ("jax", JB, JMem, j_expr, JSchema.from_arrow(SCHEMA))):
        src = mem.from_arrow(tbl)
        fs = [decode(f, sch) for f in DATE_FILTER + FLOAT_FILTER]
        ps = [decode(p, sch) for p in PROJECTIONS[:6]]
        names = [f"c{i}" for i in range(len(ps))]
        op = {"filter": lambda: basic.FilterExec(src, fs),
              "project": lambda: basic.ProjectExec(src, ps, names),
              "filter_project": lambda: basic.FilterProjectExec(
                  src, fs, ps, names)}[kind]()
        before = device_stats.snapshot()
        out.append(pa.Table.from_batches(
            [b.compact().to_arrow() for b in op.execute(0)]))
        if pkg == "torch":
            assert device_stats.delta(before)["expr_fused_batches"] > 0
    assert_same_bits(*out, nan_bits=False)  # the JAX side runs fused
