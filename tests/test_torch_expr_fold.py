"""The expression layer around the programs, against the JAX package:

  * `is_traceable` (blaze_tpu_torch/exprs/program.py) gives the JAX
    answer on one corpus of expressions over ints, floats, dates, bools,
    strings and decimals, with the decimal encoding off and on;
  * `fold_node` and `fold_constants` (exprs/fold.py) fold the same
    literal-only trees to the same Literals, and leave the same ones (a
    decimal, an ANSI cast error, a rand) alone; the wire decode
    (plan/exprs.py), which always folds, gives the JAX decode's trees
    with `auron.tpu.expr.constFold` on, and its unfolded trees (the
    decode-time fold patched out) the JAX decode's with the key off;
  * `CachedExprsEvaluator` (exprs/evaluator.py) evaluates an expression
    that appears twice in a chain once per batch, as the JAX one does,
    and always splits AND filters: the conjuncts of the JAX evaluator
    under `auron.forceShortCircuitAndOr`, and the same selection as the
    JAX evaluator's whole tree with the key off.

Tolerance: exact (booleans, tree shapes, literal values and types,
evaluation counts)."""

import dataclasses

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

from test_torch_expr_program import bin_, cast, col, lit

CPU = torch.device("cpu")
SCHEMA = pa.schema([("k", pa.int64()), ("x", pa.float64()),
                    ("d", pa.date32()), ("b", pa.bool_()),
                    ("s", pa.string()), ("m", pa.decimal128(7, 2)),
                    ("n", pa.decimal128(9, 4)), ("w", pa.decimal128(30, 2))])
K, X, D, B, S, M, N, W = range(8)


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        for opt in (c.ENCODING_DECIMAL_ENABLE, c.ANSI_ENABLED):
            c.conf.unset(opt.key)
    for opt in (jconf.EXPR_CONST_FOLD, jconf.FORCE_SHORT_CIRCUIT_AND_OR):
        jconf.conf.unset(opt.key)


def dec(v, p, s):
    return {"kind": "literal", "value": v,
            "type": {"id": "decimal", "precision": p, "scale": s}}


CORPUS = [
    col(K), col(S), col(M), col(W), lit(1, "int64"), lit("a", "utf8"),
    dec(1, 7, 2),
    bin_("+", col(K), lit(1, "int64")), bin_("/", col(X), col(X)),
    bin_("pmod", col(K), lit(3, "int64")), bin_("<<", col(K), col(K)),
    bin_("and", col(B), bin_(">", col(X), lit(0.0, "float64"))),
    bin_("<=>", col(X), lit(1.0, "float64")),
    bin_("==", col(S), lit("a", "utf8")),
    bin_("+", col(M), col(M)), bin_("*", col(M), col(M)),
    bin_("<", col(M), col(N)), bin_("+", col(M), col(N)),
    bin_("==", col(M), col(K)), bin_("+", col(M), col(X)),
    bin_("<", col(W), col(W)),
    {"kind": "not", "child": col(B)}, {"kind": "is_null", "child": col(S)},
    {"kind": "is_not_null", "child": col(K)},
    {"kind": "if", "cond": col(B), "then": col(K), "else": col(K)},
    {"kind": "if", "cond": col(B), "then": col(S), "else": col(S)},
    {"kind": "case", "branches": [[col(B), col(X)]], "else": col(X)},
    {"kind": "case", "branches": [[col(B), col(M)]]},
    {"kind": "coalesce", "args": [col(K), lit(0, "int64")]},
    {"kind": "in_list", "child": col(K), "values": [1, 2]},
    {"kind": "in_list", "child": col(S), "values": ["a"]},
    cast(col(K), "float64"), cast(col(D), "timestamp_us"),
    cast(col(S), "int64"), cast(col(K), "utf8"), cast(col(M), "float64"),
    {"kind": "try_cast", "child": col(X), "type": {"id": "int32"}},
    {"kind": "rand", "seed": 1},
    {"kind": "scalar_function", "name": "sqrt", "args": [col(X)],
     "return_type": {"id": "float64"}},
    {"kind": "like", "child": col(S), "pattern": "a%"},
]


@pytest.mark.parametrize("decimal_encoding", [False, True])
def test_is_traceable_equals_jax(decimal_encoding):
    for c in (jconf, tconf):
        c.conf.set(c.ENCODING_DECIMAL_ENABLE.key, decimal_encoding)
    ts, js = TSchema.from_arrow(SCHEMA), JSchema.from_arrow(SCHEMA)
    got = [TPROG.is_traceable(t_expr(e, ts), ts) for e in CORPUS]
    want = [JPROG.is_traceable(j_expr(e, js), js) for e in CORPUS]
    assert got == want
    assert any(got) and not all(got)
    # the decimal routes trace only with the encoding on
    eq_scale_add = CORPUS.index(bin_("+", col(M), col(M)))
    assert got[eq_scale_add] == decimal_encoding


def _shape(e):
    """A package-neutral picture of an expression tree."""
    name = type(e).__name__
    if name == "Literal":
        v = e.value
        return ("lit", repr(e.dtype), None if v is None else repr(v))
    return (name, tuple(_shape(c) for c in e.children()))


FOLDS = [
    bin_("*", lit(2, "int64"), lit(3, "int64")),
    bin_("/", lit(1, "int64"), lit(0, "int64")),
    bin_("/", lit(1.0, "float64"), lit(3.0, "float64")),
    bin_("+", col(K), bin_("*", lit(2, "int64"), lit(3, "int64"))),
    cast(lit("12", "utf8"), "int32"),
    cast(lit(2.75, "float64"), "int64"),
    cast(lit(7, "int32"), "utf8"),
    {"kind": "case", "branches": [[lit(True, "bool"), lit(1.5, "float64")]],
     "else": lit(2.5, "float64")},
    {"kind": "coalesce", "args": [lit(None, "int64"), lit(5, "int64")]},
    {"kind": "in_list", "child": lit(5, "int64"), "values": [1, 5]},
    {"kind": "not", "child": lit(None, "bool")},
    {"kind": "is_null", "child": lit(None, "int32")},
    {"kind": "like", "child": lit("abc", "utf8"), "pattern": "a%"},
    bin_("+", dec(1, 7, 2), dec(2, 7, 2)),
    bin_("<", col(X), bin_("-", lit(0.0, "float64"), lit(1.5, "float64"))),
    {"kind": "rand", "seed": 3},
]


def _unfolded(monkeypatch):
    """The port's decode with its decode-time fold patched out (the port
    has no key for it)."""
    import blaze_tpu_torch.exprs.fold as F
    monkeypatch.setattr(F, "fold_node", lambda e, schema=None: e)


@pytest.mark.parametrize("fold", [True, False])
def test_the_wire_decode_folds_as_jax(fold, monkeypatch):
    jconf.conf.set(jconf.EXPR_CONST_FOLD.key, fold)
    if not fold:
        _unfolded(monkeypatch)
    ts, js = TSchema.from_arrow(SCHEMA), JSchema.from_arrow(SCHEMA)
    got = [_shape(t_expr(e, ts)) for e in FOLDS]
    want = [_shape(j_expr(e, js)) for e in FOLDS]
    assert got == want
    folded = sum(s[0] == "lit" for s in got)
    assert folded == (12 if fold else 0)


def test_fold_constants_equals_jax():
    """Trees built unfolded (the fold off at decode), then folded by the
    direct entry, and node by node."""
    from blaze_tpu.exprs.fold import fold_constants as j_fold
    from blaze_tpu.exprs.fold import fold_node as j_node
    from blaze_tpu_torch.exprs.fold import fold_constants as t_fold
    from blaze_tpu_torch.exprs.fold import fold_node as t_node
    ts, js = TSchema.from_arrow(SCHEMA), JSchema.from_arrow(SCHEMA)
    jconf.conf.set(jconf.EXPR_CONST_FOLD.key, False)
    with pytest.MonkeyPatch.context() as mp:
        _unfolded(mp)
        trees = [(t_expr(e, ts), j_expr(e, js)) for e in FOLDS]
    jconf.conf.set(jconf.EXPR_CONST_FOLD.key, True)
    assert not any(type(t).__name__ == "Literal" for t, _j in trees)
    for t, j in trees:
        assert _shape(t_fold(t, ts)) == _shape(j_fold(j, js))
        assert _shape(t_node(t, ts)) == _shape(j_node(j, js))
    # an ANSI cast error stays unfolded, to raise at run time
    for c in (jconf, tconf):
        c.conf.set(c.ANSI_ENABLED.key, True)
    bad = cast(lit("x1", "utf8"), "int32")
    assert _shape(t_fold(t_expr(bad, ts), ts)) == \
        _shape(j_fold(j_expr(bad, js), js)) == \
        ("Cast", (("lit", "utf8", "'x1'"),))


def test_negative_zero_and_one_keep_their_own_keys():
    """The cache keys (hence the CSE and the program fingerprints) keep
    -0.0 apart from 0.0, True apart from 1, and one decimal value apart
    at two scales (the JAX keys equate the first and the last)."""
    from blaze_tpu_torch.exprs import Literal
    from blaze_tpu_torch.schema import BOOL, FLOAT64, INT64
    assert Literal(-0.0, FLOAT64).cache_key() != \
        Literal(0.0, FLOAT64).cache_key()
    assert Literal(True, BOOL).cache_key() != Literal(1, INT64).cache_key()
    from blaze_tpu_torch.schema import DataType, TypeId
    assert Literal(1, DataType(TypeId.DECIMAL, 7, 2)).cache_key() != \
        Literal(1, DataType(TypeId.DECIMAL, 9, 4)).cache_key()


def _counting(base):
    """An expression class of `base`'s package that counts its
    evaluations."""
    @dataclasses.dataclass(frozen=True, repr=False)
    class Counting(base):
        child: object
        calls: list = dataclasses.field(default_factory=list, compare=False)

        def children(self):
            return (self.child,)

        def data_type(self, schema):
            return self.child.data_type(schema)

        def evaluate(self, batch):
            self.calls.append(1)
            return self.child.evaluate(batch)

        def cache_key(self):
            return ("counting", self.child.cache_key())
    return Counting


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_a_repeated_expression_evaluates_once_a_batch(pkg):
    if pkg == "jax":
        from blaze_tpu.exprs import CachedExprsEvaluator as Ev
        from blaze_tpu.exprs.base import PhysicalExpr
        decode, schema = j_expr, JSchema.from_arrow(SCHEMA)
        make = JBatch.from_arrow
    else:
        from blaze_tpu_torch.exprs import CachedExprsEvaluator as Ev
        from blaze_tpu_torch.exprs.base import PhysicalExpr

        decode, schema = t_expr, TSchema.from_arrow(SCHEMA)

        def make(rb):
            return TBatch.from_arrow(rb, device=CPU)
    Counting = _counting(PhysicalExpr)
    calls: list = []
    pred = Counting(decode(bin_(">", col(X), lit(0.0, "float64")), schema),
                    calls)
    twin = Counting(decode(bin_(">", col(X), lit(0.0, "float64")), schema),
                    calls)
    other = decode(bin_("+", col(K), lit(1, "int64")), schema)
    out_schema = type(schema)([type(schema[0])("p", pred.data_type(schema)),
                               type(schema[0])("q", pred.data_type(schema)),
                               type(schema[0])("o", other.data_type(schema))])
    ev = Ev(filters=[pred], projections=[twin, pred, other])
    rng = np.random.default_rng(3)
    rbs = [pa.record_batch({
        "k": pa.array(rng.integers(0, 9, 200)),
        "x": pa.array(rng.normal(size=200)),
        "d": pa.array(np.zeros(200, dtype=np.int32)).cast(pa.date32()),
        "b": pa.array(rng.random(200) < 0.5),
        "s": pa.array(["a"] * 200),
        "m": pa.array([1] * 200, type=pa.decimal128(7, 2)),
        "n": pa.array([1] * 200, type=pa.decimal128(9, 4)),
        "w": pa.array([1] * 200, type=pa.decimal128(30, 2))},
        schema=SCHEMA) for _ in range(3)]
    rows = 0
    for rb in rbs:
        out = ev.filter_project(make(rb), out_schema)
        rows += out.compact().num_rows
    assert len(calls) == 3  # once a batch: filter, twin and pred share it
    assert 0 < rows < 600
    # a fresh projection-only pass shares the twin and pred too
    calls.clear()
    ev.project(make(rbs[0]), out_schema)
    assert len(calls) == 1


@pytest.mark.parametrize("flatten", [True, False])
def test_and_filters_split_under_short_circuit(flatten):
    """The port always splits (`split_conjuncts`): the JAX evaluator's
    conjuncts with its key on, and with it off (one whole tree) the same
    selection bits."""
    from blaze_tpu.exprs import CachedExprsEvaluator as JEv
    from blaze_tpu.exprs.evaluator import split_conjuncts as j_split
    from blaze_tpu_torch.exprs import CachedExprsEvaluator as TEv
    from blaze_tpu_torch.exprs.evaluator import split_conjuncts as t_split
    jconf.conf.set(jconf.FORCE_SHORT_CIRCUIT_AND_OR.key, flatten)
    ts, js = TSchema.from_arrow(SCHEMA), JSchema.from_arrow(SCHEMA)
    f = bin_("and", bin_(">", col(K), lit(2, "int64")),
             bin_("and", col(B), bin_("<", col(X), lit(1.0, "float64"))))
    t, j = TEv(filters=[t_expr(f, ts)]), JEv(filters=[j_expr(f, js)])
    assert len(t.filters) == 3
    assert len(j.filters) == (3 if flatten else 1)
    assert [_shape(c) for c in t_split(t_expr(f, ts))] == \
        [_shape(c) for c in j_split(j_expr(f, js))]
    rng = np.random.default_rng(5)
    n = 300
    x = rng.normal(size=n)
    x[::17] = np.nan
    rb = pa.record_batch({
        "k": pa.array(rng.integers(0, 6, n), mask=rng.random(n) < 0.1),
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "d": pa.array(np.zeros(n, dtype=np.int32)).cast(pa.date32()),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
        "s": pa.array(["a"] * n),
        "m": pa.array([1] * n, type=pa.decimal128(7, 2)),
        "n": pa.array([1] * n, type=pa.decimal128(9, 4)),
        "w": pa.array([1] * n, type=pa.decimal128(30, 2))}, schema=SCHEMA)
    got = t.filter(TBatch.from_arrow(rb, device=CPU)).compact().to_arrow()
    want = j.filter(JBatch.from_arrow(rb)).compact().to_arrow()
    assert 0 < got.num_rows < n
    assert pa.Table.from_batches([got]).equals(pa.Table.from_batches([want]))
