"""The port's binary arithmetic and boolean operators
(blaze_tpu_torch/exprs/binary.py) against the JAX package's `BinaryExpr`
(blaze_tpu/exprs/binary.py) on the same numpy-seeded Arrow batch:
`+ - * / %` over int8-int64 and float32/64 pairs (promotion, NULL
propagation, integer wrap at the type's edges, NULL on division or
modulo by zero, Java truncation and sign rules, NaN and infinities),
`or`/`and` (Kleene), `!=` and `<=>`, the result types, and the ANSI mode
checks (DIVIDE_BY_ZERO, ARITHMETIC_OVERFLOW) on selected rows only.

Tolerance: exact.  Integer results bit for bit; float results equal with
NaN where NaN and the same sign of zero; validity exact."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import BinaryExpr as JBinary
from blaze_tpu.exprs import BoundReference as JRef
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import BinaryExpr as TBinary
from blaze_tpu_torch.exprs import BoundReference as TRef
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
N = 600
PAIRS = [("int8", "int8"), ("int16", "int32"), ("int32", "int64"),
         ("int64", "int64"), ("float32", "float32"), ("float64", "float64"),
         ("int32", "float64"), ("int64", "float32"), ("int8", "float32"),
         ("int16", "int16")]
OPS = ["+", "-", "*", "/", "%"]


def _values(rng, dtype):
    if dtype.startswith("float"):
        v = (rng.normal(size=N) * 50).astype(dtype)
        special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0,
                            7.5], dtype=dtype)
        pick = rng.random(N) < 0.3
        v[pick] = special[rng.integers(0, len(special), int(pick.sum()))]
        return v
    info = np.iinfo(dtype)
    edge = np.array([info.min, info.max, 0, -1, 1, 2, -2, 3],
                    dtype=dtype)
    v = rng.integers(info.min, info.max, N, dtype=dtype, endpoint=True)
    pick = rng.random(N) < 0.4
    v[pick] = edge[rng.integers(0, len(edge), int(pick.sum()))]
    return v


def _batch(rng, lt, rt):
    cols = {"a": pa.array(_values(rng, lt), mask=rng.random(N) < 0.1),
            "b": pa.array(_values(rng, rt), mask=rng.random(N) < 0.1)}
    return pa.record_batch(cols)


def _eval_both(rb, op, cols=(0, 1)):
    jb = JBatch.from_arrow(rb)
    tb = TBatch.from_arrow(rb, device=CPU)
    je = JBinary(op, JRef(cols[0]), JRef(cols[1]))
    te = TBinary(op, TRef(cols[0]), TRef(cols[1]))
    jt = je.data_type(JSchema.from_arrow(rb.schema))
    tt = te.data_type(TSchema.from_arrow(rb.schema))
    assert jt.id.value == tt.id.value
    return je.evaluate(jb), te.evaluate(tb)


def _assert_same(jv, tv, n=None):
    """The rows of the batch (the JAX package keeps a host batch
    unpadded; the port pads it to its capacity)."""
    n = len(np.asarray(jv.validity)) if n is None else n
    jd, jvalid = np.asarray(jv.data)[:n], np.asarray(jv.validity)[:n]
    td, tvalid = tv.data.numpy()[:n], tv.validity.numpy()[:n]
    assert np.array_equal(jvalid, tvalid)
    assert jd.dtype == td.dtype
    if jd.dtype.kind == "f":
        assert np.array_equal(jd, td, equal_nan=True)
        assert np.array_equal(np.signbit(jd[~np.isnan(jd)]),
                              np.signbit(td[~np.isnan(td)]))
    else:
        assert np.array_equal(jd, td)


@pytest.mark.parametrize("lt,rt", PAIRS)
@pytest.mark.parametrize("op", OPS)
def test_arithmetic_matches_jax(lt, rt, op):
    rng = np.random.default_rng(PAIRS.index((lt, rt)) * 7 + OPS.index(op))
    rb = _batch(rng, lt, rt)
    jv, tv = _eval_both(rb, op)
    _assert_same(jv, tv)
    if op in ("/", "%"):
        # a zero divisor gives NULL
        b = np.asarray(rb.column(1).fill_null(1).to_numpy(
            zero_copy_only=False))
        assert not tv.validity.numpy()[:N][b == 0].any()


def test_integer_edges():
    """Wrap, truncation toward zero and the dividend's sign, exactly as
    the reference, at the edges of int64."""
    lo = np.iinfo(np.int64).min
    a = np.array([lo, lo, 7, -7, 7, -7, lo, 5], dtype=np.int64)
    b = np.array([-1, 1, -2, 2, 0, -3, lo, lo], dtype=np.int64)
    rb = pa.record_batch({"a": pa.array(a), "b": pa.array(b)})
    for op in OPS:
        jv, tv = _eval_both(rb, op)
        _assert_same(jv, tv)
    _jv, tv = _eval_both(rb, "/")
    assert tv.data.numpy()[:8].tolist()[:6] == [lo, lo, -3, -3, 0, 2]
    _jv, tv = _eval_both(rb, "%")
    assert tv.data.numpy()[:8].tolist()[2:4] == [1, -1]


@pytest.mark.parametrize("op", ["or", "and", "!=", "<=>", "==", "<"])
def test_boolean_and_comparisons_match_jax(op):
    rng = np.random.default_rng(11)
    if op in ("or", "and"):
        rb = pa.record_batch({
            "a": pa.array(rng.random(N) < 0.5, mask=rng.random(N) < 0.3),
            "b": pa.array(rng.random(N) < 0.5, mask=rng.random(N) < 0.3)})
    else:
        rb = _batch(rng, "float64", "int32")
    jv, tv = _eval_both(rb, op)
    _assert_same(jv, tv)


@pytest.fixture
def ansi():
    for c in (jconf, tconf):
        c.conf.set("spark.sql.ansi.enabled", True)
    yield
    for c in (jconf, tconf):
        c.conf.unset("spark.sql.ansi.enabled")


@pytest.mark.parametrize("case", [
    ("/", [4, 1], [0, 1], "DIVIDE_BY_ZERO"),
    ("%", [4, 1], [0, 1], "DIVIDE_BY_ZERO"),
    ("+", [2 ** 62, 1], [2 ** 62, 1], "ARITHMETIC_OVERFLOW"),
    ("-", [-2 ** 62, 1], [2 ** 62 + 1, 1], "ARITHMETIC_OVERFLOW"),
    ("*", [2 ** 40, 3], [2 ** 30, 3], "ARITHMETIC_OVERFLOW"),
    ("/", [-2 ** 63, 6], [-1, 3], "ARITHMETIC_OVERFLOW"),
    ("*", [2 ** 20, 3], [2 ** 30, 3], None),
])
def test_ansi_mode_raises_as_jax(ansi, case):
    op, a, b, err = case
    rb = pa.record_batch({"a": pa.array(a, pa.int64()),
                          "b": pa.array(b, pa.int64())})
    if err is None:
        jv, tv = _eval_both(rb, op)
        _assert_same(jv, tv)
        return
    jb = JBatch.from_arrow(rb)
    tb = TBatch.from_arrow(rb, device=CPU)
    with pytest.raises(ValueError, match=err):
        JBinary(op, JRef(0), JRef(1)).evaluate(jb)
    with pytest.raises(ValueError, match=err):
        TBinary(op, TRef(0), TRef(1)).evaluate(tb)
    # a deselected row does not raise in either package
    sel = np.array([False, True])
    jv = JBinary(op, JRef(0), JRef(1)).evaluate(
        jb.with_selection(np.resize(sel, jb.capacity) & (
            np.arange(jb.capacity) < 2)))
    tv = TBinary(op, TRef(0), TRef(1)).evaluate(
        tb.with_selection(torch.from_numpy(np.resize(sel, tb.capacity) & (
            np.arange(tb.capacity) < 2))))
    _assert_same(jv, tv)


def test_decimal_operands_raise():
    rb = pa.record_batch({"a": pa.array([1, 2], pa.decimal128(10, 2)),
                          "b": pa.array([1, 2], pa.int64())})
    schema = TSchema.from_arrow(rb.schema)
    with pytest.raises(NotImplementedError, match="item 13"):
        TBinary("+", TRef(0), TRef(1)).data_type(schema)
