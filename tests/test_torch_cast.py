"""Cast and TryCast of the port (blaze_tpu_torch/kernels/cast.py,
blaze_tpu_torch/exprs/cast.py) against the JAX package's
(blaze_tpu/kernels/cast.py, blaze_tpu/exprs/cast.py) on the same
numpy-seeded columns, and their wire encoding against the JAX
`proto_serde`.

  * `cast_column` over the whole fixed-width square (bool, int8-int64,
    float32, float64, date32, timestamp_us to each other), with the
    edges: int64's min and max, NaN, +-inf, -0.0, values past every
    target's range, and nulls; the pairs Spark refuses (numeric <->
    date) raise TypeError in both;
  * the string casts at the host boundary: utf8 to every integral type
    (Spark's trimming, a fraction truncated, scientific notation, signs
    and overflow to null), to float64, bool, date32 and timestamp_us,
    and every fixed-width type to utf8 (Spark's display of floats,
    bools and timestamps);
  * `Cast` raises under ANSI where it nulls an input, `TryCast` never;
  * a decimal side raises naming ROADMAP item 13 (the port's decimal
    columns belong to it);
  * the join keys' promotion is a Cast: an int32 key against an int64
    one is widened in both packages to the same expression;
  * the wire: cast and try_cast encode to the JAX package's bytes and
    decode to its dicts.

Tolerance: exact (validity, and values where valid, bit for bit)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu import exprs as JE
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.kernels import cast as JK
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.schema import DataType as JType
from blaze_tpu.schema import TypeId as JTid
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import exprs as TE
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.kernels import cast as TK
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.exprs import expr_from_dict
from blaze_tpu_torch.schema import DataType as TType
from blaze_tpu_torch.schema import TypeId as TTid

CPU = torch.device("cpu")

FIXED = ["bool", "int8", "int16", "int32", "int64", "float32", "float64",
         "date32", "timestamp_us"]
_TID = {"bool": "BOOL", "int8": "INT8", "int16": "INT16", "int32": "INT32",
        "int64": "INT64", "float32": "FLOAT32", "float64": "FLOAT64",
        "date32": "DATE32", "timestamp_us": "TIMESTAMP_MICROS",
        "utf8": "UTF8"}
_NP = {"bool": np.bool_, "int8": np.int8, "int16": np.int16,
       "int32": np.int32, "int64": np.int64, "float32": np.float32,
       "float64": np.float64, "date32": np.int32, "timestamp_us": np.int64}
I64 = np.iinfo(np.int64)


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for c in (jconf, tconf):
        c.conf.unset(c.ANSI_ENABLED.key)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _tt(name):
    return TType(getattr(TTid, _TID[name]))


def _jt(name):
    return JType(getattr(JTid, _TID[name]))


def _values(src, rng):
    """(values, validity) of a column of type `src` with its edges."""
    if src == "bool":
        v = np.array([True, False, True, False, True] * 4)
    elif src.startswith("float"):
        v = np.array([0.0, -0.0, 1.5, -1.5, 2.9, -2.9, np.nan, np.inf,
                      -np.inf, 127.9, 128.0, -129.0, 32768.5, 3e9, -3e9,
                      9.2e18, 2.0 ** 63, -(2.0 ** 63), 1e300, -1e-300])
        v = np.concatenate([v, rng.normal(size=12) * 1e6])
    elif src in ("int64", "timestamp_us"):
        v = np.array([0, 1, -1, 127, 128, -129, 255, 32768, -32769,
                      2 ** 31, -(2 ** 31) - 1, 86_400_000_000 * 3 + 7,
                      -86_400_000_000 - 1, I64.max, I64.min, 10 ** 15])
        v = np.concatenate([v, rng.integers(-10 ** 12, 10 ** 12, 12)])
    else:
        info = np.iinfo(_NP[src])
        v = np.array([0, 1, -1, info.max, info.min, info.max - 1, 100,
                      -100], dtype=np.int64)
        v = np.concatenate([v, rng.integers(info.min, info.max, 12)])
    with np.errstate(over="ignore"):  # 1e300 is inf as a float32
        v = v.astype(_NP[src])
    valid = rng.random(len(v)) > 0.15
    valid[:3] = True
    return v, valid


def _pairs():
    return [(s, d) for s in FIXED for d in FIXED]


@pytest.mark.parametrize("src,dst", _pairs())
def test_cast_column_equals_the_jax_kernel(src, dst):
    import jax.numpy as jnp
    rng = np.random.default_rng(len(src) * 31 + len(dst))
    v, valid = _values(src, rng)
    try:
        want, wvalid = JK.cast_column(jnp.asarray(v), jnp.asarray(valid),
                                      _jt(src), _jt(dst))
    except TypeError:  # a pair Spark refuses: the port refuses it too
        with pytest.raises(TypeError):
            TK.cast_column(torch.from_numpy(v), torch.from_numpy(valid),
                           _tt(src), _tt(dst))
        assert (src == "date32") != (dst == "date32")
        return
    got, gvalid = TK.cast_column(torch.from_numpy(v),
                                 torch.from_numpy(valid), _tt(src), _tt(dst))
    got, gvalid = got.numpy(), gvalid.numpy()
    want, wvalid = np.asarray(want), np.asarray(wvalid)
    assert got.dtype == want.dtype
    assert np.array_equal(gvalid, wvalid)
    ok = gvalid
    if got.dtype.kind == "f":  # bit for bit, NaN included
        assert np.array_equal(got[ok].view(f"i{got.itemsize}"),
                              want[ok].view(f"i{want.itemsize}"))
    else:
        assert np.array_equal(got[ok], want[ok])


def test_cast_column_edges():
    """The Spark rules themselves: truncation toward zero, NaN to 0,
    saturation at the integral bounds, wraparound on narrowing."""
    f = torch.tensor([2.9, -2.9, float("nan"), float("inf"), -float("inf"),
                      1e20, -0.0])
    ok = torch.ones(7, dtype=torch.bool)
    got, _ = TK.cast_column(f, ok, _tt("float64"), _tt("int32"))
    assert got.tolist() == [2, -2, 0, 2 ** 31 - 1, -(2 ** 31), 2 ** 31 - 1,
                            0]
    got, _ = TK.cast_column(f, ok, _tt("float64"), _tt("int64"))
    assert got.tolist()[3:6] == [I64.max, I64.min, I64.max]
    i = torch.tensor([127, 128, 255, -129, I64.min, I64.max])
    got, _ = TK.cast_column(i, torch.ones(6, dtype=torch.bool),
                            _tt("int64"), _tt("int8"))
    assert got.tolist() == [127, -128, -1, 127, 0, -1]


# ---------------------------------------------------------------------------
# the expressions, the string casts at the host boundary
# ---------------------------------------------------------------------------

STRINGS = [" 12 ", "12.5", "-12.9", "1e3", "+7", "-", "", "abc", "127",
           "128", "-128", "-129", "32767", "2147483648", "9223372036854775807",
           "-9223372036854775808", "9223372036854775808", "0x10", "1.",
           ".5", "1.2.3", " -0 ", "nan", "inf", "-Infinity", "3.25e2",
           "true", "T", "yes", "N", "0", "maybe", "2020-01-02",
           "2020-1-2", "2020", "2020-13-01", " 2020-02-29 ",
           "2021-02-29", "2020-01-02T10:00", "2020-01-02 10:30:05.25",
           "+2020-01-02", "20200", None]


def _same(got: pa.Array, want: pa.Array) -> bool:
    """Arrow equality, a NaN equal to a NaN."""
    if not pa.types.is_floating(got.type):
        return got.equals(want)
    return got.type == want.type and np.array_equal(
        np.asarray(got.is_valid()), np.asarray(want.is_valid())) and \
        np.array_equal(got.to_numpy(zero_copy_only=False),
                       want.to_numpy(zero_copy_only=False), equal_nan=True)


def _eval(pkg, rb, to, try_cast=False):
    """Cast(column 0 AS to) of package `pkg` over `rb`: the Arrow result."""
    if pkg == "jax":
        from blaze_tpu import schema as S
        cb = JBatch.from_arrow(rb)
        cls = JE.TryCast if try_cast else JE.Cast
        e = cls(JE.BoundReference(0), S.DataType(getattr(S.TypeId,
                                                         _TID[to])))
    else:
        from blaze_tpu_torch import schema as S
        cb = TBatch.from_arrow(rb, device=CPU)
        cls = TE.TryCast if try_cast else TE.Cast
        e = cls(TE.BoundReference(0), S.DataType(getattr(S.TypeId,
                                                         _TID[to])))
    return e.evaluate(cb).to_host(rb.num_rows)


@pytest.mark.parametrize("to", ["int8", "int16", "int32", "int64",
                                "float32", "float64", "bool", "date32",
                                "timestamp_us"])
def test_string_casts_equal_the_jax_ones(to):
    rb = pa.record_batch({"s": pa.array(STRINGS, type=pa.string())})
    got = _eval("torch", rb, to)
    want = _eval("jax", rb, to)
    assert _same(got, want), (got, want)
    assert got.null_count > 1  # invalid input gives null


@pytest.mark.parametrize("src", FIXED)
def test_casts_to_string_equal_the_jax_ones(src):
    rng = np.random.default_rng(3)
    v, valid = _values(src, rng)
    at = {"date32": pa.date32(), "timestamp_us": pa.timestamp("us")}
    arr = pa.array(v, mask=~valid, type=at.get(src))
    if src == "timestamp_us":  # the range Python's datetime can print
        arr = pa.array(np.clip(v, -10 ** 16, 10 ** 16), mask=~valid,
                       type=at[src])
    rb = pa.record_batch({"v": arr})
    got = _eval("torch", rb, "utf8")
    want = _eval("jax", rb, "utf8")
    assert got.equals(want), (got, want)


def test_trim_off_keeps_padding_invalid():
    rb = pa.record_batch({"s": pa.array([" 12", "12", "7 "])})
    for c in (jconf, tconf):
        c.conf.set(c.CAST_TRIM_STRING.key, False)
    try:
        got = _eval("torch", rb, "int32")
        assert got.equals(_eval("jax", rb, "int32"))
        assert got.to_pylist() == [None, 12, None]
    finally:
        for c in (jconf, tconf):
            c.conf.unset(c.CAST_TRIM_STRING.key)


@pytest.mark.parametrize("rb,to", [
    (pa.record_batch({"s": pa.array(["1", "x", None])}), "int32"),
    (pa.record_batch({"f": pa.array([1.0, float("inf"), None])}),
     "timestamp_us")])
def test_ansi_cast_raises_and_try_cast_nulls(rb, to):
    for c in (jconf, tconf):
        c.conf.set(c.ANSI_ENABLED.key, True)
    for pkg in ("torch", "jax"):
        with pytest.raises(ValueError, match="CAST_INVALID_INPUT"):
            _eval(pkg, rb, to)
    got = _eval("torch", rb, to, try_cast=True)
    assert got.equals(_eval("jax", rb, to, try_cast=True))
    assert got.null_count == 2


def test_a_decimal_side_raises_naming_item_13():
    from blaze_tpu_torch.schema import DataType, TypeId
    dec = DataType(TypeId.DECIMAL, 12, 2)
    with pytest.raises(NotImplementedError, match="item 13"):
        TK.cast_column(torch.zeros(2, dtype=torch.int64),
                       torch.ones(2, dtype=torch.bool), _tt("int64"), dec)
    rb = pa.record_batch({"k": pa.array([1, 2])})
    cb = TBatch.from_arrow(rb, device=CPU)
    with pytest.raises(NotImplementedError, match="item 13"):
        TE.Cast(TE.BoundReference(0), dec).evaluate(cb)


def test_join_key_promotion_is_a_cast():
    """An int32 key against an int64 key, and an int64 against a
    float64: both packages widen with the same Cast."""
    from blaze_tpu import schema as JS
    from blaze_tpu.ops.joins.exec import promote_join_key_exprs as jpromote
    from blaze_tpu_torch import schema as TS
    from blaze_tpu_torch.ops.joins.exec import promote_join_key_exprs
    for a, b, common in (("INT32", "INT64", "INT64"),
                         ("INT64", "FLOAT64", "FLOAT64")):
        ls = TS.Schema([TS.Field("a", TS.DataType(getattr(TTid, a)))])
        rs = TS.Schema([TS.Field("b", TS.DataType(getattr(TTid, b)))])
        lk, rk = promote_join_key_exprs([TE.BoundReference(0)],
                                        [TE.BoundReference(0)], ls, rs)
        jls = JS.Schema([JS.Field("a", JS.DataType(getattr(JTid, a)))])
        jrs = JS.Schema([JS.Field("b", JS.DataType(getattr(JTid, b)))])
        jlk, jrk = jpromote([JE.BoundReference(0)], [JE.BoundReference(0)],
                            jls, jrs)
        for got, want in ((lk[0], jlk[0]), (rk[0], jrk[0])):
            assert type(got).__name__ == type(want).__name__
            if isinstance(got, TE.Cast):
                assert got.to.id.value == want.to.id.value == \
                    getattr(TTid, common).value


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _col(i):
    return {"kind": "column", "index": i}


WIRE = [
    {"kind": "cast", "child": _col(0), "type": {"id": "float64"}},
    {"kind": "try_cast", "child": _col(1), "type": {"id": "int32"}},
    {"kind": "cast", "child": {"kind": "binary", "op": "-", "l": _col(0),
                               "r": _col(2)}, "type": {"id": "int64"}},
    {"kind": "cast", "child": _col(1), "type": {"id": "date32"}},
    {"kind": "try_cast", "child": _col(0), "type": {"id": "utf8"}},
]


@pytest.mark.parametrize("i", range(len(WIRE)))
def test_cast_wire_equals_the_jax_bytes(i):
    d = WIRE[i]
    jbytes = JP.expr_to_proto(d).SerializeToString()
    assert TP.expr_to_proto(d).SerializeToString() == jbytes
    node = TP.pb.PhysicalExprNode.FromString(jbytes)
    got = TP.expr_from_proto(node)
    assert got == JP.expr_from_proto(JP.pb.PhysicalExprNode.FromString(
        jbytes))
    expr = expr_from_dict(got)
    assert isinstance(expr, TE.TryCast if d["kind"] == "try_cast"
                      else TE.Cast)
