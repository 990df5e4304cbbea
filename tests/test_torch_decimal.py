"""The port's decimals (blaze_tpu_torch: batch.py decimal columns,
kernels/decimal128.py, exprs/decimal_arith.py, the decimal routes of
exprs/binary.py, the casts, sum/avg, sort keys, hashing and the decimal
functions) against the JAX package's on the same numpy-seeded inputs,
and against Python's `decimal` where the JAX package is wrong:

  * every int128 op of kernels/decimal128.py on random int64 limbs with
    the int64 and int128 extremes, and the wide-decimal hash against the
    JAX module and java BigInteger.toByteArray's bytes;
  * decimal_arith's result types over p in {1, 7, 9, 17, 18, 19, 38} and
    mixed scales, and its values (overflow to NULL, ANSI raises) through
    `BinaryExpr` against the JAX package and a Decimal reference; the
    device routes (equal scales, the int128 limbs under
    auron.tpu.encoding.decimal.enable) against the host one;
  * casts both ways (ints, floats, strings, rescales with negative odd
    halves) against the JAX ones;
  * sum and avg through the generic AggExec against the JAX one, in every
    mode;
  * sort order and murmur3/xxhash64 (partition ids, hash()) against the
    JAX package for p <= 18, and against Spark's rule for p > 18;
  * Arrow round trips (the unscaled int64 read, decimal_from_unscaled,
    the int32 tier) byte for byte against the JAX package;
  * the JAX package's decimal faults (ROADMAP Queue 3), each pinned
    against a Decimal reference: a decimal literal read as its truncated
    integer, a decimal meeting a float computed on its unscaled integers,
    ceil/floor keeping the fraction; the JAX package holds where it is
    right (the column x column form of the literal case).

Tolerance: exact for every decimal, integer and boolean value; a decimal
cast to float64 equal to the JAX package's bit for bit."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.kernels import decimal128 as J128
from blaze_tpu.plan.exprs import expr_from_dict as j_expr
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import decimal_arith as TD
from blaze_tpu_torch.kernels import decimal128 as T128
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
D = decimal.Decimal
PRECISIONS = [1, 7, 9, 17, 18, 19, 38]


@pytest.fixture(autouse=True)
def cpu_device():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _both_conf(key, value):
    for c in (jconf, tconf):
        if value is None:
            c.conf.unset(key)
        else:
            c.conf.set(key, value)


def dec_array(rng, p: int, s: int, n: int = 240, nulls: bool = True):
    """decimal(p, s) values: random magnitudes of every digit count, the
    extremes +-(10^p - 1), +-1, 0 and odd halves at the last digit."""
    top = 10 ** p - 1
    digits = rng.integers(1, p + 1, n)
    vals = [int(rng.integers(0, 10 ** min(int(k), 18))) *
            (10 ** max(int(k) - 18, 0)) for k in digits]
    vals = [v if rng.random() < 0.5 else -v for v in vals]
    edge = [top, -top, 1, -1, 0, 5, -5, 15, -15, top // 2, -(top // 2)]
    vals[:len(edge)] = [min(max(e, -top), top) for e in edge]
    mask = rng.random(n) < 0.1 if nulls else np.zeros(n, bool)
    mask[:len(edge)] = False
    from blaze_tpu_torch.schema import DataType, TypeId
    return TD.decimal_from_ints(np.array(vals, dtype=object), ~mask,
                                DataType(TypeId.DECIMAL, p, s))


def _col(i):
    return {"kind": "column", "index": i}


def _bin(op, l, r):
    return {"kind": "binary", "op": op, "l": l, "r": r}


def _lit(v, t):
    return {"kind": "literal", "value": v, "type": t}


def _dec_t(p, s):
    return {"id": "decimal", "precision": p, "scale": s}


def both(ir, rb):
    """(port, JAX) results of `ir` over `rb` as Arrow arrays, and the
    port's and the JAX package's result types."""
    n = rb.num_rows
    te = t_expr(ir, TSchema.from_arrow(rb.schema))
    je = j_expr(ir, JSchema.from_arrow(rb.schema))
    tt = te.data_type(TSchema.from_arrow(rb.schema))
    jt = je.data_type(JSchema.from_arrow(rb.schema))
    got = te.evaluate(TBatch.from_arrow(rb, device=CPU)).to_host(n)
    want = je.evaluate(JBatch.from_arrow(rb)).to_host(n)
    return got, want, tt, jt


def same(got, want):
    got = got.combine_chunks() if isinstance(got, pa.ChunkedArray) else got
    want = want.combine_chunks() if isinstance(want, pa.ChunkedArray) \
        else want
    assert got.type.equals(want.type), (got.type, want.type)
    assert got.to_pylist() == want.to_pylist()


# ---------------------------------------------------------------------------
# kernels/decimal128.py
# ---------------------------------------------------------------------------

def _limbs(rng, n=4096):
    v = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64,
                     endpoint=True)
    v[:8] = [-2 ** 63, 2 ** 63 - 1, 0, -1, 1, 2 ** 32, -2 ** 32, 2 ** 31]
    return v


def _same_out(j, t):
    if isinstance(j, tuple):
        assert len(j) == len(t)
        for a, b in zip(j, t):
            _same_out(a, b)
        return
    assert np.array_equal(np.asarray(j), t.numpy())


INT128_OPS = {
    "u_lt": (lambda xp, a, b, c, d: J128.u_lt(xp, b, d),
             lambda a, b, c, d: T128.u_lt(b, d)),
    "add128": (lambda xp, *x: J128.add128(xp, *x), T128.add128),
    "neg128": (lambda xp, a, b, c, d: J128.neg128(xp, a, b),
               lambda a, b, c, d: T128.neg128(a, b)),
    "sub128": (lambda xp, *x: J128.sub128(xp, *x), T128.sub128),
    "eq128": (lambda xp, *x: J128.eq128(xp, *x), T128.eq128),
    "lt128": (lambda xp, *x: J128.lt128(xp, *x), T128.lt128),
    "fits_int64": (lambda xp, a, b, c, d: J128.fits_int64(xp, a, b),
                   lambda a, b, c, d: T128.fits_int64(a, b)),
    "add_overflows": (lambda xp, a, b, c, d: J128.add_overflows(
        xp, a, c, a + c), lambda a, b, c, d: T128.add_overflows(a, c, a + c)),
    "from_int64": (lambda xp, a, b, c, d: J128.from_int64(xp, b),
                   lambda a, b, c, d: T128.from_int64(b)),
}


@pytest.mark.parametrize("name", sorted(INT128_OPS))
def test_int128_op_equals_the_jax_module(name):
    rng = np.random.default_rng(3)
    args = [_limbs(rng) for _ in range(4)]
    jfn, tfn = INT128_OPS[name]
    with np.errstate(all="ignore"):
        want = jfn(np, *args)
    _same_out(want, tfn(*(torch.from_numpy(a) for a in args)))


@pytest.mark.parametrize("m", [0, 1, 10, 12345, 10 ** 9, 2 ** 31 - 1])
def test_mul_small_equals_the_jax_module(m):
    rng = np.random.default_rng(4)
    h, l = _limbs(rng), _limbs(rng)
    with np.errstate(all="ignore"):
        want = J128.mul_small(np, h, l, m)
    _same_out(want, T128.mul_small(torch.from_numpy(h),
                                   torch.from_numpy(l), m))


@pytest.mark.parametrize("k", [0, 1, 9, 10, 18, 20])
def test_mul_pow10_and_rescale_are_exact(k):
    """Against Python ints: the int128 product of a sign-extended int64
    and 10^k (k <= 20 stays inside int128), both packages."""
    rng = np.random.default_rng(5)
    v = _limbs(rng, 2048)
    if k > 18:  # inside int128: |v| < 10^18 (the 10^18 x 10^20 bound)
        v = v % (10 ** 18) * np.where(rng.random(2048) < 0.5, -1, 1)
    th, tl = T128.rescaled_pair(torch.from_numpy(v), 0, k)
    jh, jl = J128.rescaled_pair(np, v, 0, k)
    _same_out((jh, jl), (th, tl))
    got = [int(h) * (1 << 64) + (int(l) & ((1 << 64) - 1))
           for h, l in zip(th.tolist(), tl.tolist())]
    assert got == [int(x) * 10 ** k for x in v]


def _to_bytes(v: int) -> bytes:
    """java.math.BigInteger.toByteArray."""
    n = (v + (v < 0)).bit_length() // 8 + 1
    return v.to_bytes(n, "big", signed=True)


def test_wide_decimal_hash_equals_the_jax_module_and_spark_bytes():
    rng = np.random.default_rng(6)
    hi, lo = _limbs(rng, 1024), _limbs(rng, 1024)
    hi[:6] = [0, 0, -1, -1, 0, -1]
    lo[:6] = [0, 127, -1, -128, 128, 0]
    mat, lengths = T128.minimal_be_bytes(hi, lo)
    jmat, jlengths = J128.minimal_be_bytes(hi, lo)
    assert np.array_equal(mat, jmat) and np.array_equal(lengths, jlengths)
    for h, l, row, k in zip(hi, lo, mat, lengths):
        v = int(h) * (1 << 64) + (int(l) & ((1 << 64) - 1))
        assert bytes(row[:k]) == _to_bytes(v)
    assert np.array_equal(T128.spark_decimal128_hash(hi, lo),
                          J128.spark_decimal128_hash(hi, lo))


# ---------------------------------------------------------------------------
# exprs/decimal_arith.py and the binary operators
# ---------------------------------------------------------------------------

TYPE_PAIRS = [((7, 2), (7, 2)), ((7, 2), (2, 1)), ((18, 6), (2, 1)),
              ((17, 2), (18, 6)), ((9, 0), (1, 0)), ((18, 2), (18, 2)),
              ((19, 4), (7, 2)), ((38, 10), (38, 0)), ((38, 2), (17, 17)),
              ((1, 1), (38, 37))]


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "%", "pmod"])
def test_result_types_equal_the_jax_rules(op):
    from blaze_tpu.exprs import decimal_arith as JD
    from blaze_tpu.schema import DataType as JType
    from blaze_tpu.schema import TypeId as JTid
    from blaze_tpu_torch.schema import DataType, TypeId
    for p1 in PRECISIONS:
        for p2 in PRECISIONS:
            for s1 in {0, p1 // 2, p1}:
                for s2 in {0, p2 // 2, p2}:
                    t = TD.result_type(op, DataType(TypeId.DECIMAL, p1, s1),
                                       DataType(TypeId.DECIMAL, p2, s2))
                    j = JD.result_type(op, JType(JTid.DECIMAL, p1, s1),
                                       JType(JTid.DECIMAL, p2, s2))
                    assert (t.precision, t.scale) == (j.precision, j.scale)
    for name in ("int8", "int16", "int32", "int64", "bool", "float64",
                 "date32"):
        from blaze_tpu_torch import schema as S
        from blaze_tpu import schema as JS
        tt, jt = TD.as_decimal_type(getattr(S, name.upper() if name !=
                                            "bool" else "BOOL")), \
            JD.as_decimal_type(getattr(JS, name.upper() if name != "bool"
                                       else "BOOL"))
        assert (tt is None) == (jt is None)
        if tt is not None:
            assert (tt.precision, tt.scale) == (jt.precision, jt.scale)


def _reference(op, x, y, p, s):
    """Spark's answer for one row over Python Decimals (None: NULL)."""
    if x is None or y is None:
        return None
    with decimal.localcontext() as ctx:
        ctx.prec = 100
        if op in ("/", "%", "pmod") and y == 0:
            return None
        r = {"+": lambda: x + y, "-": lambda: x - y, "*": lambda: x * y,
             "/": lambda: x / y, "%": lambda: x % y,
             "pmod": lambda: (x % y) + (y if (x % y) != 0 and
                                        ((x % y) < 0) != (y < 0) else 0)
             }[op]()
        r = r.quantize(D(1).scaleb(-s), rounding=decimal.ROUND_HALF_UP)
        return None if abs(int(r.scaleb(s))) >= 10 ** p else r


@pytest.mark.parametrize("pair", TYPE_PAIRS, ids=str)
@pytest.mark.parametrize("op", ["+", "-", "*", "/", "%", "pmod"])
def test_arithmetic_equals_the_jax_package_and_spark(op, pair):
    (p1, s1), (p2, s2) = pair
    rng = np.random.default_rng(p1 * 100 + p2)
    rb = pa.record_batch({"a": dec_array(rng, p1, s1),
                          "b": dec_array(rng, p2, s2)})
    got, want, tt, jt = both(_bin(op, _col(0), _col(1)), rb)
    assert (tt.precision, tt.scale) == (jt.precision, jt.scale)
    same(got, want)
    ref = [_reference(op, x, y, tt.precision, tt.scale) for x, y in
           zip(rb.column(0).to_pylist(), rb.column(1).to_pylist())]
    assert got.to_pylist() == ref


@pytest.mark.parametrize("pair", TYPE_PAIRS + [((7, 2), (10, 0))], ids=str)
@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">=", "<=>"])
def test_comparisons_equal_the_jax_package(op, pair):
    (p1, s1), (p2, s2) = pair
    rng = np.random.default_rng(p1 * 7 + p2 + s1)
    a, b = dec_array(rng, p1, s1), dec_array(rng, p2, s2)
    b = pa.array(b.to_pylist()[:5] + a.to_pylist()[5:], b.type) \
        if (p1, s1) == (p2, s2) else b  # equal rows too
    rb = pa.record_batch({"a": a, "b": b})
    got, want, _tt, _jt = both(_bin(op, _col(0), _col(1)), rb)
    same(got, want)


@pytest.mark.parametrize("pair", [((7, 2), (18, 6)), ((18, 0), (18, 18)),
                                  ((9, 0), (17, 4))], ids=str)
@pytest.mark.parametrize("op", ["==", "<", ">=", "<=>"])
def test_unequal_scales_compare_on_the_limbs(op, pair):
    """Under auron.tpu.encoding.decimal.enable an unequal-scale compare
    within p <= 18 runs on the int128 limbs on the device, equal to the
    JAX package's limb route and to the host route with the knob off."""
    (p1, s1), (p2, s2) = pair
    rng = np.random.default_rng(s2 + 11)
    rb = pa.record_batch({"a": dec_array(rng, p1, s1),
                          "b": dec_array(rng, p2, s2)})
    off, _w, _t, _j = both(_bin(op, _col(0), _col(1)), rb)
    _both_conf("auron.tpu.encoding.decimal.enable", "true")
    try:
        te = t_expr(_bin(op, _col(0), _col(1)),
                    TSchema.from_arrow(rb.schema))
        cv = te.evaluate(TBatch.from_arrow(rb, device=CPU))
        assert cv.is_device  # the limb route, not the host
        got, want, _t, _j = both(_bin(op, _col(0), _col(1)), rb)
    finally:
        _both_conf("auron.tpu.encoding.decimal.enable", None)
    same(got, want)
    same(got, off)


def test_integer_operands_widen_as_spark():
    rng = np.random.default_rng(8)
    rb = pa.record_batch({
        "a": dec_array(rng, 7, 2),
        "i": pa.array(rng.integers(-10 ** 6, 10 ** 6, 240), pa.int64()),
        "j": pa.array(rng.integers(-100, 100, 240).astype(np.int32)),
        "k": pa.array(rng.integers(-9, 9, 240).astype(np.int8))})
    for op in ("+", "-", "*", "/", ">", "=="):
        for other in (1, 2, 3):
            for ir in (_bin(op, _col(0), _col(other)),
                       _bin(op, _col(other), _col(0))):
                got, want, tt, jt = both(ir, rb)
                assert tt == jt or (tt.precision, tt.scale) == \
                    (jt.precision, jt.scale)
                same(got, want)


@pytest.mark.parametrize("case", ["overflow", "divide"])
def test_ansi_raises_where_the_jax_package_does(case):
    a = pa.array([D("9" * 36 + ".00"), D("1.00")], pa.decimal128(38, 2))
    b = pa.array([D("9" * 36 + ".00"), D("0.00")], pa.decimal128(38, 2))
    rb = pa.record_batch({"a": a, "b": b})
    op, err = ("+", "NUMERIC_VALUE_OUT_OF_RANGE") if case == "overflow" \
        else ("/", "DIVIDE_BY_ZERO")
    got, want, _t, _j = both(_bin(op, _col(0), _col(1)), rb)
    same(got, want)  # non-ANSI: NULL
    assert None in got.to_pylist()
    _both_conf("spark.sql.ansi.enabled", "true")
    try:
        for batch, ex in ((TBatch.from_arrow(rb, device=CPU), t_expr),
                          (JBatch.from_arrow(rb), j_expr)):
            e = ex(_bin(op, _col(0), _col(1)),
                   (TSchema if ex is t_expr else JSchema).from_arrow(
                       rb.schema))
            with pytest.raises(ValueError, match=err):
                e.evaluate(batch)
        # try_* never raises
        for name in ("try_add", "try_divide"):
            got, want, _t, _j = both({"kind": "scalar_function",
                                      "name": name,
                                      "args": [_col(0), _col(1)]}, rb)
            same(got, want)
    finally:
        _both_conf("spark.sql.ansi.enabled", None)


def test_nested_chain_keeps_host_intermediates_exact():
    rng = np.random.default_rng(9)
    rb = pa.record_batch({"a": dec_array(rng, 18, 4),
                          "b": dec_array(rng, 18, 2),
                          "c": dec_array(rng, 7, 2)})
    ir = _bin("-", _bin("*", _col(0), _col(1)), _bin("+", _col(2),
                                                     _col(1)))
    got, want, _t, _j = both(ir, rb)
    same(got, want)
    got, want, _t, _j = both(_bin(">", ir, _col(2)), rb)
    same(got, want)


# ---------------------------------------------------------------------------
# the JAX package's faults (ROADMAP Queue 3), against Python's decimal
# ---------------------------------------------------------------------------

def test_a_decimal_literal_is_its_value():
    """decimal(18,6) 60.000000 x decimal(2,1) 1.2 = 72.0000000: the port
    computes it with the literal and with the same 1.2 in a column; the
    JAX package reads the literal as its truncated integer (1, which it
    takes as the unscaled value: 0.1) but is right column x column."""
    rb = pa.record_batch({
        "a": pa.array([D("60.000000"), D("-2.500000"), None],
                      pa.decimal128(18, 6)),
        "k": pa.array([D("1.2")] * 3, pa.decimal128(2, 1))})
    lit = _lit(D("1.2"), _dec_t(2, 1))
    want = [D("72.0000000"), D("-3.0000000"), None]
    got, jax_lit, _t, _j = both(_bin("*", _col(0), lit), rb)
    assert got.to_pylist() == want
    assert jax_lit.to_pylist()[0] == D("6.0000000")  # the JAX fault
    col_got, col_jax, _t, _j = both(_bin("*", _col(0), _col(1)), rb)
    assert col_got.to_pylist() == col_jax.to_pylist() == want
    # the same literal in a comparison and over the wire
    got, _w, _t, _j = both(_bin(">", _col(0), lit), rb)
    assert got.to_pylist() == [True, False, None]
    from blaze_tpu.plan import proto_serde as JP
    from blaze_tpu_torch.plan import proto_serde as TP
    for value in (D("1.2"), 1.2, "1.2"):
        sv = TP.scalar_to_proto(value, _dec_t(2, 1))
        assert TP.scalar_from_proto(sv) == (D("1.2"), _dec_t(2, 1))
        assert sv.SerializeToString() == JP.scalar_to_proto(
            D("1.2"), _dec_t(2, 1)).SerializeToString()


def test_a_decimal_meets_a_float_as_its_double():
    """decimal(7,2) 1.50 x 1.2 (float64) is 1.8 and 1.50 > 2.0 is false,
    as Spark casts the decimal to double; the JAX package computes on the
    unscaled 150 (180.0, true)."""
    rb = pa.record_batch({"a": pa.array([D("1.50"), D("-0.05"), None],
                                        pa.decimal128(7, 2)),
                          "f": pa.array([1.2, 2.0, 1.0])})
    got, jax, tt, _j = both(_bin("*", _col(0), _col(1)), rb)
    assert tt.id.value == "float64"
    assert got.to_pylist() == [1.5 * 1.2, -0.05 * 2.0, None]
    assert jax.to_pylist()[0] == 180.0  # the JAX fault
    got, jax, _t, _j = both(_bin(">", _col(0), _lit(2.0, {"id": "float64"})),
                            rb)
    assert got.to_pylist() == [False, False, None]
    assert jax.to_pylist()[0] is True  # the JAX fault
    # Spark's decimal-to-double cast is unscaled / 10^s: exact at scale 2
    got, want, _t, _j = both({"kind": "cast", "child": _col(0),
                              "type": {"id": "float64"}}, rb)
    same(got, want)
    assert got.to_pylist()[:2] == [1.5, -0.05]


@pytest.mark.parametrize("name", ["ceil", "floor"])
def test_ceil_and_floor_drop_the_fraction(name):
    """ceil/floor of a decimal keep the JAX package's result type (the
    input's) with Spark's integral value; the JAX package keeps the
    fraction (ceil(1.25) = 1.25)."""
    vals = [D("1.25"), D("-1.25"), D("2.00"), D("-0.01"), D("0.99"), None]
    rb = pa.record_batch({"a": pa.array(vals, pa.decimal128(9, 2))})
    got, jax, tt, jt = both({"kind": "scalar_function", "name": name,
                             "args": [_col(0)]}, rb)
    assert (tt.precision, tt.scale) == (jt.precision, jt.scale) == (9, 2)
    rounding = decimal.ROUND_CEILING if name == "ceil" \
        else decimal.ROUND_FLOOR
    want = [None if v is None else v.quantize(D(1), rounding=rounding)
            .quantize(D("0.01")) for v in vals]
    assert got.to_pylist() == want
    assert jax.to_pylist()[0] == D("1.25")  # the JAX fault


# ---------------------------------------------------------------------------
# casts
# ---------------------------------------------------------------------------

CAST_CASES = [
    ("int64", None, (10, 2)), ("int32", None, (5, 2)), ("int8", None, (3, 0)),
    ("bool", None, (4, 1)), ("float64", None, (10, 2)),
    ("float32", None, (9, 3)), ("utf8", None, (10, 2)),
    ("utf8", None, (38, 18)), ("decimal", (10, 2), (12, 4)),
    ("decimal", (12, 4), (10, 2)), ("decimal", (18, 6), (5, 2)),
    ("decimal", (38, 18), (10, 2)), ("decimal", (10, 2), (38, 2)),
    ("decimal", (10, 2), "int64"), ("decimal", (10, 2), "int16"),
    ("decimal", (18, 4), "float64"), ("decimal", (10, 2), "float32"),
    ("decimal", (10, 2), "utf8"), ("decimal", (38, 18), "utf8"),
    ("decimal", (38, 4), "float64"), ("decimal", (7, 2), "bool"),
]


def _cast_input(rng, src, ps):
    n = 240
    if src == "decimal":
        return dec_array(rng, *ps, n=n)
    if src == "utf8":
        vals = ["1.005", "-1.005", "-0.005", "0.005", " 12.345 ", "abc",
                "1e3", "99999999.995", "-2.5", None]
        return pa.array([vals[i % len(vals)] for i in range(n)])
    if src == "bool":
        return pa.array(rng.random(n) < 0.5)
    if src.startswith("float"):
        v = np.round(rng.normal(size=n) * 1000, 3)
        v[:8] = [0.005, -0.005, 1.005, -2.5, np.nan, np.inf, 1e20, -0.0]
        return pa.array(v.astype(src))
    v = rng.integers(np.iinfo(src).min, np.iinfo(src).max, n, dtype=src)
    v[:3] = [0, -1, 99]
    return pa.array(v)


@pytest.mark.parametrize("case", CAST_CASES, ids=str)
def test_cast_equals_the_jax_one(case):
    src, ps, dst = case
    rng = np.random.default_rng(len(str(case)))
    rb = pa.record_batch({"a": _cast_input(rng, src, ps)})
    to = _dec_t(*dst) if isinstance(dst, tuple) else {"id": dst}
    got, want, _t, _j = both({"kind": "cast", "child": _col(0),
                              "type": to}, rb)
    same(got, want)


def test_rescale_rounds_half_up_on_the_magnitude():
    """-0.005 -> -0.01 and 0.005 -> 0.01 (HALF_UP away from zero), on the
    device kernel and on the host cast."""
    rb = pa.record_batch({"a": pa.array(
        [D("-0.005"), D("0.005"), D("-0.015"), D("-0.004"), D("0.025")],
        pa.decimal128(10, 3))})
    got, want, _t, _j = both({"kind": "cast", "child": _col(0),
                              "type": _dec_t(10, 2)}, rb)
    same(got, want)
    assert got.to_pylist() == [D("-0.01"), D("0.01"), D("-0.02"),
                               D("0.00"), D("0.03")]


# ---------------------------------------------------------------------------
# sum and avg, the decimal functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["partial", "final_of_partial",
                                  "complete"])
@pytest.mark.parametrize("ps", [(7, 2), (17, 2), (9, 0), (18, 6)], ids=str)
def test_sum_and_avg_equal_the_jax_aggexec(mode, ps):
    from test_torch_agg_engine import _run
    rng = np.random.default_rng(ps[0] + ps[1])
    batches = []
    for _ in range(4):
        # keep the sums inside the capped 18 digits
        d = dec_array(rng, min(ps[0], 13), ps[1], n=300) \
            .cast(pa.decimal128(*ps))
        batches.append(pa.record_batch({
            "k": pa.array(rng.integers(0, 7, 300)), "d": d}))
    schema = batches[0].schema
    fns = [("sum", [1]), ("avg", [1]), ("min", [1]), ("max", [1]),
           ("count", [1])]
    if mode == "final_of_partial":
        outs = []
        for pkg in ("jax", "torch"):
            part, _m = _run(pkg, batches, schema, [0], fns, "partial")
            accs = [1, 2, 3, 4, 5, 6]
            fin_fns = [("sum", [1]), ("avg", [2, 3]), ("min", [4]),
                       ("max", [5]), ("count", [6])]
            assert len(part.schema) == 7, accs
            out, _m = _run(pkg, part.to_batches(), part.schema, [0],
                           fin_fns, "final")
            outs.append(out)
        j, t = outs
    else:
        j, _m = _run("jax", batches, schema, [0], fns, mode)
        t, _m = _run("torch", batches, schema, [0], fns, mode)
    assert t.schema.equals(j.schema)
    assert t.sort_by("g0").to_pylist() == j.sort_by("g0").to_pylist()


def test_decimal_functions_equal_the_jax_ones():
    rng = np.random.default_rng(12)
    rb = pa.record_batch({"a": dec_array(rng, 10, 2),
                          "w": dec_array(rng, 30, 4)})
    fn = {"kind": "scalar_function"}
    for ir in (
            dict(fn, name="unscaled_value", args=[_col(0)]),
            dict(fn, name="check_overflow", args=[_col(0)],
                 return_type=_dec_t(7, 1)),
            dict(fn, name="check_overflow", args=[_col(1)],
                 return_type=_dec_t(12, 2)),
            dict(fn, name="make_decimal",
                 args=[dict(fn, name="unscaled_value", args=[_col(0)])],
                 return_type=_dec_t(9, 2)),
            dict(fn, name="round", args=[_col(0), _lit(1, {"id": "int32"})]),
            dict(fn, name="bround", args=[_col(0),
                                          _lit(1, {"id": "int32"})]),
            dict(fn, name="round", args=[_col(0), _lit(3, {"id": "int32"})]),
            dict(fn, name="hash", args=[_col(0)]),
            dict(fn, name="xxhash64", args=[_col(0)]),
            dict(fn, name="try_multiply", args=[_col(0), _col(0)]),
            dict(fn, name="try_divide", args=[_col(1), _col(0)]),
            dict(fn, name="try_subtract", args=[_col(0), _col(1)])):
        got, want, _t, _j = both(ir, rb)
        same(got, want)


def test_round_half_even_and_half_up_are_exact():
    vals = [D("2.25"), D("2.35"), D("-2.25"), D("-2.35"), D("0.05"),
            D("-0.05"), D("99999999.95"), None]
    rb = pa.record_batch({"a": pa.array(vals, pa.decimal128(10, 2))})
    for name, mode in (("round", decimal.ROUND_HALF_UP),
                       ("bround", decimal.ROUND_HALF_EVEN)):
        got, want, _t, _j = both({"kind": "scalar_function", "name": name,
                                  "args": [_col(0),
                                           _lit(1, {"id": "int32"})]}, rb)
        same(got, want)
        assert got.to_pylist() == [
            None if v is None else v.quantize(D("0.1"), rounding=mode)
            .quantize(D("0.01")) for v in vals]


def test_hash_of_a_wide_decimal_is_sparks():
    """hash()/murmur3 of a decimal(p > 18) is murmur3 over the unscaled
    BigInteger's bytes (the JAX module's spark_decimal128_hash)."""
    rng = np.random.default_rng(13)
    arr = dec_array(rng, 30, 4, nulls=False)
    rb = pa.record_batch({"w": arr})
    cv = t_expr({"kind": "scalar_function", "name": "hash",
                 "args": [_col(0)]}, TSchema.from_arrow(rb.schema)).evaluate(
        TBatch.from_arrow(rb, device=CPU))
    hi, lo = T128.int128_limbs(arr)
    want = J128.spark_decimal128_hash(hi, lo).view(np.int32)
    assert np.array_equal(cv.data[:len(arr)].numpy(), want)


# ---------------------------------------------------------------------------
# sort keys and partition ids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [(7, 2), (18, 6), (38, 10)], ids=str)
def test_sort_order_equals_the_jax_package(ps):
    from blaze_tpu.ops.sort import host_sort_keys as j_keys
    from blaze_tpu.ops.sort import lexsort_host as j_lexsort
    from blaze_tpu_torch.ops.sort import host_sort_keys, lexsort_host
    rng = np.random.default_rng(ps[0])
    rb = pa.record_batch({"a": dec_array(rng, *ps, n=500)})
    for desc in (False, True):
        for nf in (False, True):
            t = lexsort_host(host_sort_keys(rb, [0], [desc], [nf]))
            j = j_lexsort(j_keys(rb, [0], [desc], [nf]))
            assert np.array_equal(t, j)
            vals = rb.column(0).take(pa.array(t)).to_pylist()
            body = [v for v in vals if v is not None]
            assert body == sorted(body, reverse=desc)
            assert (vals[0] is None) == nf


@pytest.mark.parametrize("ps", [(7, 2), (18, 6), (38, 10)], ids=str)
def test_sort_exec_equals_the_jax_one(ps):
    """SortExec over 2,000 rows: the device order keys for p <= 18, the
    host keys for p > 18 (the JAX package moves those to the device too,
    and raises there)."""
    from blaze_tpu.ops.scan import MemoryScanExec as JScan
    from blaze_tpu.ops.sort import SortExec as JSort
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu_torch.exprs import BoundReference as TRef
    from blaze_tpu_torch.ops.scan import MemoryScanExec as TScan
    from blaze_tpu_torch.ops.sort import SortExec as TSort
    rng = np.random.default_rng(ps[1] + 40)
    rb = pa.record_batch({"a": dec_array(rng, *ps, n=2000),
                          "i": pa.array(np.arange(2000))})
    t = TSort(TScan.from_arrow(pa.Table.from_batches([rb])),
              [(TRef(0), True, False)])
    got = pa.Table.from_batches([b.to_arrow() for b in t.execute(0)])
    if ps[0] <= 18:
        j = JSort(JScan(JSchema.from_arrow(rb.schema),
                        [[JBatch.from_arrow(rb)]]), [(JRef(0), True, False)])
        want = pa.Table.from_batches([b.to_arrow() for b in j.execute(0)])
        assert got.equals(want)
    vals = got.column(0).to_pylist()
    body = [v for v in vals if v is not None]
    assert body == sorted(body, reverse=True) and vals[-1] is None


@pytest.mark.parametrize("ps", [(7, 2), (18, 0), (38, 10)], ids=str)
def test_partition_ids_are_sparks(ps):
    """pmod(murmur3(key, 42), 16) over a decimal key and an int key: for
    p <= 18 the JAX package's ids (the key hashed as its unscaled long),
    for p > 18 murmur3 over the unscaled BigInteger's bytes."""
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.shuffle.partitioning import HashPartitioning as JHP
    from blaze_tpu_torch.exprs import BoundReference as TRef
    from blaze_tpu_torch.shuffle.partitioning import HashPartitioning as THP
    rng = np.random.default_rng(ps[0] + 1)
    arr = dec_array(rng, *ps, n=400)
    rb = pa.record_batch({"a": arr, "i": pa.array(rng.integers(0, 9, 400))})
    got = THP([TRef(0), TRef(1)], 16).partition_ids(
        TBatch.from_arrow(rb, device=CPU)).numpy()
    if ps[0] <= 18:
        import blaze_tpu.bridge.placement as P
        saved = P.host_resident
        P.host_resident = lambda: False
        try:
            want = JHP([JRef(0), JRef(1)], 16).partition_ids(
                JBatch.from_arrow(rb))
        finally:
            P.host_resident = saved
        assert np.array_equal(got, want)
        return
    hi, lo = T128.int128_limbs(arr)
    valid = np.asarray(arr.is_valid())
    h = np.where(valid, J128.spark_decimal128_hash(hi, lo), 42) \
        .astype(np.uint32)
    from blaze_tpu.kernels.hashing import murmur3_hash_long
    h = murmur3_hash_long(rb.column(1).to_numpy().astype(np.int64), h, np)
    want = np.mod(h.view(np.int32).astype(np.int64), 16)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# Arrow round trips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ps", [(7, 2), (9, 0), (18, 6)], ids=str)
@pytest.mark.parametrize("int32_tier", [False, True])
def test_columns_round_trip_as_the_jax_package(ps, int32_tier):
    """The unscaled int64 read of a decimal128 buffer (sliced arrays too),
    the way back byte for byte, and the int32 tier for p <= 9 under
    auron.tpu.encoding.decimal.enable."""
    from blaze_tpu.batch import decimal_from_unscaled as j_from
    from blaze_tpu_torch.batch import decimal_from_unscaled as t_from
    rng = np.random.default_rng(ps[0])
    arr = dec_array(rng, *ps).slice(3, 200)
    rb = pa.record_batch({"a": arr})
    if int32_tier:
        _both_conf("auron.tpu.encoding.decimal.enable", "true")
    try:
        tb = TBatch.from_arrow(rb, device=CPU)
        want_dtype = torch.int32 if int32_tier and ps[0] <= 9 \
            else torch.int64
        assert tb.columns[0].data.dtype == want_dtype
        back = tb.to_arrow().column(0)
        assert back.equals(arr)
        assert back.buffers()[1].to_pybytes() == \
            JBatch.from_arrow(rb).to_arrow().column(0).buffers()[1] \
            .to_pybytes()
        # the same batch through an arithmetic and back
        got, want, _t, _j = both(_bin("+", _col(0), _col(0)), rb)
        same(got, want)
    finally:
        _both_conf("auron.tpu.encoding.decimal.enable", None)
    v = rng.integers(-10 ** 17, 10 ** 17, 64)
    valid = rng.random(64) < 0.8
    t = t_from(v, valid, pa.decimal128(18, 3))
    j = j_from(v, valid, pa.decimal128(18, 3))
    assert t.equals(j) and t.buffers()[1] == j.buffers()[1]
    assert [x is None for x in t.to_pylist()] == list(~valid)


def test_decimal_literals_evaluate_exactly():
    """A decimal literal's unscaled value is value x 10^scale: device form
    for p <= 18, a host decimal128 for p > 18; NULL stays NULL."""
    rb = pa.record_batch({"i": pa.array([1, 2, 3])})
    for value, t, want in ((D("1.2"), _dec_t(2, 1), D("1.2")),
                           (D("-0.05"), _dec_t(3, 2), D("-0.05")),
                           (7, _dec_t(10, 2), D("7.00")),
                           (D("12345678901234567890.12"), _dec_t(38, 2),
                            D("12345678901234567890.12")),
                           (None, _dec_t(9, 2), None)):
        cv = t_expr(_lit(value, t), TSchema.from_arrow(rb.schema)) \
            .evaluate(TBatch.from_arrow(rb, device=CPU))
        assert cv.is_device == (t["precision"] <= 18)
        assert cv.to_host(3).to_pylist() == [want] * 3


def test_wide_decimal_keys_raise_in_the_jax_package():
    """ROADMAP Queue 3: a decimal of precision > 18 as a hash() argument
    or a partition key raises IndexError in the JAX package (it reads the
    decimal128 buffers as a string's offsets), and as the key of a sort
    of 1,024 rows or more TypeError (its device sort has no form for
    it); the port hashes Spark's bytes and sorts on the host keys
    (test_hash_of_a_wide_decimal_is_sparks, test_partition_ids_are_sparks,
    test_sort_exec_equals_the_jax_one)."""
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.ops.scan import MemoryScanExec as JScan
    from blaze_tpu.ops.sort import SortExec as JSort
    from blaze_tpu.shuffle.partitioning import HashPartitioning as JHP
    rng = np.random.default_rng(14)
    rb = pa.record_batch({"w": dec_array(rng, 30, 4, n=1100)})
    ir = {"kind": "scalar_function", "name": "hash", "args": [_col(0)]}
    with pytest.raises(IndexError):
        j_expr(ir, JSchema.from_arrow(rb.schema)).evaluate(
            JBatch.from_arrow(rb))
    with pytest.raises(IndexError):
        JHP([JRef(0)], 4).partition_ids(JBatch.from_arrow(rb))
    with pytest.raises(TypeError, match="p>18"):
        list(JSort(JScan(JSchema.from_arrow(rb.schema),
                         [[JBatch.from_arrow(rb)]]),
                   [(JRef(0), False, True)]).execute(0))
    assert t_expr(ir, TSchema.from_arrow(rb.schema)).evaluate(
        TBatch.from_arrow(rb, device=CPU)).is_device
