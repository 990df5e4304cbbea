"""The port's scalar-function registry (blaze_tpu_torch/funcs/) and its
special expressions, memory scan and json_tuple generator against the
JAX package's on the same numpy-seeded inputs.

  * the registry holds the JAX package's 117 names; every function of
    funcs/math.py, dates.py, crypto.py, json_fns.py, collections.py and
    try_arith.py equals the JAX one over NULLs, NaN, -0.0, infinities,
    integer extremes and dates and timestamps before 1970 (negative day
    and microsecond counts);
  * ceil and floor cast to int64 as Java does (NaN 0, the ends
    saturated), as the JAX package's XLA cast does;
  * the Spark rules the JAX package misses: signum keeps NaN and a zero's
    sign, greatest/least order NaN above every number in any argument
    position (the JAX package's `>` never takes a NaN that comes second:
    ROADMAP Queue 3), checked against a Python reference;
  * the decimal functions and a decimal argument raise, naming the
    decimal slice;
  * RowNum, SparkPartitionId, MonotonicallyIncreasingId, GetIndexedField,
    GetMapValue, NamedStruct and ScalarSubqueryWrapper equal the JAX
    ones; Rand and randn are deterministic per task (seed +
    partition_id), in range, and differ between partitions;
  * every expression kind of plan/exprs.py round-trips through the wire
    to the JAX package's bytes and dicts (but a case-insensitive RLIKE,
    which the JAX encoder writes as a case-sensitive one: ROADMAP Queue
    3); udf decodes on the wire and raises at planning, naming item 16
    (bloom_filter_might_contain runs since the expression slice:
    tests/test_torch_bloom.py);
  * MemoryScanExec and the json_tuple generator (and its wire node) give
    the JAX package's batches.

Tolerance: exact, but the transcendental float functions (sqrt, exp,
the trigonometric and log families, pow, atan2, cbrt, degrees, radians,
expm1, months_between), held within the corpus's rtol of 1e-12 (and
a subnormal result equal to a zero: the JAX package's CPU backend
flushes subnormals)."""

import math

import numpy as np
import pyarrow as pa
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema
from test_torch_strings import (CPU, check, col, evaluate_both, fn, lit,
                                same_values, words)

RTOL = 1e-12
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)


@pytest.fixture(autouse=True)
def cpu_device():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def test_the_registry_has_the_jax_names():
    import blaze_tpu.funcs as J
    import blaze_tpu_torch.funcs as T
    assert T.registered_names() == J.registered_names()
    assert len(T.registered_names()) == 117
    with pytest.raises(KeyError):
        T.lookup("no_such_function")


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def _math_batch(seed: int = 1) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    n = 200
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.0, 0.5,
                        -2.5, 2.5, 1e-10, -8.0, 27.0, 1e300, -1e-300])
    x = np.where(rng.random(n) < 0.4, special[rng.integers(0, 15, n)],
                 rng.normal(0, 10, n))
    y = np.where(rng.random(n) < 0.4, special[rng.integers(0, 15, n)],
                 rng.normal(0, 3, n))
    ints = rng.integers(-1000, 1000, n)
    ints[:4] = [I64MAX, I64MIN, 0, -1]
    return pa.record_batch({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "y": pa.array(y, mask=rng.random(n) < 0.1),
        "i": pa.array(ints, mask=rng.random(n) < 0.1),
        "j": pa.array(rng.integers(-5, 5, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(x.astype(np.float32), mask=rng.random(n) < 0.1),
    })


X, Y, INT, J, F32 = range(5)

FLOAT_FAMILY = ["sqrt", "exp", "sin", "cos", "tan", "asin", "acos", "atan",
                "sinh", "cosh", "tanh", "cbrt", "degrees", "radians",
                "expm1", "ln", "log10", "log2", "log1p"]


@pytest.mark.parametrize("name", FLOAT_FAMILY)
def test_float_functions(name):
    rb = _math_batch()
    for c in (X, INT, F32):
        check(fn(name, col(c)), rb, RTOL)


@pytest.mark.parametrize("name", ["abs", "negative", "ceil", "floor",
                                  "isnan"])
def test_exact_unary_functions(name):
    rb = _math_batch(2)
    for c in (X, INT, J, F32):
        if name == "isnan" and c in (INT, J):
            continue
        check(fn(name, col(c)), rb)


def test_signum_keeps_nan_and_the_zero_sign():
    rb = _math_batch(3)
    got = check(fn("signum", col(X)), rb)
    for x, g in zip(rb.column(X).to_pylist(), got.to_pylist()):
        if x is None:
            assert g is None
        elif math.isnan(x):
            assert math.isnan(g)
        else:
            assert g == (math.copysign(0.0, x) if x == 0 else
                         math.copysign(1.0, x))
            assert math.copysign(1.0, g) == math.copysign(1.0, x)
    check(fn("signum", col(INT)), rb)


@pytest.mark.parametrize("name", ["pow", "atan2"])
def test_binary_float_functions(name):
    rb = _math_batch(4)
    check(fn(name, col(X), col(Y)), rb, RTOL)
    check(fn(name, col(INT), lit(2.0, "float64")), rb, RTOL)


def test_nanvl_round_bround():
    rb = _math_batch(5)
    check(fn("nanvl", col(X), col(Y)), rb)
    for name in ("round", "bround"):
        for scale in (None, 0, 1, 2, -1, -2):
            args = [col(X)] + ([] if scale is None else
                               [lit(scale, "int32")])
            check(fn(name, *args), rb)
            check(fn(name, col(INT), *args[1:]), rb)
            check(fn(name, col(J), *args[1:]), rb)


def _spark_extreme(vals, largest):
    vals = [v for v in vals if v is not None]
    if not vals:
        return None
    nans = [v for v in vals if isinstance(v, float) and math.isnan(v)]
    real = [v for v in vals if not (isinstance(v, float) and math.isnan(v))]
    if largest:
        return nans[0] if nans else max(real)
    return min(real) if real else nans[0]


@pytest.mark.parametrize("name", ["greatest", "least"])
def test_greatest_least_order_nan_largest(name):
    rb = _math_batch(6)
    t, _j = evaluate_both(fn(name, col(X), col(Y)), rb)
    for x, y, g in zip(rb.column(X).to_pylist(), rb.column(Y).to_pylist(),
                       t.to_pylist()):
        want = _spark_extreme([x, y], name == "greatest")
        if want is None:
            assert g is None
        elif math.isnan(want):
            assert math.isnan(g)
        else:
            assert g == want
    # without NaN both packages agree, over three arguments too
    no_nan = pa.record_batch({
        "x": pa.array(np.nan_to_num(rb.column(X).to_numpy(
            zero_copy_only=False)), mask=rb.column(X).is_null().to_numpy(
                zero_copy_only=False)),
        "i": rb.column(INT), "j": rb.column(J)})
    check(fn(name, col(0), col(1)), no_nan)
    check(fn(name, col(1), col(2), lit(3, "int64")), no_nan)


# ---------------------------------------------------------------------------
# dates
# ---------------------------------------------------------------------------

def _date_batch(seed: int = 7) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    n = 240
    days = rng.integers(-200_000, 60_000, n)  # 1422 .. 2134, most before
    days[:8] = [-1, 0, -719_162, -25_567, 59, 60, -306, 11_016]
    us = rng.integers(-5_000_000_000_000_000, 3_000_000_000_000_000, n)
    us[:4] = [-1, 0, -86_400_000_000, -86_400_000_001]
    return pa.record_batch({
        "d": pa.array(days.astype(np.int32), pa.date32(),
                      mask=rng.random(n) < 0.1),
        "d2": pa.array(rng.integers(-100_000, 50_000, n).astype(np.int32),
                       pa.date32(), mask=rng.random(n) < 0.1),
        "ts": pa.array(us, pa.timestamp("us"), mask=rng.random(n) < 0.1),
        "n": pa.array(rng.integers(-400, 400, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(rng.choice(["2020-02-29", "1969-12-31 23:59:59",
                                  "1900-01-01T00:00:01.5", " 2001-1-2 ",
                                  "bad", "", None], n).tolist(),
                      type=pa.string()),
        "secs": pa.array(rng.integers(-3_000_000_000, 3_000_000_000, n),
                         mask=rng.random(n) < 0.1),
    })


D, D2, TS, N, STR, SECS = range(6)
DATE_FIELDS = ["year", "month", "day", "dayofmonth", "quarter",
               "dayofweek", "weekday", "dayofyear", "weekofyear",
               "last_day"]


@pytest.mark.parametrize("name", DATE_FIELDS)
def test_date_fields_before_and_after_1970(name):
    rb = _date_batch()
    check(fn(name, col(D)), rb)
    check(fn(name, col(TS)), rb)


@pytest.mark.parametrize("name", ["hour", "minute", "second"])
def test_time_fields(name):
    check(fn(name, col(TS)), _date_batch(8))


def test_date_arithmetic():
    rb = _date_batch(9)
    for name in ("date_add", "date_sub", "add_months"):
        check(fn(name, col(D), col(N)), rb)
        check(fn(name, col(TS), lit(3, "int32")), rb)
    check(fn("datediff", col(D), col(D2)), rb)
    check(fn("datediff", col(TS), col(D)), rb)
    check(fn("months_between", col(D), col(D2)), rb, RTOL)
    check(fn("months_between", col(TS), col(D), lit(False, "bool")), rb,
          RTOL)


@pytest.mark.parametrize("unit", ["year", "yyyy", "quarter", "month", "mm",
                                  "week", "day", "hour", "minute", "second",
                                  "millisecond", "microsecond", "decade"])
def test_trunc_and_date_trunc(unit):
    rb = _date_batch(10)
    check(fn("trunc", col(D), lit(unit, "utf8")), rb)
    check(fn("date_trunc", lit(unit, "utf8"), col(TS)), rb)


@pytest.mark.parametrize("day", ["MO", "tue", "Wednesday", "th", "fr",
                                 "sa", "Sunday", "xx"])
def test_next_day(day):
    check(fn("next_day", col(D), lit(day, "utf8")), _date_batch(11))


def test_parsing_and_formatting():
    rb = _date_batch(12)
    for c in (D, TS, STR):
        check(fn("to_date", col(c)), rb)
        check(fn("unix_timestamp", col(c)), rb)
    check(fn("from_unixtime", col(SECS)), rb)


# ---------------------------------------------------------------------------
# crypto, json, collections, try arithmetic
# ---------------------------------------------------------------------------

def test_digests_and_hashes():
    rng = np.random.default_rng(13)
    n = 150
    rb = pa.record_batch({
        "s": words(13, n),
        "b": pa.array([None if x is None else x.encode()
                       for x in words(14, n).to_pylist()], pa.binary()),
        "i": pa.array(rng.integers(-9, 9, n), mask=rng.random(n) < 0.1),
        "h": pa.array(rng.integers(-9, 9, n).astype(np.int32)),
        "x": pa.array(np.where(rng.random(n) < 0.2, np.nan,
                               rng.normal(size=n)),
                      mask=rng.random(n) < 0.1),
        "t": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
    })
    for name in ("md5", "sha1", "crc32"):
        check(fn(name, col(0)), rb)
        check(fn(name, col(1)), rb)
    for bits in (0, 224, 256, 384, 512, 100):
        check(fn("sha2", col(0), lit(bits, "int32")), rb)
    for name in ("hash", "murmur3_hash", "xxhash64"):
        for args in ([0], [2], [3], [4], [5], [2, 0, 4], [0, 1]):
            got, want = evaluate_both(fn(name, *map(col, args)), rb)
            same_values(got, want)


JSON_DOCS = ['{"a": 1, "b": {"c": [1, 2, {"d": "x"}]}, "e": null}',
             '{"a": "s", "b": {"c": []}, "f": true}', '[1, {"a": 2}]',
             'not json', '{"a": 1.5e3, "b": {"c": [7]}}', None, '{}']


@pytest.mark.parametrize("path", ["$.a", "$.b.c", "$.b.c[0]", "$.b.c[2].d",
                                  "$.b.c[*]", "$[1].a", "$.e", "$.f", "a",
                                  "$.['a']", "$.b.c[9]"])
def test_get_json_object(path):
    rb = pa.record_batch({"j": pa.array(JSON_DOCS * 3)})
    check(fn("get_json_object", col(0), lit(path, "utf8")), rb)


def test_to_json():
    st = pa.array([{"a": 1, "b": None, "c": {"d": None, "e": [1, None]}},
                   None, {"a": None, "b": "x", "c": None}],
                  pa.struct([("a", pa.int64()), ("b", pa.string()),
                             ("c", pa.struct([("d", pa.int64()),
                                              ("e", pa.list_(pa.int64()))]))
                             ]))
    mp = pa.array([[("k", 1), ("z", None)], [], None],
                  pa.map_(pa.string(), pa.int64()))
    lst = pa.array([[1, None, 3], [], None], pa.list_(pa.int64()))
    rb = pa.record_batch({"s": st, "m": mp, "l": lst})
    for c in range(3):
        check(fn("to_json", col(c)), rb)


def _collections_batch(seed: int = 15) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    n = 120

    def lst(kind):
        out = []
        for _ in range(n):
            if rng.random() < 0.1:
                out.append(None)
                continue
            k = int(rng.integers(0, 5))
            if kind == "f":
                vals = [None if rng.random() < 0.1 else
                        float(rng.choice([np.nan, 1.0, -0.5, 2.0]))
                        for _ in range(k)]
            else:
                vals = [None if rng.random() < 0.1 else
                        int(rng.integers(0, 5)) for _ in range(k)]
            out.append(vals)
        return out

    return pa.record_batch({
        "li": pa.array(lst("i"), pa.list_(pa.int64())),
        "lj": pa.array(lst("i"), pa.list_(pa.int64())),
        "lf": pa.array(lst("f"), pa.list_(pa.float64())),
        "k": pa.array(rng.integers(-5, 6, n), mask=rng.random(n) < 0.1),
        "s": words(seed, n, max_len=3),
        "m": pa.array([None if rng.random() < 0.1 else
                       [(str(int(rng.integers(0, 3))),
                         int(rng.integers(0, 9))) for _ in range(
                            int(rng.integers(0, 3)))] for _ in range(n)],
                      pa.map_(pa.string(), pa.int64())),
        "kv": pa.array(rng.choice(["a:1,b:2", "a:1,a:3", "x", "", None,
                                   "k:v:w,"], n).tolist(), pa.string()),
    })


LI, LJ, LF, K, S2, M, KV = range(7)

COLLECTION_CALLS = {
    "make_array": [fn("make_array", col(K), lit(7, "int64"))],
    "array": [fn("array", col(S2), col(S2))],
    "array_contains": [fn("array_contains", col(LI), col(K)),
                       fn("array_contains", col(LF),
                          lit(float("nan"), "float64"))],
    "size": [fn("size", col(LI)), fn("size", col(M))],
    "cardinality": [fn("cardinality", col(LF))],
    "array_union": [fn("array_union", col(LI), col(LJ))],
    "array_distinct": [fn("array_distinct", col(LI)),
                       fn("array_distinct", col(LF))],
    "array_max": [fn("array_max", col(LI)), fn("array_max", col(LF))],
    "array_min": [fn("array_min", col(LI)), fn("array_min", col(LF))],
    "array_join": [fn("array_join", col(LI), lit("|", "utf8")),
                   fn("array_join", col(LF), lit(",", "utf8"),
                      lit("NULL", "utf8"))],
    "str_to_map": [fn("str_to_map", col(KV)),
                   fn("str_to_map", col(KV), lit(";", "utf8"),
                      lit("=", "utf8"))],
    "map_keys": [fn("map_keys", col(M))],
    "map_values": [fn("map_values", col(M))],
    "element_at": [fn("element_at", col(LI), lit(2, "int64")),
                   fn("element_at", col(LI), lit(-1, "int64")),
                   fn("element_at", col(M), lit("1", "utf8"))],
    "try_element_at": [fn("try_element_at", col(LI), lit(3, "int64"))],
}


def test_every_collection_registration_is_covered():
    from blaze_tpu_torch.funcs import _REGISTRY
    from blaze_tpu_torch.funcs import collections as TC
    names = {n for n, (f, _t) in _REGISTRY.items()
             if f.__module__ == TC.__name__}
    assert names | {"try_element_at"} == set(COLLECTION_CALLS)


@pytest.mark.parametrize("name", sorted(COLLECTION_CALLS))
def test_collection_function_equals_the_jax_one(name):
    rb = _collections_batch()
    for ir in COLLECTION_CALLS[name]:
        check(ir, rb)


def _each(ir: dict, rb: pa.RecordBatch):
    """The port's and the JAX package's evaluations of `ir` over `rb`,
    each as a thunk (so that each can be asked to raise)."""
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.plan.exprs import expr_from_dict as j_expr
    from blaze_tpu.schema import Schema as JSchema
    n = rb.num_rows
    return (lambda: t_expr(ir, TSchema.from_arrow(rb.schema)).evaluate(
                TBatch.from_arrow(rb, device=CPU)).to_host(n),
            lambda: j_expr(ir, JSchema.from_arrow(rb.schema)).evaluate(
                JBatch.from_arrow(rb)).to_host(n))


def test_element_at_raises_where_the_jax_one_does():
    from blaze_tpu import config as jconf
    rb = _collections_batch(16)
    for run in _each(fn("element_at", col(LI), lit(0, "int64")), rb):
        with pytest.raises(ValueError, match="INVALID_INDEX_OF_ZERO"):
            run()
    for c in (jconf, tconf):
        c.conf.set("spark.sql.ansi.enabled", "true")
    try:
        for run in _each(fn("element_at", col(LI), lit(9, "int64")), rb):
            with pytest.raises(ValueError, match="INVALID_ARRAY_INDEX"):
                run()
        check(fn("try_element_at", col(LI), lit(9, "int64")), rb)
    finally:
        for c in (jconf, tconf):
            c.conf.unset("spark.sql.ansi.enabled")


@pytest.mark.parametrize("name", ["try_add", "try_subtract", "try_multiply",
                                  "try_divide"])
def test_try_arithmetic(name):
    rng = np.random.default_rng(17)
    n = 100
    a = rng.integers(-2**62, 2**62, n)
    a[:4] = [I64MAX, I64MIN, -1, 0]
    rb = pa.record_batch({
        "a": pa.array(a, mask=rng.random(n) < 0.1),
        "b": pa.array(rng.integers(-4, 4, n) * 2**61,
                      mask=rng.random(n) < 0.1),
        "c": pa.array(rng.integers(-100, 100, n).astype(np.int32)),
        "d": pa.array(rng.integers(-3, 3, n).astype(np.int8)),
        "x": pa.array(rng.normal(size=n)),
        "y": pa.array(rng.integers(-2, 2, n).astype(np.float32)),
    })
    for l, r in ((0, 1), (2, 3), (2, 2), (3, 3), (4, 5), (5, 3), (0, 4)):
        check(fn(name, col(l), col(r)), rb)


def test_decimal_functions_raise_naming_the_decimal_slice():
    """The decimal functions no longer raise (the decimal slice): each
    equals the JAX one over int64 unscaled values (tests/
    test_torch_decimal.py holds them over decimals)."""
    rb = pa.record_batch({"i": pa.array([1, -2, 10 ** 12, None])})
    for name in ("unscaled_value", "check_overflow"):
        check(fn(name, col(0)), rb)
    check(dict(fn("make_decimal", col(0)), return_type={
        "id": "decimal", "precision": 10, "scale": 2}), rb)


# ---------------------------------------------------------------------------
# special expressions
# ---------------------------------------------------------------------------

def _in_task(partition_id, f):
    from blaze_tpu.bridge.context import TaskContext as JCtx
    from blaze_tpu.bridge.context import task_scope as j_scope
    from blaze_tpu_torch.bridge.context import TaskContext as TCtx
    from blaze_tpu_torch.bridge.context import task_scope as t_scope
    with t_scope(TCtx(partition_id=partition_id)), \
            j_scope(JCtx(partition_id=partition_id)):
        return f()


@pytest.mark.parametrize("kind", ["row_num", "spark_partition_id",
                                  "monotonically_increasing_id"])
def test_ids(kind):
    rb = pa.record_batch({"s": words(18, 50)})
    for pid in (0, 3):
        _in_task(pid, lambda: check({"kind": kind}, rb))


def test_nested_access_and_named_struct():
    st = pa.array([{"a": 1, "b": "x"}, None, {"a": None, "b": "é"}],
                  pa.struct([("a", pa.int64()), ("b", pa.string())]))
    lst = pa.array([[1, None, 3], [], None], pa.list_(pa.int64()))
    mp = pa.array([[("k", 1), ("k", 2)], [("z", 3)], None],
                  pa.map_(pa.string(), pa.int64()))
    rb = pa.record_batch({"st": st, "l": lst, "m": mp,
                          "i": pa.array([1, None, 3])})
    for idx, t in ((0, "int64"), (1, "utf8")):
        check({"kind": "get_indexed_field", "child": col(0), "index": idx,
               "type": {"id": t}}, rb)
    for idx in (0, 1, 2, 5):
        check({"kind": "get_indexed_field", "child": col(1), "index": idx,
               "type": {"id": "int64"}}, rb)
    for key in ("k", "z", "q"):
        check({"kind": "get_map_value", "child": col(2), "key": key,
               "type": {"id": "int64"}}, rb)
    check({"kind": "named_struct", "names": ["x", "y"],
           "args": [col(3), col(0)]}, rb)


def test_scalar_subquery():
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    for v, t in ((42, "int64"), ("é", "utf8"), (None, "float64")):
        for put in (j_put, t_put):
            put("subquery://1", v)
        check({"kind": "scalar_subquery", "uuid": "subquery://1",
               "type": {"id": t}}, pa.record_batch({"i": pa.array([1, 2])}))


@pytest.mark.parametrize("kind", ["rand", "randn"])
def test_rand_is_deterministic_per_task(kind):
    from blaze_tpu_torch.bridge.context import TaskContext, task_scope
    rb = pa.record_batch({"i": pa.array(np.arange(300))})
    schema = TSchema.from_arrow(rb.schema)

    def draw(pid, seed=7, batches=2):
        e = t_expr({"kind": kind, "seed": seed}, schema)
        with task_scope(TaskContext(partition_id=pid)):
            return [e.evaluate(TBatch.from_arrow(rb, device=CPU))
                    .to_host(300).to_numpy() for _ in range(batches)]

    a, b = draw(0), draw(0)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1])  # the stream runs on
    assert not np.array_equal(a[0], draw(1)[0])
    assert np.array_equal(draw(1, seed=6)[0], draw(0, seed=7)[0])
    vals = np.concatenate(a)
    assert np.isfinite(vals).all()
    if kind == "rand":
        assert vals.min() >= 0.0 and vals.max() < 1.0
    else:
        assert abs(vals.mean()) < 0.2 and 0.8 < vals.std() < 1.2


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

WIRE_EXPRS = [
    {"kind": "like", "child": col(0), "pattern": "a%", "negated": True,
     "case_insensitive": True},
    {"kind": "rlike", "child": col(0), "pattern": "^[a-z]+$",
     "case_insensitive": False},
    {"kind": "string_starts_with", "child": col(0), "pattern": "é"},
    {"kind": "string_ends_with", "child": col(0), "pattern": "x"},
    {"kind": "string_contains", "child": col(0), "pattern": "天"},
    fn("substring", col(0), lit(1, "int32"), lit(2, "int32"), rt="utf8"),
    fn("upper", col(0)), fn("trim", col(0)), fn("concat", col(0), col(0)),
    fn("get_json_object", col(0), lit("$.a", "utf8"), rt="utf8"),
    fn("negative", col(1)),
    {"kind": "named_struct", "names": ["p", "q"], "args": [col(1), col(0)]},
    {"kind": "get_indexed_field", "child": col(2), "index": 1},
    {"kind": "get_map_value", "child": col(3), "key": "k"},
    {"kind": "row_num"}, {"kind": "spark_partition_id"},
    {"kind": "monotonically_increasing_id"}, {"kind": "randn", "seed": 5},
    {"kind": "scalar_subquery", "uuid": "sq-1", "type": {"id": "int64"}},
    {"kind": "bloom_filter_might_contain", "uuid": "bf-1", "value": col(1)},
    {"kind": "udf", "name": "f", "args": [col(1)],
     "type": {"id": "int64"}},
]


@pytest.mark.parametrize("i", range(len(WIRE_EXPRS)))
def test_expression_wire_equals_jax(i):
    from blaze_tpu.plan import proto_serde as JP
    from blaze_tpu_torch.plan import proto_serde as TP
    d = WIRE_EXPRS[i]
    data = TP.expr_to_proto(d).SerializeToString()
    assert data == JP.expr_to_proto(d).SerializeToString()
    msg = TP.pb.PhysicalExprNode()
    msg.ParseFromString(data)
    jmsg = JP.pb.PhysicalExprNode()
    jmsg.ParseFromString(data)
    decoded = TP.expr_from_proto(msg)
    assert decoded == JP.expr_from_proto(jmsg)
    assert TP.expr_to_proto(decoded).SerializeToString() == data


def test_a_case_insensitive_rlike_round_trips():
    from blaze_tpu_torch.plan import proto_serde as TP
    d = {"kind": "rlike", "child": col(0), "pattern": "ab",
         "case_insensitive": True}
    assert TP.expr_from_proto(TP.expr_to_proto(d)) == d


def test_struct_and_map_types_ride_the_wire():
    from blaze_tpu.plan import proto_serde as JP
    from blaze_tpu_torch.plan import proto_serde as TP
    for t in ({"id": "struct", "children": [
                  {"name": "a", "type": {"id": "int64"}, "nullable": True},
                  {"name": "b", "type": {"id": "utf8"}, "nullable": False}]},
              {"id": "map", "children": [
                  {"name": "key", "type": {"id": "utf8"}, "nullable": False},
                  {"name": "value", "type": {"id": "float64"},
                   "nullable": True}]}):
        data = TP.type_to_proto(t).SerializeToString()
        assert data == JP.type_to_proto(t).SerializeToString()
        assert TP.type_from_proto(TP.type_to_proto(t)) == t


@pytest.mark.parametrize("kind,item", [("udf", "16")])
def test_unported_kinds_raise_naming_their_item(kind, item):
    d = next(e for e in WIRE_EXPRS if e["kind"] == kind)
    schema = TSchema.from_arrow(pa.schema([("s", pa.string()),
                                           ("i", pa.int64())]))
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        t_expr(d, schema)


def test_every_jax_expression_kind_decodes():
    """The kinds of blaze_tpu/plan/exprs.py's docstring: each decodes in
    the port, or raises naming its item (udf 16)."""
    import blaze_tpu.plan.exprs as JX
    doc = JX.__doc__.split("Expression kinds")[1]
    kinds = {k.strip() for k in doc.replace("(the `kind` discriminator):",
                                            "").replace("\n", " ").split(",")}
    kinds.discard("")
    assert len(kinds) == 29
    covered = {d["kind"] for d in WIRE_EXPRS} | {
        "column", "literal", "binary", "is_null", "is_not_null", "not",
        "case", "if", "coalesce", "in_list", "cast", "try_cast",
        "scalar_function", "rand"}
    assert kinds <= covered


# ---------------------------------------------------------------------------
# the memory scan and json_tuple
# ---------------------------------------------------------------------------

def _run_both(ir, table, rid):
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu.plan import create_plan as j_create
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    from blaze_tpu_torch.plan import create_plan as t_create
    t_put(rid, table)
    j_put(rid, table)
    t_plan, j_plan = t_create(ir), j_create(ir)
    out = []
    for p in range(t_plan.num_partitions):
        got = [b.compact().to_arrow() for b in t_plan.execute(p)]
        want = [b.compact().to_arrow() for b in j_plan.execute(p)]
        assert [b.num_rows for b in got] == [b.num_rows for b in want]
        for g, w in zip(got, want):
            assert g.equals(w)
        out.extend(got)
    return out


def _mem_scan(table, rid, parts=1):
    from blaze_tpu_torch.plan.types import schema_to_dict
    return {"kind": "memory_scan", "resource_id": rid,
            "schema": schema_to_dict(TSchema.from_arrow(table.schema)),
            "num_partitions": parts}


def test_memory_scan_deals_batches_like_the_jax_one():
    from blaze_tpu import config as jconf
    table = pa.table({"s": words(19, 50), "i": pa.array(np.arange(50))})
    for c in (jconf, tconf):
        c.conf.set("auron.batch.size", 7)
    try:
        out = _run_both(_mem_scan(table, "mem://deal", 3), table,
                        "mem://deal")
    finally:
        for c in (jconf, tconf):
            c.conf.unset("auron.batch.size")
    assert sum(b.num_rows for b in out) == 50 and len(out) == 8


def test_json_tuple_equals_the_jax_generator():
    table = pa.table({"k": pa.array(np.arange(21)),
                      "j": pa.array(JSON_DOCS * 3)})
    ir = {"kind": "generate", "input": _mem_scan(table, "mem://json"),
          "generator": {"kind": "json_tuple", "child": col(1),
                        "fields": ["a", "b", "e", "zz"]},
          "required_cols": [0]}
    out = _run_both(ir, table, "mem://json")
    assert out[0].schema.names == ["k", "c0", "c1", "c2", "c3"]


def test_json_tuple_wire_equals_jax():
    from blaze_tpu.plan import proto_serde as JP
    from blaze_tpu.plan.planner import decode_task_definition as j_decode
    from blaze_tpu_torch.plan import proto_serde as TP
    from blaze_tpu_torch.plan.planner import decode_task_definition \
        as t_decode
    scan = {"kind": "ipc_reader", "resource_id": "r", "num_partitions": 1,
            "schema": {"fields": [
                {"name": "k", "type": {"id": "int64"}, "nullable": True},
                {"name": "j", "type": {"id": "utf8"}, "nullable": True}]}}
    td = {"stage_id": 1, "partition_id": 0, "task_attempt_id": 0,
          "plan": {"kind": "generate", "input": scan,
                   "generator": {"kind": "json_tuple", "child": col(1),
                                 "fields": ["a", "b"]},
                   "required_child_output": ["k"]}}
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    assert t_decode(data) == j_decode(data)
