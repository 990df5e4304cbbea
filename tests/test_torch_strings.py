"""The port's string pieces (blaze_tpu_torch/exprs/binary.py's host
branch, exprs/strings.py, kernels/strings.py and funcs/strings.py)
against the JAX package's on the same numpy-seeded inputs: multi-byte
UTF-8 (two-, three- and four-byte characters), NUL bytes, empty strings
and NULLs.

  * utf8 `== != < <= > >=` and `<=>` between two columns and against a
    literal (Arrow orders UTF-8 bytes unsigned, as Spark does), and a
    Kleene AND/OR whose side is a string predicate's host bools;
  * StringPredicate (starts_with, ends_with, contains), LIKE (with `%`,
    `_`, an escape, negated, case-insensitive) and RLIKE;
  * every registration of funcs/strings.py (all 30 names), with literal
    and column arguments where the function takes both;
  * `substring`'s vectorised route for literal arguments
    (`substring_const`) against its per-row route (`substring_rows`) on
    random multi-byte UTF-8, over every start in -12..12 (zero, negative
    and past either end) and every length in -2..12;
  * the byte-matrix kernels of kernels/strings.py against
    blaze_tpu.kernels.strings on the same matrices;
  * a fixed-width result computed on the host (`length`, `instr`, LIKE)
    projected over two batches that the coalescing stream concatenates:
    the column is on the device, and the rows equal the JAX package's.

Tolerance: exact (Arrow equality, or equal Python values)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.plan.exprs import expr_from_dict as j_expr
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")

#: characters of 1 to 4 UTF-8 bytes, a NUL and the ASCII digits that
#: q08 and q45 compare
ALPHABET = list("ab Z0159_%.-") + ["\x00", "é", "ß", "ü", "天", "地", "😁",
                                   "𝄞"]


@pytest.fixture(autouse=True)
def cpu_device():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def words(seed: int, n: int = 200, max_len: int = 9,
          null_rate: float = 0.1) -> pa.Array:
    """Random UTF-8 strings (empty ones included) with NULLs."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < null_rate:
            out.append(None)
            continue
        k = int(rng.integers(0, max_len + 1))
        out.append("".join(ALPHABET[i] for i in
                           rng.integers(0, len(ALPHABET), k)))
    return pa.array(out, type=pa.string())


def col(i: int) -> dict:
    return {"kind": "column", "index": i}


def lit(v, t: str) -> dict:
    return {"kind": "literal", "value": v, "type": {"id": t}}


def fn(name: str, *args, rt=None) -> dict:
    d = {"kind": "scalar_function", "name": name, "args": list(args)}
    if rt:
        d["return_type"] = {"id": rt}
    return d


def evaluate_both(ir: dict, rb: pa.RecordBatch):
    """(port, JAX) results of one expression IR over `rb`, as Arrow
    arrays of rb.num_rows."""
    n = rb.num_rows
    tb = TBatch.from_arrow(rb, device=CPU)
    jb = JBatch.from_arrow(rb)
    te = t_expr(ir, TSchema.from_arrow(rb.schema))
    je = j_expr(ir, JSchema.from_arrow(rb.schema))
    return te.evaluate(tb).to_host(n), je.evaluate(jb).to_host(n)


#: the smallest normal float64: below it the JAX package's CPU backend
#: flushes a result to zero where torch (and Java) keep the subnormal
TINY = 2.2250738585072014e-308


def _nan_safe(v):
    """A nested value with NaN replaced by a marker, so that equality
    holds NaN equal to NaN inside lists, maps and structs."""
    if isinstance(v, float) and v != v:
        return "NaN"
    if isinstance(v, (list, tuple)):
        return [_nan_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _nan_safe(x) for k, x in v.items()}
    return v


def _plain(arr: pa.Array) -> pa.Array:
    """Dates and timestamps as their integers (a result may lie outside
    Python's datetime range)."""
    if pa.types.is_date32(arr.type):
        return arr.cast(pa.int32())
    if pa.types.is_timestamp(arr.type):
        return arr.cast(pa.int64())
    return arr


def same_values(got: pa.Array, want: pa.Array, rtol: float = 0.0) -> None:
    """Equal Python values row by row (NaN equal to NaN; floats within
    `rtol`, or both below the smallest normal float)."""
    g, w = _plain(got).to_pylist(), _plain(want).to_pylist()
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        if isinstance(b, float) and isinstance(a, float):
            if b != b:
                assert a != a, (i, a, b)
            elif rtol:
                assert (a == b or abs(a - b) <= rtol * abs(b)
                        or abs(a) < TINY and abs(b) < TINY), (i, a, b)
            else:
                assert a == b and np.signbit(a) == np.signbit(b), (i, a, b)
        else:
            assert _nan_safe(a) == _nan_safe(b), (i, a, b)


def check(ir: dict, rb: pa.RecordBatch, rtol: float = 0.0) -> pa.Array:
    got, want = evaluate_both(ir, rb)
    same_values(got, want, rtol)
    return got


# ---------------------------------------------------------------------------
# utf8 comparisons and Kleene logic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["==", "!=", "<", "<=", ">", ">=", "<=>"])
def test_utf8_comparisons_order_bytes_unsigned(op):
    rb = pa.record_batch({"a": words(1), "b": words(2)})
    got = check({"kind": "binary", "op": op, "l": col(0), "r": col(1)}, rb)
    # against Python's order of the UTF-8 bytes (unsigned)
    py = {"==": lambda x, y: x == y, "!=": lambda x, y: x != y,
          "<": lambda x, y: x < y, "<=": lambda x, y: x <= y,
          ">": lambda x, y: x > y, ">=": lambda x, y: x >= y}
    for x, y, g in zip(rb.column(0).to_pylist(), rb.column(1).to_pylist(),
                       got.to_pylist()):
        if op == "<=>":
            assert g == (x == y)
        elif x is None or y is None:
            assert g is None
        else:
            assert g == py[op](x.encode(), y.encode())
    check({"kind": "binary", "op": op, "l": col(0),
           "r": lit("ab", "utf8")}, rb)


def test_q08_zip_filter_and_a_null_literal():
    zips = pa.array(["19999", "20000", "200001", "1", "", "99", None,
                     "2000\x00", "１"])
    rb = pa.record_batch({"z": zips})
    got = check({"kind": "binary", "op": "<", "l": col(0),
                 "r": lit("20000", "utf8")}, rb)
    assert got.to_pylist() == [True, False, False, True, True, False,
                               None, True, False]
    check({"kind": "binary", "op": "<", "l": col(0),
           "r": lit(None, "utf8")}, rb)


@pytest.mark.parametrize("op", ["and", "or"])
def test_kleene_logic_with_a_host_side(op):
    rb = pa.record_batch({"s": words(3), "k": pa.array(
        np.random.default_rng(3).integers(0, 3, 200),
        mask=np.random.default_rng(4).random(200) < 0.2)})
    pred = {"kind": "string_contains", "child": col(0), "pattern": "a"}
    dev = {"kind": "binary", "op": "==", "l": col(1), "r": lit(1, "int64")}
    check({"kind": "binary", "op": op, "l": pred, "r": dev}, rb)
    check({"kind": "binary", "op": op, "l": dev, "r": pred}, rb)
    check({"kind": "binary", "op": op, "l": pred,
           "r": lit(None, "null")}, rb)


# ---------------------------------------------------------------------------
# string predicates, LIKE, RLIKE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["string_starts_with", "string_ends_with",
                                  "string_contains"])
@pytest.mark.parametrize("needle", ["a", "é天", "", "\x00", "😁b"])
def test_string_predicates(kind, needle):
    rb = pa.record_batch({"s": words(5, 300)})
    check({"kind": kind, "child": col(0), "pattern": needle}, rb)


@pytest.mark.parametrize("pattern,neg,ci", [
    ("a%", False, False), ("%é_", False, False), ("_", True, False),
    ("%\\%%", False, False), ("A%Z", False, True), ("", False, False),
    ("%天%地%", True, False), ("%", False, False)])
def test_like(pattern, neg, ci):
    rb = pa.record_batch({"s": words(6, 300)})
    check({"kind": "like", "child": col(0), "pattern": pattern,
           "negated": neg, "case_insensitive": ci}, rb)


@pytest.mark.parametrize("pattern,ci", [("a.b", False), ("^[0-9]+$", False),
                                        ("É", True), ("天|😁", False)])
def test_rlike(pattern, ci):
    rb = pa.record_batch({"s": words(7, 300)})
    check({"kind": "rlike", "child": col(0), "pattern": pattern,
           "case_insensitive": ci}, rb)


# ---------------------------------------------------------------------------
# funcs/strings.py: every registration
# ---------------------------------------------------------------------------

def _strings_batch(seed: int = 11) -> pa.RecordBatch:
    rng = np.random.default_rng(seed)
    n = 160
    return pa.record_batch({
        "s": words(seed, n),
        "t": words(seed + 1, n, max_len=3),
        "i": pa.array(rng.integers(-6, 10, n).astype(np.int32),
                      mask=rng.random(n) < 0.1),
        "c": pa.array(rng.integers(-300, 600, n),
                      mask=rng.random(n) < 0.1),
        "sep": pa.array(rng.choice(["-", "", "é", None], n).tolist(),
                        type=pa.string()),
        "l": pa.array([None if rng.random() < 0.1 else
                       words(int(rng.integers(0, 1000)), 3, 4, 0.3)
                       .to_pylist() for _ in range(n)],
                      type=pa.list_(pa.string())),
        "j": pa.array(rng.choice(["a,b:1", "x:2,,y", "", "k:v:w",
                                  None], n).tolist(), type=pa.string()),
    })


S, T, I, C, SEP, L, J = range(7)

STRING_CALLS = {
    "concat": [fn("concat", col(S), col(T)),
               fn("concat", col(S), lit("!", "utf8"), col(T))],
    "concat_ws": [fn("concat_ws", lit("-", "utf8"), col(S), col(T)),
                  fn("concat_ws", col(SEP), col(S), col(L)),
                  fn("concat_ws", lit(None, "utf8"), col(S))],
    "upper": [fn("upper", col(S))],
    "lower": [fn("lower", col(S))],
    "trim": [fn("trim", col(S)), fn("trim", col(S), lit("aé", "utf8"))],
    "ltrim": [fn("ltrim", col(S)), fn("ltrim", col(S), lit("a ", "utf8"))],
    "rtrim": [fn("rtrim", col(S)), fn("rtrim", col(S), lit("b", "utf8"))],
    "length": [fn("length", col(S))],
    "char_length": [fn("char_length", col(S))],
    "octet_length": [fn("octet_length", col(S))],
    "substring": [fn("substring", col(S), lit(2, "int32"), lit(3, "int32")),
                  fn("substring", col(S), lit(-3, "int32")),
                  fn("substring", col(S), col(I), lit(2, "int32")),
                  fn("substring", col(S), lit(1, "int32"), col(I))],
    "substr": [fn("substr", col(S), lit(0, "int32"), lit(3, "int32"))],
    "locate": [fn("locate", col(T), col(S)),
               fn("locate", col(T), col(S), col(I))],
    "position": [fn("position", lit("a", "utf8"), col(S))],
    "strpos": [fn("strpos", col(S), lit("é", "utf8"))],
    "instr": [fn("instr", col(S), col(T)),
              fn("instr", col(S), lit(None, "utf8"))],
    "lpad": [fn("lpad", col(S), col(I), lit("é.", "utf8")),
             fn("lpad", col(S), lit(6, "int32"))],
    "rpad": [fn("rpad", col(S), col(I), col(T))],
    "repeat": [fn("repeat", col(T), col(I))],
    "reverse": [fn("reverse", col(S))],
    "split": [fn("split", col(S), lit("a|é", "utf8")),
              fn("split", col(S), lit("[0-9]", "utf8"), lit(2, "int32")),
              fn("split", col(S), lit("b", "utf8"), lit(0, "int32"))],
    "replace": [fn("replace", col(S), lit("a", "utf8"), lit("天", "utf8")),
                fn("replace", col(S), lit("é", "utf8"))],
    "regexp_replace": [fn("regexp_replace", col(S), lit("([a-z])", "utf8"),
                          lit("<$1>", "utf8")),
                       fn("regexp_replace", col(S), lit("[é天]", "utf8"),
                          lit("\\$", "utf8"))],
    "regexp_extract": [fn("regexp_extract", col(S), lit("([a-z])(.)",
                                                         "utf8"),
                          lit(2, "int32")),
                       fn("regexp_extract", col(S), lit("[0-9]+", "utf8"),
                          lit(0, "int32"))],
    "translate": [fn("translate", col(S), lit("abé", "utf8"),
                     lit("x天", "utf8"))],
    "initcap": [fn("initcap", col(S))],
    "substring_index": [fn("substring_index", col(S), lit("a", "utf8"),
                           col(I)),
                        fn("substring_index", col(S), col(T),
                           lit(-1, "int32"))],
    "ascii": [fn("ascii", col(S))],
    "chr": [fn("chr", col(C))],
    "space": [fn("space", col(I))],
}


def test_every_string_registration_is_covered():
    from blaze_tpu.funcs import strings as JS
    from blaze_tpu_torch.funcs import _REGISTRY
    from blaze_tpu_torch.funcs import strings as TS
    t_names = {n for n, (f, _t) in _REGISTRY.items()
               if f.__module__ == TS.__name__}
    import blaze_tpu.funcs as JF
    j_names = {n for n, (f, _t) in JF._REGISTRY.items()
               if f.__module__ == JS.__name__}
    assert t_names == j_names == set(STRING_CALLS) and len(t_names) == 30


@pytest.mark.parametrize("name", sorted(STRING_CALLS))
def test_string_function_equals_the_jax_one(name):
    rb = _strings_batch()
    for ir in STRING_CALLS[name]:
        check(ir, rb)


def test_substring_constant_route_equals_the_row_route():
    from blaze_tpu_torch.funcs.strings import (substring_const,
                                               substring_rows)
    s = words(21, 120, max_len=8)
    n = len(s)
    for start in range(-12, 13):
        starts = pa.array([start] * n, pa.int32())
        assert substring_const(s, start, None, False).equals(
            substring_rows(s, starts)), start
        for length in range(-2, 13):
            lens = pa.array([length] * n, pa.int32())
            assert substring_const(s, start, length).equals(
                substring_rows(s, starts, lens)), (start, length)
    assert substring_const(s, None, 2).null_count == n
    assert substring_const(s, 1, None).null_count == n


def test_substring_routes_and_their_stats():
    from blaze_tpu_torch.funcs.strings import SUBSTRING_STATS
    rb = pa.record_batch({"s": words(22, 50), "i": pa.array(
        np.arange(50, dtype=np.int32) % 7 - 3)})
    before = dict(SUBSTRING_STATS)
    check(fn("substring", col(0), lit(-2, "int32"), lit(5, "int32")), rb)
    check(fn("substring", col(0), col(1), lit(5, "int32")), rb)
    assert SUBSTRING_STATS["calls"] == before["calls"] + 2
    assert SUBSTRING_STATS["vector"] == before["vector"] + 1
    assert SUBSTRING_STATS["rows"] == before["rows"] + 100
    assert SUBSTRING_STATS["seconds"] > before["seconds"]


# ---------------------------------------------------------------------------
# kernels/strings.py
# ---------------------------------------------------------------------------

def _mats(seed: int):
    from blaze_tpu.kernels.hashing import string_column_to_padded_bytes
    (mat, lengths), _valid = string_column_to_padded_bytes(
        words(seed, 150, max_len=12, null_rate=0.0))
    return mat, lengths


@pytest.mark.parametrize("name,pattern", [
    ("starts_with", "a".encode()), ("starts_with", "é天".encode()),
    ("ends_with", "b".encode()), ("ends_with", "😁".encode()),
    ("contains", "a ".encode()), ("contains", "天".encode()),
    ("eq_const", "ab".encode()), ("starts_with", b""), ("contains", b""),
    ("ends_with", b"x" * 40), ("eq_const", b"")])
def test_byte_matrix_predicates(name, pattern):
    from blaze_tpu.kernels import strings as JK
    from blaze_tpu_torch.kernels import strings as TK
    mat, lengths = _mats(len(pattern) + 30)
    got = getattr(TK, name)(torch.from_numpy(mat), torch.from_numpy(lengths),
                            pattern)
    want = getattr(JK, name)(mat, lengths, pattern)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_byte_matrix_length_and_case():
    from blaze_tpu.kernels import strings as JK
    from blaze_tpu_torch.kernels import strings as TK
    mat, lengths = _mats(40)
    tm, tl = torch.from_numpy(mat), torch.from_numpy(lengths)
    np.testing.assert_array_equal(TK.length_utf8_chars(tm, tl).numpy(),
                                  np.asarray(JK.length_utf8_chars(mat,
                                                                  lengths)))
    for f in ("upper_ascii", "lower_ascii"):
        np.testing.assert_array_equal(getattr(TK, f)(tm).numpy(),
                                      np.asarray(getattr(JK, f)(mat)))


@pytest.mark.parametrize("start", [-14, -3, -1, 0, 1, 2, 9, 13])
@pytest.mark.parametrize("sub_len", [0, 1, 3, 20])
def test_byte_matrix_substring(start, sub_len):
    from blaze_tpu.kernels import strings as JK
    from blaze_tpu_torch.kernels import strings as TK
    mat, lengths = _mats(41)
    got, got_len = TK.substring_fixed(torch.from_numpy(mat),
                                      torch.from_numpy(lengths), start,
                                      sub_len)
    want, want_len = JK.substring_fixed(mat, lengths, start, sub_len)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))


# ---------------------------------------------------------------------------
# a host-computed fixed-width column through the coalescing stream
# ---------------------------------------------------------------------------

def test_host_results_project_as_device_columns_over_two_batches():
    from blaze_tpu_torch.batch import DeviceColumn
    from blaze_tpu_torch.ops.base import CoalesceStream
    from blaze_tpu_torch.plan import create_plan as t_create
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    from blaze_tpu.plan import create_plan as j_create
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu_torch.plan.types import schema_to_dict
    table = pa.table({"s": words(31, 10)})
    exprs = [fn("length", col(0)), fn("instr", col(0), lit("a", "utf8")),
             {"kind": "like", "child": col(0), "pattern": "%a%"},
             fn("upper", col(0))]
    scan = {"kind": "memory_scan", "resource_id": "strings://two",
            "schema": schema_to_dict(TSchema.from_arrow(table.schema)),
            "num_partitions": 1}
    ir = {"kind": "project", "input": scan, "exprs": exprs,
          "names": ["n", "pos", "has_a", "up"]}
    t_put("strings://two", table)
    j_put("strings://two", table)
    for c in (tconf, __import__("blaze_tpu.config").config):
        c.conf.set("auron.batch.size", 6)
    try:
        t_plan, j_plan = t_create(ir), j_create(ir)
        batches = list(t_plan.execute(0))
        assert len(batches) == 2  # 6 + 4 rows
        for b in batches:
            assert all(isinstance(c, DeviceColumn) for c in b.columns[:3])
        merged = list(CoalesceStream(iter(batches), batch_size=1024))
        assert len(merged) == 1 and merged[0].num_rows == 10
        got = pa.Table.from_batches([merged[0].to_arrow()])
        want = pa.Table.from_batches(
            [b.compact().to_arrow() for b in j_plan.execute(0)])
    finally:
        for c in (tconf, __import__("blaze_tpu.config").config):
            c.conf.unset("auron.batch.size")
    assert got.to_pylist() == want.to_pylist()
