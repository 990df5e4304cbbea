"""Spark-semantics conformance corpus, run through the PyTorch port (a
copy of blaze_tpu/itest/spark_corpus.py's vectors, 65 suites with
spark_corpus_ext.py).

Each case is an expression list (projected over a memory scan of its
input table) or a plan over one or two memory scans, with the rows Spark
gives: 1-based string indexing, Java division and modulo, HALF_UP round
against HALF_EVEN bround, concat_ws skipping NULLs, three-valued logic,
NaN ordering, non-ANSI overflow wrapping and ANSI raising, ...  Every
case runs the real path: IR dict -> `create_plan` -> execute, on the
device `auron.torch.device` names (the card by default, the CPU in the
tests).

The include/exclude settings keep the reference's DSL:

    settings = CorpusSettings()
    settings.enable_suite("StringFunctionsSuite") \\
            .exclude("substring_index - negative count", reason="...")
    results = run_corpus(settings)

`later_item(suite, case)` names the ROADMAP item a case waits for in the
port, or None when it must pass: since the decimal slice no case waits
(`holds_decimal` names the 27 cases that waited for it).  The vectors
must stay equal to the JAX package's (tests/test_torch_spark_corpus.py
compares them).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import pyarrow as pa


# ---------------------------------------------------------------------------
# DSL (ref SparkTestSettings.scala)
# ---------------------------------------------------------------------------

@dataclass
class SuiteSettings:
    name: str
    included: Optional[List[str]] = None   # None = all
    excluded: Dict[str, str] = field(default_factory=dict)  # case -> reason
    include_prefixes: List[str] = field(default_factory=list)

    def include(self, *names: str) -> "SuiteSettings":
        if self.included is None:
            self.included = []
        self.included.extend(names)
        return self

    def include_by_prefix(self, *prefixes: str) -> "SuiteSettings":
        self.include_prefixes.extend(prefixes)
        return self

    def exclude(self, name: str, reason: str = "") -> "SuiteSettings":
        self.excluded[name] = reason
        return self

    def selects(self, case_name: str) -> bool:
        if case_name in self.excluded:
            return False
        if self.included is None and not self.include_prefixes:
            return True
        if self.included and case_name in self.included:
            return True
        return any(case_name.startswith(p) for p in self.include_prefixes)


class CorpusSettings:
    def __init__(self):
        self.suites: Dict[str, SuiteSettings] = {}

    def enable_suite(self, name: str) -> SuiteSettings:
        if name not in SUITES:
            raise KeyError(f"unknown suite {name!r}; have {sorted(SUITES)}")
        s = SuiteSettings(name)
        self.suites[name] = s
        return s

    def enable_all(self) -> "CorpusSettings":
        for name in SUITES:
            self.enable_suite(name)
        return self


# ---------------------------------------------------------------------------
# case model
# ---------------------------------------------------------------------------

@dataclass
class Case:
    """One conformance vector: expression(s) over an input column set.

    Two shapes:
      * projection vectors — `exprs` are projected over `input`;
      * plan vectors — `plan(scan_ir[, scan2_ir])` builds an arbitrary
        root plan (sort / agg / join...) over the memory scan(s), the
        analog of the reference's full-suite re-runs that exercise
        operators, not just expressions.
    `confs` scopes engine config keys around the run (the ANSI-toggle
    analog of SparkTestSettings' per-suite conf overrides).
    `unordered` compares results as multisets (agg/join output order is
    not contractual, like Spark's checkAnswer).
    """

    name: str
    input: pa.Table                      # input columns c0..cn
    exprs: List[dict]                    # IR expression dicts
    expected: List[tuple]                # rows of expected output
    rtol: float = 0.0                    # float tolerance (0 = exact)
    confs: Optional[Dict[str, Any]] = None
    plan: Optional[Callable[..., dict]] = None
    input2: Optional[pa.Table] = None    # second scan for join vectors
    unordered: bool = False
    raises: Optional[str] = None         # expect failure containing this


def _col(i: int) -> dict:
    return {"kind": "column", "index": i}


def _lit(v, t="int64") -> dict:
    return {"kind": "literal", "value": v, "type": {"id": t}}


def _fn(name: str, *args, rt: Optional[str] = None) -> dict:
    d = {"kind": "scalar_function", "name": name, "args": list(args)}
    if rt:
        d["return_type"] = {"id": rt}
    return d


def _bin(op, l, r) -> dict:
    return {"kind": "binary", "op": op, "l": l, "r": r}


SUITES: Dict[str, List[Case]] = {}


def _suite(name: str):
    def deco(build: Callable[[], List[Case]]):
        SUITES[name] = build()
        return build
    return deco


# ---------------------------------------------------------------------------
# suites
# ---------------------------------------------------------------------------

I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)


@_suite("ArithmeticSuite")
def _arith():
    ints = pa.table({"a": pa.array([7, -7, 7, -7, None, I64MAX]),
                     "b": pa.array([3, 3, -3, -3, 3, 1])})
    return [
        Case("division by zero yields null (non-ANSI)",
             pa.table({"a": pa.array([10, 0, None])}),
             [_bin("%", _col(0), _lit(0))],
             [(None,), (None,), (None,)]),
        Case("java modulo sign follows dividend",
             ints, [_bin("%", _col(0), _col(1))],
             [(1,), (-1,), (1,), (-1,), (None,), (0,)]),
        Case("pmod sign follows divisor",
             ints, [_bin("pmod", _col(0), _col(1))],
             [(1,), (2,), (1,), (-1,), (None,), (0,)]),
        Case("int64 overflow wraps (non-ANSI two's complement)",
             pa.table({"a": pa.array([I64MAX])}),
             [_bin("+", _col(0), _lit(1))],
             [(I64MIN,)]),
        Case("float division by zero is NULL (DivModLike, non-ANSI)",
             pa.table({"a": pa.array([1.0, -1.0, 0.0])}),
             [_bin("/", _col(0), _lit(0.0, "float64"))],
             [(None,), (None,), (None,)]),
    ]


@_suite("StringFunctionsSuite")
def _strings():
    s = pa.table({"s": pa.array(["Spark SQL", "", None, "abcdef"])})
    return [
        Case("substring is 1-based",
             s, [_fn("substring", _col(0), _lit(1), _lit(5), rt="utf8")],
             [("Spark",), ("",), (None,), ("abcde",)]),
        Case("substring negative start counts from end",
             s, [_fn("substring", _col(0), _lit(-3), _lit(3), rt="utf8")],
             [("SQL",), ("",), (None,), ("def",)]),
        Case("instr is 1-based, 0 when absent",
             s, [_fn("instr", _col(0), _lit("SQL", "utf8"), rt="int32")],
             [(7,), (0,), (None,), (0,)]),
        Case("concat null poisons",
             s, [_fn("concat", _col(0), _lit("!", "utf8"), rt="utf8")],
             [("Spark SQL!",), ("!",), (None,), ("abcdef!",)]),
        Case("concat_ws skips nulls",
             pa.table({"a": pa.array(["x", None]),
                       "b": pa.array(["y", "z"])}),
             [_fn("concat_ws", _lit(",", "utf8"), _col(0), _col(1),
                  rt="utf8")],
             [("x,y",), ("z",)]),
        Case("lpad truncates when longer than target",
             pa.table({"s": pa.array(["abcd"])}),
             [_fn("lpad", _col(0), _lit(2), _lit("#", "utf8"),
                  rt="utf8")],
             [("ab",)]),
        Case("initcap capitalizes each word",
             pa.table({"s": pa.array(["sPark sql"])}),
             [_fn("initcap", _col(0), rt="utf8")],
             [("Spark Sql",)]),
        Case("substring_index positive and sign",
             pa.table({"s": pa.array(["www.apache.org"] * 2),
                       "n": pa.array([2, -2])}),
             [_fn("substring_index", _col(0), _lit(".", "utf8"), _col(1),
                  rt="utf8")],
             [("www.apache",), ("apache.org",)]),
        Case("translate maps and drops",
             pa.table({"s": pa.array(["AaBbCc"])}),
             [_fn("translate", _col(0), _lit("abc", "utf8"),
                  _lit("12", "utf8"), rt="utf8")],
             [("A1B2C",)]),
        Case("repeat and reverse",
             pa.table({"s": pa.array(["ab"])}),
             [_fn("repeat", _col(0), _lit(3), rt="utf8"),
              _fn("reverse", _col(0), rt="utf8")],
             [("ababab", "ba")]),
        Case("length counts characters not bytes",
             pa.table({"s": pa.array(["héllo"])}),
             [_fn("length", _col(0), rt="int32")],
             [(5,)]),
        Case("ascii and chr",
             pa.table({"s": pa.array(["A"]), "n": pa.array([66])}),
             [_fn("ascii", _col(0), rt="int32"),
              _fn("chr", _col(1), rt="utf8")],
             [(65, "B")]),
        Case("chr edge codes: negative empty, 256 is NUL",
             pa.table({"n": pa.array([-1, 0, 256, 321])}),
             [_fn("chr", _col(0), rt="utf8")],
             [("",), ("\x00",), ("\x00",), ("A",)]),
    ]


@_suite("MathSuite")
def _math():
    return [
        Case("round is HALF_UP away from zero",
             pa.table({"a": pa.array([2.5, 3.5, -2.5, 0.35])}),
             [_fn("round", _col(0), rt="float64"),
              _fn("round", _col(0), _lit(1), rt="float64")],
             [(3.0, 2.5), (4.0, 3.5), (-3.0, -2.5), (0.0, 0.4)],
             rtol=1e-9),
        Case("bround is HALF_EVEN",
             pa.table({"a": pa.array([2.5, 3.5, -2.5])}),
             [_fn("bround", _col(0), rt="float64")],
             [(2.0,), (4.0,), (-2.0,)]),
        Case("signum and abs",
             pa.table({"a": pa.array([-5.0, 0.0, 7.5])}),
             [_fn("signum", _col(0), rt="float64"),
              _fn("abs", _col(0), rt="float64")],
             [(-1.0, 5.0), (0.0, 0.0), (1.0, 7.5)]),
        Case("greatest skips nulls, NaN is largest",
             pa.table({"a": pa.array([1.0, None, float("nan")]),
                       "b": pa.array([2.0, 3.0, 2.0])}),
             [_fn("greatest", _col(0), _col(1), rt="float64")],
             [(2.0,), (3.0,), (float("nan"),)]),
        Case("least skips nulls",
             pa.table({"a": pa.array([1.0, None]),
                       "b": pa.array([2.0, 3.0])}),
             [_fn("least", _col(0), _col(1), rt="float64")],
             [(1.0,), (3.0,)]),
        Case("nanvl replaces NaN only",
             pa.table({"a": pa.array([float("nan"), 1.0]),
                       "b": pa.array([9.0, 9.0])}),
             [_fn("nanvl", _col(0), _col(1), rt="float64")],
             [(9.0,), (1.0,)]),
    ]


@_suite("MathEdgeSuite")
def _math_edge():
    import math as _m
    return [
        Case("ln/log of non-positive is null (Spark, not -inf)",
             pa.table({"a": pa.array([0.0, -1.0, _m.e])}),
             [_fn("ln", _col(0), rt="float64")],
             [(None,), (None,), (1.0,)], rtol=1e-12),
        Case("log10 and log2 exact powers",
             pa.table({"a": pa.array([100.0, 8.0])}),
             [_fn("log10", _col(0), rt="float64"),
              _fn("log2", _col(0), rt="float64")],
             [(2.0, _m.log2(100.0)), (_m.log10(8.0), 3.0)], rtol=1e-12),
        Case("sqrt of negative is NaN",
             pa.table({"a": pa.array([-1.0, 4.0])}),
             [_fn("sqrt", _col(0), rt="float64")],
             [(float("nan"),), (2.0,)]),
        Case("pow zero zero is one; cbrt of negative is real",
             pa.table({"a": pa.array([0.0, -8.0])}),
             [_fn("pow", _col(0), _lit(0.0, "float64"), rt="float64"),
              _fn("cbrt", _col(0), rt="float64")],
             [(1.0, 0.0), (1.0, -2.0)], rtol=1e-12),
        Case("expm1/log1p stay precise near zero",
             pa.table({"a": pa.array([0.0, 1e-10])}),
             [_fn("expm1", _col(0), rt="float64"),
              _fn("log1p", _col(0), rt="float64")],
             [(0.0, 0.0), (1.00000000005e-10, 9.9999999995e-11)],
             rtol=1e-9),
        Case("atan2 quadrants",
             pa.table({"y": pa.array([1.0, -1.0]),
                       "x": pa.array([1.0, -1.0])}),
             [_fn("atan2", _col(0), _col(1), rt="float64")],
             [(_m.pi / 4,), (-3 * _m.pi / 4,)], rtol=1e-12),
        Case("log of NaN stays NaN, not null",
             pa.table({"a": pa.array([float("nan")])}),
             [_fn("ln", _col(0), rt="float64")],
             [(float("nan"),)]),
    ]


@_suite("DateTimeEdgeSuite")
def _dates_edge():
    import datetime as dt
    d = pa.table({"d": pa.array([dt.date(2001, 1, 31),
                                 dt.date(2001, 2, 3)])})
    return [
        Case("add_months clamps to month end",
             d, [_fn("add_months", _col(0), _lit(1),
                     rt="date32")],
             [(dt.date(2001, 2, 28),), (dt.date(2001, 3, 3),)]),
        Case("last_day of february",
             d, [_fn("last_day", _col(0), rt="date32")],
             [(dt.date(2001, 1, 31),), (dt.date(2001, 2, 28),)]),
        Case("datediff sign",
             pa.table({"a": pa.array([dt.date(2001, 1, 1)]),
                       "b": pa.array([dt.date(2000, 12, 31)])}),
             [_fn("datediff", _col(0), _col(1), rt="int32"),
              _fn("datediff", _col(1), _col(0), rt="int32")],
             [(1, -1)]),
        Case("weekday is 0-Monday while dayofweek is 1-Sunday",
             pa.table({"d": pa.array([dt.date(2001, 1, 1)])}),  # a Monday
             [_fn("weekday", _col(0), rt="int32"),
              _fn("dayofweek", _col(0), rt="int32")],
             [(0, 2)]),
        Case("months_between integer when both month ends",
             pa.table({"a": pa.array([dt.date(2001, 3, 31)]),
                       "b": pa.array([dt.date(2001, 2, 28)])}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(1.0,)], rtol=1e-9),
    ]


@_suite("CryptoSuite")
def _crypto():
    s = pa.table({"s": pa.array(["ABC", None])})
    return [
        Case("md5 digest",
             s, [_fn("md5", _col(0), rt="utf8")],
             [("902fbdd2b1df0c4f70b4a5d23525e932",), (None,)]),
        Case("sha1 digest",
             s, [_fn("sha1", _col(0), rt="utf8")],
             [("3c01bdbb26f358bab27f267924aa2c9a03fcfdb8",), (None,)]),
        Case("sha2-256 digest",
             s, [_fn("sha2", _col(0), _lit(256), rt="utf8")],
             [("b5d4045c3f466fa91fe2cc6abe79232a1a57cdf1"
               "04f7a26e716e0a1e2789df78",), (None,)]),
        Case("crc32 value",
             s, [_fn("crc32", _col(0), rt="int64")],
             [(2743272264,), (None,)]),
    ]


@_suite("StringEdgeSuite")
def _string_edge():
    return [
        Case("locate and position are 1-based with 0 for missing",
             pa.table({"s": pa.array(["abcb", "xyz"])}),
             [_fn("locate", _lit("b", "utf8"), _col(0), rt="int32"),
              _fn("position", _lit("b", "utf8"), _col(0), rt="int32")],
             [(2, 2), (0, 0)]),
        Case("split on literal delimiter",
             pa.table({"s": pa.array(["aXbXc"])}),
             [_fn("split", _col(0), _lit("X", "utf8"))],
             [((["a", "b", "c"]),)]),
        Case("space builds and clamps at zero",
             pa.table({"n": pa.array([3, 0, -2])}),
             [_fn("space", _col(0), rt="utf8")],
             [("   ",), ("",), ("",)]),
        Case("octet_length counts bytes, char_length characters",
             pa.table({"s": pa.array(["h\u00e9llo"])}),
             [_fn("octet_length", _col(0), rt="int32"),
              _fn("char_length", _col(0), rt="int32")],
             [(6, 5)]),
        Case("replace replaces every occurrence",
             pa.table({"s": pa.array(["ababa"])}),
             [_fn("replace", _col(0), _lit("b", "utf8"),
                  _lit("z", "utf8"), rt="utf8")],
             [("azaza",)]),
        Case("substring zero position behaves as one",
             pa.table({"s": pa.array(["Spark SQL"])}),
             [_fn("substring", _col(0), _lit(0), _lit(3), rt="utf8")],
             [("Spa",)]),
        Case("locate with start offset (NULL start yields 0, not NULL)",
             pa.table({"s": pa.array(["abcb", "abcb", "abcb"]),
                       "p": pa.array([3, 0, None])}),
             [_fn("locate", _lit("b", "utf8"), _col(0), _col(1),
                  rt="int32")],
             [(4,), (0,), (0,)]),
        Case("strpos uses datafusion (str, substr) order",
             pa.table({"s": pa.array(["abcb"])}),
             [_fn("strpos", _col(0), _lit("b", "utf8"), rt="int32")],
             [(2,)]),
    ]


@_suite("ConditionalSuite")
def _cond():
    return [
        Case("three-valued AND",
             pa.table({"a": pa.array([True, True, False, None]),
                       "b": pa.array([None, True, None, None])}),
             [_bin("and", _col(0), _col(1))],
             [(None,), (True,), (False,), (None,)]),
        Case("three-valued OR",
             pa.table({"a": pa.array([True, False, None]),
                       "b": pa.array([None, None, None])}),
             [_bin("or", _col(0), _col(1))],
             [(True,), (None,), (None,)]),
        Case("in-list with null member is never FALSE",
             pa.table({"a": pa.array([1, 2, None])}),
             [{"kind": "in_list", "child": _col(0),
               "values": [1, None], "type": {"id": "int64"}}],
             [(True,), (None,), (None,)]),
        Case("coalesce picks first non-null",
             pa.table({"a": pa.array([None, 1], type=pa.int64()),
                       "b": pa.array([2, 3], type=pa.int64())}),
             [{"kind": "coalesce", "args": [_col(0), _col(1)]}],
             [(2,), (1,)]),
        Case("null-safe equal",
             pa.table({"a": pa.array([1, None, None]),
                       "b": pa.array([1, None, 2])}),
             [_bin("<=>", _col(0), _col(1))],
             [(True,), (True,), (False,)]),
        Case("case with no match and no else is null",
             pa.table({"a": pa.array([1, 5])}),
             [{"kind": "case",
               "branches": [[_bin("==", _col(0), _lit(1)), _lit(10)]]}],
             [(10,), (None,)]),
    ]


@_suite("DateTimeSuite")
def _dates():
    import datetime as dt
    d = pa.table({"d": pa.array([dt.date(2001, 2, 28),
                                 dt.date(2000, 1, 31)])})
    return [
        Case("date_add / date_sub",
             d, [_fn("date_add", _col(0), _lit(1), rt="date32"),
                 _fn("date_sub", _col(0), _lit(28), rt="date32")],
             [(dt.date(2001, 3, 1), dt.date(2001, 1, 31)),
              (dt.date(2000, 2, 1), dt.date(2000, 1, 3))]),
        Case("add_months clamps to month end",
             d, [_fn("add_months", _col(0), _lit(1), rt="date32")],
             [(dt.date(2001, 3, 28),), (dt.date(2000, 2, 29),)]),
        Case("last_day",
             d, [_fn("last_day", _col(0), rt="date32")],
             [(dt.date(2001, 2, 28),), (dt.date(2000, 1, 31),)]),
        Case("year month day dayofweek",
             d, [_fn("year", _col(0), rt="int32"),
                 _fn("month", _col(0), rt="int32"),
                 _fn("dayofweek", _col(0), rt="int32")],
             [(2001, 2, 4), (2000, 1, 2)]),  # dayofweek: 1=Sunday
        Case("datediff is signed",
             pa.table({"a": pa.array([dt.date(2001, 1, 10)]),
                       "b": pa.array([dt.date(2001, 1, 1)])}),
             [_fn("datediff", _col(0), _col(1), rt="int32")],
             [(9,)]),
        Case("months_between 31-day fraction",
             pa.table({"a": pa.array([dt.date(2001, 3, 31)]),
                       "b": pa.array([dt.date(2001, 2, 28)])}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(1.0,)]),
    ]


@_suite("HashSuite")
def _hash():
    # Spark-generated vectors (seed 42): hash(1L)= -7723843922299065623?
    # — authoritative int vectors already live in tests/test_hashing.py;
    # here the corpus pins the EXPRESSION surface (int32 output, null
    # handling: null input leaves the seed untouched)
    return [
        Case("murmur3 null input keeps seed",
             pa.table({"a": pa.array([None], type=pa.int64())}),
             [_fn("murmur3_hash", _col(0), rt="int32")],
             [(42,)]),
        Case("crc32 of utf8 bytes",
             pa.table({"s": pa.array(["ABC"])}),
             [_fn("crc32", _col(0), rt="int64")],
             [(2743272264,)]),
        Case("md5 hex",
             pa.table({"s": pa.array(["abc"])}),
             [_fn("md5", _col(0), rt="utf8")],
             [("900150983cd24fb0d6963f7d28e17f72",)]),
        Case("sha2-256 hex",
             pa.table({"s": pa.array(["abc"])}),
             [_fn("sha2", _col(0), _lit(256), rt="utf8")],
             [("ba7816bf8f01cfea414140de5dae2223b00361a396177a9cb410ff"
               "61f20015ad",)]),
    ]


@_suite("CollectionSuite")
def _coll():
    lst = pa.table({"a": pa.array([[1, 2, 2, None], [], None],
                                  type=pa.list_(pa.int64()))})
    return [
        Case("size of null is -1 (legacy spark.sql.legacy.sizeOfNull)",
             lst, [_fn("size", _col(0), rt="int32")],
             [(4,), (0,), (-1,)]),
        Case("array_distinct keeps order",
             pa.table({"a": pa.array([[3, 1, 3, 2]],
                                     type=pa.list_(pa.int64()))}),
             [_fn("array_distinct", _col(0))],
             [([3, 1, 2],)]),
        Case("array_contains null semantics",
             lst, [_fn("array_contains", _col(0), _lit(2), rt="bool")],
             [(True,), (False,), (None,)]),
        Case("element_at is 1-based",
             pa.table({"a": pa.array([[10, 20]],
                                     type=pa.list_(pa.int64()))}),
             [_fn("element_at", _col(0), _lit(2), rt="int64")],
             [(20,)]),
        Case("str_to_map default delimiters",
             pa.table({"s": pa.array(["a:1,b:2"])}),
             [_fn("map_keys", _fn("str_to_map", _col(0)))],
             [(["a", "b"],)]),
    ]


@_suite("CollectionEdgeSuite")
def _collection_edge():
    arr = pa.table({"a": pa.array([[1, 2, 3], [5], None])})
    return [
        Case("element_at is 1-based, negative from end, OOB null",
             arr,
             [_fn("element_at", _col(0), _lit(2), rt="int64"),
              _fn("element_at", _col(0), _lit(-1), rt="int64"),
              _fn("element_at", _col(0), _lit(4), rt="int64")],
             [(2, 3, None), (None, 5, None), (None, None, None)]),
        Case("array_join skips null elements",
             pa.table({"a": pa.array([["x", None, "y"]])}),
             [_fn("array_join", _col(0), _lit(",", "utf8"), rt="utf8")],
             [("x,y",)]),
        Case("split delimiter is a regex",
             pa.table({"s": pa.array(["a.b.c"])}),
             [_fn("split", _col(0), _lit("\\.", "utf8"))],
             [((["a", "b", "c"]),)]),
    ]


@_suite("RegexpEdgeSuite")
def _regexp_edge():
    return [
        Case("regexp_extract returns empty string on no match",
             pa.table({"s": pa.array(["a123b", "zzz"])}),
             [_fn("regexp_extract", _col(0),
                  _lit("([0-9]+)", "utf8"), _lit(1), rt="utf8")],
             [("123",), ("",)]),
    ]


@_suite("MathSignSuite")
def _math_sign():
    return [
        Case("round HALF_UP is away from zero on negatives",
             pa.table({"a": pa.array([-2.5, 2.5, -0.45])}),
             [_fn("round", _col(0), rt="float64"),
              _fn("round", _col(0), _lit(1), rt="float64")],
             [(-3.0, -2.5), (3.0, 2.5), (-0.0, -0.5)], rtol=1e-12),
        Case("signum preserves negative zero",
             pa.table({"a": pa.array([-0.0, 0.0])}),
             [_fn("signum", _col(0), rt="float64")],
             [(-0.0,), (0.0,)]),
    ]


@_suite("RegexpLikeSuite")
def _regexp():
    s = pa.table({"s": pa.array(["Spark", "park", None, "SPARK"])})
    return [
        Case("LIKE percent and underscore",
             s, [{"kind": "like", "child": _col(0), "pattern": "%par_"}],
             # '%' matches empty or any prefix: both "Spark" and "park"
             # satisfy %par_ ; SPARK fails case-sensitively
             [(True,), (True,), (None,), (False,)]),
        Case("LIKE is case sensitive",
             s, [{"kind": "like", "child": _col(0), "pattern": "spark"}],
             [(False,), (False,), (None,), (False,)]),
        Case("RLIKE finds substring matches",
             s, [{"kind": "rlike", "child": _col(0),
                  "pattern": "ar(k|t)"}],
             [(True,), (True,), (None,), (False,)]),
        Case("regexp_replace all occurrences",
             pa.table({"s": pa.array(["a1b2c3"])}),
             [_fn("regexp_replace", _col(0), _lit("[0-9]", "utf8"),
                  _lit("#", "utf8"), rt="utf8")],
             [("a#b#c#",)]),
        Case("regexp_extract group and no-match empty",
             pa.table({"s": pa.array(["100-200", "foo"])}),
             [_fn("regexp_extract", _col(0),
                  _lit(r"(\d+)-(\d+)", "utf8"), _lit(2), rt="utf8")],
             [("200",), ("",)]),
        Case("split drops nothing by default",
             pa.table({"s": pa.array(["a,b,,c"])}),
             [_fn("split", _col(0), _lit(",", "utf8"))],
             [(["a", "b", "", "c"],)]),
    ]


@_suite("JsonSuite")
def _json():
    j = pa.table({"j": pa.array(
        ['{"a": 1, "b": {"c": "x"}, "d": [5, 6]}', "not json", None])})
    return [
        Case("get_json_object dotted path",
             j, [_fn("get_json_object", _col(0), _lit("$.b.c", "utf8"),
                     rt="utf8")],
             [("x",), (None,), (None,)]),
        Case("get_json_object array index",
             j, [_fn("get_json_object", _col(0), _lit("$.d[1]", "utf8"),
                     rt="utf8")],
             [("6",), (None,), (None,)]),
        Case("get_json_object missing key is null",
             j, [_fn("get_json_object", _col(0), _lit("$.zz", "utf8"),
                     rt="utf8")],
             [(None,), (None,), (None,)]),
    ]


@_suite("DecimalSuite")
def _decimal():
    dec = {"id": "decimal", "precision": 10, "scale": 2}
    return [
        Case("cast int to decimal renders full scale",
             pa.table({"a": pa.array([7, None])}),
             [{"kind": "cast",
               "child": {"kind": "cast", "child": _col(0), "type": dec},
               "type": {"id": "utf8"}}],
             [("7.00",), (None,)]),
        Case("decimal overflow to null (non-ANSI)",
             pa.table({"a": pa.array([10 ** 12])}),
             [{"kind": "cast", "child": _col(0),
               "type": {"id": "decimal", "precision": 5, "scale": 2}}],
             [(None,)]),
        Case("string to decimal HALF_UP at scale",
             pa.table({"s": pa.array(["1.005", "-1.005"])}),
             [{"kind": "cast",
               "child": {"kind": "cast", "child": _col(0), "type": dec},
               "type": {"id": "utf8"}}],
             [("1.01",), ("-1.01",)]),
    ]


@_suite("TrigMathSuite")
def _trig():
    import math
    x = pa.table({"x": pa.array([0.0, 0.5, None])})
    return [
        Case("sin/cos/tan at zero",
             pa.table({"x": pa.array([0.0])}),
             [_fn("sin", _col(0), rt="float64"),
              _fn("cos", _col(0), rt="float64"),
              _fn("tan", _col(0), rt="float64")],
             [(0.0, 1.0, 0.0)], rtol=1e-12),
        Case("asin/acos outside [-1,1] give NaN, not error",
             pa.table({"x": pa.array([2.0, -2.0])}),
             [_fn("asin", _col(0), rt="float64"),
              _fn("acos", _col(0), rt="float64")],
             [(float("nan"), float("nan")),
              (float("nan"), float("nan"))]),
        Case("asin/atan principal values",
             x,
             [_fn("asin", _col(0), rt="float64"),
              _fn("atan", _col(0), rt="float64")],
             [(0.0, 0.0), (math.asin(0.5), math.atan(0.5)),
              (None, None)], rtol=1e-12),
        Case("hyperbolics and exp",
             pa.table({"x": pa.array([1.0])}),
             [_fn("sinh", _col(0), rt="float64"),
              _fn("cosh", _col(0), rt="float64"),
              _fn("tanh", _col(0), rt="float64"),
              _fn("exp", _col(0), rt="float64")],
             [(math.sinh(1.0), math.cosh(1.0), math.tanh(1.0),
               math.e)], rtol=1e-12),
        Case("degrees/radians round trip",
             pa.table({"x": pa.array([math.pi, 0.0])}),
             [_fn("degrees", _col(0), rt="float64")],
             [(180.0,), (0.0,)], rtol=1e-12),
        Case("radians of 180",
             pa.table({"x": pa.array([180.0])}),
             [_fn("radians", _col(0), rt="float64")],
             [(math.pi,)], rtol=1e-12),
        Case("negative flips sign, passes null",
             pa.table({"x": pa.array([5, -3, None])}),
             [_fn("negative", _col(0), rt="int64")],
             [(-5,), (3,), (None,)]),
        Case("isnan: null input is false, not null",
             pa.table({"x": pa.array([float("nan"), 1.0, None])}),
             [_fn("isnan", _col(0), rt="bool")],
             [(True,), (False,), (False,)]),
        Case("ceil/floor return LONG for double input",
             pa.table({"x": pa.array([2.5, -0.1, -2.5, None])}),
             [_fn("ceil", _col(0), rt="int64"),
              _fn("floor", _col(0), rt="int64")],
             [(3, 2), (0, -1), (-2, -3), (None, None)]),
    ]


@_suite("DateFieldsSuite")
def _date_fields():
    import datetime as _dt
    d = pa.table({"d": pa.array([_dt.date(2016, 4, 9),
                                 _dt.date(2008, 2, 20), None],
                                pa.date32())})
    ts = pa.table({"t": pa.array([_dt.datetime(2015, 3, 5, 9, 32, 5)],
                                 pa.timestamp("us"))})
    return [
        Case("day/dayofmonth agree",
             d, [_fn("day", _col(0), rt="int32"),
                 _fn("dayofmonth", _col(0), rt="int32")],
             [(9, 9), (20, 20), (None, None)]),
        Case("dayofyear",
             d, [_fn("dayofyear", _col(0), rt="int32")],
             [(100,), (51,), (None,)]),
        Case("weekofyear is ISO-8601",
             d, [_fn("weekofyear", _col(0), rt="int32")],
             [(14,), (8,), (None,)]),
        Case("quarter",
             d, [_fn("quarter", _col(0), rt="int32")],
             [(2,), (1,), (None,)]),
        Case("hour/minute/second from timestamp",
             ts, [_fn("hour", _col(0), rt="int32"),
                  _fn("minute", _col(0), rt="int32"),
                  _fn("second", _col(0), rt="int32")],
             [(9, 32, 5)]),
    ]


@_suite("DateNavSuite")
def _date_nav():
    import datetime as _dt
    d = pa.table({"d": pa.array([_dt.date(2016, 4, 9),   # a Saturday
                                 _dt.date(2019, 8, 4)],  # a Sunday
                                pa.date32())})
    return [
        Case("next_day by abbreviated day name",
             d, [_fn("next_day", _col(0), _lit("TU", "utf8"),
                     rt="date32")],
             [(_dt.date(2016, 4, 12),), (_dt.date(2019, 8, 6),)]),
        Case("next_day invalid day name yields null (non-ANSI)",
             d, [_fn("next_day", _col(0), _lit("XX", "utf8"),
                     rt="date32")],
             [(None,), (None,)]),
        Case("trunc to month and ISO week (Monday)",
             d, [_fn("trunc", _col(0), _lit("MM", "utf8"), rt="date32"),
                 _fn("trunc", _col(0), _lit("week", "utf8"),
                     rt="date32")],
             [(_dt.date(2016, 4, 1), _dt.date(2016, 4, 4)),
              (_dt.date(2019, 8, 1), _dt.date(2019, 7, 29))]),
        Case("date_trunc HOUR on timestamp",
             pa.table({"t": pa.array(
                 [_dt.datetime(2015, 3, 5, 9, 32, 5, 359000)],
                 pa.timestamp("us"))}),
             [_fn("date_trunc", _lit("HOUR", "utf8"), _col(0))],
             [(_dt.datetime(2015, 3, 5, 9, 0),)]),
        Case("to_date parses date and timestamp strings, null on junk",
             pa.table({"s": pa.array(["2009-07-30 04:17:52",
                                      "2016-12-31", "bad"])}),
             [_fn("to_date", _col(0), rt="date32")],
             [(_dt.date(2009, 7, 30),), (_dt.date(2016, 12, 31),),
              (None,)]),
        Case("from_unixtime default pattern, UTC session tz",
             pa.table({"u": pa.array([0, 86400])}),
             [_fn("from_unixtime", _col(0), rt="utf8")],
             [("1970-01-01 00:00:00",), ("1970-01-02 00:00:00",)]),
        Case("unix_timestamp parses default pattern, null on junk",
             pa.table({"s": pa.array(["1970-01-02 00:00:00",
                                      "2016-04-09", "junk", None])}),
             [_fn("unix_timestamp", _col(0))],
             [(86400,), (1460160000,), (None,), (None,)]),
    ]


@_suite("ArrayExtraSuite")
def _array_extra():
    lt = pa.list_(pa.int64())
    a = pa.table({"a": pa.array([[2, 1, None], [5], None], lt)})
    return [
        Case("array_min/max skip nulls inside the array",
             a, [_fn("array_min", _col(0), rt="int64"),
                 _fn("array_max", _col(0), rt="int64")],
             [(1, 2), (5, 5), (None, None)]),
        Case("cardinality counts elements; null input is -1 "
             "(legacy sizeOfNull, the Spark default)",
             a, [_fn("cardinality", _col(0), rt="int32")],
             [(3,), (1,), (-1,)]),
        Case("array_union dedups keeping first-seen order",
             pa.table({"a": pa.array([[1, 2, 2]], lt),
                       "b": pa.array([[2, 3, 1]], lt)}),
             [_fn("array_union", _col(0), _col(1))],
             [([1, 2, 3],)]),
        Case("array builder from columns",
             pa.table({"x": pa.array([1, 4]), "y": pa.array([2, 5])}),
             [_fn("make_array", _col(0), _col(1))],
             [([1, 2],), ([4, 5],)]),
        Case("map_values",
             pa.table({"m": pa.array([[("a", 1), ("b", 2)]],
                                     pa.map_(pa.utf8(), pa.int64()))}),
             [_fn("map_values", _col(0))],
             [([1, 2],)]),
    ]


@_suite("CaseTrimSuite")
def _case_trim():
    return [
        Case("upper/lower",
             pa.table({"s": pa.array(["Spark", None])}),
             [_fn("upper", _col(0), rt="utf8"),
              _fn("lower", _col(0), rt="utf8")],
             [("SPARK", "spark"), (None, None)]),
        Case("trim strips ONLY spaces, not tabs "
             "(UTF8String.trim semantics)",
             pa.table({"s": pa.array(["  \tabc \t ", " x "])}),
             [_fn("trim", _col(0), rt="utf8")],
             [("\tabc \t",), ("x",)]),
        Case("ltrim/rtrim one-sided space strip",
             pa.table({"s": pa.array([" \ta "])}),
             [_fn("ltrim", _col(0), rt="utf8"),
              _fn("rtrim", _col(0), rt="utf8")],
             [("\ta ", " \ta")]),
        Case("rpad truncates when target is shorter",
             pa.table({"s": pa.array(["abcd", "ab"])}),
             [_fn("rpad", _col(0), _lit(3), _lit("x", "utf8"),
                  rt="utf8")],
             [("abc",), ("abx",)]),
        Case("substr position 0 behaves as 1; negative counts "
             "from the end",
             pa.table({"s": pa.array(["Spark"])}),
             [_fn("substr", _col(0), _lit(0), _lit(3), rt="utf8"),
              _fn("substr", _col(0), _lit(-3), _lit(2), rt="utf8")],
             [("Spa", "ar")]),
    ]


@_suite("HashExprSuite")
def _hash_expr():
    return [
        Case("hash() is Spark murmur3 seed 42, bit-exact",
             pa.table({"x": pa.array([1, 2], pa.int32())}),
             [_fn("hash", _col(0), rt="int32")],
             [(-559580957,), (1765031574,)]),
        Case("xxhash64 seed 42, bit-exact",
             pa.table({"x": pa.array([1], pa.int64())}),
             [_fn("xxhash64", _col(0), rt="int64")],
             [(-7001672635703045582,)]),
    ]


# ---------------------------------------------------------------------------
# runner (ref SparkQueryTestsBase: run case, compare, report)
# ---------------------------------------------------------------------------

@dataclass
class CaseResult:
    suite: str
    case: str
    passed: bool
    detail: str = ""


def _values_equal(got, want, rtol: float) -> bool:
    if want is None or got is None:
        return got is None and want is None
    if isinstance(want, float):
        if math.isnan(want):
            return isinstance(got, float) and math.isnan(got)
        if rtol:
            return got == want or abs(got - want) <= rtol * abs(want)
        return float(got) == want
    return got == want


def _scan_ir(rid: str, table: pa.Table) -> dict:
    from blaze_tpu_torch.plan.types import schema_to_dict
    from blaze_tpu_torch.schema import Schema
    return {"kind": "memory_scan", "resource_id": rid,
            "schema": schema_to_dict(Schema.from_arrow(table.schema)),
            "num_partitions": 1}


class _scoped_conf:
    """`case.confs` set on the port's conf session for one run, the
    earlier values restored after it."""

    def __init__(self, kv: Optional[Dict[str, Any]]):
        self._kv = dict(kv or {})
        self._prev: Dict[str, Optional[str]] = {}

    def __enter__(self):
        from blaze_tpu_torch import config
        for k, v in self._kv.items():
            self._prev[k] = config.conf.get_raw(k)
            config.conf.set(k, v)
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch import config
        for k, v in self._prev.items():
            if v is None:
                config.conf.unset(k)
            else:
                config.conf.set(k, v)
        return False


def case_ir(suite: str, case: Case) -> dict:
    """The case's plan IR over memory scans, its tables put into the
    resource map."""
    from blaze_tpu_torch.bridge.resource import put_resource
    rid = f"corpus://{suite}/{case.name}"
    put_resource(rid, case.input)
    scan = _scan_ir(rid, case.input)
    if case.plan is not None:
        if case.input2 is not None:
            rid2 = rid + "/2"
            put_resource(rid2, case.input2)
            return case.plan(scan, _scan_ir(rid2, case.input2))
        return case.plan(scan)
    return {"kind": "project", "exprs": case.exprs,
            "names": [f"o{i}" for i in range(len(case.exprs))],
            "input": scan}


def run_case(suite: str, case: Case) -> CaseResult:
    from blaze_tpu_torch.plan import create_plan

    ir = case_ir(suite, case)
    try:
        with _scoped_conf(case.confs):
            plan = create_plan(ir)
            batches = [b.compact().to_arrow() for b in plan.execute(0)]
        ncols = (len(case.exprs) if case.plan is None
                 else (len(case.expected[0]) if case.expected else 1))
        tbl = (pa.Table.from_batches(batches) if batches
               else pa.Table.from_batches(
                   [], schema=pa.schema(
                       [(f"o{i}", pa.null()) for i in range(ncols)])))
        got = [tuple(r) for r in zip(*[c.to_pylist()
                                       for c in tbl.columns])] \
            if tbl.num_rows else []
    except Exception as e:  # noqa: BLE001 — recorded, like a test failure
        if case.raises is not None and case.raises in repr(e):
            return CaseResult(suite, case.name, True)
        return CaseResult(suite, case.name, False, f"raised {e!r}")
    if case.raises is not None:
        return CaseResult(suite, case.name, False,
                          f"expected raise {case.raises!r}, got rows")
    if len(got) != len(case.expected):
        return CaseResult(suite, case.name, False,
                          f"rows {len(got)} != {len(case.expected)}")
    want_rows = case.expected
    if case.unordered:
        key = repr
        got = sorted(got, key=key)
        want_rows = sorted(want_rows, key=key)
    for i, (g, w) in enumerate(zip(got, want_rows)):
        if len(g) != len(w):
            return CaseResult(suite, case.name, False,
                              f"row {i}: arity {len(g)} != {len(w)}")
        for j, (gv, wv) in enumerate(zip(g, w)):
            if not _values_equal(gv, wv, case.rtol):
                return CaseResult(
                    suite, case.name, False,
                    f"row {i} col {j}: got {gv!r}, want {wv!r}")
    return CaseResult(suite, case.name, True)


def holds_decimal(case: Case) -> bool:
    """Whether a case's input, expressions, plan or expected rows hold a
    decimal (27 of the 357)."""
    blob = [repr(case.input.schema), repr(case.exprs), repr(case.expected)]
    if case.input2 is not None:
        blob.append(repr(case.input2.schema))
    if case.plan is not None:
        scans = [_scan_ir("later", case.input)]
        if case.input2 is not None:
            scans.append(_scan_ir("later2", case.input2))
        blob.append(repr(case.plan(*scans)))
    return "decimal" in " ".join(blob).lower()


def later_item(suite: str, case: Case) -> Optional[str]:
    """The ROADMAP item a case waits for in the port, or None when it
    must pass.  Since the decimal slice no case waits: none needs the
    bloom filter (item 11) or a UDF (item 16)."""
    return None


def run_corpus(settings: CorpusSettings) -> List[CaseResult]:
    out: List[CaseResult] = []
    for sname, ss in settings.suites.items():
        for case in SUITES[sname]:
            if ss.selects(case.name):
                out.append(run_case(sname, case))
    return out


# The extended tier (round-5 expansion: cast edges, decimal38, ANSI,
# nested types, NaN/-0.0 ordering, agg/join/window semantics) registers
# its suites into SUITES on import.
from blaze_tpu_torch.itest import spark_corpus_ext  # noqa: E402,F401


def default_settings() -> CorpusSettings:
    """The checked-in settings: every suite enabled; exclusions document
    declared divergences (the SparkTestSettings exclusion-ledger analog).
    An empty ledger means full conformance on the vendored corpus."""
    return CorpusSettings().enable_all()

