"""The extended tier of the Spark conformance corpus (a copy of
blaze_tpu/itest/spark_corpus_ext.py's vectors): cast edges, decimals,
ANSI, nested types, NaN and -0.0 ordering, aggregate, join, window,
generate and expand semantics.  Importing it registers its suites into
`spark_corpus.SUITES`.
"""

from __future__ import annotations

import datetime as _dt
import math

import pyarrow as pa

from blaze_tpu_torch.itest.spark_corpus import (Case, _bin, _col, _fn, _lit,
                                          _suite)

NAN = float("nan")
INF = float("inf")
I64MAX = (1 << 63) - 1
I64MIN = -(1 << 63)
I32MAX = (1 << 31) - 1
I32MIN = -(1 << 31)


def _cast(child, t, **kw):
    t = t if isinstance(t, dict) else {"id": t}
    return {"kind": "cast", "child": child, "type": dict(t, **kw)}


def _try_cast(child, t):
    t = t if isinstance(t, dict) else {"id": t}
    return {"kind": "try_cast", "child": child, "type": t}


def _sort_plan(*specs, fetch=None):
    def mk(scan):
        d = {"kind": "sort", "input": scan,
             "specs": [{"expr": _col(i), "descending": desc,
                        "nulls_first": nf}
                       for (i, desc, nf) in specs]}
        if fetch is not None:
            d["fetch"] = fetch
        return d
    return mk


def _agg_plan(group_idx, aggs):
    """aggs: [(fn, arg_expr_or_None, name)] in COMPLETE mode."""
    def mk(scan):
        return {"kind": "hash_agg", "input": scan,
                "groupings": [{"expr": _col(i), "name": f"g{i}"}
                              for i in group_idx],
                "aggs": [{"fn": fn, "mode": "complete", "name": name,
                          "args": ([] if arg is None else [arg])}
                         for fn, arg, name in aggs]}
    return mk


def _join_plan(kind, join_type, lkeys=(0,), rkeys=(0,), **kw):
    def mk(scan, scan2):
        d = {"kind": kind, "left": scan, "right": scan2,
             "left_keys": [_col(i) for i in lkeys],
             "right_keys": [_col(i) for i in rkeys],
             "join_type": join_type}
        d.update(kw)
        return d
    return mk


# ---------------------------------------------------------------------------
# cast suites (ref CastSuite / native cast.rs)
# ---------------------------------------------------------------------------

@_suite("CastNumericSuite")
def _cast_numeric():
    return [
        Case("double to int saturates at int bounds (Scala toInt)",
             pa.table({"x": pa.array([1e20, -1e20, 2.9, -2.9, None])}),
             [_cast(_col(0), "int32")],
             [(I32MAX,), (I32MIN,), (2,), (-2,), (None,)]),
        Case("NaN to int is 0, not null",
             pa.table({"x": pa.array([NAN, INF, -INF])}),
             [_cast(_col(0), "int32")],
             [(0,), (I32MAX,), (I32MIN,)]),
        Case("long to int truncates low 32 bits (two's complement)",
             pa.table({"x": pa.array([4294967297, -1, 1 << 31, None])}),
             [_cast(_col(0), "int32")],
             [(1,), (-1,), (I32MIN,), (None,)]),
        Case("long to short and byte wrap",
             pa.table({"x": pa.array([65537, 257])}),
             [_cast(_col(0), "int16"), _cast(_col(0), "int8")],
             [(1, 1), (257, 1)]),
        Case("int to double is exact for small values",
             pa.table({"x": pa.array([7, -7, None])}),
             [_cast(_col(0), "float64")],
             [(7.0,), (-7.0,), (None,)]),
        Case("double to long saturates",
             pa.table({"x": pa.array([1e30, -1e30])}),
             [_cast(_col(0), "int64")],
             [(I64MAX,), (I64MIN,)]),
        Case("float widens to double",
             pa.table({"x": pa.array([1.5], pa.float32())}),
             [_cast(_col(0), "float64")],
             [(1.5,)]),
        Case("bool to int is 0/1",
             pa.table({"b": pa.array([True, False, None])}),
             [_cast(_col(0), "int32")],
             [(1,), (0,), (None,)]),
        Case("int to bool is zero-test",
             pa.table({"x": pa.array([0, 1, -3, None])}),
             [_cast(_col(0), "bool")],
             [(False,), (True,), (True,), (None,)]),
    ]


@_suite("CastStringNumericSuite")
def _cast_string_numeric():
    return [
        Case("string to int trims whitespace",
             pa.table({"s": pa.array([" 42 ", "\t7\n", "-7"])}),
             [_cast(_col(0), "int32")],
             [(42,), (7,), (-7,)]),
        Case("string with decimal point truncates toward zero",
             pa.table({"s": pa.array(["42.5", "-42.9", "1.0"])}),
             [_cast(_col(0), "int32")],
             [(42,), (-42,), (1,)]),
        Case("non-numeric string to int is null (non-ANSI)",
             pa.table({"s": pa.array(["0x1A", "", "abc", "1 2"])}),
             [_cast(_col(0), "int32")],
             [(None,), (None,), (None,), (None,)]),
        Case("string to double parses scientific notation",
             pa.table({"s": pa.array(["1.5e2", "-2E-1", ".5"])}),
             [_cast(_col(0), "float64")],
             [(150.0,), (-0.2,), (0.5,)]),
        Case("string Infinity/NaN spellings to double",
             pa.table({"s": pa.array(["Infinity", "-Infinity", "NaN",
                                      "inf"])}),
             [_cast(_col(0), "float64")],
             [(INF,), (-INF,), (NAN,), (INF,)]),
        Case("int renders to string without sign noise",
             pa.table({"x": pa.array([42, -7, 0, None])}),
             [_cast(_col(0), "utf8")],
             [("42",), ("-7",), ("0",), (None,)]),
        Case("double renders Spark-style",
             pa.table({"x": pa.array([1.5, -0.5])}),
             [_cast(_col(0), "utf8")],
             [("1.5",), ("-0.5",)]),
        Case("bool renders lowercase true/false",
             pa.table({"b": pa.array([True, False])}),
             [_cast(_col(0), "utf8")],
             [("true",), ("false",)]),
    ]


@_suite("CastBooleanSuite")
def _cast_boolean():
    return [
        Case("accepted true spellings",
             pa.table({"s": pa.array(["t", "true", "y", "yes", "1",
                                      "TRUE"])}),
             [_cast(_col(0), "bool")],
             [(True,)] * 6),
        Case("accepted false spellings",
             pa.table({"s": pa.array(["f", "false", "n", "no", "0",
                                      "FALSE"])}),
             [_cast(_col(0), "bool")],
             [(False,)] * 6),
        Case("unrecognized string to bool is null (non-ANSI)",
             pa.table({"s": pa.array(["2", "tr", "", "on"])}),
             [_cast(_col(0), "bool")],
             [(None,), (None,), (None,), (None,)]),
    ]


@_suite("CastTimestampSuite")
def _cast_timestamp():
    ts = _dt.datetime(2015, 3, 5, 9, 32, 5)
    us = int(ts.replace(tzinfo=_dt.timezone.utc).timestamp() * 1_000_000)
    return [
        Case("timestamp to long is epoch SECONDS (floored)",
             pa.table({"t": pa.array([us, us + 999_999],
                                     pa.timestamp("us"))}),
             [_cast(_col(0), "int64")],
             [(1425547925,), (1425547925,)]),
        Case("long to timestamp treats input as seconds",
             pa.table({"x": pa.array([1425547925, 0])}),
             [_cast(_col(0), "timestamp_us")],
             [(ts,), (_dt.datetime(1970, 1, 1),)]),
        Case("date to timestamp is midnight",
             pa.table({"d": pa.array([_dt.date(2016, 4, 9), None],
                                     pa.date32())}),
             [_cast(_col(0), "timestamp_us")],
             [(_dt.datetime(2016, 4, 9, 0, 0, 0),), (None,)]),
        Case("timestamp to date truncates time-of-day",
             pa.table({"t": pa.array([us], pa.timestamp("us"))}),
             [_cast(_col(0), "date32")],
             [(_dt.date(2015, 3, 5),)]),
        Case("timestamp renders ISO with space separator",
             pa.table({"t": pa.array([us], pa.timestamp("us"))}),
             [_cast(_col(0), "utf8")],
             [("2015-03-05 09:32:05",)]),
        Case("string to date, junk is null (non-ANSI)",
             pa.table({"s": pa.array(["2016-04-09", "2016-4-9",
                                      "not a date", None])}),
             [_cast(_col(0), "date32")],
             [(_dt.date(2016, 4, 9),), (_dt.date(2016, 4, 9),),
              (None,), (None,)]),
        Case("double to timestamp keeps fraction as micros",
             pa.table({"x": pa.array([1.5])}),
             [_cast(_col(0), "timestamp_us")],
             [(_dt.datetime(1970, 1, 1, 0, 0, 1, 500000),)]),
    ]


# ---------------------------------------------------------------------------
# decimal38 (ref DecimalExpressionSuite / spark_check_overflow.rs)
# ---------------------------------------------------------------------------

@_suite("Decimal38Suite")
def _decimal38():
    d38 = {"id": "decimal", "precision": 38, "scale": 18}
    d38s2 = {"id": "decimal", "precision": 38, "scale": 2}
    return [
        Case("int to decimal(38,18) renders full scale",
             pa.table({"a": pa.array([7, -3, None])}),
             [_cast(_cast(_col(0), d38), "utf8")],
             [("7.000000000000000000",), ("-3.000000000000000000",),
              (None,)]),
        Case("string to decimal(38,18) keeps 18 digits",
             pa.table({"s": pa.array(["1.234567890123456789",
                                      "-0.000000000000000001"])}),
             [_cast(_cast(_col(0), d38), "utf8")],
             [("1.234567890123456789",), ("-0.000000000000000001",)]),
        Case("decimal(38,2) holds values beyond int64 unscaled",
             pa.table({"s": pa.array(["123456789012345678901234567890.12"])}),
             [_cast(_cast(_col(0), d38s2), "utf8")],
             [("123456789012345678901234567890.12",)]),
        Case("rescale 38,18 -> 10,2 rounds HALF_UP",
             pa.table({"s": pa.array(["1.005000000000000000",
                                      "-1.005000000000000000"])}),
             [_cast(_cast(_cast(_col(0), d38),
                          {"id": "decimal", "precision": 10, "scale": 2}),
                    "utf8")],
             [("1.01",), ("-1.01",)]),
        Case("narrowing overflow to null (non-ANSI)",
             pa.table({"s": pa.array(["123456789012345678901234567890.12",
                                      "1.00"])}),
             [_cast(_cast(_cast(_col(0), d38s2),
                          {"id": "decimal", "precision": 5, "scale": 2}),
                    "utf8")],
             [(None,), ("1.00",)]),
        Case("decimal to long truncates the fraction",
             pa.table({"s": pa.array(["42.99", "-42.99"])}),
             [_cast(_cast(_col(0),
                          {"id": "decimal", "precision": 10, "scale": 2}),
                    "int64")],
             [(42,), (-42,)]),
        Case("decimal to double is exact at short scale",
             pa.table({"s": pa.array(["2.50"])}),
             [_cast(_cast(_col(0),
                          {"id": "decimal", "precision": 10, "scale": 2}),
                    "float64")],
             [(2.5,)]),
        Case("make_decimal/unscaled_value round trip",
             pa.table({"x": pa.array([12345])}),
             [{"kind": "scalar_function", "name": "unscaled_value",
               "args": [{"kind": "scalar_function", "name": "make_decimal",
                         "args": [_col(0)],
                         "return_type": {"id": "decimal", "precision": 10,
                                         "scale": 2}}],
               "return_type": {"id": "int64"}}],
             [(12345,)]),
    ]


# ---------------------------------------------------------------------------
# ANSI mode (ref ansi-enabled suite splits in SparkTestSettings)
# ---------------------------------------------------------------------------

_ANSI_ON = {"spark.sql.ansi.enabled": "true"}


@_suite("AnsiModeSuite")
def _ansi():
    return [
        Case("ANSI: invalid string to int raises",
             pa.table({"s": pa.array(["abc"])}),
             [_cast(_col(0), "int32")], [], confs=_ANSI_ON,
             raises="CAST_INVALID_INPUT"),
        Case("ANSI: valid string to int still casts",
             pa.table({"s": pa.array(["42"])}),
             [_cast(_col(0), "int32")],
             [(42,)], confs=_ANSI_ON),
        Case("ANSI: try_cast stays null on invalid input",
             pa.table({"s": pa.array(["abc", "7"])}),
             [_try_cast(_col(0), "int32")],
             [(None,), (7,)], confs=_ANSI_ON),
        Case("ANSI: array index out of bounds raises",
             pa.table({"a": pa.array([[1, 2, 3]])}),
             [{"kind": "get_indexed_field", "child": _col(0), "index": 9,
               "type": {"id": "int64"}}],
             [], confs=_ANSI_ON, raises="INVALID_ARRAY_INDEX"),
        Case("non-ANSI: same invalid cast is null",
             pa.table({"s": pa.array(["abc"])}),
             [_cast(_col(0), "int32")],
             [(None,)]),
        Case("ANSI: element_at out of bounds raises",
             pa.table({"a": pa.array([[1, 2]])}),
             [_fn("element_at", _col(0), _lit(5), rt="int64")],
             [], confs=_ANSI_ON,
             raises="INVALID_ARRAY_INDEX_IN_ELEMENT_AT"),
        Case("ANSI: element_at on a missing map key raises",
             pa.table({"m": pa.array([[("a", 1)]],
                                     pa.map_(pa.utf8(), pa.int64()))}),
             [_fn("element_at", _col(0), _lit("zz", "utf8"),
                  rt="int64")],
             [], confs=_ANSI_ON, raises="MAP_KEY_DOES_NOT_EXIST"),
        Case("months_between roundOff=false keeps full precision",
             pa.table({"a": pa.array([_dt.date(2020, 1, 14)],
                                     pa.date32()),
                       "b": pa.array([_dt.date(2020, 1, 10)],
                                     pa.date32())}),
             [_fn("months_between", _col(0), _col(1),
                  _lit(False, "bool"), rt="float64")],
             [(4.0 / 31.0,)]),
        Case("raises honor the filter selection mask",
             # row 2 has i=0, which would raise INVALID_INDEX_OF_ZERO —
             # but the filter deselects it, so the query must succeed
             pa.table({"a": pa.array([[1, 2], [3]]),
                       "i": pa.array([2, 0])}),
             [], [(2,)],
             plan=lambda scan: {
                 "kind": "project",
                 "exprs": [_fn("element_at", _col(0), _col(1),
                               rt="int64")],
                 "names": ["v"],
                 "input": {"kind": "filter",
                           "predicates": [_bin("!=", _col(1), _lit(0))],
                           "input": scan}}),
    ]


# ---------------------------------------------------------------------------
# three-valued logic (ref PredicateSuite)
# ---------------------------------------------------------------------------

@_suite("ThreeValuedLogicSuite")
def _tvl():
    b = pa.table({"a": pa.array([True, True, False, False, None, None]),
                  "b": pa.array([True, None, True, None, True, None])})
    return [
        Case("Kleene AND truth table",
             b, [_bin("and", _col(0), _col(1))],
             [(True,), (None,), (False,), (False,), (None,), (None,)]),
        Case("Kleene OR truth table",
             b, [_bin("or", _col(0), _col(1))],
             [(True,), (True,), (True,), (None,), (True,), (None,)]),
        Case("NOT of null is null",
             pa.table({"a": pa.array([True, False, None])}),
             [{"kind": "not", "child": _col(0)}],
             [(False,), (True,), (None,)]),
        Case("null-safe equal over null patterns",
             pa.table({"a": pa.array([1, None, None, 2]),
                       "b": pa.array([1, None, 3, 9])}),
             [_bin("<=>", _col(0), _col(1))],
             [(True,), (True,), (False,), (False,)]),
        Case("comparison with null is null, not false",
             pa.table({"a": pa.array([1, None])}),
             [_bin("<", _col(0), _lit(5)),
              _bin("==", _col(0), _lit(1))],
             [(True, True), (None, None)]),
        Case("in-list: match wins over null member",
             pa.table({"a": pa.array([1, 3, None])}),
             [{"kind": "in_list", "child": _col(0), "values": [1, None]}],
             [(True,), (None,), (None,)]),
        Case("negated in-list keeps null as null",
             pa.table({"a": pa.array([1, 3])}),
             [{"kind": "in_list", "child": _col(0), "values": [1, None],
               "negated": True}],
             [(False,), (None,)]),
        Case("is_null / is_not_null never return null",
             pa.table({"a": pa.array([1, None])}),
             [{"kind": "is_null", "child": _col(0)},
              {"kind": "is_not_null", "child": _col(0)}],
             [(False, True), (True, False)]),
        Case("if with null condition takes else",
             pa.table({"c": pa.array([True, False, None])}),
             [{"kind": "if", "cond": _col(0), "then": _lit(1),
               "else": _lit(2)}],
             [(1,), (2,), (2,)]),
    ]


# ---------------------------------------------------------------------------
# bitwise (ref BitwiseExpressionsSuite)
# ---------------------------------------------------------------------------

@_suite("BitwiseSuite")
def _bitwise():
    t = pa.table({"a": pa.array([0b1100, -1, None]),
                  "b": pa.array([0b1010, 1, 1])})
    return [
        Case("AND/OR/XOR with negatives and nulls",
             t, [_bin("&", _col(0), _col(1)),
                 _bin("|", _col(0), _col(1)),
                 _bin("^", _col(0), _col(1))],
             [(0b1000, 0b1110, 0b0110), (1, -1, -2), (None, None, None)]),
        Case("shift left grows, arithmetic shift right keeps sign",
             pa.table({"a": pa.array([1, -8])}),
             [_bin("<<", _col(0), _lit(3)),
              _bin(">>", _col(0), _lit(1))],
             [(8, 0), (-64, -4)]),
        Case("xor with self is zero",
             pa.table({"a": pa.array([12345, -9])}),
             [_bin("^", _col(0), _col(0))],
             [(0,), (0,)]),
    ]


# ---------------------------------------------------------------------------
# nested types (ref ComplexTypeSuite)
# ---------------------------------------------------------------------------

@_suite("NestedStructSuite")
def _nested_struct():
    s = pa.table({"s": pa.array([{"x": 1, "y": "a"},
                                 {"x": 2, "y": None}, None],
                                pa.struct([("x", pa.int64()),
                                           ("y", pa.utf8())]))})
    return [
        Case("struct field access by ordinal",
             s, [{"kind": "get_indexed_field", "child": _col(0),
                  "index": 0, "type": {"id": "int64"}}],
             [(1,), (2,), (None,)]),
        Case("null struct yields null field, not garbage",
             s, [{"kind": "get_indexed_field", "child": _col(0),
                  "index": 1, "type": {"id": "utf8"}}],
             [("a",), (None,), (None,)]),
        Case("named_struct builds then projects back",
             pa.table({"a": pa.array([5, None])}),
             [{"kind": "get_indexed_field",
               "child": {"kind": "named_struct", "names": ["v", "w"],
                         "args": [_col(0), _lit(9)]},
               "index": 0, "type": {"id": "int64"}}],
             [(5,), (None,)]),
        Case("nested struct-in-struct access",
             pa.table({"s": pa.array(
                 [{"inner": {"z": 7}}, None],
                 pa.struct([("inner", pa.struct([("z", pa.int64())]))]))}),
             [{"kind": "get_indexed_field",
               "child": {"kind": "get_indexed_field", "child": _col(0),
                         "index": 0,
                         "type": {"id": "struct",
                                  "children": [{"name": "z",
                                                "type": {"id": "int64"}}]}},
               "index": 0, "type": {"id": "int64"}}],
             [(7,), (None,)]),
    ]


@_suite("MapAccessSuite")
def _map_access():
    m = pa.table({"m": pa.array([[("k1", 1), ("k2", 2)], [], None],
                                pa.map_(pa.utf8(), pa.int64()))})
    return [
        Case("map value by literal key",
             m, [{"kind": "get_map_value", "child": _col(0), "key": "k2",
                  "type": {"id": "int64"}}],
             [(2,), (None,), (None,)]),
        Case("missing key is null",
             m, [{"kind": "get_map_value", "child": _col(0), "key": "zz",
                  "type": {"id": "int64"}}],
             [(None,), (None,), (None,)]),
        Case("map_keys preserves insertion order",
             m, [_fn("map_keys", _col(0))],
             [(["k1", "k2"],), ([],), (None,)]),
        Case("element_at on map is key lookup",
             m, [_fn("element_at", _col(0), _lit("k1", "utf8"),
                     rt="int64")],
             [(1,), (None,), (None,)]),
        Case("cardinality of a map counts entries",
             m, [_fn("cardinality", _col(0), rt="int32")],
             [(2,), (0,), (-1,)]),
    ]


@_suite("ArrayAccessSuite")
def _array_access():
    a = pa.table({"a": pa.array([[10, 20, 30], [], None])})
    return [
        Case("array ordinal access, OOB is null (non-ANSI)",
             a, [{"kind": "get_indexed_field", "child": _col(0),
                  "index": 1, "type": {"id": "int64"}},
                 {"kind": "get_indexed_field", "child": _col(0),
                  "index": 9, "type": {"id": "int64"}}],
             [(20, None), (None, None), (None, None)]),
        Case("element_at index 0 raises in every mode",
             pa.table({"a": pa.array([[1, 2, 3]])}),
             [_fn("element_at", _col(0), _lit(0), rt="int64")],
             [], raises="INVALID_INDEX_OF_ZERO"),
        Case("element_at beyond either end is null",
             pa.table({"a": pa.array([[1, 2, 3]])}),
             [_fn("element_at", _col(0), _lit(4), rt="int64"),
              _fn("element_at", _col(0), _lit(-4), rt="int64")],
             [(None, None)]),
        Case("array of strings ordinal access",
             pa.table({"a": pa.array([["x", None, "z"]])}),
             [{"kind": "get_indexed_field", "child": _col(0),
               "index": 1, "type": {"id": "utf8"}}],
             [(None,)]),
        Case("make_array then index round trips",
             pa.table({"x": pa.array([1, 2]), "y": pa.array([3, 4])}),
             [{"kind": "get_indexed_field",
               "child": _fn("make_array", _col(0), _col(1)),
               "index": 1, "type": {"id": "int64"}}],
             [(3,), (4,)]),
    ]


# ---------------------------------------------------------------------------
# NaN / -0.0 ordering (ref DataFrameAggregateSuite "NaN and -0.0" cases)
# ---------------------------------------------------------------------------

@_suite("NaNOrderingSuite")
def _nan_ordering():
    f = pa.table({"x": pa.array([NAN, 1.0, INF, -INF, None])})
    return [
        Case("sort asc: NaN after +Infinity, nulls first",
             f, [], [(None,), (-INF,), (1.0,), (INF,), (NAN,)],
             plan=_sort_plan((0, False, True))),
        Case("sort desc: NaN before +Infinity, nulls last",
             f, [], [(NAN,), (INF,), (1.0,), (-INF,), (None,)],
             plan=_sort_plan((0, True, False))),
        Case("max treats NaN as largest",
             pa.table({"x": pa.array([1.0, NAN, INF])}),
             [], [(NAN,)],
             plan=_agg_plan((), [("max", _col(0), "mx")])),
        Case("min skips NaN (NaN is largest, not smallest)",
             pa.table({"x": pa.array([1.0, NAN, 2.0])}),
             [], [(1.0,)],
             plan=_agg_plan((), [("min", _col(0), "mn")])),
        Case("min of all-NaN group is NaN",
             pa.table({"x": pa.array([NAN, NAN])}),
             [], [(NAN,)],
             plan=_agg_plan((), [("min", _col(0), "mn")])),
        Case("group keys: all NaN bit patterns are one group",
             pa.table({"k": pa.array([NAN, NAN, 1.0]),
                       "v": pa.array([1, 2, 3])}),
             [], [(1.0, 3), (NAN, 3)], unordered=True,
             plan=_agg_plan((0,), [("sum", _col(1), "s")])),
        Case("group keys: -0.0 and 0.0 are one group",
             pa.table({"k": pa.array([-0.0, 0.0]),
                       "v": pa.array([1, 2])}),
             [], [(0.0, 3)],
             plan=_agg_plan((0,), [("sum", _col(1), "s")])),
    ]


@_suite("SortNullsSuite")
def _sort_nulls():
    t = pa.table({"a": pa.array([3, None, 1, 2]),
                  "b": pa.array(["x", "y", "z", None])})
    return [
        Case("asc nulls first (Spark default asc)",
             t, [], [(None, "y"), (1, "z"), (2, None), (3, "x")],
             plan=_sort_plan((0, False, True))),
        Case("asc nulls last",
             t, [], [(1, "z"), (2, None), (3, "x"), (None, "y")],
             plan=_sort_plan((0, False, False))),
        Case("desc nulls last (Spark default desc)",
             t, [], [(3, "x"), (2, None), (1, "z"), (None, "y")],
             plan=_sort_plan((0, True, False))),
        Case("desc nulls first",
             t, [], [(None, "y"), (3, "x"), (2, None), (1, "z")],
             plan=_sort_plan((0, True, True))),
        Case("two keys: second breaks ties incl. null",
             pa.table({"a": pa.array([1, 1, 1]),
                       "b": pa.array([None, "b", "a"])}),
             [], [(1, None), (1, "a"), (1, "b")],
             plan=_sort_plan((0, False, True), (1, False, True))),
        Case("top-n fetch keeps sort contract",
             pa.table({"a": pa.array([5, 1, 4, 2, 3])}),
             [], [(1,), (2,)],
             plan=_sort_plan((0, False, True), fetch=2)),
        Case("utf8 sort is bytewise, empty first",
             pa.table({"s": pa.array(["b", "", "a", "B"])}),
             [], [("",), ("B",), ("a",), ("b",)],
             plan=_sort_plan((0, False, True))),
    ]


# ---------------------------------------------------------------------------
# aggregate null semantics (ref DataFrameAggregateSuite)
# ---------------------------------------------------------------------------

@_suite("AggNullSemanticsSuite")
def _agg_nulls():
    t = pa.table({"k": pa.array(["a", "a", "b", "b"]),
                  "v": pa.array([1, None, None, None])})
    return [
        Case("count(1) counts rows, count(col) skips nulls",
             t, [], [("a", 2, 1), ("b", 2, 0)], unordered=True,
             plan=_agg_plan((0,), [("count", _lit(1), "c1"),
                                   ("count", _col(1), "cv")])),
        Case("sum of an all-null group is null, not 0",
             t, [], [("a", 1), ("b", None)], unordered=True,
             plan=_agg_plan((0,), [("sum", _col(1), "s")])),
        Case("avg ignores nulls in the denominator",
             pa.table({"k": pa.array(["a", "a", "a"]),
                       "v": pa.array([2, None, 4])}),
             [], [("a", 3.0)],
             plan=_agg_plan((0,), [("avg", _col(1), "m")])),
        Case("min/max of all-null group are null",
             t, [], [("a", 1, 1), ("b", None, None)], unordered=True,
             plan=_agg_plan((0,), [("min", _col(1), "mn"),
                                   ("max", _col(1), "mx")])),
        Case("global agg over empty input: count 0, sum null",
             pa.table({"v": pa.array([], pa.int64())}),
             [], [(0, None)],
             plan=_agg_plan((), [("count", _col(0), "c"),
                                 ("sum", _col(0), "s")])),
        Case("grouped agg over empty input has no rows",
             pa.table({"k": pa.array([], pa.utf8()),
                       "v": pa.array([], pa.int64())}),
             [], [],
             plan=_agg_plan((0,), [("sum", _col(1), "s")])),
        Case("sum int64 overflow wraps (non-ANSI)",
             pa.table({"v": pa.array([I64MAX, 1])}),
             [], [(I64MIN,)],
             plan=_agg_plan((), [("sum", _col(0), "s")])),
        Case("first takes first row even when null",
             pa.table({"v": pa.array([None, 7, 8])}),
             [], [(None,)],
             plan=_agg_plan((), [("first", _col(0), "f")])),
        Case("first_ignores_null skips leading nulls",
             pa.table({"v": pa.array([None, 7, 8])}),
             [], [(7,)],
             plan=_agg_plan((), [("first_ignores_null", _col(0), "f")])),
        Case("null group key forms its own group",
             pa.table({"k": pa.array(["a", None, None]),
                       "v": pa.array([1, 2, 3])}),
             [], [("a", 1), (None, 5)], unordered=True,
             plan=_agg_plan((0,), [("sum", _col(1), "s")])),
        Case("avg of int column widens to double",
             pa.table({"v": pa.array([1, 2])}),
             [], [(1.5,)],
             plan=_agg_plan((), [("avg", _col(0), "m")])),
        Case("collect_list keeps duplicates, skips nulls",
             pa.table({"v": pa.array([1, None, 1, 2])}),
             [], [([1, 1, 2],)],
             plan=_agg_plan((), [("collect_list", _col(0), "l")])),
    ]


# ---------------------------------------------------------------------------
# join-key semantics (ref JoinSuite / OuterJoinSuite)
# ---------------------------------------------------------------------------

def _join_inputs():
    l = pa.table({"a": pa.array([1.0, NAN, -0.0, None]),
                  "lv": pa.array([10, 20, 30, 40])})
    r = pa.table({"b": pa.array([NAN, 0.0, None]),
                  "rv": pa.array([100, 200, 300])})
    return l, r


@_suite("JoinKeySemanticsSuite")
def _join_keys():
    l, r = _join_inputs()
    il = pa.table({"a": pa.array([1, 2, None]),
                   "lv": pa.array([10, 20, 30])})
    ir = pa.table({"b": pa.array([2, None, 2]),
                   "rv": pa.array([100, 200, 300])})
    out = [
        Case("inner: NaN matches NaN, -0.0 matches 0.0, null never",
             l, [], [(NAN, 20, NAN, 100), (-0.0, 30, 0.0, 200)],
             unordered=True, input2=r,
             plan=_join_plan("hash_join", "inner")),
        Case("SMJ agrees with hash join on NaN/-0.0 keys",
             l, [], [(NAN, 20, NAN, 100), (-0.0, 30, 0.0, 200)],
             unordered=True, input2=r,
             plan=_join_plan("sort_merge_join", "inner")),
        Case("left outer: unmatched and null-keyed rows null-extend",
             l, [], [(NAN, 20, NAN, 100), (-0.0, 30, 0.0, 200),
                     (1.0, 10, None, None), (None, 40, None, None)],
             unordered=True, input2=r,
             plan=_join_plan("hash_join", "left")),
        Case("left semi keeps each match once",
             il, [], [(2, 20)], unordered=True, input2=ir,
             plan=_join_plan("hash_join", "left_semi")),
        Case("left anti keeps null-keyed probe rows",
             il, [], [(1, 10), (None, 30)], unordered=True, input2=ir,
             plan=_join_plan("hash_join", "left_anti")),
        Case("null-aware anti drops everything when build has null",
             il, [], [], input2=ir,
             plan=_join_plan("hash_join", "left_anti",
                             null_aware_anti=True)),
        Case("full outer covers both dangling sides",
             pa.table({"a": pa.array([1, 2]), "lv": pa.array([10, 20])}),
             [], [(1, 10, None, None), (2, 20, 2, 100),
                  (None, None, 3, 300)],
             unordered=True,
             input2=pa.table({"b": pa.array([2, 3]),
                              "rv": pa.array([100, 300])}),
             plan=_join_plan("sort_merge_join", "full")),
        Case("duplicate keys produce the cross product of matches",
             pa.table({"a": pa.array([7, 7]), "lv": pa.array([1, 2])}),
             [], [(7, 1, 7, 100), (7, 1, 7, 200), (7, 2, 7, 100),
                  (7, 2, 7, 200)],
             unordered=True,
             input2=pa.table({"b": pa.array([7, 7]),
                              "rv": pa.array([100, 200])}),
             plan=_join_plan("hash_join", "inner")),
    ]
    return out


# ---------------------------------------------------------------------------
# window functions (ref DataFrameWindowFunctionsSuite)
# ---------------------------------------------------------------------------

def _window_plan(functions, part_idx=(), order=()):
    """Window over Sort — the real plan shape: WindowExec requires its
    child pre-sorted by (partition, order) keys exactly like the
    reference (window_exec.rs expects the planner-inserted SortExec)."""
    def mk(scan):
        sort = {"kind": "sort", "input": scan,
                "specs": ([{"expr": _col(i), "descending": False,
                            "nulls_first": True} for i in part_idx] +
                          [{"expr": _col(i), "descending": d,
                            "nulls_first": not d} for (i, d) in order])}
        return {"kind": "window", "input": sort, "functions": functions,
                "partition_by": [_col(i) for i in part_idx],
                "order_by": [{"expr": _col(i), "descending": d}
                             for (i, d) in order]}
    return mk


@_suite("WindowFunctionsSuite")
def _window_fns():
    t = pa.table({"g": pa.array([1, 1, 1, 2]),
                  "x": pa.array([10, 10, 5, 7])})
    return [
        Case("rank leaves gaps on ties, dense_rank does not",
             t, [],
             [(1, 10, 1, 1, 1), (1, 10, 2, 1, 1), (1, 5, 3, 3, 2),
              (2, 7, 1, 1, 1)],
             plan=_window_plan([{"kind": "row_number", "name": "rn"},
                                {"kind": "rank", "name": "rk"},
                                {"kind": "dense_rank", "name": "dr"}],
                               part_idx=(0,), order=((1, True),))),
        Case("lag at partition head takes default null",
             t, [],
             [(1, 5, None), (1, 10, 5), (1, 10, 10), (2, 7, None)],
             unordered=True,
             plan=_window_plan([{"kind": "lag", "name": "lg",
                                 "expr": _col(1), "offset": 1}],
                               part_idx=(0,), order=((1, False),))),
        Case("lead past partition end is null",
             t, [],
             [(1, 5, 10), (1, 10, 10), (1, 10, None), (2, 7, None)],
             unordered=True,
             plan=_window_plan([{"kind": "lead", "name": "ld",
                                 "expr": _col(1), "offset": 1}],
                               part_idx=(0,), order=((1, False),))),
        Case("running sum over the ordered frame",
             pa.table({"g": pa.array([1, 1, 1]),
                       "x": pa.array([1, 2, 3])}),
             [], [(1, 1, 1), (1, 2, 3), (1, 3, 6)],
             plan=_window_plan([{"kind": "agg", "name": "rs",
                                 "fn": "sum", "args": [_col(1)],
                                 "running": True}],
                               part_idx=(0,), order=((1, False),))),
        Case("unpartitioned window ranks the whole input",
             pa.table({"x": pa.array([3, 1, 2])}),
             [], [(1, 1), (2, 2), (3, 3)], unordered=True,
             plan=_window_plan([{"kind": "row_number", "name": "rn"}],
                               order=((0, False),))),
    ]


# ---------------------------------------------------------------------------
# string predicates beyond the basics (ref StringFunctionsSuite)
# ---------------------------------------------------------------------------

@_suite("StringPredicateExtSuite")
def _string_pred_ext():
    s = pa.table({"s": pa.array(["50%", "50x", "a_b", "axb", None])})
    return [
        Case("LIKE escapes backslashed percent",
             s, [{"kind": "like", "child": _col(0),
                  "pattern": "50\\%"}],
             [(True,), (False,), (False,), (False,), (None,)]),
        Case("LIKE escapes backslashed underscore",
             s, [{"kind": "like", "child": _col(0),
                  "pattern": "a\\_b"}],
             [(False,), (False,), (True,), (False,), (None,)]),
        Case("NOT LIKE keeps null as null",
             pa.table({"s": pa.array(["abc", "xyz", None])}),
             [{"kind": "like", "child": _col(0), "pattern": "a%",
               "negated": True}],
             [(False,), (True,), (None,)]),
        Case("case-insensitive LIKE (ILIKE)",
             pa.table({"s": pa.array(["ABC", "abc", "xbc"])}),
             [{"kind": "like", "child": _col(0), "pattern": "a%",
               "case_insensitive": True}],
             [(True,), (True,), (False,)]),
        Case("LIKE regex metacharacters are literal",
             pa.table({"s": pa.array(["a.c", "abc", "a+c"])}),
             [{"kind": "like", "child": _col(0), "pattern": "a.c"}],
             [(True,), (False,), (False,)]),
        Case("starts/ends/contains predicates",
             pa.table({"s": pa.array(["spark sql", "sql spark", None])}),
             [{"kind": "string_starts_with", "child": _col(0),
               "pattern": "spark"},
              {"kind": "string_ends_with", "child": _col(0),
               "pattern": "spark"},
              {"kind": "string_contains", "child": _col(0),
               "pattern": "k s"}],
             [(True, False, True), (False, True, False),
              (None, None, None)]),
        Case("RLIKE anchors make a full match",
             pa.table({"s": pa.array(["abc", "zabc"])}),
             [{"kind": "rlike", "child": _col(0), "pattern": "^abc$"}],
             [(True,), (False,)]),
    ]


# ---------------------------------------------------------------------------
# multi-column hash vectors (ref HashExpressionsSuite)
# ---------------------------------------------------------------------------

@_suite("HashMultiColumnSuite")
def _hash_multi():
    return [
        Case("hash chains columns left to right",
             pa.table({"a": pa.array([1], pa.int32()),
                       "b": pa.array([2], pa.int32())}),
             [_fn("hash", _col(0), _col(1), rt="int32")],
             [(-222940379,)]),
        Case("null column keeps the running seed",
             pa.table({"a": pa.array([1], pa.int32()),
                       "b": pa.array([None], pa.int32())}),
             [_fn("hash", _col(0), _col(1), rt="int32")],
             [(-559580957,)]),
        Case("hash of utf8 is bit-exact",
             pa.table({"s": pa.array(["Spark"])}),
             [_fn("hash", _col(0), rt="int32")],
             [(228093765,)]),
        Case("xxhash64 of utf8 is bit-exact",
             pa.table({"s": pa.array(["Spark"])}),
             [_fn("xxhash64", _col(0), rt="int64")],
             [(-4294468057691064905,)]),
    ]


# ---------------------------------------------------------------------------
# wave 2: collections with NaN, regexp backrefs, months_between time
# fraction, generate / expand / limit operators, string + math edges
# ---------------------------------------------------------------------------

@_suite("CollectionNaNSuite")
def _collection_nan():
    return [
        Case("array_contains matches NaN (ordering.equiv)",
             pa.table({"a": pa.array([[1.0, NAN]])}),
             [_fn("array_contains", _col(0), _lit(NAN, "float64"),
                  rt="bool")],
             [(True,)]),
        Case("array_contains: no match + null element is null",
             pa.table({"a": pa.array([[1, None], [1, 2]],
                                     pa.list_(pa.int64()))}),
             [_fn("array_contains", _col(0), _lit(9), rt="bool")],
             [(None,), (False,)]),
        Case("array_max treats NaN as largest",
             pa.table({"a": pa.array([[1.0, NAN, 2.0]])}),
             [_fn("array_max", _col(0), rt="float64")],
             [(NAN,)]),
        Case("array_min skips NaN",
             pa.table({"a": pa.array([[1.0, NAN, 2.0]])}),
             [_fn("array_min", _col(0), rt="float64")],
             [(1.0,)]),
        Case("array_min of all-NaN array is NaN",
             pa.table({"a": pa.array([[NAN, NAN]])}),
             [_fn("array_min", _col(0), rt="float64")],
             [(NAN,)]),
        Case("concat_ws flattens array arguments",
             pa.table({"a": pa.array([["a", "b"]]),
                       "s": pa.array(["z"])}),
             [_fn("concat_ws", _lit(",", "utf8"), _col(0), _col(1),
                  rt="utf8")],
             [("a,b,z",)]),
        Case("concat_ws skips null elements inside arrays",
             pa.table({"a": pa.array([["a", None, "c"]])}),
             [_fn("concat_ws", _lit("-", "utf8"), _col(0), rt="utf8")],
             [("a-c",)]),
    ]


@_suite("RegexpBackrefSuite")
def _regexp_backref():
    return [
        Case("regexp_replace substitutes $1 group references",
             pa.table({"s": pa.array(["a1b2"])}),
             [_fn("regexp_replace", _col(0), _lit("(\\d)", "utf8"),
                  _lit("[$1]", "utf8"), rt="utf8")],
             [("a[1]b[2]",)]),
        Case("regexp_replace swaps two groups",
             pa.table({"s": pa.array(["john smith"])}),
             [_fn("regexp_replace", _col(0),
                  _lit("(\\w+) (\\w+)", "utf8"),
                  _lit("$2 $1", "utf8"), rt="utf8")],
             [("smith john",)]),
        Case("escaped dollar stays literal",
             pa.table({"s": pa.array(["x"])}),
             [_fn("regexp_replace", _col(0), _lit("x", "utf8"),
                  _lit("\\$9", "utf8"), rt="utf8")],
             [("$9",)]),
        Case("backslash-digit is a literal, not a group ref (Java)",
             pa.table({"s": pa.array(["ab"])}),
             [_fn("regexp_replace", _col(0), _lit("(a)b", "utf8"),
                  _lit("\\1", "utf8"), rt="utf8")],
             [("1",)]),
        Case("regexp_extract group 0 is the whole match",
             pa.table({"s": pa.array(["a1", "zzz"])}),
             [_fn("regexp_extract", _col(0), _lit("([a-z])(\\d)", "utf8"),
                  _lit(0), rt="utf8")],
             [("a1",), ("",)]),
        Case("unmatched optional group extracts empty string",
             pa.table({"s": pa.array(["a1", "b"])}),
             [_fn("regexp_extract", _col(0),
                  _lit("([a-z])(\\d)?", "utf8"), _lit(2), rt="utf8")],
             [("1",), ("",)]),
    ]


@_suite("MonthsBetweenSuite")
def _months_between_suite():
    import numpy as _np

    def ts(s):
        return pa.array([_np.datetime64(s, "us")], pa.timestamp("us"))
    return [
        Case("doc example includes the time-of-day fraction",
             pa.table({"a": ts("1997-02-28T10:30:00"),
                       "b": ts("1996-10-30T00:00:00")}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(3.94959677,)]),
        Case("same day-of-month ignores time of day",
             pa.table({"a": ts("2020-03-15T23:00:00"),
                       "b": ts("2020-01-15T01:00:00")}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(2.0,)]),
        Case("both month-ends are integral",
             pa.table({"a": ts("2020-02-29T12:00:00"),
                       "b": ts("2019-11-30T00:00:00")}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(3.0,)]),
        Case("negative when first is earlier",
             pa.table({"a": ts("2020-01-10T00:00:00"),
                       "b": ts("2020-02-10T00:00:00")}),
             [_fn("months_between", _col(0), _col(1), rt="float64")],
             [(-1.0,)]),
    ]


@_suite("GenerateOperatorSuite")
def _generate_operator():
    t = pa.table({"id": pa.array([1, 2, 3]),
                  "a": pa.array([[10, 20], [], None])})

    def gen_plan(kind, outer):
        def mk(scan):
            return {"kind": "generate",
                    "generator": {"kind": kind, "child": _col(1),
                                  "outer": outer},
                    "required_cols": [0], "input": scan}
        return mk
    jt = pa.table({"j": pa.array(['{"a": 1, "b": "x"}', "bad", None])})

    def json_tuple_plan(scan):
        return {"kind": "generate",
                "generator": {"kind": "json_tuple", "child": _col(0),
                              "fields": ["a", "b"]},
                "required_cols": [], "input": scan}
    return [
        Case("explode drops empty and null arrays",
             t, [], [(1, 10), (1, 20)],
             plan=gen_plan("explode", False)),
        Case("explode_outer keeps them as null rows",
             t, [], [(1, 10), (1, 20), (2, None), (3, None)],
             plan=gen_plan("explode", True)),
        Case("posexplode emits 0-based positions",
             t, [], [(1, 0, 10), (1, 1, 20)],
             plan=gen_plan("posexplode", False)),
        Case("posexplode_outer null position on empty",
             t, [], [(1, 0, 10), (1, 1, 20), (2, None, None),
                     (3, None, None)],
             plan=gen_plan("posexplode", True)),
        Case("json_tuple extracts fields, null row on bad json",
             jt, [], [("1", "x"), (None, None), (None, None)],
             plan=json_tuple_plan),
    ]


@_suite("ExpandUnionLimitSuite")
def _expand_union_limit():
    t = pa.table({"a": pa.array([1, 2]), "b": pa.array([10, 20])})

    def expand_plan(scan):
        return {"kind": "expand",
                "projections": [[_col(0), _lit(None, "int64")],
                                [_lit(None, "int64"), _col(1)]],
                "names": ["a", "b"], "input": scan}

    def union_plan(scan, scan2):
        return {"kind": "union", "inputs": [scan, scan2]}

    def limit_plan(limit, offset):
        def mk(scan):
            return {"kind": "limit", "limit": limit, "offset": offset,
                    "input": scan}
        return mk
    five = pa.table({"x": pa.array([1, 2, 3, 4, 5])})
    return [
        Case("expand replicates each row per projection (rollup shape)",
             t, [], [(1, None), (2, None), (None, 10), (None, 20)],
             unordered=True, plan=expand_plan),
        Case("union concatenates without dedup",
             pa.table({"x": pa.array([1, 2])}), [],
             [(1,), (2,), (2,), (3,)], unordered=True,
             input2=pa.table({"x": pa.array([2, 3])}),
             plan=union_plan),
        Case("limit with offset skips then takes",
             five, [], [(2,), (3,)], plan=limit_plan(2, 1)),
        Case("limit beyond input is the whole input",
             five, [], [(1,), (2,), (3,), (4,), (5,)],
             plan=limit_plan(99, 0)),
        Case("offset beyond input is empty",
             five, [], [], plan=limit_plan(5, 99)),
    ]


@_suite("MathIntegerEdgeSuite")
def _math_integer_edge():
    return [
        Case("abs of int64 min wraps to itself (non-ANSI)",
             pa.table({"x": pa.array([I64MIN, -7])}),
             [_fn("abs", _col(0), rt="int64")],
             [(I64MIN,), (7,)]),
        Case("int32 addition wraps at int32 width",
             pa.table({"a": pa.array([I32MAX], pa.int32()),
                       "b": pa.array([1], pa.int32())}),
             [_bin("+", _col(0), _col(1))],
             [(I32MIN,)]),
        Case("int32 multiplication wraps at int32 width",
             pa.table({"a": pa.array([1 << 30], pa.int32())}),
             [_bin("*", _col(0), _lit(4, "int32"))],
             [(0,)]),
        Case("float modulo sign follows dividend",
             pa.table({"a": pa.array([7.5, -7.5])}),
             [_bin("%", _col(0), _lit(3.0, "float64"))],
             [(1.5,), (-1.5,)]),
        Case("pmod of float is non-negative",
             pa.table({"a": pa.array([-7.0])}),
             [_bin("pmod", _col(0), _lit(3.0, "float64"))],
             [(2.0,)]),
        Case("round with negative digits",
             pa.table({"x": pa.array([1254.0, 1249.0])}),
             [_fn("round", _col(0), _lit(-2), rt="float64")],
             [(1300.0,), (1200.0,)]),
        Case("sqrt of negative zero is negative zero (IEEE)",
             pa.table({"x": pa.array([-0.0])}),
             [_fn("sqrt", _col(0), rt="float64")],
             [(-0.0,)]),
        Case("signum of NaN is NaN",
             pa.table({"x": pa.array([NAN, -0.0])}),
             [_fn("signum", _col(0), rt="float64")],
             [(NAN,), (-0.0,)]),
    ]


@_suite("StringFnEdgeSuite")
def _string_fn_edge():
    return [
        Case("lpad cycles a multi-char pad",
             pa.table({"s": pa.array(["7"])}),
             [_fn("lpad", _col(0), _lit(5), _lit("xy", "utf8"),
                  rt="utf8")],
             [("xyxy7",)]),
        Case("repeat of zero or negative count is empty",
             pa.table({"s": pa.array(["ab"])}),
             [_fn("repeat", _col(0), _lit(0), rt="utf8"),
              _fn("repeat", _col(0), _lit(-1), rt="utf8")],
             [("", "")]),
        Case("ascii returns the first code point, 0 for empty",
             pa.table({"s": pa.array(["€x", "", "A"])}),
             [_fn("ascii", _col(0), rt="int32")],
             [(8364,), (0,), (65,)]),
        Case("reverse is character-wise, not byte-wise",
             pa.table({"s": pa.array(["ab€"])}),
             [_fn("reverse", _col(0), rt="utf8")],
             [("€ba",)]),
        Case("substring_index with negative count takes from the right",
             pa.table({"s": pa.array(["a.b.c.d"])}),
             [_fn("substring_index", _col(0), _lit(".", "utf8"),
                  _lit(-2), rt="utf8")],
             [("c.d",)]),
        Case("locate start beyond length is 0",
             pa.table({"s": pa.array(["hello"])}),
             [_fn("locate", _lit("l", "utf8"), _col(0), _lit(99),
                  rt="int32")],
             [(0,)]),
        Case("trim of only-space strings is empty not null",
             pa.table({"s": pa.array(["   ", ""])}),
             [_fn("trim", _col(0), rt="utf8")],
             [("",), ("",)]),
    ]


@_suite("DateTruncExtSuite")
def _date_trunc_ext():
    import numpy as _np
    t = pa.table({"t": pa.array([_np.datetime64("2015-03-05T09:32:05.359",
                                                "us")],
                                pa.timestamp("us"))})

    def dt(*a):
        return _dt.datetime(*a)
    return [
        Case("date_trunc across the unit ladder",
             t, [_fn("date_trunc", _lit("MINUTE", "utf8"), _col(0),
                     rt="timestamp_us"),
                 _fn("date_trunc", _lit("DAY", "utf8"), _col(0),
                     rt="timestamp_us"),
                 _fn("date_trunc", _lit("WEEK", "utf8"), _col(0),
                     rt="timestamp_us"),
                 _fn("date_trunc", _lit("QUARTER", "utf8"), _col(0),
                     rt="timestamp_us"),
                 _fn("date_trunc", _lit("YEAR", "utf8"), _col(0),
                     rt="timestamp_us")],
             [(dt(2015, 3, 5, 9, 32), dt(2015, 3, 5),
               dt(2015, 3, 2), dt(2015, 1, 1), dt(2015, 1, 1))]),
        Case("date_trunc SECOND drops fractional seconds",
             t, [_fn("date_trunc", _lit("SECOND", "utf8"), _col(0),
                     rt="timestamp_us")],
             [(dt(2015, 3, 5, 9, 32, 5),)]),
        Case("date_trunc HOUR",
             t, [_fn("date_trunc", _lit("HOUR", "utf8"), _col(0),
                     rt="timestamp_us")],
             [(dt(2015, 3, 5, 9),)]),
    ]


@_suite("ConditionalExtSuite")
def _conditional_ext():
    return [
        Case("case takes the FIRST matching branch",
             pa.table({"x": pa.array([5])}),
             [{"kind": "case",
               "branches": [[_bin(">", _col(0), _lit(1)), _lit(10)],
                            [_bin(">", _col(0), _lit(2)), _lit(20)]],
               "else": _lit(0)}],
             [(10,)]),
        Case("case with null condition falls through",
             pa.table({"x": pa.array([None], pa.int64())}),
             [{"kind": "case",
               "branches": [[_bin(">", _col(0), _lit(1)), _lit(10)]],
               "else": _lit(99)}],
             [(99,)]),
        Case("nested coalesce picks leftmost non-null",
             pa.table({"a": pa.array([None, 1], pa.int64()),
                       "b": pa.array([None, 9], pa.int64())}),
             [{"kind": "coalesce",
               "args": [_col(0), _col(1), _lit(7)]}],
             [(7,), (1,)]),
        Case("if propagates the chosen branch's null",
             pa.table({"c": pa.array([True, False]),
                       "x": pa.array([None, None], pa.int64())}),
             [{"kind": "if", "cond": _col(0), "then": _col(1),
               "else": _lit(3)}],
             [(None,), (3,)]),
    ]


@_suite("SortTypesSuite")
def _sort_types():
    import numpy as _np
    return [
        Case("date32 sorts chronologically",
             pa.table({"d": pa.array([_dt.date(2020, 5, 1),
                                      _dt.date(2019, 1, 1), None],
                                     pa.date32())}),
             [], [(None,), (_dt.date(2019, 1, 1),),
                  (_dt.date(2020, 5, 1),)],
             plan=_sort_plan((0, False, True))),
        Case("bool sorts false before true",
             pa.table({"b": pa.array([True, False, None])}),
             [], [(None,), (False,), (True,)],
             plan=_sort_plan((0, False, True))),
        Case("negative zero and zero are equal sort keys",
             pa.table({"x": pa.array([0.0, -0.0, -1.0])}),
             [], [(-1.0,), (-0.0,), (0.0,)], unordered=True,
             plan=_sort_plan((0, False, True))),
        Case("timestamp sorts by instant",
             pa.table({"t": pa.array([_np.datetime64("2020-01-02", "us"),
                                      _np.datetime64("2020-01-01", "us")],
                                     pa.timestamp("us"))}),
             [], [(_dt.datetime(2020, 1, 1),),
                  (_dt.datetime(2020, 1, 2),)],
             plan=_sort_plan((0, False, True))),
    ]


@_suite("AggTypedMinMaxSuite")
def _agg_typed_minmax():
    t = pa.table({"k": pa.array(["g1", "g1", "g2"]),
                  "s": pa.array(["b", "a", None]),
                  "b": pa.array([True, False, None]),
                  "d": pa.array([_dt.date(2020, 1, 1), None,
                                 _dt.date(2019, 1, 1)], pa.date32())})
    return [
        Case("min/max over utf8 is lexicographic, host-accumulated",
             t, [], [("g1", "a", "b"), ("g2", None, None)],
             unordered=True,
             plan=_agg_plan((0,), [("min", _col(1), "mn"),
                                   ("max", _col(1), "mx")])),
        Case("min/max over bool orders false < true",
             t, [], [("g1", False, True), ("g2", None, None)],
             unordered=True,
             plan=_agg_plan((0,), [("min", _col(2), "mn"),
                                   ("max", _col(2), "mx")])),
        Case("min over date32 is chronological",
             t, [], [("g1", _dt.date(2020, 1, 1)),
                     ("g2", _dt.date(2019, 1, 1))],
             unordered=True,
             plan=_agg_plan((0,), [("min", _col(3), "mn")])),
        Case("global min/max over utf8 without grouping",
             pa.table({"s": pa.array(["m", "z", "a"])}),
             [], [("a", "z")],
             plan=_agg_plan((), [("min", _col(0), "mn"),
                                 ("max", _col(0), "mx")])),
        Case("sum of float64 propagates NaN",
             pa.table({"x": pa.array([1.0, NAN])}),
             [], [(NAN,)],
             plan=_agg_plan((), [("sum", _col(0), "s")])),
    ]


@_suite("BroadcastJoinSuite")
def _broadcast_join():
    l = pa.table({"a": pa.array([1, 2, 3]), "lv": pa.array([10, 20, 30])})
    r = pa.table({"b": pa.array([2, 3, 4]), "rv": pa.array([200, 300,
                                                            400])})
    return [
        Case("broadcast inner matches shuffled-hash results",
             l, [], [(2, 20, 2, 200), (3, 30, 3, 300)], unordered=True,
             input2=r,
             plan=_join_plan("broadcast_join", "inner",
                             build_side="right")),
        Case("broadcast left outer null-extends",
             l, [], [(1, 10, None, None), (2, 20, 2, 200),
                     (3, 30, 3, 300)], unordered=True, input2=r,
             plan=_join_plan("broadcast_join", "left",
                             build_side="right")),
        Case("nested-loop join applies a non-equi filter",
             l, [],
             [(1, 10, 2, 200), (1, 10, 3, 300), (1, 10, 4, 400),
              (2, 20, 3, 300), (2, 20, 4, 400), (3, 30, 4, 400)],
             unordered=True, input2=r,
             plan=lambda scan, scan2: {
                 "kind": "broadcast_nested_loop_join",
                 "left": scan, "right": scan2, "join_type": "inner",
                 "build_side": "right",
                 "join_filter": _bin("<", _col(0), _col(2))}),
        Case("join filter references the joined row",
             l, [], [(3, 30, 3, 300)], unordered=True, input2=r,
             plan=lambda scan, scan2: dict(
                 _join_plan("hash_join", "inner")(scan, scan2),
                 join_filter=_bin(">", _col(3), _lit(200)))),
        Case("right outer keeps dangling build rows",
             l, [], [(2, 20, 2, 200), (3, 30, 3, 300),
                     (None, None, 4, 400)], unordered=True, input2=r,
             plan=_join_plan("sort_merge_join", "right")),
    ]


@_suite("TimestampFieldsExtSuite")
def _timestamp_fields_ext():
    import numpy as _np
    t = pa.table({"t": pa.array([_np.datetime64("1970-01-01T00:00:00",
                                                "us"),
                                 _np.datetime64("2015-03-05T23:59:59",
                                                "us")],
                                pa.timestamp("us"))})
    return [
        Case("hour/minute/second at the epoch and day end",
             t, [_fn("hour", _col(0), rt="int32"),
                 _fn("minute", _col(0), rt="int32"),
                 _fn("second", _col(0), rt="int32")],
             [(0, 0, 0), (23, 59, 59)]),
        Case("from_unixtime of zero is the epoch (UTC session)",
             pa.table({"x": pa.array([0])}),
             [_fn("from_unixtime", _col(0), rt="utf8")],
             [("1970-01-01 00:00:00",)]),
        Case("unix_timestamp round trips from_unixtime",
             pa.table({"x": pa.array([1425547925])}),
             [_fn("unix_timestamp",
                  _fn("from_unixtime", _col(0), rt="utf8"),
                  rt="int64")],
             [(1425547925,)]),
        Case("to_date truncates a timestamp string",
             pa.table({"s": pa.array(["2015-03-05 09:32:05"])}),
             [_fn("to_date", _col(0), rt="date32")],
             [(_dt.date(2015, 3, 5),)]),
    ]


@_suite("DecimalArithmeticSuite")
def _decimal_arithmetic():
    from decimal import Decimal as D
    d102 = pa.array([D("12.34"), D("-1.50")], pa.decimal128(10, 2))
    d103 = pa.array([D("1.234"), D("2.000")], pa.decimal128(10, 3))
    t = pa.table({"a": d102, "b": d103})
    return [
        Case("add aligns scales, widens precision (12,3)",
             t, [_bin("+", _col(0), _col(1))],
             [(D("13.574"),), (D("0.500"),)]),
        Case("multiply scale is s1+s2",
             t, [_bin("*", _col(0), _col(1))],
             [(D("15.22756"),), (D("-3.00000"),)]),
        Case("divide scale is max(6, s1+p2+1)",
             t, [_bin("/", _col(0), _col(1))],
             [(D("10.0000000000000"),), (D("-0.7500000000000"),)]),
        Case("comparison aligns scales first",
             pa.table({"a": pa.array([D("1.00")], pa.decimal128(10, 2)),
                       "b": pa.array([D("0.500")],
                                     pa.decimal128(10, 3))}),
             [_bin(">", _col(0), _col(1)),
              _bin("==", _col(0), _col(1))],
             [(True, False)]),
        Case("integer operand widens to decimal",
             pa.table({"a": pa.array([5]),
                       "b": pa.array([D("0.25")],
                                     pa.decimal128(10, 2))}),
             [_bin("+", _col(0), _col(1))],
             [(D("5.25"),)]),
        Case("addition overflow at precision 38 is null",
             pa.table({"a": pa.array([D("9" * 38)],
                                     pa.decimal128(38, 0)),
                       "b": pa.array([D("9" * 38)],
                                     pa.decimal128(38, 0))}),
             [_bin("+", _col(0), _col(1))],
             [(None,)]),
        Case("decimal division by zero is null (non-ANSI)",
             pa.table({"a": pa.array([D("1.00")], pa.decimal128(10, 2)),
                       "b": pa.array([D("0.00")],
                                     pa.decimal128(10, 2))}),
             [_bin("/", _col(0), _col(1))],
             [(None,)]),
        Case("modulo sign follows dividend, pmod the divisor",
             pa.table({"a": pa.array([D("-7.0")], pa.decimal128(10, 1)),
                       "b": pa.array([D("3.0")],
                                     pa.decimal128(10, 1))}),
             [_bin("%", _col(0), _col(1)),
              _bin("pmod", _col(0), _col(1))],
             [(D("-1.0"), D("2.0"))]),
        Case("sum widens precision by 10, avg adds scale 4",
             pa.table({"k": pa.array(["a", "a"]),
                       "v": pa.array([D("12.34"), D("-1.50")],
                                     pa.decimal128(10, 2))}),
             [], [("a", D("10.84"), D("5.420000"))], unordered=True,
             plan=_agg_plan((0,), [("sum", _col(1), "s"),
                                   ("avg", _col(1), "m")])),
        Case("check_overflow keeps wide (p>18) products exact",
             # Spark wraps decimal arithmetic in CheckOverflow; a wide
             # host result must NOT round-trip through int64 device
             # storage (low-8-bytes truncation, r5 review finding)
             pa.table({"a": pa.array([D("1" + "0" * 17)],
                                     pa.decimal128(18, 0)),
                       "b": pa.array([D("1" + "0" * 17)],
                                     pa.decimal128(18, 0))}),
             [{"kind": "scalar_function", "name": "check_overflow",
               "args": [_bin("*", _col(0), _col(1))],
               "return_type": {"id": "decimal", "precision": 38,
                               "scale": 0}}],
             [(D("1" + "0" * 34),)]),
        Case("nested arithmetic chains host intermediates correctly",
             # (a + b) + c: the inner add returns a HOST decimal of a
             # widened type; the outer equal-scale add must not fall
             # into the host comparator path (r5 review finding)
             pa.table({"a": pa.array([D("12.34")], pa.decimal128(10, 2)),
                       "b": pa.array([D("1.234")], pa.decimal128(10, 3)),
                       "c": pa.array([D("0.006")],
                                     pa.decimal128(12, 3))}),
             [_bin("+", _bin("+", _col(0), _col(1)), _col(2))],
             [(D("13.580"),)]),
        Case("date compared to decimal stays a device comparison",
             pa.table({"d": pa.array([_dt.date(2020, 1, 1)],
                                     pa.date32()),
                       "x": pa.array([_dt.date(2019, 1, 1)],
                                     pa.date32())}),
             [_bin(">", _col(0), _col(1))],
             [(True,)]),
        Case("null decimal operand poisons the row",
             pa.table({"a": pa.array([D("1.00"), None],
                                     pa.decimal128(10, 2)),
                       "b": pa.array([D("2.00"), D("2.00")],
                                     pa.decimal128(10, 2))}),
             [_bin("+", _col(0), _col(1))],
             [(D("3.00"),), (None,)]),
    ]


# ---------------------------------------------------------------------------
# wave 3: json rendering, nested-type display casts, crypto widths,
# window group-limit, SMJ semi/anti (the final breadth push)
# ---------------------------------------------------------------------------

@_suite("ToJsonSuite")
def _to_json_suite():
    return [
        Case("to_json omits null fields (ignoreNullFields default)",
             pa.table({"a": pa.array([1, None])}),
             [_fn("to_json", {"kind": "named_struct",
                              "names": ["x", "y"],
                              "args": [_col(0), _lit("s", "utf8")]},
                  rt="utf8")],
             [('{"x":1,"y":"s"}',), ('{"y":"s"}',)]),
        Case("to_json over an array value",
             pa.table({"a": pa.array([[1, 2]])}),
             [_fn("to_json", _col(0), rt="utf8")],
             [("[1,2]",)]),
    ]


@_suite("NestedDisplayCastSuite")
def _nested_display_cast():
    return [
        Case("array renders Spark-style with null literal",
             pa.table({"a": pa.array([[1, 2, None]])}),
             [_cast(_col(0), "utf8")],
             [("[1, 2, null]",)]),
        Case("struct renders value tuple without field names",
             pa.table({"s": pa.array([{"x": 1, "y": "a"}],
                                     pa.struct([("x", pa.int64()),
                                                ("y", pa.utf8())]))}),
             [_cast(_col(0), "utf8")],
             [("{1, a}",)]),
    ]


@_suite("CryptoWidthSuite")
def _crypto_width():
    return [
        Case("sha2 bit widths select the digest family",
             pa.table({"s": pa.array(["abc"])}),
             [_fn("sha2", _col(0), _lit(224), rt="utf8"),
              _fn("sha2", _col(0), _lit(384), rt="utf8")],
             [("23097d223405d8228642a477bda255b32aadbce4bda0b3f7e36c"
               "9da7",
               "cb00753f45a35e8bb5a03d699ac65007272c32ab0eded1631a8b"
               "605a43ff5bed8086072ba1e7cc2358baeca134c825a7")]),
        Case("md5 of empty string",
             pa.table({"s": pa.array([""])}),
             [_fn("md5", _col(0), rt="utf8")],
             [("d41d8cd98f00b204e9800998ecf8427e",)]),
    ]


@_suite("WindowGroupLimitSuite")
def _window_group_limit():
    t = pa.table({"g": pa.array([1, 1, 1, 2, 2]),
                  "x": pa.array([9, 7, 5, 4, 8])})

    def plan(scan):
        return {"kind": "window",
                "input": {"kind": "sort", "input": scan,
                          "specs": [{"expr": _col(0),
                                     "descending": False,
                                     "nulls_first": True},
                                    {"expr": _col(1),
                                     "descending": True,
                                     "nulls_first": False}]},
                "functions": [{"kind": "rank", "name": "rk"}],
                "partition_by": [_col(0)],
                "order_by": [{"expr": _col(1), "descending": True}],
                "group_limit": 2}
    return [
        Case("window-group-limit keeps top-k rows per partition",
             t, [], [(1, 9, 1), (1, 7, 2), (2, 8, 1), (2, 4, 2)],
             plan=plan),
    ]


@_suite("SortMergeJoinTypesSuite")
def _smj_types():
    l = pa.table({"a": pa.array([1, 2, None]),
                  "lv": pa.array([10, 20, 30])})
    r = pa.table({"b": pa.array([2, None, 2]),
                  "rv": pa.array([100, 200, 300])})
    return [
        Case("SMJ left semi keeps each probe match once",
             l, [], [(2, 20)], unordered=True, input2=r,
             plan=_join_plan("sort_merge_join", "left_semi")),
        Case("SMJ left anti keeps null-keyed probe rows",
             l, [], [(1, 10), (None, 30)], unordered=True, input2=r,
             plan=_join_plan("sort_merge_join", "left_anti")),
        Case("SMJ right semi mirrors build-side membership",
             l, [], [(2, 100), (2, 300)], unordered=True, input2=r,
             plan=_join_plan("sort_merge_join", "right_semi")),
    ]


@_suite("ToJsonShapeSuite")
def _to_json_shape():
    nested = pa.struct([("a", pa.struct([("b", pa.int64()),
                                         ("c", pa.int64())]))])
    return [
        Case("null struct fields are omitted RECURSIVELY",
             pa.table({"s": pa.array([{"a": {"b": None, "c": 1}}],
                                     nested)}),
             [_fn("to_json", _col(0), rt="utf8")],
             [('{"a":{"c":1}}',)]),
        Case("null MAP values are kept (ignoreNullFields is "
             "struct-only, JacksonGenerator.writeMapData)",
             pa.table({"m": pa.array([[("k", None), ("j", 1)]],
                                     pa.map_(pa.utf8(), pa.int64()))}),
             [_fn("to_json", _col(0), rt="utf8")],
             [('{"k":null,"j":1}',)]),
        Case("empty map renders as {} not []",
             pa.table({"m": pa.array([[]],
                                     pa.map_(pa.utf8(), pa.int64()))}),
             [_fn("to_json", _col(0), rt="utf8")],
             [("{}",)]),
        Case("null array elements are kept",
             pa.table({"a": pa.array([[1, None, 3]])}),
             [_fn("to_json", _col(0), rt="utf8")],
             [("[1,null,3]",)]),
    ]


@_suite("AnsiArithmeticSuite")
def _ansi_arithmetic():
    return [
        Case("ANSI: integral division by zero raises",
             pa.table({"a": pa.array([10])}),
             [_bin("%", _col(0), _lit(0))],
             [], confs=_ANSI_ON, raises="DIVIDE_BY_ZERO"),
        Case("ANSI: int64 addition overflow raises",
             pa.table({"a": pa.array([I64MAX])}),
             [_bin("+", _col(0), _lit(1))],
             [], confs=_ANSI_ON, raises="ARITHMETIC_OVERFLOW"),
        Case("ANSI: int64 multiply overflow raises",
             pa.table({"a": pa.array([1 << 62])}),
             [_bin("*", _col(0), _lit(4))],
             [], confs=_ANSI_ON, raises="ARITHMETIC_OVERFLOW"),
        Case("ANSI: subtraction underflow raises",
             pa.table({"a": pa.array([I64MIN])}),
             [_bin("-", _col(0), _lit(1))],
             [], confs=_ANSI_ON, raises="ARITHMETIC_OVERFLOW"),
        Case("ANSI: in-range arithmetic still computes",
             pa.table({"a": pa.array([3])}),
             [_bin("*", _col(0), _lit(4)),
              _bin("%", _col(0), _lit(2))],
             [(12, 1)], confs=_ANSI_ON),
        Case("ANSI: float division by zero raises DIVIDE_BY_ZERO",
             pa.table({"a": pa.array([1.0])}),
             [_bin("/", _col(0), _lit(0.0, "float64"))],
             [], confs=_ANSI_ON, raises="DIVIDE_BY_ZERO"),
        Case("ANSI: filtered-out rows cannot raise",
             pa.table({"a": pa.array([10, 10]),
                       "b": pa.array([2, 0])}),
             [], [(5,)],
             confs=_ANSI_ON,
             plan=lambda scan: {
                 "kind": "project",
                 "exprs": [_bin("/", _col(0), _col(1))],
                 "names": ["q"],
                 "input": {"kind": "filter",
                           "predicates": [_bin("!=", _col(1), _lit(0))],
                           "input": scan}}),
    ]


@_suite("AnsiArithmeticEdgeSuite")
def _ansi_arith_edge():
    from decimal import Decimal as D
    return [
        Case("ANSI: INT64_MIN * -1 raises (verify-division wraps)",
             pa.table({"a": pa.array([I64MIN])}),
             [_bin("*", _col(0), _lit(-1))],
             [], confs=_ANSI_ON, raises="ARITHMETIC_OVERFLOW"),
        Case("ANSI: INT64_MIN / -1 raises, not wraps",
             pa.table({"a": pa.array([I64MIN])}),
             [_bin("/", _col(0), _lit(-1))],
             [], confs=_ANSI_ON, raises="ARITHMETIC_OVERFLOW"),
        Case("ANSI: decimal division by zero raises",
             pa.table({"a": pa.array([D("1.00")], pa.decimal128(10, 2)),
                       "b": pa.array([D("0.00")],
                                     pa.decimal128(10, 2))}),
             [_bin("/", _col(0), _col(1))],
             [], confs=_ANSI_ON, raises="DIVIDE_BY_ZERO"),
        Case("ANSI: decimal overflow raises",
             pa.table({"a": pa.array([D("9" * 38)],
                                     pa.decimal128(38, 0)),
                       "b": pa.array([D("9" * 38)],
                                     pa.decimal128(38, 0))}),
             [_bin("+", _col(0), _col(1))],
             [], confs=_ANSI_ON, raises="NUMERIC_VALUE_OUT_OF_RANGE"),
        Case("non-ANSI: the same edges stay null/wrap",
             pa.table({"a": pa.array([I64MIN])}),
             [_bin("*", _col(0), _lit(-1))],
             [(I64MIN,)]),
    ]


@_suite("TryArithmeticSuite")
def _try_arithmetic():
    from decimal import Decimal as D
    return [
        Case("try_add nulls int64 overflow in every mode",
             pa.table({"a": pa.array([I64MAX, 5])}),
             [_fn("try_add", _col(0), _lit(1), rt="int64")],
             [(None,), (6,)], confs=_ANSI_ON),
        Case("try_subtract nulls underflow",
             pa.table({"a": pa.array([I64MIN])}),
             [_fn("try_subtract", _col(0), _lit(1), rt="int64")],
             [(None,)]),
        Case("try_multiply nulls overflow incl INT64_MIN * -1",
             pa.table({"a": pa.array([I64MIN, 3])}),
             [_fn("try_multiply", _col(0), _lit(-1), rt="int64")],
             [(None,), (-3,)]),
        Case("try_divide is double division, /0 null even for floats",
             pa.table({"a": pa.array([7, 1])}),
             [_fn("try_divide", _col(0), _lit(2), rt="float64"),
              _fn("try_divide", _col(0), _lit(0), rt="float64")],
             [(3.5, None), (0.5, None)]),
        Case("try_divide decimal keeps decimal, /0 null under ANSI",
             pa.table({"a": pa.array([D("1.00")], pa.decimal128(10, 2)),
                       "b": pa.array([D("0.00")],
                                     pa.decimal128(10, 2))}),
             [_fn("try_divide", _col(0), _col(1))],
             [(None,)], confs=_ANSI_ON),
        Case("try_element_at out-of-bounds is null under ANSI too",
             pa.table({"a": pa.array([[1, 2]])}),
             [_fn("try_element_at", _col(0), _lit(5), rt="int64")],
             [(None,)], confs=_ANSI_ON),
        Case("try_element_at index 0 still raises",
             pa.table({"a": pa.array([[1, 2]])}),
             [_fn("try_element_at", _col(0), _lit(0), rt="int64")],
             [], raises="INVALID_INDEX_OF_ZERO"),
    ]


@_suite("TryArithmeticWidthSuite")
def _try_arith_width():
    from decimal import Decimal as D
    return [
        Case("try_add nulls at INT32 bounds for int32 operands",
             pa.table({"a": pa.array([I32MAX, 5], pa.int32()),
                       "b": pa.array([1, 1], pa.int32())}),
             [_fn("try_add", _col(0), _col(1))],
             [(None,), (6,)]),
        Case("try_multiply on decimals reports the widened type",
             pa.table({"a": pa.array([D("2.50")], pa.decimal128(10, 2)),
                       "b": pa.array([D("4.00")],
                                     pa.decimal128(10, 2))}),
             [_fn("try_multiply", _col(0), _col(1))],
             [(D("10.0000"),)]),
        Case("array() is an alias of make_array",
             pa.table({"x": pa.array([1]), "y": pa.array([2])}),
             [_fn("array", _col(0), _col(1))],
             [([1, 2],)]),
        Case("try_add float operands widen to double",
             pa.table({"a": pa.array([1.5], pa.float64()),
                       "b": pa.array([2], pa.int64())}),
             [_fn("try_add", _col(0), _col(1))],
             [(3.5,)]),
    ]
