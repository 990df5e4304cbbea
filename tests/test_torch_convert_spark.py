"""The port's Spark converter (blaze_tpu_torch/convert/) against the JAX
package's (blaze_tpu/convert/): the same function of the same JSON.

  * each of the seven checked-in plans (tests/fixtures/: six TPC-DS
    queries and the hand-captured Spark 3.5 plan) converts to the same
    plan-IR dict, output ids and names, converted-class log and wrapped
    UDFs;
  * the unit plans of tests/test_convert_spark.py and
    tests/test_convert_extended.py (binding by exprId, the two-stage
    aggregate, joins, take-ordered, wrappers, result reordering, pmod,
    aggregate modes, the scalar-function map, windows, the group limit,
    generate, the UDF wrap with and without `auron.udf.fallback.enable`)
    and one gated plan per `auron.enable.<op>` switch each give equal
    dicts or equal `ConversionError`s (node class and reason);
  * `tag_plan`, `remove_inefficient_converts` and `explain` give the same
    tags and reasons;
  * a Hive scan with a partition column and a round-robin exchange,
    which waited for the plan-kinds slice, run through both packages'
    `execute_spark_plan_json` over written files with equal rows in
    order; a wrapped UDF still raises NotImplementedError naming item 16.

The one field compared after normalising is `broadcast_id`: both
converters draw it from uuid4, so it is replaced by its order of
appearance.  No data is read: conversion only copies file names.
"""

import json
import re

import pytest

from blaze_tpu import config as jconf
from blaze_tpu.convert import ConversionError as JError
from blaze_tpu.convert import convert_spark_plan as j_convert
from blaze_tpu.convert import strategy as JS
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.convert import ConversionError as TError
from blaze_tpu_torch.convert import convert_spark_plan as t_convert
from blaze_tpu_torch.convert import strategy as TS
from blaze_tpu_torch.itest import spark_fixtures as SF

CAT = "org.apache.spark.sql.catalyst.expressions."
EXEC = "org.apache.spark.sql.execution."
FILES = [["/data/t/part-00000.parquet"], ["/data/t/part-00001.parquet"]]


def _normal(plan) -> str:
    """The plan as sorted JSON, each broadcast id by its order of
    appearance."""
    text = json.dumps(plan, sort_keys=True, default=str)
    ids = {}
    return re.sub(r'"conv-[0-9a-f]{10}"',
                  lambda m: '"bcast-%d"' % ids.setdefault(m.group(0),
                                                          len(ids)), text)


def _outcome(convert, error, plan_json, parts):
    """What a converter makes of a plan: its result's fields, or the
    error's node class and reason."""
    try:
        r = convert(plan_json, num_partitions=parts)
    except error as e:
        return ("error", e.node_class, e.reason)
    return ("plan", _normal(r.plan), r.output_ids, r.output_names,
            r.converted_nodes, r.wrapped_udfs)


def _both(plan_json, parts=1, conf=None):
    conf = conf or {}
    for c in (jconf, tconf):
        for k, v in conf.items():
            c.conf.set(k, v)
    try:
        return (_outcome(j_convert, JError, plan_json, parts),
                _outcome(t_convert, TError, plan_json, parts))
    finally:
        for c in (jconf, tconf):
            for k in conf:
                c.conf.unset(k)


# -- the checked-in plans ---------------------------------------------------

@pytest.mark.parametrize("name", SF.FIXTURES)
def test_fixture_converts_as_the_jax_package(name):
    paths = {"store_returns": FILES}
    plan_json = SF.instantiate(name, "/data", paths)
    jax_out, port_out = _both(plan_json, SF.NUM_PARTITIONS)
    assert jax_out[0] == "plan"
    assert port_out == jax_out


# -- the unit plans of the JAX package's converter tests --------------------

def attr(name, dt, eid):
    return [{"class": CAT + "AttributeReference", "num-children": 0,
             "name": name, "dataType": dt, "nullable": True,
             "exprId": {"id": eid, "jvmId": "u"}}]


def lit(value, dt):
    return [{"class": CAT + "Literal", "num-children": 0,
             "value": value, "dataType": dt}]


def binexpr(cls, left, right):
    return [{"class": CAT + cls, "num-children": 2}] + left + right


def alias(child, name, eid):
    return [{"class": CAT + "Alias", "num-children": 1, "name": name,
             "exprId": {"id": eid, "jvmId": "u"}}] + child


def sort_order(child, desc=False):
    return [{"class": CAT + "SortOrder", "num-children": 1,
             "direction": ("Descending" if desc else "Ascending"),
             "nullOrdering": ("NullsLast" if desc else "NullsFirst")}] + \
        child


def agg_expr(fn_cls, arg, mode, result_id):
    return [{"class": CAT + "aggregate.AggregateExpression",
             "num-children": 1, "mode": mode, "isDistinct": False,
             "resultId": {"id": result_id, "jvmId": "u"}},
            {"class": CAT + f"aggregate.{fn_cls}",
             "num-children": 1 if arg else 0}] + (arg or [])


def scan_node(attrs, files=FILES):
    return [{"class": EXEC + "FileSourceScanExec", "num-children": 0,
             "output": list(attrs), "files": files}]


def plan_node(cls, fields, children):
    out = [{"class": EXEC + cls, "num-children": len(children), **fields}]
    for c in children:
        out += c
    return out


def window_expr(fn_nodes, name, eid):
    spec = [{"class": CAT + "WindowSpecDefinition", "num-children": 0}]
    wex = [{"class": CAT + "WindowExpression", "num-children": 2}] + \
        fn_nodes + spec
    return alias(wex, name, eid)


K, V = attr("k", "long", 1), attr("v", "double", 2)


def _kv_scan():
    return scan_node([K[0], V[0]])


def _filter_scan():
    cond = binexpr("GreaterThan", K, lit("0", "long"))
    return plan_node("FilterExec", {"condition": cond}, [_kv_scan()])


def _partial_final():
    partial = plan_node(
        "aggregate.HashAggregateExec",
        {"groupingExpressions": [K],
         "aggregateExpressions": [agg_expr("Sum", V, "Partial", 10)]},
        [_kv_scan()])
    exchange = plan_node(
        "exchange.ShuffleExchangeExec",
        {"outputPartitioning": [
            {"class": CAT + "HashPartitioning", "num-children": 1,
             "numPartitions": 2}, K[0]]},
        [partial])
    return plan_node(
        "aggregate.HashAggregateExec",
        {"groupingExpressions": [K],
         "aggregateExpressions": [agg_expr("Sum", None, "Final", 10)]},
        [exchange])


def _bhj():
    dk, nm = attr("dk", "long", 3), attr("name", "string", 4)
    return plan_node(
        "joins.BroadcastHashJoinExec",
        {"leftKeys": [K], "rightKeys": [dk], "joinType": "Inner",
         "buildSide": "BuildRight"},
        [_kv_scan(), plan_node("exchange.BroadcastExchangeExec", {},
                               [scan_node([dk[0], nm[0]])])])


def _agg(mode, result_exprs=None, second=None):
    aggs = [agg_expr("Sum", V, mode, 10)] + ([second] if second else [])
    fields = {"groupingExpressions": [K], "aggregateExpressions": aggs}
    if result_exprs:
        fields["resultExpressions"] = result_exprs
    return plan_node("aggregate.HashAggregateExec", fields, [_kv_scan()])


def _scala_udf(typed):
    node = {"class": CAT + "ScalaUDF", "num-children": 1}
    if typed:
        node["dataType"] = "long"
    return [node] + K


def _generate():
    xs = [{"class": CAT + "AttributeReference", "num-children": 0,
           "name": "xs", "dataType": {"type": "array", "elementType": "long",
                                      "containsNull": True},
           "nullable": True, "exprId": {"id": 2, "jvmId": "u"}}]
    gen = [{"class": CAT + "Explode", "num-children": 1}] + xs
    return plan_node(
        "GenerateExec",
        {"generator": [gen], "outer": False, "requiredChildOutput": [K],
         "generatorOutput": [attr("x", "long", 3)]},
        [scan_node([K[0], xs[0]])])


def _window():
    rn = window_expr([{"class": CAT + "RowNumber", "num-children": 0}],
                     "rn", 10)
    sm = window_expr(
        [{"class": CAT + "aggregate.AggregateExpression",
          "num-children": 1, "mode": "Complete",
          "resultId": {"id": 99, "jvmId": "u"}},
         {"class": CAT + "aggregate.Sum", "num-children": 1}] + V,
        "running_sum", 11)
    ld = window_expr([{"class": CAT + "Lead", "num-children": 3}] + V
                     + lit("1", "integer") + lit(None, "double"), "nxt", 12)
    return plan_node(
        "window.WindowExec",
        {"windowExpression": [rn, sm, ld], "partitionSpec": [K],
         "orderSpec": [sort_order(V)]},
        [_kv_scan()])


def _island(with_output):
    mystery = {"class": EXEC + "MysteryExec", "num-children": 1}
    if with_output:
        mystery["output"] = [K]
    return plan_node("CollectLimitExec", {"limit": 1},
                     [plan_node("ProjectExec", {"projectList": [K]},
                                [[mystery] + _kv_scan()])])


UNIT_PLANS = {
    "binds by exprId": lambda: plan_node(
        "ProjectExec",
        {"projectList": [alias(binexpr("Add", attr("x", "long", 2),
                                       lit("5", "long")), "y", 3)]},
        [plan_node("FilterExec",
                   {"condition": binexpr("GreaterThan", attr("x", "long", 1),
                                         lit("1", "long"))},
                   [scan_node([attr("x", "long", 1)[0],
                               attr("x", "long", 2)[0]])])]),
    "two-stage aggregate": _partial_final,
    "broadcast hash join": _bhj,
    "take ordered and project": lambda: plan_node(
        "TakeOrderedAndProjectExec",
        {"limit": 3, "sortOrder": [sort_order(K)], "projectList": [V]},
        [_kv_scan()]),
    "unwrappable expression": lambda: plan_node(
        "ProjectExec", {"projectList": [_scala_udf(False)]}, [_kv_scan()]),
    "transparent wrappers": lambda: plan_node(
        "WholeStageCodegenExec", {},
        [plan_node("InputAdapter", {}, [_kv_scan()])]),
    "reordered result expressions": lambda: plan_node(
        "ProjectExec", {"projectList": [attr("s", "double", 10)]},
        [_agg("Complete", [attr("s", "double", 10), K])]),
    "pmod": lambda: plan_node(
        "ProjectExec",
        {"projectList": [alias(binexpr("Pmod", K, lit("3", "long")), "m",
                               5)]},
        [_kv_scan()]),
    "complete mode": lambda: _agg("Complete"),
    "mixed aggregate modes": lambda: _agg(
        "Partial", second=agg_expr("Sum", None, "PartialMerge", 11)),
    "scalar-function map": lambda: plan_node(
        "ProjectExec",
        {"projectList": [
            alias([{"class": CAT + "StringLocate", "num-children": 2}]
                  + lit("b", "string") + attr("s", "string", 7), "pos", 8),
            alias([{"class": CAT + "InitCap", "num-children": 1}]
                  + attr("s", "string", 7), "cap", 9)]},
        [scan_node(attr("s", "string", 7))]),
    "window rank, aggregate and lead": _window,
    "window group limit": lambda: plan_node(
        "window.WindowGroupLimitExec",
        {"partitionSpec": [K], "orderSpec": [sort_order(V)], "limit": 1,
         "rankLikeFunction": [{"class": CAT + "RowNumber",
                               "num-children": 0}]},
        [_kv_scan()]),
    "dense-rank group limit": lambda: plan_node(
        "window.WindowGroupLimitExec",
        {"partitionSpec": [K], "orderSpec": [sort_order(V)], "limit": 1,
         "rankLikeFunction": [{"class": CAT + "DenseRank",
                               "num-children": 0}]},
        [_kv_scan()]),
    "generate explode": _generate,
    "udf wrap": lambda: plan_node(
        "ProjectExec", {"projectList": [alias(_scala_udf(True), "y", 5)]},
        [_kv_scan()]),
    "unsupported node": lambda: plan_node(
        "CollectLimitExec", {"limit": 5}, [_filter_scan()]),
    "round-robin exchange": lambda: plan_node(
        "exchange.ShuffleExchangeExec",
        {"outputPartitioning": [{"class": CAT + "RoundRobinPartitioning",
                                 "num-children": 0, "numPartitions": 3}]},
        [_kv_scan()]),
}

#: name -> (plan, conf): the same plans under other keys
UNIT_CONFS = {
    "udf wrap, fallback off": ("udf wrap",
                               {"auron.udf.fallback.enable": "false"}),
    "conversion off": ("two-stage aggregate", {"auron.enabled": "false"}),
}

#: one plan per gate: `auron.enable.<op>` off must name the op
GATES = {
    "scan": "binds by exprId", "scan.parquet": "binds by exprId",
    "project": "binds by exprId", "filter": "binds by exprId",
    "aggr": "two-stage aggregate", "shuffleExchange": "two-stage aggregate",
    "bhj": "broadcast hash join", "broadcastExchange": "broadcast hash join",
    "take.ordered.and.project": "take ordered and project",
    "window": "window rank, aggregate and lead",
    "window.group.limit": "window group limit",
    "generate": "generate explode",
}


@pytest.mark.parametrize("case", sorted(UNIT_PLANS) + sorted(UNIT_CONFS)
                         + [f"gate {op}" for op in sorted(GATES)])
def test_unit_plan_converts_as_the_jax_package(case):
    if case.startswith("gate "):
        op = case[5:]
        plan, conf = UNIT_PLANS[GATES[op]](), {f"auron.enable.{op}": "false"}
    elif case in UNIT_CONFS:
        name, conf = UNIT_CONFS[case]
        plan = UNIT_PLANS[name]()
    else:
        plan, conf = UNIT_PLANS[case](), {}
    jax_out, port_out = _both(plan, conf=conf)
    assert port_out == jax_out
    if case.startswith("gate "):
        assert jax_out[0] == "error"
        assert jax_out[2] == f"disabled by auron.enable.{op}"


def test_operator_enabled_reads_the_switches():
    assert tconf.operator_enabled("filter") and tconf.operator_enabled("?")
    tconf.conf.set("auron.enable.filter", "false")
    try:
        assert not tconf.operator_enabled("filter")
    finally:
        tconf.conf.unset("auron.enable.filter")
    assert set(tconf.OPERATOR_SWITCHES) == set(jconf._OPERATOR_SWITCHES)


# -- the strategy -----------------------------------------------------------

def _tags(tag):
    return [(t.node_class, t.convertible, t.reason) for t in tag.walk()]


STRATEGY_PLANS = {
    "unsupported top node": UNIT_PLANS["unsupported node"],
    "island": lambda: _island(True),
    "blind child": lambda: plan_node(
        "SortExec", {"sortOrder": [sort_order(K)]},
        [plan_node("MysteryExec", {}, [_kv_scan()])]),
    "island without output": lambda: _island(False),
    **{f"fixture {n}": (lambda n=n: SF.instantiate(
        n, "/data", {"store_returns": FILES})) for n in SF.FIXTURES},
}


@pytest.mark.parametrize("case", sorted(STRATEGY_PLANS))
def test_strategy_tags_as_the_jax_package(case):
    plan = STRATEGY_PLANS[case]()
    jt, tt = JS.tag_plan(plan), TS.tag_plan(plan)
    assert _tags(tt) == _tags(jt)
    jr, tr = (JS.remove_inefficient_converts(jt),
              TS.remove_inefficient_converts(tt))
    assert _tags(tr) == _tags(jr)
    assert TS.explain(tr) == JS.explain(jr)
    if case == "island":
        assert "removeInefficientConverts" in tr.children[0].reason
    if case.startswith("fixture"):
        assert all(t.convertible for t in tt.walk())


# -- converted, and run as the JAX package runs them, or in a later slice --

@pytest.fixture
def cpu():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _hive_scan(files=None):
    return [{"class": "org.apache.spark.sql.hive.execution.HiveTableScanExec",
             "num-children": 0, "format": "parquet",
             "requestedAttributes": [K, attr("dt", "date", 9)],
             "files": files or [["/data/t/dt=2024-01-02/part-00000.parquet"]],
             "partition_schema": [{"name": "dt", "type": {"id": "date32"}}],
             "partition_values": [[["2024-01-02"]]]}]


def _run_both(plan_json, parts=1):
    """The plan through both front doors (`execute_spark_plan_json`), the
    JAX package on its device route."""
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import execute_spark_plan_json as j_run
    from blaze_tpu_torch.plan.stages import execute_spark_plan_json as t_run
    MemManager.init(4 << 30)
    saved = P.host_resident
    P.host_resident = lambda: False
    try:
        want = j_run(plan_json, parts)
    finally:
        P.host_resident = saved
    return t_run(plan_json, parts), want


def _kv_files(tmp_path, n_files):
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    rng = np.random.default_rng(17)
    out = []
    for i in range(n_files):
        p = str(tmp_path / f"part-{i:05d}.parquet")
        n = 37 + 11 * i
        pq.write_table(pa.table({"k": rng.integers(0, 9, n),
                                 "v": rng.random(n)}), p)
        out.append([p])
    return out


def test_hive_partition_columns_convert_and_run_as_the_jax_package(
        cpu, tmp_path):
    import datetime
    from blaze_tpu_torch.plan import create_plan
    jax_out, port_out = _both(_hive_scan())
    assert port_out == jax_out and jax_out[0] == "plan"
    plan = t_convert(_hive_scan()).plan
    day = datetime.date(2024, 1, 2)
    assert plan["partition_values"] == [[[day]]]
    assert [f.name for f in create_plan(plan).schema] == ["k", "dt"]
    files = _kv_files(tmp_path, 1)
    got, want = _run_both(_hive_scan(files))
    assert got.num_rows == 37 and got.equals(want)
    assert set(got["dt"].to_pylist()) == {day}


def test_round_robin_converts_and_runs_as_the_jax_package(cpu, tmp_path):
    from blaze_tpu_torch.plan import create_plan
    plan = t_convert(UNIT_PLANS["round-robin exchange"]()).plan
    assert plan["partitioning"] == {"kind": "round_robin",
                                    "num_partitions": 3}
    assert create_plan(plan).num_partitions == 3
    files = _kv_files(tmp_path, 2)
    plan_json = plan_node(
        "exchange.ShuffleExchangeExec",
        {"outputPartitioning": [{"class": CAT + "RoundRobinPartitioning",
                                 "num-children": 0, "numPartitions": 3}]},
        [scan_node([K[0], V[0]], files)])
    got, want = _run_both(plan_json)
    # two map tasks of 37 and 48 rows, one cursor run on in the local
    # mode's exchange: rows in the JAX package's order
    assert got.num_rows == 85 and got.equals(want)


def test_a_wrapped_udf_converts_and_waits_for_item_16(cpu):
    from blaze_tpu_torch.plan import create_plan
    plan = t_convert(UNIT_PLANS["udf wrap"]()).plan
    assert plan["exprs"][0]["kind"] == "udf"
    with pytest.raises(NotImplementedError, match="item 16"):
        create_plan(plan)


def test_the_shim_imports_and_needs_pyspark():
    """The PySpark hand-off runs only where pyspark is importable, as the
    JAX package's does (tests/test_convert_extended.py)."""
    from blaze_tpu_torch.convert import shim
    assert callable(shim.execute_dataframe)
    assert callable(shim.extract_plan_json)
    pytest.importorskip("pyspark")
