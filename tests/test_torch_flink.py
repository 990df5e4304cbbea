"""The port's Flink front door (blaze_tpu_torch/convert/flink.py and
convert/flink_runtime.py) against the JAX package's on the CPU: the same
Flink types, RexNodes, aggregate calls and COMPILE PLANs give the JAX
package's engine IR or the same ConversionError, for the vocabulary of
tests/test_convert_flink.py and for the two Nexmark plans of
itest/nexmark.py; the micro-batch operator gives the JAX operator's
batches, offsets and idempotent replay over the same Kafka records."""

import json

import pyarrow as pa
import pytest

from blaze_tpu.bridge.resource import put_resource as j_put
from blaze_tpu.convert import flink as JF
from blaze_tpu.convert.flink_runtime import \
    FlinkMicroBatchOperator as JOperator
from blaze_tpu.convert.spark import ConversionError as JConversionError
from blaze_tpu.memory import MemManager as JMemManager
from blaze_tpu.ops.kafka import KafkaRecord as JRecord
from blaze_tpu.plan.planner import create_plan as j_create
from blaze_tpu.streaming import CheckpointManager as JCheckpoint
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.bridge.resource import put_resource as t_put
from blaze_tpu_torch.convert import ConversionError
from blaze_tpu_torch.convert import flink as TF
from blaze_tpu_torch.convert.flink_runtime import \
    FlinkMicroBatchOperator as TOperator
from blaze_tpu_torch.itest import nexmark
from blaze_tpu_torch.memory import MemManager
from blaze_tpu_torch.ops.kafka import KafkaRecord as TRecord
from blaze_tpu_torch.plan.planner import create_plan as t_create
from blaze_tpu_torch.streaming import CheckpointManager as TCheckpoint


@pytest.fixture(autouse=True)
def confs():
    MemManager.init(4 << 30)
    JMemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _ref(i, t):
    return {"kind": "INPUT_REF", "inputIndex": i, "type": t}


def _lit(v, t):
    return {"kind": "LITERAL", "value": v, "type": t}


def _call(op, operands, t="BOOLEAN", name=None):
    return {"kind": "CALL", "internalName": name or f"${op}$1",
            "operands": operands, "type": t}


def _same_outcome(t_fn, j_fn, arg):
    """Both give equal values, or both raise ConversionError with the
    same message."""
    try:
        want = j_fn(arg)
    except JConversionError as e:
        with pytest.raises(ConversionError) as got:
            t_fn(arg)
        assert str(got.value) == str(e)
        return None
    got = t_fn(arg)
    assert got == want
    return got


TYPES = ["BOOLEAN", "TINYINT", "SMALLINT", "INT", "INTEGER", "BIGINT",
         "FLOAT", "REAL", "DOUBLE", "DATE", "STRING", "BYTES",
         "VARCHAR(2147483647)", "CHAR(3)", "DECIMAL(10, 2)",
         "DECIMAL(38,18)", "TIMESTAMP(3)", "TIMESTAMP_LTZ(6)",
         "INT NOT NULL", "BIGINT NOT NULL", "INTERVAL DAY", "MAP<INT, INT>",
         "TIMESTAMP", ""]


@pytest.mark.parametrize("t", TYPES)
def test_types_equal_the_jax_ones(t):
    _same_outcome(TF.type_from_flink, JF.type_from_flink, t)


REX = {
    "ref": _ref(2, "BIGINT"),
    "int literal": _lit("7", "INT"),
    "double literal": _lit("2.5", "DOUBLE"),
    "bool literal": _lit("TRUE", "BOOLEAN"),
    "null literal": _lit(None, "VARCHAR(10)"),
    "decimal literal": _lit("1.25", "DECIMAL(5, 2)"),
    "date literal": _lit("19000", "DATE"),
    "not equal": _call("<>", [_ref(0, "INT"), _lit(1, "INT")]),
    "mod": _call("MOD", [_ref(0, "BIGINT"), _lit(123, "INT")], "BIGINT"),
    "arith": _call("+", [_call("*", [_ref(1, "DOUBLE"),
                                     _lit(2.0, "DOUBLE")], "DOUBLE"),
                         _call("/", [_ref(1, "DOUBLE"), _lit(3, "INT")],
                               "DOUBLE")], "DOUBLE"),
    "comparisons": _call("AND", [
        _call(">", [_ref(0, "INT"), _lit(1, "INT")]),
        _call("<=", [_ref(0, "INT"), _lit(9, "INT")]),
        _call(">=", [_ref(1, "DOUBLE"), _lit(0, "INT")])]),
    "or not null": _call("OR", [
        _call("IS NULL", [_ref(0, "INT")]),
        _call("NOT", [_call("IS NOT NULL", [_ref(1, "INT")])])]),
    "cast": _call("CAST", [_ref(0, "INT")], "BIGINT"),
    "try_cast": _call("TRY_CAST", [_ref(2, "STRING")], "INT"),
    "like": _call("LIKE", [_ref(2, "STRING"), _lit("a%", "STRING")]),
    "like non-literal": _call("LIKE", [_ref(2, "STRING"),
                                       _ref(3, "STRING")]),
    "case": _call("CASE", [_call(">", [_ref(0, "INT"), _lit(0, "INT")]),
                           _lit(1, "INT"), _lit(2, "INT")], "INT"),
    "case no else": _call("CASE", [
        _call(">", [_ref(0, "INT"), _lit(0, "INT")]), _lit(1, "INT"),
        _call("<", [_ref(0, "INT"), _lit(-5, "INT")]), _lit(3, "INT")],
        "INT"),
    "functions": _call("CONCAT", [
        _call("UPPER", [_ref(2, "STRING")], "STRING"),
        _call("TRIM", [_ref(3, "STRING")], "STRING")], "STRING"),
    "char length": _call("CHAR_LENGTH", [_ref(2, "STRING")], "INT"),
    "bare operator": {"kind": "CALL", "operator": "abs",
                      "operands": [_ref(0, "INT")], "type": "INT"},
    "unsupported operator": _call("TUMBLE", [_ref(0, "INT")]),
    "unsupported kind": {"kind": "FIELD_ACCESS", "name": "x"},
    "unsupported type": _lit(1, "INTERVAL SECOND"),
}


@pytest.mark.parametrize("name", list(REX))
def test_rex_equals_the_jax_ir(name):
    _same_outcome(TF.convert_rex, JF.convert_rex, REX[name])


AGG_CALLS = {
    "sum": {"internalName": "$SUM$1", "argList": [1]},
    "sum0": {"internalName": "$SUM0", "argList": [1]},
    "count star": {"internalName": "$COUNT$1", "argList": []},
    "count": {"internalName": "$COUNT$1", "argList": [0]},
    "min max avg": {"name": "MIN(x)", "argList": [2]},
    "avg": {"internalName": "$AVG$1", "argList": [3]},
    "distinct": {"internalName": "$SUM$1", "argList": [0],
                 "distinct": True},
    "unsupported": {"internalName": "$LISTAGG$1", "argList": [0]},
}


@pytest.mark.parametrize("name", list(AGG_CALLS))
def test_agg_calls_equal_the_jax_specs(name):
    _same_outcome(TF.convert_agg_call, JF.convert_agg_call, AGG_CALLS[name])


def test_converter_registries_reject_duplicates_and_win():
    TF.register_agg_converter("MYAGG", lambda c: {"fn": "sum", "args": []})
    TF.register_rex_converter("MY_REX", lambda n: {"kind": "literal",
                                                  "value": 1})
    try:
        with pytest.raises(ValueError, match="already registered"):
            TF.register_agg_converter("MYAGG", lambda c: None)
        with pytest.raises(ValueError, match="already registered"):
            TF.register_rex_converter("MY_REX", lambda c: None)
        assert TF.convert_agg_call({"internalName": "$MYAGG$1"}) == \
            {"fn": "sum", "args": []}
        assert TF.convert_rex({"kind": "MY_REX"}) == {"kind": "literal",
                                                     "value": 1}
    finally:
        TF._AGG_CONVERTERS.pop("MYAGG", None)
        TF._REX_CONVERTERS.pop("MY_REX", None)


ROWS = [{"user_id": 1, "amount": 10.0, "category": "a"},
        {"user_id": 2, "amount": 55.5, "category": "b"},
        {"user_id": 3, "amount": 7.25, "category": "a"},
        {"user_id": 4, "amount": 99.0, "category": "c"}]


def _compiled_plan(projection, condition=None, connector="kafka",
                   mock=True):
    opts = {"connector": connector, "topic": "orders", "format": "json"}
    if mock:
        opts["__mock_data__"] = json.dumps(ROWS)
    return {"flinkVersion": "1.18", "nodes": [
        {"id": 1, "type": "stream-exec-table-source-scan_1",
         "scanTableSource": {"table": {"resolvedTable": {
             "schema": {"columns": [
                 {"name": "user_id", "dataType": "BIGINT"},
                 {"name": "amount", "dataType": "DOUBLE"},
                 {"name": "category", "dataType": "VARCHAR(2147483647)"}]},
             "options": opts}}}},
        {"id": 2, "type": "stream-exec-calc_2", "projection": projection,
         "condition": condition},
        {"id": 3, "type": "stream-exec-sink_3"}],
        "edges": [{"source": 1, "target": 2}, {"source": 2, "target": 3}]}


def _values_agg(kinds, calls, grouping=(0,)):
    src = {"id": 1, "type": "stream-exec-table-source-scan_1",
           "scanTableSource": {"table": {"resolvedTable": {
               "schema": {"columns": [
                   {"name": "k", "dataType": "BIGINT"},
                   {"name": "v", "dataType": "DOUBLE NOT NULL"}]},
               "options": {"connector": "values",
                           "resource-id": "flink://parity-src"}}}}}
    nodes = [src] + [{"id": i + 2, "type": f"{k}_1",
                      "grouping": list(grouping), "aggCalls": calls}
                     for i, k in enumerate(kinds)]
    nodes.append({"id": len(nodes) + 1, "type": "stream-exec-sink_1"})
    return {"nodes": nodes,
            "edges": [{"source": a["id"], "target": b["id"]}
                      for a, b in zip(nodes, nodes[1:])]}


def _fanout():
    p = _compiled_plan([_ref(0, "BIGINT")])
    p["edges"].append({"source": 1, "target": 3})
    return p


def _two_sources():
    p = _compiled_plan([_ref(0, "BIGINT")])
    p["nodes"].append(dict(p["nodes"][0], id=9))
    return p


def _unknown_node():
    p = _compiled_plan([_ref(0, "BIGINT")])
    p["nodes"][1]["type"] = "stream-exec-over-aggregate_1"
    return p


CALLS = [{"name": "s", "internalName": "$SUM$1", "argList": [1]},
         {"name": "a", "internalName": "$AVG$1", "argList": [1]},
         {"name": "z", "internalName": "$SUM0", "argList": [1]},
         {"name": "c", "internalName": "$COUNT$1", "argList": []}]

PLANS = {
    "kafka calc": _compiled_plan(
        [_ref(0, "BIGINT"),
         _call("*", [_ref(1, "DOUBLE"), _lit(2.0, "DOUBLE")], "DOUBLE"),
         _call("UPPER", [_ref(2, "VARCHAR(2147483647)")],
               "VARCHAR(2147483647)")],
        _call("AND", [_call(">", [_ref(1, "DOUBLE"), _lit(8.0, "DOUBLE")]),
                      _call("IS NOT NULL", [_ref(0, "BIGINT")])])),
    "condition only": _compiled_plan([], _call(">", [_ref(1, "DOUBLE"),
                                                     _lit(8.0, "DOUBLE")])),
    "filesystem": _compiled_plan([_ref(0, "BIGINT")],
                                 connector="filesystem"),
    "values without id": {"nodes": [dict(
        _values_agg([], [])["nodes"][0],
        scanTableSource={"table": {"resolvedTable": {
            "schema": {"columns": []},
            "options": {"connector": "values"}}}})], "edges": []},
    "one phase": _values_agg(["stream-exec-group-aggregate"], CALLS),
    "two phase": _values_agg(["stream-exec-local-group-aggregate",
                              "stream-exec-exchange",
                              "stream-exec-global-group-aggregate"], CALLS),
    "global no keys": _values_agg(["stream-exec-local-group-aggregate",
                                   "stream-exec-global-group-aggregate"],
                                  CALLS[:2], grouping=()),
    "fan-out": _fanout(),
    "two sources": _two_sources(),
    "unknown node": _unknown_node(),
    "nexmark q2": nexmark.q2_plan(),
    "nexmark q17": nexmark.q17_plan(),
    "nexmark calc": nexmark.calc_plan(),
}


@pytest.mark.parametrize("name", list(PLANS))
@pytest.mark.parametrize("partitions", [1, 4])
def test_compile_plans_equal_the_jax_ir(name, partitions):
    for arg in (PLANS[name], json.dumps(PLANS[name])):
        _same_outcome(lambda p: TF.convert_flink_plan(p, partitions),
                      lambda p: JF.convert_flink_plan(p, partitions), arg)


def _rows_of(batches):
    t = pa.Table.from_batches(batches)
    return t.sort_by([(c, "ascending") for c in t.column_names])


@pytest.mark.parametrize("name", ["kafka calc", "one phase", "two phase",
                                  "global no keys"])
def test_converted_plans_run_as_the_jax_ones(name):
    t = pa.table({"k": pa.array([1, 1, 2, 2, 3, None]),
                  "v": pa.array([10.0, 5.0, 2.0, 1.0, None, 4.0])})
    t_put("flink://parity-src", t)
    j_put("flink://parity-src", t)
    ir = TF.convert_flink_plan(PLANS[name])
    got = [b.compact().to_arrow() for b in t_create(ir).execute(0)]
    want = [b.compact().to_arrow() for b in j_create(ir).execute(0)]
    assert _rows_of(got).equals(_rows_of(want))


def _stream_records(mod, stream, lo, hi):
    return [[mod(value=r.value, offset=r.offset, partition=r.partition,
                 timestamp_ms=r.timestamp_ms) for r in p[lo:hi]]
            for p in stream.partitions]


@pytest.mark.parametrize("plan", ["q2", "q17"])
def test_micro_batches_equal_the_jax_operator(plan, tmp_path):
    """Three micro-batches of a generated Nexmark stream (2,048 bids over
    4 partitions, 200 records a partition a batch, the last short),
    through both operators with a CheckpointManager each: the same batches
    in the same order and the same offsets and manifests; then epoch 1
    fed again to a fresh operator over each checkpoint directory runs
    nothing, restores the committed offsets and counts one dup skip."""
    stream = nexmark.generate_bids(2048, seed=5)
    make = nexmark.PLANS[plan]
    tck, jck = TCheckpoint(str(tmp_path / "t")), JCheckpoint(
        str(tmp_path / "j"))
    top = TOperator(make(), num_partitions=4, checkpoint=tck)
    jop = JOperator(make(), num_partitions=4, checkpoint=jck)
    for e, lo in enumerate((0, 200, 400)):
        got = top.run_micro_batch(_stream_records(TRecord, stream, lo,
                                                  lo + 200), epoch=e)
        want = jop.run_micro_batch(_stream_records(JRecord, stream, lo,
                                                   lo + 200), epoch=e)
        assert [b.num_rows for b in got] == [b.num_rows for b in want]
        for g, w in zip(got, want):
            assert g.equals(w)
        assert top.offsets == jop.offsets
    assert top.offsets == {p: 512 for p in range(4)}
    for e in range(3):
        assert open(tck._path(e), "rb").read() == \
            open(jck._path(e), "rb").read()
    before = device_stats.stream_stats()["stream_sink_dup_skips"]
    again = TOperator(make(), num_partitions=4, checkpoint=tck)
    assert again.run_micro_batch(
        _stream_records(TRecord, stream, 200, 400), epoch=1) == []
    assert again.batches_run == 0
    assert again.offsets == {p: 400 for p in range(4)}
    assert device_stats.stream_stats()["stream_sink_dup_skips"] == \
        before + 1
    assert list(again.iter_micro_batch([[]] * 4, epoch=2)) == []


def _flaky(monkeypatch, runtime_module):
    real = runtime_module.NativeExecutionRuntime
    calls = {"n": 0}

    class FlakySecondTask:
        def __init__(self, td):
            calls["n"] += 1
            self._boom = calls["n"] == 2
            self._inner = real(td)

        def start(self):
            self._inner.start()
            return self

        def batches(self):
            if self._boom:
                raise RuntimeError("injected: partition 1 task died")
            return self._inner.batches()

        def finalize(self):
            self._inner.finalize()

    monkeypatch.setattr(runtime_module, "NativeExecutionRuntime",
                        FlakySecondTask)


def _calc_recs(mod, partition, n):
    return [mod(value=json.dumps({"user_id": partition * 100 + i,
                                  "amount": float(i)}).encode(),
                offset=i, partition=partition) for i in range(n)]


@pytest.mark.parametrize("route", ["iter", "run"])
def test_midbatch_failure_offsets_equal_the_jax_operator(monkeypatch, route):
    """A task that dies on partition 1: `iter_micro_batch` keeps partition
    0's delivered offset, `run_micro_batch` rewinds the whole batch; the
    replay then delivers each row once; both as the JAX operator."""
    from blaze_tpu.bridge import runtime as jrt
    from blaze_tpu_torch.bridge import runtime as trt
    plan = _compiled_plan([_ref(0, "BIGINT"), _ref(1, "DOUBLE")],
                          mock=False)
    outcomes = []
    for mod, rt, op_cls in ((TRecord, trt, TOperator),
                            (JRecord, jrt, JOperator)):
        with monkeypatch.context() as m:
            _flaky(m, rt)
            op = op_cls(plan, num_partitions=2)
            p0, p1 = _calc_recs(mod, 0, 3), _calc_recs(mod, 1, 3)
            delivered = []
            with pytest.raises(RuntimeError, match="partition 1"):
                if route == "iter":
                    for _p, batches in op.iter_micro_batch([p0, p1]):
                        delivered.extend(batches)
                else:
                    op.run_micro_batch([p0, p1])
            after_fail = dict(op.offsets)
            replay = [[r for r in p0 if r.offset >= op.offsets[0]],
                      [r for r in p1 if r.offset >= op.offsets[1]]]
            out = op.run_micro_batch(replay)
            ids = sorted(i for rb in delivered + out
                         for i in rb.column(0).to_pylist())
            outcomes.append((after_fail, ids, dict(op.offsets)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == [0, 1, 2, 100, 101, 102]
    assert outcomes[0][2] == {0: 3, 1: 3}


def test_operator_needs_a_kafka_source():
    plan = _values_agg(["stream-exec-group-aggregate"], CALLS[:1])
    with pytest.raises(ValueError, match="no kafka_scan"):
        TOperator(plan)
    op = TOperator(_compiled_plan([_ref(0, "BIGINT")]))
    assert op.snapshot_state() == {0: 0}
    op.restore_state({0: 7})
    assert op.offsets == {0: 7}
