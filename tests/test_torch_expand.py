"""ExpandExec, the IN list and the conditional expressions of the port
(blaze_tpu_torch/ops/basic.py, blaze_tpu_torch/exprs/conditional.py)
against the JAX package's (blaze_tpu/ops/basic.py ExpandExec,
blaze_tpu/exprs/conditional.py) on the same numpy-seeded batches, with
`blaze_tpu.bridge.placement.host_resident` patched to False (the JAX
package's device route), and their wire nodes against the JAX
`proto_serde`.

  * ExpandExec over q18-shaped projections (utf8 keys with NULLs, null
    utf8 literals, an int64 grouping-id literal, a null int64 literal,
    int32 and float64 measures): the same output batches, rows in order,
    at batch sizes that make the coalescing stream pass batches through,
    stage them and concatenate them;
  * IN over int64 and utf8 probes with NULLs, with and without a null
    member, negated or not; IS NULL, IS NOT NULL, NOT, IF, CASE WHEN
    (fixed-width and utf8 results, with and without ELSE) and COALESCE;
  * the wire: expand, in_list and the conditional kinds encode to the
    JAX package's bytes and decode to its dicts.

Tolerance: exact (validity, and values where valid; Arrow equality for
host results; float64 bit for bit)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu import exprs as JE
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import conditional as JC
from blaze_tpu.ops.basic import ExpandExec as JExpand
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import decode_task_definition as j_decode
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import exprs as TE
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs.base import ColVal
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import ExpandExec as TExpand
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.exprs import expr_from_dict
from blaze_tpu_torch.plan.planner import create_plan
from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode
from blaze_tpu_torch.plan.types import schema_to_dict
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
SCHEMA = pa.schema([("id", pa.string()), ("st", pa.string()),
                    ("k", pa.int64()), ("q", pa.int32()),
                    ("x", pa.float64()), ("b", pa.bool_()),
                    ("t", pa.string())])
ID, ST, K, Q, X, B, T = range(7)


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.BATCH_SIZE.key)


def _batches(rng, n_batches, rows):
    states = np.array(["TX", "OH", "IL", "CA", "", "ß€"], dtype=object)
    out = []
    for b in range(n_batches):
        n = rows + b
        out.append(pa.record_batch({
            "id": pa.array([f"I{v:05d}" for v in rng.integers(0, 40, n)],
                           mask=rng.random(n) < 0.05),
            "st": pa.array(states[rng.integers(0, len(states), n)],
                           type=pa.string(), mask=rng.random(n) < 0.1),
            "k": pa.array(rng.integers(0, 6, n), mask=rng.random(n) < 0.1),
            "q": pa.array(rng.integers(1, 100, n).astype(np.int32),
                          mask=rng.random(n) < 0.05),
            "x": pa.array(np.round(rng.normal(size=n) * 100, 2),
                          mask=rng.random(n) < 0.05),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
            "t": pa.array(states[rng.integers(0, len(states), n)],
                          type=pa.string(), mask=rng.random(n) < 0.3)}))
    return out


class _Source(ExecutionPlan):
    """Fixed Arrow batches as port batches on the CPU (one partition)."""

    def __init__(self, batches):
        super().__init__()
        self._batches = list(batches)

    @property
    def schema(self):
        return TSchema.from_arrow(SCHEMA)

    def execute(self, partition):
        for rb in self._batches:
            yield TBatch.from_arrow(rb, device=CPU)


def _projections(E, S):
    """q18's ROLLUP over (id, st) as expressions of package E with schema
    module S: each set keeps a prefix of the keys and nulls the rest, then
    the grouping id, a null int64, and the measures."""
    null_utf8 = E.Literal(None, S.UTF8)
    keys = [E.BoundReference(ID), E.BoundReference(ST)]
    out = []
    for kept, gid in ((2, 0), (1, 1), (0, 3)):
        row = [keys[i] if i < kept else null_utf8 for i in range(2)]
        row += [E.Literal(gid, S.INT64), E.Literal(None, S.INT64),
                E.BoundReference(Q), E.BoundReference(X)]
        out.append(row)
    return out


NAMES = ["id", "st", "g_id", "nul", "q", "x"]


def _run_expand(pkg, batches):
    if pkg == "jax":
        from blaze_tpu import schema as S
        src = MemoryScanExec(JSchema.from_arrow(SCHEMA),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        op = JExpand(src, _projections(JE, S), NAMES)
    else:
        from blaze_tpu_torch import schema as S
        op = TExpand(_Source(batches), _projections(TE, S), NAMES)
    out = [b.compact().to_arrow() for b in op.execute(0)]
    return op, out


@pytest.mark.parametrize("n_batches,rows,batch_size", [
    (1, 40, 32768), (3, 300, 1024), (4, 700, 1024), (2, 2000, 4096)])
def test_expand_equals_jax(n_batches, rows, batch_size):
    for c in (jconf, tconf):
        c.conf.set(c.BATCH_SIZE.key, batch_size)
    batches = _batches(np.random.default_rng(rows), n_batches, rows)
    t_op, got = _run_expand("torch", batches)
    _j_op, want = _run_expand("jax", batches)
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    tg = pa.Table.from_batches(got)
    tw = pa.Table.from_batches(want)
    assert tg.schema == tw.schema
    assert tg.equals(tw)
    # batch by batch, projection by projection: the first rows are the
    # first batch's rows with both keys, then the same rows with st null
    n0 = batches[0].num_rows
    assert tg.column("g_id").to_pylist()[:n0] == [0] * n0
    assert tg.column("st").slice(n0, n0).null_count == n0
    assert tg.column("nul").null_count == tg.num_rows
    assert t_op.metrics.values["output_rows"] == tg.num_rows
    assert t_op.metrics.values["cpu_batches"] == 3 * n_batches


def test_expand_schema_comes_from_the_first_projection():
    from blaze_tpu_torch import schema as S
    op = TExpand(_Source([]), _projections(TE, S), NAMES)
    assert [f.name for f in op.schema] == NAMES
    assert [f.data_type.id for f in op.schema] == [
        S.TypeId.UTF8, S.TypeId.UTF8, S.TypeId.INT64, S.TypeId.INT64,
        S.TypeId.INT32, S.TypeId.FLOAT64]
    assert list(op.execute(0)) == []


# ---------------------------------------------------------------------------
# IN and the conditional expressions
# ---------------------------------------------------------------------------

def _lit(E, S, v, t):
    return E.Literal(v, getattr(S, t))


def _cmp(E, S, op, col, v):
    return E.BinaryExpr(op, E.BoundReference(col), _lit(E, S, v, "INT64"))


def _ref(E, i):
    return E.BoundReference(i)


#: name -> builder of the expression from (exprs package, conditional
#: module, schema module)
CASES = {
    "in_int64": lambda E, C, S: C.InList(_ref(E, K), (1, 3, 5)),
    "in_int64_null_member": lambda E, C, S: C.InList(_ref(E, K),
                                                     (1, None, 3)),
    "not_in_int64": lambda E, C, S: C.InList(_ref(E, K), (1, 3), True),
    "not_in_int64_null_member": lambda E, C, S: C.InList(
        _ref(E, K), (None, 2), True),
    "in_only_null": lambda E, C, S: C.InList(_ref(E, K), (None,)),
    "in_int32": lambda E, C, S: C.InList(_ref(E, Q), (7, 42, 99)),
    "in_utf8": lambda E, C, S: C.InList(_ref(E, ST), ("TX", "OH", "IL")),
    "in_utf8_null_member": lambda E, C, S: C.InList(
        _ref(E, ST), ("TX", None, "ß€")),
    "not_in_utf8": lambda E, C, S: C.InList(_ref(E, ST), ("TX", ""), True),
    "not_in_utf8_null_member": lambda E, C, S: C.InList(
        _ref(E, ST), ("TX", None), True),
    "is_null_int64": lambda E, C, S: C.IsNull(_ref(E, K)),
    "is_null_utf8": lambda E, C, S: C.IsNull(_ref(E, ST)),
    "is_not_null_float64": lambda E, C, S: C.IsNotNull(_ref(E, X)),
    "is_not_null_utf8": lambda E, C, S: C.IsNotNull(_ref(E, T)),
    "not_bool": lambda E, C, S: C.Not(_ref(E, B)),
    "not_utf8_in": lambda E, C, S: C.Not(C.InList(_ref(E, T), ("IL",))),
    "if_float64": lambda E, C, S: C.If(
        _cmp(E, S, ">", K, 2), _ref(E, X), _lit(E, S, -1.5, "FLOAT64")),
    "if_null_cond": lambda E, C, S: C.If(
        _ref(E, B), _ref(E, K), _lit(E, S, None, "INT64")),
    "case_int32": lambda E, C, S: C.CaseWhen(
        ((_cmp(E, S, "==", K, 1), _ref(E, Q)),
         (_ref(E, B), _lit(E, S, 7, "INT32"))),
        _lit(E, S, -7, "INT32")),
    "case_no_else": lambda E, C, S: C.CaseWhen(
        ((_cmp(E, S, "<", K, 2), _ref(E, X)),)),
    "case_utf8": lambda E, C, S: C.CaseWhen(
        ((_cmp(E, S, "==", K, 1), _ref(E, ST)),
         (_ref(E, B), _lit(E, S, "z", "UTF8"))),
        _ref(E, T)),
    "case_utf8_no_else": lambda E, C, S: C.CaseWhen(
        ((_cmp(E, S, ">=", K, 3), _ref(E, ID)),)),
    "coalesce_int64": lambda E, C, S: C.Coalesce(
        (_ref(E, K), _lit(E, S, 9, "INT64"))),
    "coalesce_utf8": lambda E, C, S: C.Coalesce(
        (_ref(E, T), _ref(E, ST), _lit(E, S, "zz", "UTF8"))),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_expression_equals_jax(name):
    from blaze_tpu import schema as JS
    from blaze_tpu_torch import schema as TS
    from blaze_tpu_torch.exprs import conditional as TC
    rb = _batches(np.random.default_rng(len(name)), 1, 777)[0]
    n = rb.num_rows
    jv = CASES[name](JE, JC, JS).evaluate(JBatch.from_arrow(rb))
    tv = CASES[name](TE, TC, TS).evaluate(TBatch.from_arrow(rb, device=CPU))
    assert jv.is_device == tv.is_device
    if not tv.is_device:
        assert tv.to_host(n).equals(jv.to_host(n))
        return
    jvalid = np.asarray(jv.validity)[:n]
    tvalid = tv.validity.numpy()[:n]
    assert np.array_equal(jvalid, tvalid)
    jd, td = np.asarray(jv.data)[:n], tv.data.numpy()[:n]
    assert jd.dtype == td.dtype
    assert np.array_equal(jd[jvalid].view(np.uint8),
                          td[tvalid].view(np.uint8))


def test_in_list_null_semantics():
    """`k IN (1, NULL)`: a match is TRUE, no match NULL, a null probe
    NULL; NOT IN keeps the validity and negates the value."""
    from blaze_tpu_torch import schema as S
    rb = pa.record_batch({"k": pa.array([1, 2, None], type=pa.int64())})
    b = TBatch.from_arrow(rb, device=CPU)
    for negated, want in ((False, [True, None, None]),
                          (True, [False, None, None])):
        v = TE.InList(TE.BoundReference(0), (1, None), negated).evaluate(b)
        assert v.to_host(3).to_pylist() == want
    v = TE.InList(TE.BoundReference(0), (1,), True).evaluate(b)
    assert v.to_host(3).to_pylist() == [False, True, None]
    assert TE.InList(TE.BoundReference(0), ()).data_type(None) == S.BOOL


def test_in_list_over_a_dictionary_probe_raises():
    from blaze_tpu_torch import schema as S

    class DictProbe(TE.PhysicalExpr):
        def data_type(self, schema):
            return S.UTF8

        def evaluate(self, batch):
            return ColVal(S.UTF8, array=pa.array(
                ["TX", "OH"]).dictionary_encode())

    b = TBatch.from_arrow(pa.record_batch({"k": pa.array([1, 2])}),
                          device=CPU)
    with pytest.raises(NotImplementedError, match="item 13"):
        TE.InList(DictProbe(), ("TX",)).evaluate(b)


# ---------------------------------------------------------------------------
# the wire and the decoder
# ---------------------------------------------------------------------------

def _c(i):
    return {"kind": "column", "index": i}


def _l(v, t):
    return {"kind": "literal", "value": v, "type": {"id": t}}


WIRE_EXPRS = [
    {"kind": "in_list", "child": {"kind": "column", "name": "st"},
     "values": ["TX", "OH", "IL"], "negated": False},
    {"kind": "in_list", "child": _c(K), "values": [1, None, 3],
     "negated": True},
    {"kind": "in_list", "child": _c(X), "values": [1.5, 2.25],
     "negated": False},
    {"kind": "is_null", "child": _c(ID)},
    {"kind": "is_not_null", "child": _c(K)},
    {"kind": "not", "child": _c(B)},
    {"kind": "case", "branches": [
        [{"kind": "binary", "op": "==", "l": _c(K), "r": _l(1, "int64")},
         _c(Q)]], "else": _l(-7, "int32")},
    {"kind": "case", "branches": [[_c(B), _c(ST)]]},
    {"kind": "if", "cond": _c(B), "then": _c(X), "else": _l(0.5, "float64")},
    {"kind": "coalesce", "args": [_c(T), _c(ST), _l("zz", "utf8")]},
]


def _scan():
    return {"kind": "parquet_scan",
            "schema": schema_to_dict(TSchema.from_arrow(SCHEMA)),
            "file_groups": [["/data/t.parquet"]]}


def _expand_td():
    nul = _l(None, "utf8")
    projections = [[_c(ID), _c(ST), _l(0, "int64"), _c(Q), _c(X)],
                   [_c(ID), nul, _l(1, "int64"), _c(Q), _c(X)],
                   [nul, nul, _l(3, "int64"), _c(Q), _c(X)]]
    return {"stage_id": 2, "partition_id": 0, "plan": {
        "kind": "shuffle_writer",
        "partitioning": {"kind": "hash", "exprs": [_c(0), _c(1), _c(2)],
                         "num_partitions": 4},
        "data_file": "/tmp/e.data", "index_file": "/tmp/e.index",
        "input": {"kind": "expand", "projections": projections,
                  "names": ["id", "st", "g_id", "q", "x"],
                  "input": {"kind": "filter", "predicates": [WIRE_EXPRS[0]],
                            "input": _scan()}}}}


def _expr_td(e):
    return {"stage_id": 1, "partition_id": 0, "plan": {
        "kind": "project", "exprs": [e], "names": ["e"], "input": _scan()}}


@pytest.mark.parametrize("i", range(len(WIRE_EXPRS) + 1))
def test_wire_equals_jax(i):
    td = _expand_td() if i == len(WIRE_EXPRS) else _expr_td(WIRE_EXPRS[i])
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    assert t_decode(data) == j_decode(data)
    assert TP.task_definition_to_bytes(t_decode(data)) == data


def test_decoded_expand_plans_an_expand():
    plan = create_plan(t_decode(TP.task_definition_to_bytes(
        _expand_td()))["plan"]["input"])
    assert isinstance(plan, TExpand)
    assert [f.name for f in plan.schema] == ["id", "st", "g_id", "q", "x"]
    schema = TSchema.from_arrow(SCHEMA)
    for e in WIRE_EXPRS:
        assert expr_from_dict(e, schema).data_type(schema) is not None
    with pytest.raises(NotImplementedError, match="item 13"):
        expr_from_dict({"kind": "like", "child": _c(K),
                        "pattern": "a%"}, schema)
