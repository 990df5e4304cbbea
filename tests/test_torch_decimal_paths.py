"""TPC-DS full q01 and q12 with their money typed decimal(7,2)
(blaze_tpu_torch/itest/decimal_money.py) through the port's stage DAG,
at scale 0.05 (store_returns and web_sales in 4 files, every dimension
in one, 2 exchange partitions), against each query's exact oracle and
the JAX package's DagScheduler on the same plan and data:

  * every map output upstream of the JAX package's decimal faults is the
    JAX run's `.data` and `.index` bytes: q01's stages before its filter
    `ctr_total_return > avg_return * 1.2` (the JAX package cannot
    evaluate the decimal(2,1) literal 1.2 there), q12's two map stages
    (the JAX package's window then fails casting its unscaled sums);
  * each result equals its exact oracle (integer cents for q01, Python
    Decimal for q12's ratio) under the stage loop `off` and `auto`; the
    JAX package raises in both (ROADMAP Queue 3);
  * the route is the JAX package's: the decimal sums stay on the generic
    AggExec (no fused lane, no placement), and each exchange groups its
    rows through kernels/radix.py `partition_order`;
  * the window over a decimal argument (sum, avg, min, max, count)
    equals a Decimal reference.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0, the JAX
package with `blaze_tpu.bridge.placement.host_resident` patched to False
(its device route) and `auron.tpu.shuffle.device` off, as
tests/test_torch_q17_q18.py runs them.

Tolerance: exact for every decimal, integer and string value."""

import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.itest import decimal_money as M
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.plan.stages import DagScheduler

from test_torch_q17_q18 import _recording

SCALE = 0.05
PARTS = 2
N_FILES = 4
D = decimal.Decimal


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STAGE_DEVICE_LOOP_ENABLE):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    names = sorted({t for ts in M.TABLES.values() for t in ts})
    tables = M.with_money(TT.make_tables(SCALE, names))
    root = tmp_path_factory.mktemp("decimal_money")
    return tables, TT.write_splits(tables, str(root), N_FILES)


def _jax_run(plan):
    """The JAX DagScheduler's result (or the exception it raised) and the
    scheduler, on its device route."""
    import blaze_tpu.bridge.placement as P
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import DagScheduler as JDag
    MemManager.init(4 << 30)
    saved = P.host_resident
    P.host_resident = lambda: False
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    sched = _recording(JDag)()
    try:
        return sched.run_collect(plan), sched
    except Exception as e:  # noqa: BLE001 - the JAX fault is the result
        return e, sched
    finally:
        P.host_resident = saved
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
        jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)


@pytest.fixture(scope="module")
def runs(data):
    """name -> (plan, oracle result, JAX result or exception, JAX
    scheduler)."""
    tables, paths = data
    out = {}
    for name, build in (("q01", M.q01), ("q12", M.q12)):
        plan, oracle = build(paths, tables, PARTS)
        out[name] = (plan, oracle()) + _jax_run(plan)
    return out


CHECK = {"q01": M.check_q01, "q12": M.check_q12}


def test_money_columns_are_decimal_cents(data):
    tables, _paths = data
    raw = TT.make_tables(SCALE, ["store_returns", "web_sales"])
    for name, cols in M.MONEY_COLUMNS.items():
        for c in cols:
            got = tables[name].column(c)
            assert got.type == pa.decimal128(7, 2)
            want = np.rint(raw[name].column(c).to_numpy() * 100)
            assert np.array_equal(M.cents(got), want.astype(np.int64))
            assert [float(v) for v in got.to_pylist()[:50]] == \
                raw[name].column(c).to_pylist()[:50]


def test_literals_are_typed_as_sparks_parser_types_them(runs):
    lits = []

    def walk(node):
        if isinstance(node, dict):
            if node.get("kind") == "literal" and \
                    node["type"]["id"] in ("decimal", "int32") and \
                    not isinstance(node["value"], str):
                lits.append((node["value"], node["type"]))
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)
    walk(runs["q01"][0])
    assert (D("1.2"), {"id": "decimal", "precision": 2, "scale": 1}) in lits
    lits.clear()
    walk(runs["q12"][0])
    assert (100, {"id": "int32"}) in lits


def _stages_holding(sched, text):
    return {st.sid for st in sched.stages if text in repr(st.plan)}


@pytest.mark.parametrize("name", ["q01", "q12"])
def test_map_outputs_upstream_of_the_faults_are_the_jax_bytes(runs, name):
    plan, _want, _jax, jsched = runs[name]
    sched = _recording(DagScheduler)()
    sched.run_collect(plan)
    assert len(sched.stages) == len(jsched.stages) == M.STAGES[name]
    faulty = _stages_holding(sched, "Decimal('1.2')")
    assert len(faulty) == (1 if name == "q01" else 0)
    upstream = {k: v for k, v in sched.outputs.items()
                if k[0] not in faulty}
    assert upstream and any(len(v) > 8 for v in upstream.values())
    for key, raw in upstream.items():
        assert raw == jsched.outputs[key], key


@pytest.mark.parametrize("loop", ["off", "auto"])
@pytest.mark.parametrize("name", ["q01", "q12"])
def test_query_equals_its_exact_oracle(runs, name, loop):
    plan, want, _jax, _jsched = runs[name]
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, loop)
    sched = DagScheduler()
    out = sched.run_collect(plan)
    assert out.num_rows > 0
    assert CHECK[name](out, want) == ""
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def test_the_jax_package_gets_both_queries_wrong(runs):
    """ROADMAP Queue 3: the JAX package's q01 cannot evaluate the literal
    1.2 on its device route (jnp.full of a Decimal raises; its host route
    reads it as 0.1, tests/test_torch_decimal.py), and its q12's window
    fails casting its unscaled sums to decimal(18,2)."""
    jax = runs["q01"][2]
    assert isinstance(jax, TypeError) and "1.2" in str(jax)
    _plan, _want, jax, _s = runs["q12"]
    assert isinstance(jax, pa.ArrowInvalid)
    assert "Precision is not great enough" in str(jax)


def test_the_route_is_the_jax_packages(runs):
    """The decimal sums stay on the generic AggExec (the fused lanes turn
    a decimal sum argument down in both packages: placement never runs),
    and every exchange groups through partition_order."""
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.ops.agg.exec import AggExec
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.fused import fuse_plan
    calls = []
    real = R.partition_order

    def counting(pids, n):
        calls.append(len(pids))
        return real(pids, n)
    for name in ("q01", "q12"):
        plan = runs[name][0]
        tree = fuse_plan(create_plan(plan))
        stack, kinds = [tree], []
        while stack:
            node = stack.pop()
            kinds.append(type(node).__name__)
            stack.extend(node.children)
        assert "FusedPartialAggExec" not in kinds
        assert kinds.count(AggExec.__name__) >= 2
        R.partition_order = counting
        try:
            DagScheduler().run_collect(plan)
        finally:
            R.partition_order = real
    assert len(calls) >= M.STAGES["q01"] - 1 + M.STAGES["q12"] - 1


# ---------------------------------------------------------------------------
# the window over a decimal argument
# ---------------------------------------------------------------------------

def test_window_aggregates_over_a_decimal_are_exact():
    """sum, avg, min, max and count over decimal(7,2) by partition, whole
    partition and running: sum decimal(17,2), avg decimal(11,6) (sum x
    10^4 / count HALF_UP), min/max decimal(7,2), against Python Decimal."""
    from blaze_tpu_torch.exprs import BoundReference as Ref
    from blaze_tpu_torch.ops import window as W
    from blaze_tpu_torch.ops.agg import make_agg
    from blaze_tpu_torch.ops.base import ExecutionPlan
    from blaze_tpu_torch.schema import Schema
    rng = np.random.default_rng(21)
    n = 300
    g = np.sort(rng.integers(0, 9, n))
    o = rng.integers(0, 20, n)
    order = np.lexsort((o, g))
    g, o = g[order], o[order]
    cents = rng.integers(-99999, 99999, n)
    vals = [None if rng.random() < 0.1 else D(int(c)).scaleb(-2)
            for c in cents]
    rb = pa.record_batch({"g": pa.array(g), "o": pa.array(o),
                          "d": pa.array(vals, pa.decimal128(7, 2))})

    class Src(ExecutionPlan):
        schema = Schema.from_arrow(rb.schema)

        def execute(self, partition):
            yield TBatch.from_arrow(rb, device=torch.device("cpu"))
    d = Ref(2)
    funcs = []
    for running in (False, True):
        for fn in ("sum", "avg", "min", "max", "count"):
            funcs.append(W.WindowAggFunc(f"{fn}{int(running)}",
                                         make_agg(fn, [d]), running))
    op = W.WindowExec(Src(), funcs, [Ref(0)], [(Ref(1), False, True)])
    out = pa.Table.from_batches([b.to_arrow() for b in op.execute(0)])
    assert out.schema.field("sum0").type == pa.decimal128(17, 2)
    assert out.schema.field("avg0").type == pa.decimal128(11, 6)
    assert out.schema.field("min1").type == pa.decimal128(7, 2)
    for running in (False, True):
        for i in range(n):
            frame = [j for j in range(n) if g[j] == g[i] and
                     (not running or o[j] <= o[i])]
            xs = [vals[j] for j in frame if vals[j] is not None]
            row = {c: out.column(f"{c}{int(running)}")[i].as_py()
                   for c in ("sum", "avg", "min", "max", "count")}
            assert row["count"] == len(xs)
            if not xs:
                assert row["sum"] is None and row["avg"] is None
                continue
            assert row["sum"] == sum(xs)
            assert row["min"] == min(xs) and row["max"] == max(xs)
            with decimal.localcontext() as ctx:
                ctx.prec = 50
                avg = (sum(xs) / len(xs)).quantize(
                    D("0.000001"), rounding=decimal.ROUND_HALF_UP)
            assert row["avg"] == avg
