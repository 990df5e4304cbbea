"""The per-task plan passes of the port (blaze_tpu_torch/plan/planner.py
`collapse_filter_project`, plan/column_pruning.py `prune_columns`, the
runtime that runs them before `fuse_plan`) against the JAX package's
(blaze_tpu/plan/planner.py, blaze_tpu/plan/column_pruning.py).

  * parity: every stage of every query of the port's `QUERIES` (the 100
    of itest/queries.py, queries_ext.py and queries_ext2.py; q45 plans
    `substring`, ROADMAP item 13, and is marked xfail), and the task
    plans of itest/q01.py, itest/rollup.py and itest/q01_branches.py,
    encoded as TaskDefinition bytes and decoded in both packages: after
    `prune_columns(collapse_filter_project(...))` the two trees have the
    same node kinds in tree order and the same scan projections (a union
    and a nested-loop join are barriers in both);
  * on and off: each query of itest/queries.py (`BASE_QUERIES`) through
    the port's DagScheduler gives the same
    rows, and every map output the same `.data` and `.index` bytes, with
    `auron.tpu.columnPruning` true and false; where a stage's scan
    narrows, the stage reads fewer `io_bytes`; off, no scan narrows;
  * collapse: `FilterProjectExec` against the JAX one over int, float and
    utf8 columns with nulls, at batch sizes that make the coalescing
    stream pass, stage and concatenate batches: the same batches, rows in
    order; and the same batches as the port's Filter then Project;
  * the fused lanes: a Filter under a Project under a partial aggregation
    takes the same lane (dense or hash), with the same key bounds from
    parquet statistics (`_column_bounds` through the FilterProjectExec),
    the same counters and the same rows, collapsed or not; a join whose
    key types differ keeps its widened key through pruning.

Tolerance: exact (node kinds, projections, bytes, rows, Arrow equality);
the on/off rows in order within 1e-9 relative (absolute below 1), as
tests/test_torch_q95_windows.py states, though both runs compute the same
floats."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu import exprs as JE
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.ops.basic import FilterProjectExec as JFilterProject
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import exprs as TE
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.itest import q01, q01_branches, rollup
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest import tpcds_data as TT
from blaze_tpu_torch.itest.q01_dag import stage_counters
from blaze_tpu_torch.itest.runner import frame, same_order
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import FilterExec as TFilter
from blaze_tpu_torch.ops.basic import FilterProjectExec as TFilterProject
from blaze_tpu_torch.ops.basic import ProjectExec as TProject
from blaze_tpu_torch.plan.proto_serde import task_definition_to_bytes
from blaze_tpu_torch.plan.stages import DagScheduler
from blaze_tpu_torch.schema import Schema as TSchema

from test_torch_q17_q18 import _recording

SCALE = 0.02
PARTS = 2
N_FILES = 2
REL = 1e-9
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.COLUMN_PRUNING_ENABLE, tconf.COLLAPSE_FILTER_PROJECT,
                tconf.BATCH_SIZE):
        tconf.conf.unset(opt.key)
    jconf.conf.unset(jconf.BATCH_SIZE.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    names = sorted({t for q in TQ.QUERIES.values() for t in q[1]})
    tables = TT.make_tables(SCALE, names)
    root = tmp_path_factory.mktemp("pruning")
    return tables, TT.write_splits(tables, str(root), N_FILES)


# ---------------------------------------------------------------------------
# parity of the two passes
# ---------------------------------------------------------------------------

def _walk(node, out):
    """(class name, scan projection or None) of each node, in tree
    order."""
    name = type(node).__name__
    out.append((name, [f.name for f in node.schema]
                if name == "ParquetScanExec" else None))
    for c in node.children:
        _walk(c, out)
    return out


def _both_trees(data: bytes):
    from blaze_tpu.plan.column_pruning import prune_columns as j_prune
    from blaze_tpu.plan.planner import collapse_filter_project as j_collapse
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu.plan.planner import decode_task_definition as j_decode
    from blaze_tpu_torch.plan.column_pruning import prune_columns
    from blaze_tpu_torch.plan.planner import (collapse_filter_project,
                                              create_plan,
                                              decode_task_definition)
    got = prune_columns(collapse_filter_project(create_plan(
        decode_task_definition(data)["plan"])))
    want = j_prune(j_collapse(j_create(j_decode(data)["plan"])))
    return _walk(got, []), _walk(want, [])


def _query_task_defs(plan):
    """Task 0's TaskDefinition of each stage, as DagScheduler writes it."""
    sched = DagScheduler()
    try:
        out = []
        for st in sched.split(plan):
            if st.partitioning is not None:
                out.append(sched._map_task_def(st, sched._part_of(st), 0))
            else:
                out.append({"stage_id": st.sid, "plan": sched._per_task(
                    st.plan, 0, st.num_tasks)})
        return out
    finally:
        sched.cleanup()


def _itest_task_defs(name, paths, tmp_path):
    sr = [f for group in paths["store_returns"] for f in group]
    lo, hi = TQ._day_range(0, 365)
    if name == "q01 inner":
        return [q01.stage1_td(sr, lo, hi, 0, str(tmp_path), N_FILES, PARTS),
                q01.stage2_td(0, PARTS)]
    if name == "rollup":
        return [rollup.stage1_td(sr, lo, hi, 0, str(tmp_path), N_FILES,
                                 PARTS), rollup.stage2_td(0, PARTS)]
    return [st.task_td(0) for st in q01_branches.stages(
        sr, lo, hi, str(tmp_path), N_FILES, PARTS)]


#: every query and driver plan; q45 plans `substring` (ROADMAP item 13)
PARITY = [pytest.param(n, marks=pytest.mark.xfail(
              strict=True, raises=NotImplementedError, reason="item 13"))
          if n == "q45" else n for n in TQ.QUERIES] + [
    "q01 inner", "rollup", "q01 branches"]


@pytest.mark.parametrize("name", PARITY)
def test_pruned_trees_equal_the_jax_pass(data, tmp_path, name):
    tables, paths = data
    if name in TQ.QUERIES:
        plan, _ = TQ.plans(paths, tables, PARTS, [name])[name]
        tds = _query_task_defs(plan)
    else:
        tds = _itest_task_defs(name, paths, tmp_path)
    for td in tds:
        got, want = _both_trees(task_definition_to_bytes(td))
        assert got == want, td["stage_id"]


def test_the_pass_narrows_where_the_reference_does(data):
    """q98's store_sales scan reads 3 of its 16 columns; q67's reads all
    16: its joins sit under an Expand, which no requirement crosses."""
    tables, paths = data
    assert len(tables["store_sales"].schema) == 16
    for name, width in (("q98", 3), ("q67", 16)):
        plan, _ = TQ.plans(paths, tables, PARTS, [name])[name]
        got, _want = _both_trees(task_definition_to_bytes(
            _query_task_defs(plan)[0]))
        scans = [p for n, p in got if n == "ParquetScanExec"]
        assert len(scans[0]) == width, name


def _chain_plan(path):
    """project(project(filter(scan))) and project(project(scan)) over a
    four-column file."""
    col = lambda i: {"kind": "column", "index": i}  # noqa: E731
    scan = {"kind": "parquet_scan", "file_groups": [[path]],
            "schema": {"fields": [{"name": n, "type": {"id": t},
                                   "nullable": True}
                                  for n, t in (("a", "int64"),
                                               ("b", "float64"),
                                               ("c", "int32"),
                                               ("d", "int64"))]}}
    flt = {"kind": "filter", "input": scan, "predicates": [
        {"kind": "binary", "op": ">", "l": col(0),
         "r": {"kind": "literal", "value": 3, "type": {"id": "int64"}}}]}

    def proj(inp):
        inner = {"kind": "project", "input": inp, "names": ["x", "y"],
                 "exprs": [{"kind": "binary", "op": "+", "l": col(0),
                            "r": col(2)}, col(1)]}
        return {"kind": "project", "input": inner, "names": ["y", "z"],
                "exprs": [col(1), {"kind": "binary", "op": "*",
                                   "l": col(0), "r": col(0)}]}
    return proj(flt), proj(scan)


@pytest.mark.parametrize("which,kinds", [
    (0, ["ProjectExec", "FilterProjectExec", "ParquetScanExec"]),
    (1, ["ProjectExec", "ParquetScanExec"])])
def test_collapse_equals_the_jax_pass(tmp_path, which, kinds):
    """A Filter under a Project becomes a FilterProjectExec, a Project
    over a Project one Project; the scan narrows to the columns read; the
    rows equal those of the plan without the passes."""
    from blaze_tpu_torch.plan.planner import create_plan
    rng = np.random.default_rng(2)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": rng.integers(0, 9, 300),
                             "b": rng.normal(size=300),
                             "c": rng.integers(0, 9, 300).astype(np.int32),
                             "d": rng.integers(0, 9, 300)}), path)
    plan_d = _chain_plan(path)[which]
    got, want = _both_trees(task_definition_to_bytes({"plan": plan_d}))
    assert got == want
    assert [n for n, _p in got] == kinds
    assert got[-1][1] == ["a", "b", "c"]
    from blaze_tpu_torch.plan.column_pruning import prune_columns
    from blaze_tpu_torch.plan.planner import collapse_filter_project
    passed = prune_columns(collapse_filter_project(create_plan(plan_d)))
    t = pa.Table.from_batches(list(passed.arrow_batches(0)))
    plain = pa.Table.from_batches(list(create_plan(plan_d).arrow_batches(0)))
    assert t.num_rows > 0 and t.equals(plain)


# ---------------------------------------------------------------------------
# pruning on and off, through the DAG
# ---------------------------------------------------------------------------

def _run(plan, pruning: bool):
    tconf.conf.set(tconf.COLUMN_PRUNING_ENABLE.key, pruning)
    sched = _recording(DagScheduler)()
    got = frame(sched.run_collect(plan))
    return got, sched, stage_counters(sched, ("io_bytes",))


@pytest.mark.parametrize("name", TQ.BASE_QUERIES)
def test_pruning_on_and_off_give_the_same_rows_and_bytes(data, name):
    tables, paths = data
    plan, _ = TQ.plans(paths, tables, PARTS, [name])[name]
    on, s_on, io_on = _run(plan, True)
    plan, _ = TQ.plans(paths, tables, PARTS, [name])[name]
    off, s_off, io_off = _run(plan, False)
    assert same_order(on, off, REL) is None
    assert sorted(s_on.outputs) == sorted(s_off.outputs)
    for key, raw in s_on.outputs.items():
        assert raw == s_off.outputs[key], key
    narrowed = {td["stage_id"] for td in _query_task_defs(plan)
                if _scan_widths(td, True) != _scan_widths(td, False)}
    assert set(io_on) == set(io_off)
    for sid, c in io_on.items():
        if sid in narrowed:
            assert c["io_bytes"] < io_off[sid]["io_bytes"], sid
        else:
            assert c["io_bytes"] == io_off[sid]["io_bytes"], sid


def _scan_widths(td, pruning: bool):
    """The column count of each scan of the task's plan after the port's
    passes, with pruning on or off."""
    from blaze_tpu_torch.plan.column_pruning import prune_columns
    from blaze_tpu_torch.plan.planner import (collapse_filter_project,
                                              create_plan)
    tconf.conf.set(tconf.COLUMN_PRUNING_ENABLE.key, pruning)
    tree = prune_columns(collapse_filter_project(create_plan(td["plan"])))
    return [len(p) for n, p in _walk(tree, []) if p is not None]


# ---------------------------------------------------------------------------
# FilterProjectExec against the JAX one
# ---------------------------------------------------------------------------

SCHEMA = pa.schema([("id", pa.string()), ("k", pa.int64()),
                    ("q", pa.int32()), ("x", pa.float64())])


def _batches(rng, n_batches, rows):
    words = np.array(["TX", "OH", "", "ß€", "IL"], dtype=object)
    out = []
    for b in range(n_batches):
        n = rows + b
        out.append(pa.record_batch({
            "id": pa.array(words[rng.integers(0, len(words), n)],
                           type=pa.string(), mask=rng.random(n) < 0.1),
            "k": pa.array(rng.integers(0, 10, n), mask=rng.random(n) < 0.1),
            "q": pa.array(rng.integers(-50, 50, n).astype(np.int32),
                          mask=rng.random(n) < 0.05),
            "x": pa.array(rng.normal(size=n) * 100,
                          mask=rng.random(n) < 0.1)}, schema=SCHEMA))
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


def _exprs(E, S):
    """(predicates, projections) in package E with schema module S."""
    preds = [E.BinaryExpr("<", E.BoundReference(1), E.Literal(7, S.INT64)),
             E.BinaryExpr(">", E.BoundReference(3),
                          E.Literal(-80.0, S.FLOAT64))]
    projs = [E.BoundReference(0),
             E.BinaryExpr("+", E.BoundReference(1), E.BoundReference(2)),
             E.BinaryExpr("*", E.BoundReference(3),
                          E.Literal(2.0, S.FLOAT64)),
             E.BinaryExpr("==", E.BoundReference(0),
                          E.Literal("TX", S.UTF8))]
    return preds, projs


NAMES = ["id", "kq", "x2", "is_tx"]


def _run_filter_project(pkg, batches, collapsed=True):
    if pkg == "jax":
        import blaze_tpu.schema as S
        preds, projs = _exprs(JE, S)
        src = MemoryScanExec(JSchema.from_arrow(SCHEMA),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        op = JFilterProject(src, preds, projs, NAMES)
    else:
        import blaze_tpu_torch.schema as S
        preds, projs = _exprs(TE, S)
        if collapsed:
            op = TFilterProject(_Source(batches), preds, projs, NAMES)
        else:
            op = TProject(TFilter(_Source(batches), preds), projs, NAMES)
    return [b.compact().to_arrow() for b in op.execute(0)]


@pytest.fixture
def host_route(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)


@pytest.mark.parametrize("n_batches,rows,batch_size", [
    (1, 60, 32768), (4, 500, 1024), (3, 1500, 2048), (5, 3000, 4096)])
def test_filter_project_equals_jax(host_route, n_batches, rows, batch_size):
    for c in (jconf, tconf):
        c.conf.set(c.BATCH_SIZE.key, batch_size)
    batches = _batches(np.random.default_rng(rows), n_batches, rows)
    got = _run_filter_project("torch", batches)
    want = _run_filter_project("jax", batches)
    apart = _run_filter_project("torch", batches, collapsed=False)
    for other in (want, apart):
        assert [b.num_rows for b in got] == [b.num_rows for b in other]
        tg, to = pa.Table.from_batches(got), pa.Table.from_batches(other)
        assert tg.schema == to.schema
        assert tg.equals(to)
    assert 0 < sum(b.num_rows for b in got) < sum(b.num_rows
                                                  for b in batches)


# ---------------------------------------------------------------------------
# the fused lanes see through FilterProjectExec
# ---------------------------------------------------------------------------

def _agg_plan(path, key_hi):
    """A partial sum and count of x by (k, j) over project(filter(scan)),
    with k in [0, key_hi)."""
    col = lambda n: {"kind": "column", "name": n}  # noqa: E731
    lit = {"kind": "literal", "value": 0.0, "type": {"id": "float64"}}
    scan = {"kind": "parquet_scan",
            "schema": {"fields": [
                {"name": n, "type": {"id": t}, "nullable": True}
                for n, t in (("k", "int64"), ("j", "int32"),
                             ("x", "float64"), ("pad", "int64"))]},
            "file_groups": [[path]]}
    flt = {"kind": "filter", "input": scan, "predicates": [
        {"kind": "binary", "op": ">", "l": col("x"), "r": lit}]}
    prj = {"kind": "project", "input": flt, "names": ["j2", "k2", "x2"],
           "exprs": [col("j"), col("k"), col("x")]}
    return {"kind": "hash_agg", "input": prj,
            "groupings": [{"expr": col("k2"), "name": "k"},
                          {"expr": col("j2"), "name": "j"}],
            "aggs": [{"fn": "sum", "mode": "partial", "name": "s",
                      "args": [col("x2")]},
                     {"fn": "count", "mode": "partial", "name": "c",
                      "args": [col("x2")]}]}


def _fused(plan_d):
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.column_pruning import prune_columns
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec, fuse_plan
    from blaze_tpu_torch.plan.planner import collapse_filter_project
    plan = fuse_plan(prune_columns(collapse_filter_project(
        create_plan(plan_d))))
    assert isinstance(plan, FusedPartialAggExec)
    rbs = [b.compact().to_arrow() for b in plan.execute(0)]
    return plan, [rb for rb in rbs if rb.num_rows]


@pytest.mark.parametrize("key_hi,mode", [(40, "dense"),
                                         (1 << 40, "sorted")])
def test_fused_lane_is_the_same_after_collapse(tmp_path, key_hi, mode):
    from blaze_tpu_torch.plan.fused import _column_bounds
    rng = np.random.default_rng(11)
    n = 20_000
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "k": rng.integers(0, key_hi, n),
        "j": rng.integers(0, 7, n).astype(np.int32),
        "x": rng.normal(size=n), "pad": rng.integers(0, 9, n)}), path,
        row_group_size=4096)
    tconf.conf.set(tconf.BATCH_SIZE.key, 4096)
    runs = {}
    for collapse in (True, False):
        tconf.conf.set(tconf.COLLAPSE_FILTER_PROJECT.key, collapse)
        runs[collapse] = _fused(_agg_plan(path, key_hi))
    (on, got), (off, want) = runs[True], runs[False]
    assert type(on.children[0]).__name__ == "FilterProjectExec"
    assert type(off.children[0]).__name__ == "ProjectExec"
    assert on.fused_mode == off.fused_mode == mode
    assert on._ranges == off._ranges
    assert [s[0] for s in on._chain] == [s[0] for s in off._chain] \
        == ["filter", "project"]
    assert [f.name for f in on._source.schema] == ["k", "j", "x"]
    for i in (0, 1):
        e = TE.BoundReference(i)
        assert _column_bounds(on.children[0], e) == \
            _column_bounds(off.children[0], e) is not None
    assert on.metrics.values == off.metrics.values
    assert on.metrics.values["cpu_batches"] == 5  # 20,000 rows / 4,096
    assert pa.Table.from_batches(got).equals(pa.Table.from_batches(want))


def test_pruned_join_keeps_its_widened_key(tmp_path):
    """An int32 key against an int64 one: the join widens the int32 side;
    pruning rebuilds the join over narrowed scans and keeps the rows."""
    from blaze_tpu_torch.plan import create_plan
    from blaze_tpu_torch.plan.column_pruning import prune_columns
    rng = np.random.default_rng(4)
    paths = {}
    for name, t in (("l", pa.table({
            "a": rng.integers(0, 9, 500).astype(np.int32),
            "b": rng.normal(size=500), "c": rng.integers(0, 5, 500)})),
                    ("r", pa.table({"z": rng.normal(size=30),
                                    "a64": np.arange(30, dtype=np.int64)}))):
        paths[name] = str(tmp_path / f"{name}.parquet")
        pq.write_table(t, paths[name])

    def scan(name, fields):
        return {"kind": "parquet_scan", "file_groups": [[paths[name]]],
                "schema": {"fields": [{"name": n, "type": {"id": t},
                                       "nullable": True}
                                      for n, t in fields]}}
    col = lambda n: {"kind": "column", "name": n}  # noqa: E731
    plan_d = {"kind": "project", "names": ["b", "a64"],
              "exprs": [col("b"), col("a64")],
              "input": {"kind": "hash_join", "join_type": "inner",
                        "build_side": "right",
                        "left": scan("l", [("a", "int32"), ("b", "float64"),
                                           ("c", "int64")]),
                        "right": scan("r", [("z", "float64"),
                                            ("a64", "int64")]),
                        "left_keys": [col("a")], "right_keys": [col("a64")]}}
    want = pa.Table.from_batches(list(create_plan(plan_d).arrow_batches(0)))
    pruned = prune_columns(create_plan(plan_d))
    join = pruned.children[0]
    assert [f.name for f in join.children[0].schema] == ["a", "b"]
    assert [f.name for f in join.children[1].schema] == ["a64"]
    assert type(join.left_keys[0]).__name__ == "Cast"
    got = pa.Table.from_batches(list(pruned.arrow_batches(0)))
    assert got.num_rows > 0 and got.equals(want)
