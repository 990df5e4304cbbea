"""The port's standard operator meter (blaze_tpu_torch/ops/base.py
`_meter_stream`, `_MeteredIter`): full TPC-DS q01 through the stage DAG
gives a metric tree equal to the JAX package's, node for node (names,
`output_rows`, `output_batches`, `io_bytes`, `pruned_row_groups`); the
re-entry guard counts an operator that calls itself once; a LimitExec
above a scan leaves the scan's partial work recorded; a cancelled task
stops at the next metered step; a count left on the device (the meter's
rows of a selection nobody counted) resolves when the metrics are read;
a finished stream emits its `operator:*` span.

The JAX side runs its device route (`host_resident` patched to False),
one task at a time (its thread pool races the broadcast build cache, so
a build side counts once or twice) and `auron.tpu.shuffle.device` off;
both with `auron.tpu.dag.singleTaskBytes` = 0.  Tolerance: exact."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge.metrics import MetricNode
from blaze_tpu_torch.ops.base import ExecutionPlan

KEYS = ("output_rows", "output_batches", "io_bytes", "pruned_row_groups")


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


def jax_explain(plan):
    """The JAX explain_analyze of `plan`, serial, on its device route."""
    import blaze_tpu.bridge.placement as P
    import blaze_tpu.bridge.tasks as JT
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.explain import explain_analyze
    MemManager.init(4 << 30)
    saved = P.host_resident, JT.default_task_parallelism
    P.host_resident = lambda: False
    JT.default_task_parallelism = lambda n: 1
    for k, v in ((jconf.DAG_SINGLE_TASK_BYTES.key, 0),
                 (jconf.SHUFFLE_DEVICE.key, "off")):
        jconf.conf.set(k, v)
    try:
        return explain_analyze(plan, record=False)
    finally:
        P.host_resident, JT.default_task_parallelism = saved
        for opt in (jconf.DAG_SINGLE_TASK_BYTES, jconf.SHUFFLE_DEVICE):
            jconf.conf.unset(opt.key)


def q01_plan(root):
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest import queries as TQ
    from blaze_tpu_torch.itest.tpcds_data import (make_tables,
                                                  write_parquet_splits)
    tables = make_tables(0.05, QD.TABLES)
    paths = write_parquet_splits(tables, str(root), 2)
    return TQ.q01(paths, tables, partitions=2)[0]


def tree_rows(node, path="0"):
    """[(path, name, (KEYS values))] in DFS order."""
    out = [(path, node.name, tuple(node.values.get(k, 0) for k in KEYS))]
    for i, c in enumerate(node.children):
        out.extend(tree_rows(c, f"{path}.{i}"))
    return out


@pytest.fixture(scope="module")
def q01(tmp_path_factory):
    """(the plan, the JAX tree)."""
    plan = q01_plan(tmp_path_factory.mktemp("q01"))
    return plan, jax_explain(plan).tree


def test_q01_tree_equals_the_jax_tree_node_for_node(q01):
    from blaze_tpu_torch.plan.stages import DagScheduler
    from blaze_tpu_torch.plan.explain import _stitch_stages
    plan, jtree = q01
    sched = DagScheduler()
    sched.run_collect(plan)
    assert sched.exec_mode == "staged"
    tree = _stitch_stages(sched.collect_metrics(), sched.stages[-1].deps,
                          sched)
    got, want = tree_rows(tree), tree_rows(jtree)
    assert len(got) == len(want) > 30
    for g, w in zip(got, want):
        assert g == w
    assert sum(r[2][0] for r in got if r[1] == "ParquetScanExec") > 0


class _SelfCalling(ExecutionPlan):
    """execute() pulls its own arrow_batches(), as IpcReaderExec does."""

    def __init__(self, batches):
        super().__init__()
        self._batches = batches

    @property
    def schema(self):
        from blaze_tpu_torch.schema import Schema
        return Schema.from_arrow(self._batches[0].schema)

    def arrow_batches(self, partition):
        yield from self._batches

    def execute(self, partition):
        from blaze_tpu_torch.batch import ColumnBatch
        for rb in self.arrow_batches(partition):
            yield ColumnBatch.from_arrow(rb)


def test_reentry_guard_counts_a_self_call_once():
    rbs = [pa.record_batch({"x": pa.array(range(i, i + 5))})
           for i in range(0, 15, 5)]
    op = _SelfCalling(rbs)
    assert sum(b.num_rows for b in op.execute(0)) == 15
    assert op.metrics.get("output_rows") == 15
    assert op.metrics.get("output_batches") == 3
    assert sum(rb.num_rows for rb in op.arrow_batches(0)) == 15
    assert op.metrics.get("output_rows") == 30  # a second stream
    assert op.metrics.get("elapsed_compute_ns") > 0


def _parquet(tmp_path, n=4000):
    t = pa.table({"k": pa.array(np.arange(n) % 11),
                  "v": pa.array(np.arange(n) * 0.5)})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=1000)
    return path, t


def test_a_limit_records_partial_work(tmp_path):
    from blaze_tpu_torch.ops.basic import LimitExec
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=256)
    lim = LimitExec(scan, 600)
    assert sum(b.selected_count() for b in lim.execute(0)) == 600
    assert lim.metrics.get("output_rows") == 600
    # three batches of 256 pulled before the limit was met
    assert scan.metrics.get("output_batches") == 3
    assert scan.metrics.get("output_rows") == 768
    assert 0 < scan.metrics.get("io_bytes") < t.nbytes


def test_a_cancelled_task_stops_at_the_next_metered_step(tmp_path):
    from blaze_tpu_torch.bridge.context import (TaskContext,
                                                TaskKilledError, task_scope)
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=256)
    alive = [True]
    with task_scope(TaskContext(is_running=lambda: alive[0])):
        it = scan.execute(0)
        next(it)
        alive[0] = False
        with pytest.raises(TaskKilledError):
            next(it)
        it.close()
    assert scan.metrics.get("output_batches") == 1


def test_selected_rows_of_a_filter_are_counted(tmp_path):
    from blaze_tpu_torch.exprs import BoundReference, Literal
    from blaze_tpu_torch.exprs.binary import BinaryExpr
    from blaze_tpu_torch.ops.basic import FilterExec
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=256)
    from blaze_tpu_torch.schema import INT64
    f = FilterExec(scan, [BinaryExpr("<", BoundReference(0),
                                     Literal(3, INT64))])
    batches = list(f.execute(0))
    want = int((np.arange(4000) % 11 < 3).sum())
    assert f.metrics.get("output_rows") == want
    assert sum(b.selected_count() for b in batches) == want


def test_device_counts_resolve_when_read():
    m = MetricNode("x")
    for i in range(130):  # past the fold of 64 pending scalars
        m.add_pending("output_rows", torch.tensor(i))
    m.add("output_rows", 5)
    assert m.values["output_rows"] == 5
    assert m.get("output_rows") == 5 + sum(range(130))
    assert not m._pending


def test_a_finished_stream_emits_its_operator_span(tmp_path):
    from blaze_tpu_torch.bridge import tracing
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=1000)
    tracing.start_tracing()
    try:
        with tracing.execution_context(query="meter-span"):
            assert sum(b.num_rows for b in scan.execute(0)) == 4000
        spans = tracing.spans_for_query("meter-span")
    finally:
        tracing.stop_tracing()
        tracing.reset_conf_probe()
    ops = [s for s in spans if s["name"] == "operator:ParquetScanExec"]
    assert len(ops) == 1
    assert ops[0]["attrs"]["rows"] == 4000
    assert ops[0]["dur_ns"] > 0
