"""The port's EXPLAIN ANALYZE (blaze_tpu_torch/plan/explain.py): full
TPC-DS q01 staged through the stage DAG gives the JAX package's
`explain_analyze` tree (node names and every counter both trees hold but
the timings), the same host shuffle bytes, task attempts and kernel-lane
resolutions; with tracing on, the bottleneck attribution's categories
sum to the span extent and the extent to the query's wall within 1%; the
local mode and an operator tree run too; the profile is recorded for the
HTTP service; the footers render.

The JAX side runs serial on its device route (tests/test_torch_meter.py
`jax_explain`).  Both packages' counter registries and expression-program
caches are cleared right before each side's run, so the process-wide
counters compared (the distinct bucket rungs, the expression programs
built) do not depend on what earlier test files ran in the same worker.
Tolerance: exact for names, counts and bytes; 1% for the attribution
against the wall."""

import pyarrow as pa
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import profiling, tracing
from blaze_tpu_torch.plan.explain import explain_analyze

from test_torch_meter import jax_explain, q01_plan

SAME = ("shuffle_host_bytes", "task_attempts", "task_retries",
        "scatter_lane_hash_scatter", "scatter_lane_partition_scatter",
        "distinct_buckets", "fetch_failures", "stage_recoveries",
        "expr_fused_batches", "expr_eager_batches", "expr_programs_built")


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def q01(tmp_path_factory):
    """(the plan, the JAX profile, the port's traced profile)."""
    from blaze_tpu.bridge import xla_stats
    from blaze_tpu.exprs import program as jprogram
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.exprs import program as tprogram
    plan = q01_plan(tmp_path_factory.mktemp("q01"))
    xla_stats.reset()
    jprogram.clear_program_cache()
    jprof = jax_explain(plan)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    device_stats.reset()
    tprogram.clear_program_cache()
    tracing.start_tracing()
    try:
        prof = explain_analyze(plan, query_id="explain-q01",
                               keep_result=True)
    finally:
        tracing.stop_tracing()
        with tracing._lock:
            tracing._spans.clear()
        tracing.reset_conf_probe()
    return plan, jprof, prof


def _rows(node, path="0"):
    out = [(path, node.name, node.values)]
    for i, c in enumerate(node.children):
        out.extend(_rows(c, f"{path}.{i}"))
    return out


def test_q01_tree_equals_the_jax_tree(q01):
    _plan, jprof, prof = q01
    got, want = _rows(prof.tree), _rows(jprof.tree)
    assert [(p, n) for p, n, _ in got] == [(p, n) for p, n, _ in want]
    for (p, name, g), (_, _, w) in zip(got, want):
        common = (set(g) & set(w)) - {"elapsed_compute_ns"}
        assert {k: g[k] for k in common} == {k: w[k] for k in common}, \
            (p, name)
    assert prof.exec_mode == jprof.exec_mode == "staged"
    assert prof.partitions == jprof.partitions == 1
    assert prof.output_rows == jprof.output_rows == 100
    assert prof.placement == "cpu"
    for k in SAME:
        assert prof.counters[k] == jprof.xla[k], k
    assert prof.counters["shuffle_host_bytes"] > 0
    assert prof.result.num_rows == 100


def test_attribution_sums_to_the_wall(q01):
    _plan, _jprof, prof = q01
    bn = prof.bottleneck
    assert bn is not None and bn["span_count"] > 0
    cats = bn["categories"]
    assert sum(cats.values()) == pytest.approx(bn["wall_s"], rel=1e-4)
    assert bn["wall_s"] == pytest.approx(prof.wall_ns / 1e9, rel=0.01)
    # every scan of staged q01 runs in a producer stage, whose exchange
    # span outranks it
    assert cats["exchange_wire"] > 0 and cats["host_compute"] > 0
    assert bn["critical_path"][0]["name"] == "explain_analyze"


def test_profile_is_recorded_and_renders(q01):
    _plan, _jprof, prof = q01
    assert profiling.get_profile("explain-q01") == prof.to_dict()
    text = prof.render_text()
    assert text.startswith("== query profile explain-q01")
    for head in ("LimitExec", "ParquetScanExec", "transfers:", "prefetch:",
                 "kernel launches:", "shuffle: host=", "bottleneck:",
                 "scatter lanes:"):
        assert head in text, head
    assert "rows=100" in text.splitlines()[1]


def test_local_mode_and_an_operator_tree(q01, tmp_path):
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    import pyarrow.parquet as pq
    plan, _jprof, _prof = q01
    tconf.conf.unset(tconf.DAG_SINGLE_TASK_BYTES.key)
    local = explain_analyze(plan, record=False)
    assert local.exec_mode == "local" and local.output_rows == 100
    assert local.tree.name == "LimitExec"
    assert "bottleneck:" not in local.render_text()  # tracing off
    t = pa.table({"k": list(range(1000))})
    path = str(tmp_path / "k.parquet")
    pq.write_table(t, path, row_group_size=300)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=256)
    op = explain_analyze(scan, record=False)
    assert op.output_rows == 1000 and op.partitions == 1
    assert op.tree.values["output_rows"] == 1000
    assert op.counters["prefetch_batches"] == 4
