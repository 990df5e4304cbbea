"""EXPLAIN ANALYZE: execute a plan and render the annotated operator tree
(port of blaze_tpu/plan/explain.py).

`explain_analyze` runs a query through the production task path (a plan
dict through the stage DAG, staged or in the local mode, or an operator
tree through the task runtime), merges the per-partition metric trees
into one query-level profile, snapshots the counter registry
(bridge/device_stats.py) around the run, and renders the result as an
annotated plan text or a JSON-ready dict.  With tracing on
(bridge/tracing.py) it adds the bottleneck attribution of the query's
spans (bridge/critical_path.py).  It runs on the card unless
`auron.torch.device` is `cpu`.

The profile is registered with the observability service
(bridge/profiling.py `record_profile`), so the same data is served at
/profile/<qid> and folded into /metrics.prom.  Footers appear only for
counters that moved (the "aqe:" footer when adaptive execution rewrote
or seeded the plan, the "stream:" footer once the streaming runtime has
committed an epoch); the reference's footers of subsystems the port
lacks (speculation, work sharing, encodings, workers: ROADMAP Queue 1)
have no counters here, so they never render, as the
reference's do not when their stats are empty.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from blaze_tpu_torch.bridge.metrics import BASELINE_METRICS, MetricNode


def _fmt_ns(ns: int) -> str:
    if ns >= 1_000_000_000:
        return f"{ns / 1e9:.2f}s"
    if ns >= 1_000_000:
        return f"{ns / 1e6:.2f}ms"
    if ns >= 1_000:
        return f"{ns / 1e3:.1f}us"
    return f"{ns}ns"


def _fmt_bytes(n: int) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return f"{n}B"


def format_bottleneck_footer(report) -> Optional[str]:
    """The "bottleneck:" footer from a critical_path.bottleneck_report
    dict, or None when no spans were traced."""
    if not report or not report.get("span_count"):
        return None
    cats = report.get("categories") or {}
    parts = [f"{k}={cats[k]:.3f}s" for k in sorted(cats) if cats.get(k)]
    head = f"bottleneck: wall={report.get('wall_s', 0):.3f}s"
    dom = report.get("dominant")
    if dom:
        head += (f" dominant={dom} "
                 f"({report.get('dominant_fraction', 0):.0%})")
    return head + ((" " + " ".join(parts)) if parts else "")


def format_aqe_footer(x) -> Optional[str]:
    """The "aqe:" footer (runtime rewrites and history-seeded planning),
    or None when adaptive execution never fired — AQE is off by default
    and the profile stays byte-identical then."""
    if not (x.get("aqe_rewrites") or x.get("aqe_history_seeds")):
        return None
    return (
        f"aqe: rewrites={x.get('aqe_rewrites', 0)} "
        f"broadcast={x.get('aqe_broadcast_switches', 0)} "
        f"coalesced={x.get('aqe_partitions_coalesced', 0)} "
        f"skew_splits={x.get('aqe_skew_splits', 0)} "
        f"history_seeds={x.get('aqe_history_seeds', 0)} "
        f"stages_elided={x.get('aqe_stages_elided', 0)} "
        f"saved={_fmt_bytes(x.get('aqe_bytes_saved', 0))}")


def _node_line(node: MetricNode) -> str:
    v = node.values
    total = v.get("elapsed_compute_ns", 0)
    self_ns = max(0, total - sum(c.values.get("elapsed_compute_ns", 0)
                                 for c in node.children))
    parts = [f"rows={v.get('output_rows', 0)}",
             f"batches={v.get('output_batches', 0)}",
             f"time={_fmt_ns(total)}"]
    if node.children:
        parts.append(f"(self {_fmt_ns(self_ns)})")
    if v.get("mem_used", 0):
        parts.append(f"mem={_fmt_bytes(v['mem_used'])}")
    if v.get("spilled_bytes", 0):
        parts.append(f"spilled={_fmt_bytes(v['spilled_bytes'])}")
    if v.get("io_bytes", 0):
        parts.append(f"io={_fmt_bytes(v['io_bytes'])}")
    for k in sorted(v):
        if k not in BASELINE_METRICS and v[k]:
            parts.append(f"{k}={v[k]}")
    return f"{node.name or '?'}  [{' '.join(parts)}]"


def render_tree(node: MetricNode, indent: str = "", last: bool = True,
                root: bool = True) -> List[str]:
    if root:
        lines = [_node_line(node)]
        child_indent = ""
    else:
        branch = "└─ " if last else "├─ "
        lines = [indent + branch + _node_line(node)]
        child_indent = indent + ("   " if last else "│  ")
    for i, c in enumerate(node.children):
        lines.extend(render_tree(c, child_indent,
                                 last=(i == len(node.children) - 1),
                                 root=False))
    return lines


def _footers(x: Dict[str, int]) -> List[str]:
    """The counter lines under the tree, each only where it moved."""
    lines = [
        f"compiles: builds_and_captures={x.get('total_compiles', 0)} "
        f"found_built={x.get('total_cache_hits', 0)} "
        f"compile_time={_fmt_ns(x.get('total_compile_ns', 0))}",
        f"transfers: h2d={_fmt_bytes(x.get('h2d_bytes', 0))} "
        f"({x.get('h2d_transfers', 0)}) "
        f"d2h={_fmt_bytes(x.get('d2h_bytes', 0))} "
        f"({x.get('d2h_transfers', 0)})"]
    launch_keys = ("placement_launches", "radix_launches",
                   "segment_sum_launches", "window_step_launches",
                   "join_probe_cuda_calls", "join_probe_cpu_calls")
    if any(x.get(k) for k in launch_keys):
        lines.append(
            f"kernel launches: placement={x.get('placement_launches', 0)} "
            f"radix={x.get('radix_launches', 0)} "
            f"segment_sum={x.get('segment_sum_launches', 0)} "
            f"window_step={x.get('window_step_launches', 0)} "
            f"join_probe=cuda:{x.get('join_probe_cuda_calls', 0)}"
            f"/cpu:{x.get('join_probe_cpu_calls', 0)}")
    if x.get("bucket_batches"):
        lines.append(
            f"batch shaping: bucketed_caps={x.get('bucket_batches', 0)} "
            f"new_buckets={x.get('distinct_buckets', 0)} "
            f"pad_rows={x.get('bucket_pad_rows', 0)}")
    if x.get("prefetch_batches") or x.get("prefetch_wait_ns"):
        lines.append(
            f"prefetch: batches={x.get('prefetch_batches', 0)} "
            f"consumer_wait={_fmt_ns(x.get('prefetch_wait_ns', 0))} "
            f"({x.get('prefetch_waits', 0)} waits)")
    if (x.get("expr_fused_batches") or x.get("expr_eager_batches")
            or x.get("expr_programs_built")):
        looked_up = (x.get("expr_programs_built", 0)
                     + x.get("expr_program_cache_hits", 0))
        rate = (x.get("expr_program_cache_hits", 0) / looked_up
                if looked_up else 0.0)
        lines.append(
            f"expr programs: built={x.get('expr_programs_built', 0)} "
            f"cache_hits={x.get('expr_program_cache_hits', 0)} "
            f"(hit_rate={rate:.2f}) "
            f"fused_batches={x.get('expr_fused_batches', 0)} "
            f"eager_batches={x.get('expr_eager_batches', 0)} "
            f"evictions={x.get('expr_program_evictions', 0)}")
    if x.get("partial_agg_skip_events") or x.get("partial_agg_probe_rows"):
        probe_rows = x.get("partial_agg_probe_rows", 0)
        ratio = (x.get("partial_agg_probe_groups", 0) / probe_rows
                 if probe_rows else 0.0)
        events = x.get("partial_agg_skip_events", 0)
        switch_row = (x.get("partial_agg_switch_rows", 0) // events
                      if events else 0)
        lines.append(
            f"partial agg: probe_ratio={ratio:.2f} "
            f"skip_events={events} switch_row={switch_row} "
            f"passed_rows={x.get('partial_agg_skipped_rows', 0)} "
            f"spill_switches={x.get('partial_agg_spill_switches', 0)}")
    if any(x.get(k) for k in ("task_retries", "task_failures",
                              "fetch_failures", "stage_recoveries")):
        lines.append(
            f"fault tolerance: attempts={x.get('task_attempts', 0)} "
            f"retries={x.get('task_retries', 0)} "
            f"retry_wait={_fmt_ns(x.get('task_retry_wait_ns', 0))} "
            f"failures={x.get('task_failures', 0)} "
            f"fetch_failures={x.get('fetch_failures', 0)} "
            f"recoveries={x.get('stage_recoveries', 0)} "
            f"recovered_map_tasks={x.get('recovered_map_tasks', 0)}")
    aqe_line = format_aqe_footer(x)
    if aqe_line is not None:
        lines.append(aqe_line)
    if x.get("shuffle_host_bytes"):
        lines.append(
            f"shuffle: host={_fmt_bytes(x.get('shuffle_host_bytes', 0))}")
    if any(x.get(k) for k in ("stage_loop_tasks", "stage_loop_fallbacks")):
        lines.append(
            f"stage loop: tasks={x.get('stage_loop_tasks', 0)} "
            f"programs={x.get('stage_loop_calls', 0)} "
            f"batches={x.get('stage_loop_batches', 0)} "
            f"rows={x.get('stage_loop_rows', 0)} "
            f"dispatches_avoided="
            f"{x.get('stage_loop_staged_dispatches_avoided', 0)} "
            f"regrows={x.get('stage_loop_regrows', 0)} "
            f"fallbacks={x.get('stage_loop_fallbacks', 0)}")
    if x.get("stream_epochs"):
        epochs = x.get("stream_epochs", 0)
        wall = x.get("stream_epoch_wall_ns", 0)
        lines.append(
            f"stream: epochs={epochs} "
            f"epoch_wall={_fmt_ns(wall // max(1, epochs))}/avg "
            f"rows={x.get('stream_rows', 0)} "
            f"records={x.get('stream_records', 0)} "
            f"late={x.get('stream_late_records', 0)} "
            f"watermark_delay={x.get('stream_watermark_delay_ms_last', 0)}ms "
            f"state={_fmt_bytes(x.get('stream_window_state_bytes_last', 0))} "
            f"lag={x.get('stream_source_lag_records_last', 0)} "
            f"ckpts={x.get('stream_checkpoints', 0)} "
            f"recoveries={x.get('stream_recoveries', 0)} "
            f"sink_commits={x.get('stream_sink_commits', 0)} "
            f"dup_skips={x.get('stream_sink_dup_skips', 0)}")
    lane_keys = ("scatter_lane_hash_pallas", "scatter_lane_hash_scatter",
                 "scatter_lane_partition_pallas",
                 "scatter_lane_partition_scatter")
    if any(x.get(k) for k in lane_keys):
        lines.append(
            "scatter lanes: hash="
            f"{x.get('scatter_lane_hash_pallas', 0)}p/"
            f"{x.get('scatter_lane_hash_scatter', 0)}s "
            "partition="
            f"{x.get('scatter_lane_partition_pallas', 0)}p/"
            f"{x.get('scatter_lane_partition_scatter', 0)}s")
    return lines


@dataclass
class QueryProfile:
    """One executed query's merged profile (the /profile/<qid> payload).
    `counters` is the registry's delta over the run (the reference's
    `xla`), `kernels` the compile report (nvcc builds, graph captures)."""
    query_id: str
    wall_ns: int
    tree: MetricNode
    partitions: int
    exec_mode: str
    counters: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, dict] = field(default_factory=dict)
    placement: str = ""
    output_rows: int = 0
    # bridge/critical_path.py bottleneck_report over the run's spans;
    # None when tracing was off
    bottleneck: Optional[dict] = None
    # the result table, under keep_result=True only; NOT serialized
    result: Optional[Any] = None

    def to_dict(self) -> dict:
        d = {
            "query_id": self.query_id,
            "wall_ns": self.wall_ns,
            "tree": self.tree.to_dict(),
            "partitions": self.partitions,
            "exec_mode": self.exec_mode,
            "counters": dict(self.counters),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "placement": self.placement,
            "output_rows": self.output_rows,
        }
        if self.bottleneck is not None:
            d["bottleneck"] = self.bottleneck
        return d

    def render_text(self) -> str:
        lines = [f"== query profile {self.query_id} "
                 f"(wall {_fmt_ns(self.wall_ns)}, "
                 f"{self.partitions} partition(s), "
                 f"mode={self.exec_mode}, placement={self.placement}) =="]
        lines.extend(render_tree(self.tree))
        lines.extend(_footers(self.counters))
        bn_line = format_bottleneck_footer(self.bottleneck)
        if bn_line is not None:
            lines.append(bn_line)
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render_text()


def _run_execution_plan(plan, keep_result: bool) -> tuple:
    """Every partition of an operator tree through the task runtime;
    returns (merged tree, partitions, rows, table or None)."""
    import pyarrow as pa

    from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime

    n = plan.num_partitions
    merged = MetricNode()
    rows = 0
    batches = []
    for p in range(n):
        rt = NativeExecutionRuntime(
            {"stage_id": 0, "partition_id": p, "num_partitions": n},
            plan=plan).start()
        # the tree may be shared across partition runtimes (counters
        # accumulate on the same nodes): keep each partition's delta
        before = rt.plan.collect_metrics()
        try:
            for rb in rt.batches():
                rows += rb.num_rows
                if keep_result:
                    batches.append(rb)
        finally:
            after = rt.finalize()
        merged.merge_from(after.diff(before))
    table = None
    if keep_result:
        table = (pa.Table.from_batches(batches) if batches
                 else pa.Table.from_batches([], schema=plan.schema.to_arrow()))
    return merged, n, rows, table


_READER_NODES = ("IpcReaderExec", "FFIReaderExec")


def _stitch_stages(tree: MetricNode, deps: List[int], sched) -> MetricNode:
    """Reconnect producer-stage metric trees under the reader nodes that
    consumed them, recreating the whole operator tree.  Reader nodes
    appear in the result tree in the DFS order the splitter found the
    exchanges (Stage.deps order).  Works on copies: the scheduler's
    per-stage trees stay as they were."""
    tree = tree.snapshot()
    pending = list(deps)

    def walk(node: MetricNode) -> None:
        # snapshot: an appended subtree was stitched with its OWN stage's
        # deps; walking into it would consume this level's
        children = list(node.children)
        if node.name in _READER_NODES and pending:
            sid = pending.pop(0)
            sub = sched.stage_metrics.get(sid)
            if sub is not None and sid < len(sched.stages):
                node.children.append(
                    _stitch_stages(sub, sched.stages[sid].deps, sched))
        for c in children:
            walk(c)

    walk(tree)
    return tree


def _run_plan_dict(plan: Dict[str, Any], work_dir: Optional[str],
                   sched=None) -> tuple:
    """An engine-IR dict through the stage DAG scheduler."""
    from blaze_tpu_torch.plan.stages import DagScheduler

    if sched is None:
        sched = DagScheduler(work_dir=work_dir)
    table = sched.run_collect(plan)
    tree = sched.collect_metrics() or MetricNode()
    staged = sched.exec_mode == "staged" and sched.stages
    if staged:
        tree = _stitch_stages(tree, sched.stages[-1].deps, sched)
    partitions = sched.stages[-1].num_tasks if staged else 1
    return (tree, partitions, table.num_rows, sched.exec_mode or "local",
            table)


def explain_analyze(plan: Union[Dict[str, Any], Any], *,
                    query_id: Optional[str] = None,
                    work_dir: Optional[str] = None,
                    record: bool = True,
                    keep_result: bool = False,
                    scheduler=None) -> QueryProfile:
    """Execute `plan` (an ExecutionPlan or an engine-IR dict) and return
    the merged query profile.

    `print(explain_analyze(plan))` renders the annotated operator tree;
    `.to_dict()` is the JSON served on /profile/<qid> when `record`.
    With `keep_result` the output table rides along on `.result`.  A
    plan dict runs on `scheduler` where one is given (a DagScheduler the
    caller reads afterwards), else on a fresh one in `work_dir`."""
    from blaze_tpu_torch.bridge import device_stats, profiling, tracing
    from blaze_tpu_torch.device import resolve
    from blaze_tpu_torch.ops.base import ExecutionPlan

    device = resolve()
    if query_id is None:
        from blaze_tpu_torch.convert.spark import next_query_id
        query_id = next_query_id()
    before = device_stats.snapshot()
    t0 = time.perf_counter_ns()
    with tracing.execution_context(query=query_id), \
            tracing.span("explain_analyze", query=query_id):
        if isinstance(plan, ExecutionPlan):
            tree, partitions, rows, table = _run_execution_plan(
                plan, keep_result)
            mode = "local"
        else:
            tree, partitions, rows, mode, table = _run_plan_dict(
                plan, work_dir, scheduler)
    wall_ns = time.perf_counter_ns() - t0

    bottleneck = None
    spans = tracing.spans_for_query(query_id)
    if spans:
        from blaze_tpu_torch.bridge import critical_path
        bottleneck = critical_path.bottleneck_report(spans, wall_ns / 1e9)

    profile = QueryProfile(
        query_id=query_id, wall_ns=wall_ns, tree=tree,
        partitions=partitions, exec_mode=mode,
        counters=device_stats.delta(before),
        kernels=device_stats.compile_report()["kernels"],
        placement=device.type, output_rows=rows, bottleneck=bottleneck,
        result=table if keep_result else None)
    if record:
        profiling.record_profile(query_id, profile.to_dict())
    return profile
