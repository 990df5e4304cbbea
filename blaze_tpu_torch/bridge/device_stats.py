"""Process-wide counter registry of the port: transfers, the IO pipeline,
fault tolerance, the stage loop, partial aggregation, the kernel lanes,
the host exchange, latency histograms, and what the port compiles.

The counterpart of blaze_tpu/bridge/xla_stats.py, under the reference's
counter names wherever the port has the same site.  The port compiles
nothing with XLA, so `compile_report` counts the port's own compilation
instead: the hand kernels' lazy `nvcc` builds (kernels/build.py) and the
CUDA graph captures of the stage loop and of the expression programs
(runtime/loop.py, exprs/program.py), each a "kernel" of the report with
its calls and nanoseconds.  `snapshot()` also reads the
launch counters the kernel wrappers keep (placement, radix, segment_sum,
window_step, the join probe), so `explain_analyze` shows them beside the
rest.

The statistics-plane (`stats`) and adaptive-execution (`aqe`) families
are the reference's, fed by plan/statstore.py and plan/adaptive.py; the
`serving` family sums the query services' admission and outcome counters
(serving/service.py), `faults_injected` counts the injector's fires
(faults.py), and the `stream` family is the streaming runtime's
(streaming/executor.py, streaming/checkpoint.py,
convert/flink_runtime.py), under the reference's names.  These counters are process-wide: with several queries in
flight none of them can be read per query.

Not carried over (ROADMAP Queue 1): the worker-pool, speculation,
observability-plane, cache, fleet and device-exchange
families, the encoding family but its host evictions
(the dictionary and decimal-tier counters), frame compression, the stage-program cache and the lane declines and
fault fallbacks; the port has no site for them yet (item 16 and the
slices of those subsystems add each back with its site).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

_lock = threading.Lock()

_transfers = {"h2d_bytes": 0, "h2d_transfers": 0,
              "d2h_bytes": 0, "d2h_transfers": 0}
# batch shaping and the IO pipeline (batch.bucket_capacity,
# ops.base.PrefetchIterator): capacity requests quantized onto the bucket
# ladder and the padding that cost; batches delivered through a prefetch
# queue and the time the consumer blocked on it (0 = IO fully overlapped)
_pipeline = {"bucket_batches": 0, "bucket_pad_rows": 0,
             "prefetch_batches": 0, "prefetch_wait_ns": 0,
             "prefetch_waits": 0}
_bucket_caps: set = set()

# expression programs (exprs/program.py): programs resolve by
# fingerprint, so every partition's evaluator shares one program; a batch
# runs fused (one program) or eager
_exprs = {"expr_programs_built": 0, "expr_program_cache_hits": 0,
          "expr_program_evictions": 0,
          "expr_fused_batches": 0, "expr_eager_batches": 0}

# chains that left the device lanes, by the dtype of the first column the
# gates rejected (exprs/program.py eviction_reason)
_encoding = {"host_evictions_string": 0, "host_evictions_decimal": 0,
             "host_evictions_other": 0}

# fault tolerance (bridge/tasks.py, the shuffle readers, plan/stages.py
# lineage recovery)
_faults = {"task_attempts": 0, "task_retries": 0, "task_retry_wait_ns": 0,
           "task_failures": 0, "fetch_failures": 0, "stage_recoveries": 0,
           "recovered_map_tasks": 0, "faults_injected": 0}

# the query service (serving/service.py), over every service of the
# process: its per-service `counters` under a `serving_` prefix
_serving = {"serving_admitted": 0, "serving_completed": 0,
            "serving_failed": 0, "serving_cancelled": 0,
            "serving_deadline": 0, "serving_shed_queue_full": 0,
            "serving_shed_tenant_quota": 0, "serving_shed_memory": 0,
            "serving_shed_injected": 0}

# the host file exchange (plan/stages.py)
_shuffle = {"shuffle_host_bytes": 0}

# the device stage loop (plan/stage_compiler.py, runtime/loop.py)
_stage_loop = {"stage_loop_programs_built": 0,
               "stage_loop_calls": 0, "stage_loop_chunks": 0,
               "stage_loop_batches": 0, "stage_loop_rows": 0,
               "stage_loop_tasks": 0, "stage_loop_regrows": 0,
               "stage_loop_fallbacks": 0,
               "stage_loop_staged_dispatches_avoided": 0}

# adaptive partial aggregation (ops/agg/exec.py)
_agg = {"partial_agg_skip_events": 0, "partial_agg_skipped_rows": 0,
        "partial_agg_probe_rows": 0, "partial_agg_probe_groups": 0,
        "partial_agg_switch_rows": 0, "partial_agg_spill_switches": 0}

# kernel-lane resolutions (kernels/lane.py): the reference's `pallas`
# lane is the port's hand CUDA kernel, its `scatter` formulation the
# plain PyTorch version on the CPU.  The reference's interpret lane, its
# VMEM declines and its lane fault fallbacks have no site in the port
# (kernels/lane.py says why)
_scatter_lane = {"scatter_lane_hash_pallas": 0,
                 "scatter_lane_hash_scatter": 0,
                 "scatter_lane_partition_pallas": 0,
                 "scatter_lane_partition_scatter": 0}

# the statistics feedback plane (plan/statstore.py): observations ingested,
# ingests that merged onto an earlier run, advisor findings, ETA seeds
# (no site in the port: they come with the serving progress registry), and
# the store's fingerprint count
_stats = {"stats_ingests": 0, "stats_runs_merged": 0,
          "stats_advisor_findings": 0, "stats_eta_seeded": 0,
          "stats_fingerprints_last": 0}

# adaptive execution (plan/adaptive.py): runtime rewrites at stage
# boundaries by rule, plans seeded from history at bind time, producer
# stages elided (their exchange never ran) and the estimated shuffle bytes
# those rewrites avoided
_aqe = {"aqe_rewrites": 0, "aqe_broadcast_switches": 0,
        "aqe_partitions_coalesced": 0, "aqe_skew_splits": 0,
        "aqe_history_seeds": 0, "aqe_bytes_saved": 0,
        "aqe_stages_elided": 0}

# the streaming runtime (streaming/executor.py StreamExecutor): committed
# epochs and their wall, rows and records through the pipeline, late-record
# routing, checkpoint commits, recovery rounds and the exactly-once sink's
# outcomes; the *_last entries are gauges (the latest observation):
# watermark delay, window-state bytes and source lag
_stream = {"stream_epochs": 0, "stream_epoch_wall_ns": 0,
           "stream_rows": 0, "stream_records": 0,
           "stream_late_records": 0, "stream_late_side_rows": 0,
           "stream_checkpoints": 0, "stream_checkpoint_bytes": 0,
           "stream_recoveries": 0, "stream_replayed_epochs": 0,
           "stream_sink_commits": 0, "stream_sink_dup_skips": 0,
           "stream_watermark_delay_ms_last": 0,
           "stream_window_state_bytes_last": 0,
           "stream_source_lag_records_last": 0}

# what the port compiles: name -> {"calls", "compiles", "cache_hits",
# "compile_ns"}; kernels/build.py notes each nvcc build, runtime/loop.py
# each graph capture
_compiles: Dict[str, Dict[str, int]] = {}

# bounded raw-sample reservoirs (ns) of successful task attempts and
# run_tasks waves, read as histograms
_task_duration_ns: List[int] = []
_wave_wall_ns: List[int] = []
_SAMPLE_CAP = 8192
# per-thread lists of open task-duration sinks (open_task_sink)
_task_sinks = threading.local()

HISTOGRAM_BUCKETS_S = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0)


def note_h2d(nbytes: int) -> None:
    if nbytes <= 0:
        return
    with _lock:
        _transfers["h2d_bytes"] += int(nbytes)
        _transfers["h2d_transfers"] += 1


def note_d2h(nbytes: int) -> None:
    if nbytes <= 0:
        return
    with _lock:
        _transfers["d2h_bytes"] += int(nbytes)
        _transfers["d2h_transfers"] += 1


def note_bucket(capacity: int, pad_rows: int) -> None:
    """One capacity request quantized onto the bucket ladder."""
    with _lock:
        _pipeline["bucket_batches"] += 1
        _pipeline["bucket_pad_rows"] += max(0, int(pad_rows))
        _bucket_caps.add(int(capacity))


def note_prefetch(batches: int = 0, wait_ns: int = 0) -> None:
    """Consumer-side prefetch accounting: `batches` delivered through a
    prefetch queue, `wait_ns` the consumer blocked on it."""
    with _lock:
        _pipeline["prefetch_batches"] += int(batches)
        if wait_ns > 0:
            _pipeline["prefetch_wait_ns"] += int(wait_ns)
            _pipeline["prefetch_waits"] += 1


def note_expr_program(built: bool = False, cache_hit: bool = False,
                      evicted: bool = False) -> None:
    """One program-cache resolution (exprs/program.py get_program)."""
    with _lock:
        _exprs["expr_programs_built"] += int(built)
        _exprs["expr_program_cache_hits"] += int(cache_hit)
        _exprs["expr_program_evictions"] += int(evicted)


def note_expr_dispatch(fused: int = 0, eager: int = 0) -> None:
    """Batches through a program (`fused`) or the eager evaluator."""
    with _lock:
        _exprs["expr_fused_batches"] += int(fused)
        _exprs["expr_eager_batches"] += int(eager)


def note_host_eviction(reason: str) -> None:
    """A chain left the device lanes; `reason` string/decimal/other."""
    with _lock:
        _encoding[f"host_evictions_{reason}"] += 1


def expr_stats() -> dict:
    """The expression-program counters and `expr_cache_hit_rate`, hits
    over cache resolutions (a ratio, so not in `snapshot`)."""
    with _lock:
        d = dict(_exprs)
    looked_up = d["expr_programs_built"] + d["expr_program_cache_hits"]
    d["expr_cache_hit_rate"] = (d["expr_program_cache_hits"] / looked_up
                                if looked_up else 0.0)
    return d


def note_task_attempts(attempts: int = 1, retry_wait_ns: int = 0,
                       failed: bool = False) -> None:
    """One task reached a terminal state after `attempts` tries, having
    slept `retry_wait_ns` in backoff (bridge/tasks.py)."""
    with _lock:
        _faults["task_attempts"] += int(attempts)
        _faults["task_retries"] += max(0, int(attempts) - 1)
        _faults["task_retry_wait_ns"] += int(retry_wait_ns)
        if failed:
            _faults["task_failures"] += 1


def note_fetch_failure() -> None:
    """One shuffle block failed verification or its read
    (FetchFailedError)."""
    with _lock:
        _faults["fetch_failures"] += 1


def note_fault_injected() -> None:
    """The chaos injector fired one scripted fault (faults.py)."""
    with _lock:
        _faults["faults_injected"] += 1


def note_serving(**counts: int) -> None:
    """Add to the query service's counters (serving/service.py), by their
    names without the `serving_` prefix; an unknown name is ignored."""
    with _lock:
        for k, v in counts.items():
            key = f"serving_{k}"
            if key in _serving:
                _serving[key] += int(v)


def note_stage_recovery(map_tasks: int = 1) -> None:
    """One lineage-recovery round re-ran `map_tasks` producer tasks."""
    with _lock:
        _faults["stage_recoveries"] += 1
        _faults["recovered_map_tasks"] += int(map_tasks)




def note_task_duration(ns: int) -> None:
    """One successful task attempt's wall time, into the reservoir and
    into every sink this thread has open."""
    with _lock:
        if len(_task_duration_ns) < _SAMPLE_CAP:
            _task_duration_ns.append(int(ns))
    for sink in getattr(_task_sinks, "open", ()):
        sink.append(int(ns))


def open_task_sink() -> List[int]:
    """A list that takes every task duration this thread notes until
    `close_task_sink`, uncapped: one run's durations for plan/stages.py's
    statistics ingest, which the reservoir stops taking at _SAMPLE_CAP.
    bridge/tasks.py runs a scheduler's tasks on its own thread."""
    sink: List[int] = []
    if not hasattr(_task_sinks, "open"):
        _task_sinks.open = []
    _task_sinks.open.append(sink)
    return sink


def close_task_sink(sink: List[int]) -> None:
    _task_sinks.open = [s for s in getattr(_task_sinks, "open", ())
                        if s is not sink]


def note_wave_wall(ns: int) -> None:
    """One run_tasks wave's wall time, first task to last result."""
    with _lock:
        if len(_wave_wall_ns) < _SAMPLE_CAP:
            _wave_wall_ns.append(int(ns))


def duration_samples() -> Dict[str, List[int]]:
    """Raw ns samples: {"task_ns": [...], "wave_ns": [...]}, the first
    _SAMPLE_CAP of each since the last reset (one run's task durations
    come from `open_task_sink`)."""
    with _lock:
        return {"task_ns": list(_task_duration_ns),
                "wave_ns": list(_wave_wall_ns)}


def _histogram(samples_ns: List[int]) -> Dict[str, Any]:
    """Cumulative-bucket Prometheus histogram over an ns reservoir:
    {"buckets": [(le_seconds, cumulative_count), ...], "sum": seconds,
    "count": n}."""
    counts = [0] * len(HISTOGRAM_BUCKETS_S)
    total = 0.0
    for ns in samples_ns:
        s = ns / 1e9
        total += s
        for bi, le in enumerate(HISTOGRAM_BUCKETS_S):
            if s <= le:
                counts[bi] += 1
    return {"buckets": list(zip(HISTOGRAM_BUCKETS_S, counts)),
            "sum": total, "count": len(samples_ns)}


def latency_histograms() -> Dict[str, Dict[str, Any]]:
    with _lock:
        task = list(_task_duration_ns)
        wave = list(_wave_wall_ns)
    return {"task_duration_seconds": _histogram(task),
            "wave_wall_seconds": _histogram(wave)}


def note_host_exchange(nbytes: int) -> None:
    """One producer stage's map outputs landed in host shuffle files
    (`nbytes`: their .data bytes)."""
    with _lock:
        _shuffle["shuffle_host_bytes"] += int(nbytes)


def note_stage_program() -> None:
    """A stage program was compiled (the port keeps no program cache)."""
    with _lock:
        _stage_loop["stage_loop_programs_built"] += 1


def note_stage_loop_task(chunks: int, batches: int, rows: int,
                         regrows: int, dispatches_avoided: int) -> None:
    """One task folded through the stage loop: `chunks` steps over
    `batches` batches and `rows` rows, `regrows` table growths; the
    staged path would have issued `dispatches_avoided` more per-batch
    steps."""
    with _lock:
        _stage_loop["stage_loop_tasks"] += 1
        _stage_loop["stage_loop_calls"] += int(chunks)
        _stage_loop["stage_loop_chunks"] += int(chunks)
        _stage_loop["stage_loop_batches"] += int(batches)
        _stage_loop["stage_loop_rows"] += int(rows)
        _stage_loop["stage_loop_regrows"] += int(regrows)
        _stage_loop["stage_loop_staged_dispatches_avoided"] += \
            int(dispatches_avoided)


def note_stage_loop_fallback() -> None:
    """A stage-loop task declined and re-ran through the staged path."""
    with _lock:
        _stage_loop["stage_loop_fallbacks"] += 1




def note_partial_agg_probe(rows: int, groups: int) -> None:
    """One cardinality probe over `rows` rows that found `groups`."""
    with _lock:
        _agg["partial_agg_probe_rows"] += int(rows)
        _agg["partial_agg_probe_groups"] += int(groups)


def note_partial_agg_skip(switch_row: int, on_spill: bool = False) -> None:
    """One partial aggregation switched to pass-through after
    `switch_row` rows; `on_spill` when a spill forced it."""
    with _lock:
        _agg["partial_agg_skip_events"] += 1
        _agg["partial_agg_switch_rows"] += int(switch_row)
        if on_spill:
            _agg["partial_agg_spill_switches"] += 1


def note_partial_agg_rows(rows: int) -> None:
    """Rows passed through un-aggregated."""
    with _lock:
        _agg["partial_agg_skipped_rows"] += int(rows)




def _note_family(family: Dict[str, int], prefix: str,
                 deltas: Dict[str, int]) -> None:
    """kwargs name the family's keys with or without `prefix`; gauges
    (`*_last`) are set absolutely, counters are incremented, unknown keys
    are ignored."""
    with _lock:
        for k, v in deltas.items():
            key = k if k.startswith(prefix) else prefix + k
            if key not in family:
                continue
            if key.endswith("_last"):
                family[key] = int(v)
            else:
                family[key] += int(v)


def note_stats(**deltas: int) -> None:
    """Statistics-plane mutator (keys with or without `stats_`)."""
    _note_family(_stats, "stats_", deltas)


def statstore_stats() -> dict:
    with _lock:
        return dict(_stats)


def note_aqe(**deltas: int) -> None:
    """Adaptive-execution mutator (keys with or without `aqe_`)."""
    _note_family(_aqe, "aqe_", deltas)


def aqe_stats() -> dict:
    with _lock:
        return dict(_aqe)


def note_stream_epoch(wall_ns: int, rows: int = 0,
                      records: int = 0) -> None:
    """One committed micro-batch epoch: wall time, sink rows emitted,
    source records consumed."""
    with _lock:
        _stream["stream_epochs"] += 1
        _stream["stream_epoch_wall_ns"] += int(wall_ns)
        _stream["stream_rows"] += int(rows)
        _stream["stream_records"] += int(records)


def note_stream_late(records: int, side_rows: int = 0) -> None:
    """Late records seen past the watermark; `side_rows` the ones routed
    to the late-side output (policy `side`)."""
    with _lock:
        _stream["stream_late_records"] += int(records)
        _stream["stream_late_side_rows"] += int(side_rows)


def note_stream_checkpoint(nbytes: int = 0) -> None:
    with _lock:
        _stream["stream_checkpoints"] += 1
        _stream["stream_checkpoint_bytes"] += int(nbytes)


def note_stream_recovery(replayed_epochs: int = 0) -> None:
    """One recovery round: a restore from the last committed manifest."""
    with _lock:
        _stream["stream_recoveries"] += 1
        _stream["stream_replayed_epochs"] += int(replayed_epochs)


def note_stream_sink(committed: int = 0, dup_skips: int = 0) -> None:
    """Exactly-once sink outcomes: first-wins commits, and replays
    skipped because their epoch's manifest already existed."""
    with _lock:
        _stream["stream_sink_commits"] += int(committed)
        _stream["stream_sink_dup_skips"] += int(dup_skips)


def note_stream_gauges(watermark_delay_ms: Optional[int] = None,
                       window_state_bytes: Optional[int] = None,
                       source_lag_records: Optional[int] = None) -> None:
    """The latest watermark delay, window-state bytes and unread source
    records."""
    with _lock:
        if watermark_delay_ms is not None:
            _stream["stream_watermark_delay_ms_last"] = \
                int(watermark_delay_ms)
        if window_state_bytes is not None:
            _stream["stream_window_state_bytes_last"] = \
                int(window_state_bytes)
        if source_lag_records is not None:
            _stream["stream_source_lag_records_last"] = \
                int(source_lag_records)


def stream_stats() -> dict:
    with _lock:
        return dict(_stream)


def note_scatter_lane(kind: str, lane: str) -> None:
    """One kernel-lane resolution: kind hash/partition, lane
    pallas/scatter."""
    key = f"scatter_lane_{kind}_{lane}"
    with _lock:
        if key in _scatter_lane:
            _scatter_lane[key] += 1




def note_compile(name: str, ns: int) -> None:
    """The port compiled `name` (an nvcc build, a graph capture) in
    `ns` nanoseconds."""
    with _lock:
        e = _compiles.setdefault(name, {"calls": 0, "compiles": 0,
                                        "cache_hits": 0, "compile_ns": 0})
        e["calls"] += 1
        e["compiles"] += 1
        e["compile_ns"] += int(ns)


def note_compile_hit(name: str) -> None:
    """A compiled artifact was found built (a library on disk)."""
    with _lock:
        e = _compiles.setdefault(name, {"calls": 0, "compiles": 0,
                                        "cache_hits": 0, "compile_ns": 0})
        e["calls"] += 1
        e["cache_hits"] += 1


def compile_report() -> dict:
    """Per-artifact compile stats and totals, JSON-ready."""
    with _lock:
        kernels = {k: dict(v) for k, v in sorted(_compiles.items())}
    totals = {"calls": 0, "compiles": 0, "cache_hits": 0, "compile_ns": 0}
    for e in kernels.values():
        for k in totals:
            totals[k] += e[k]
    return {"kernels": kernels, "totals": totals}


def launch_counts() -> Dict[str, int]:
    """The kernel wrappers' launch counters, read where they are kept:
    placement (eager calls plus each replay's nodes), radix (partition
    calls and its two kernels), window_step, segment_sum by form, and the
    join probe by device."""
    from blaze_tpu_torch.kernels import hash_update, join, radix, sort, \
        window_table
    out = {"placement_launches": hash_update.placement_launches,
           "radix_launches": radix.partition_launches,
           "radix_upsweep_kernels": radix.kernel_launches["upsweep"],
           "radix_downsweep_kernels": radix.kernel_launches["downsweep"],
           "window_step_launches": window_table.window_step_launches,
           "segment_sum_launches": sum(sort.form_launches.values())}
    for form, n in sort.form_launches.items():
        out[f"segment_sum_{form}_launches"] = n
    for dev, n in join.probe_calls.items():
        out[f"join_probe_{dev}_calls"] = n
    return out




def pipeline_stats() -> dict:
    with _lock:
        d = dict(_pipeline)
        d["distinct_buckets"] = len(_bucket_caps)
        d["bucket_capacities"] = sorted(_bucket_caps)
        return d


def counter_families() -> Dict[str, Dict[str, int]]:
    """Every flat counter, by family (the Prometheus exposition iterates
    these); the launch counters are a family of their own."""
    with _lock:
        fams = {"transfers": dict(_transfers),
                "pipeline": dict(_pipeline),
                "faults": dict(_faults),
                "shuffle": dict(_shuffle),
                "stage_loop": dict(_stage_loop),
                "agg": dict(_agg),
                "scatter_lane": dict(_scatter_lane),
                "exprs": dict(_exprs),
                "stats": dict(_stats),
                "aqe": dict(_aqe),
                "encoding": dict(_encoding),
                "serving": dict(_serving),
                "stream": dict(_stream)}
    fams["launches"] = launch_counts()
    return fams


def snapshot() -> dict:
    """Flat counter snapshot for before/after deltas (explain_analyze)."""
    flat: Dict[str, int] = {}
    for fam in counter_families().values():
        flat.update(fam)
    ps = pipeline_stats()
    flat["distinct_buckets"] = ps["distinct_buckets"]
    flat.update({f"total_{k}": v
                 for k, v in compile_report()["totals"].items()})
    return flat


def delta(before: dict) -> dict:
    now = snapshot()
    return {k: now.get(k, 0) - before.get(k, 0) for k in now}


def reset() -> None:
    """Test helper: clear every counter this module keeps (the kernel
    wrappers' launch counters are theirs)."""
    with _lock:
        for d in (_transfers, _pipeline, _faults, _shuffle, _stage_loop,
                  _agg, _scatter_lane, _exprs, _stats, _aqe, _encoding,
                  _serving, _stream):
            for k in d:
                d[k] = 0
        _compiles.clear()
        _task_duration_ns.clear()
        _wave_wall_ns.clear()
        _bucket_caps.clear()
