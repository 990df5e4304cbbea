"""Layered typed configuration (the PyTorch port's copy).

The option system of `blaze_tpu/config.py`, cut to the keys this package
reads.  Every key keeps its `auron.*` (or `io.*`) name and default, so one
set of overrides drives both packages; `auron.torch.device` is the port's
own.  A key of the JAX package that is not defined here has no effect on
the port: TPU concerns such as `auron.tpu.kernels.pallas` and its VMEM
budget are not carried over (see `kernels/lane.py`).

A host engine or test harness supplies key->string overrides through the
single `conf` session; operators read typed values through the module-level
`ConfigOption` objects.  An environment variable `BLAZE_TPU_<KEY>` (dots as
underscores, upper case) applies where no override is set.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional


@dataclass(frozen=True)
class ConfigOption:
    """Typed config key with its default, doc and alternative keys (read
    after `key`, in order, as the JAX package reads them)."""

    key: str
    default: Any
    parse: Callable[[str], Any]
    doc: str = ""
    alt_keys: tuple = ()
    category: str = "core"

    @property
    def keys(self) -> tuple:
        return (self.key, *self.alt_keys)

    def get(self, session: Optional["ConfSession"] = None) -> Any:
        return (session or conf).get(self)

    @property
    def env_key(self) -> str:
        return _env_key(self.key)


def _env_key(key: str) -> str:
    return "BLAZE_TPU_" + key.upper().replace(".", "_")


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def int_conf(key: str, default: int, doc: str = "",
             alt_keys: tuple = (), category: str = "core"
             ) -> ConfigOption:
    return ConfigOption(key, default, int, doc, alt_keys, category)


def float_conf(key: str, default: float, doc: str = "",
               alt_keys: tuple = (), category: str = "core"
               ) -> ConfigOption:
    return ConfigOption(key, default, float, doc, alt_keys, category)


def bool_conf(key: str, default: bool, doc: str = "",
              alt_keys: tuple = (), category: str = "core"
              ) -> ConfigOption:
    return ConfigOption(key, default, _parse_bool, doc, alt_keys, category)


def str_conf(key: str, default: str, doc: str = "",
             alt_keys: tuple = (), category: str = "core"
             ) -> ConfigOption:
    return ConfigOption(key, default, str, doc, alt_keys, category)


class ConfSession:
    """Mutable override store; thread-safe; env `BLAZE_TPU_<KEY>` wins lowest."""

    def __init__(self, overrides: Optional[Dict[str, str]] = None):
        self._lock = threading.Lock()
        self._overrides: Dict[str, str] = dict(overrides or {})

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._overrides[key] = str(value)

    def unset(self, key: str) -> None:
        with self._lock:
            self._overrides.pop(key, None)

    def get(self, opt: ConfigOption) -> Any:
        with self._lock:
            for k in opt.keys:
                if k in self._overrides:
                    return opt.parse(self._overrides[k])
        for k in opt.keys:
            if _env_key(k) in os.environ:
                return opt.parse(os.environ[_env_key(k)])
        return opt.default

    def get_raw(self, key: str) -> Optional[str]:
        """The override (or environment) string of `key`, which need not
        be a key the port defines; None where neither sets it."""
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
        return os.environ.get(_env_key(key))

    def is_set(self, opt: ConfigOption) -> bool:
        with self._lock:
            if any(k in self._overrides for k in opt.keys):
                return True
        return any(_env_key(k) in os.environ for k in opt.keys)


#: Global session.
conf = ConfSession()


# ---------------------------------------------------------------------------
# Options, under the JAX package's names and defaults.
# ---------------------------------------------------------------------------

BATCH_SIZE = int_conf(
    "auron.batch.size", 32768,
    "Rows per batch: the scan's slice size, the coalescing target and the "
    "row count of each emitted aggregate or shuffle batch.")
BATCH_BUCKETING_ENABLE = bool_conf(
    "auron.tpu.batch.bucketing", True,
    "Quantize batch capacities onto the geometric bucket ladder "
    "(batch.bucket_capacity), so batch shapes, and the row indices inside "
    "the hash aggregation step, equal the JAX package's; off, capacities "
    "round to the 128-row lane.")
BATCH_BUCKET_MIN = int_conf(
    "auron.tpu.batch.bucket.min", 128,
    "Smallest rung of the capacity bucket ladder (rounded up to 128 rows).")
BATCH_BUCKET_GROWTH = float_conf(
    "auron.tpu.batch.bucket.growth", 2.0,
    "Geometric growth factor between bucket-ladder rungs; 2.0 gives the "
    "128*2^k ladder.")
IO_PREFETCH_ENABLE = bool_conf(
    "auron.tpu.io.prefetch", True,
    "Async pipelined executor at host-IO edges (ops/base.py "
    "PrefetchIterator): parquet row-group decode with the batch's one "
    "host-to-device copy, and shuffle IPC segment reads, run on a bounded "
    "background worker so the device never idles on host IO.  Kill-switch "
    "for debugging; depth comes from auron.tpu.io.prefetch.depth.")
IO_PREFETCH_DEPTH = int_conf(
    "auron.tpu.io.prefetch.depth", 2,
    "Bounded queue depth of the IO prefetcher; <= 0 degrades to a "
    "synchronous passthrough (same as disabling the kill-switch).")
ON_DEVICE_AGG_CAPACITY = int_conf(
    "auron.tpu.agg.table.capacity", 1 << 18,
    "Slots of the open-addressing hash aggregation table (rounded up to a "
    "power of two); a partial aggregation that overflows it passes rows "
    "through, a final one grows the table (plan/fused.py).")
FUSED_STAGE_ENABLE = bool_conf(
    "auron.tpu.fused.stage.enable", True,
    "Rewrite eligible scan->filter->partial-agg subtrees into fused "
    "aggregation operators (plan/fused.py fuse_plan).")
FUSED_STAGE_CAPACITY = int_conf(
    "auron.tpu.fused.stage.capacity", 1 << 24,
    "Max dense group-table slots (product of key ranges) for which the "
    "fuser keeps the discovered key ranges.")
AGG_MXU_ENABLE = bool_conf(
    "auron.tpu.mxuAgg.enable", True,
    "Aggregate compact dense group tables through the window-table kernel "
    "(kernels/window_table.py: an exact 8-bit-limb integer histogram) "
    "instead of per-accumulator scatters, where the key and value bounds "
    "from parquet statistics admit it.")
AGG_MXU_MAX_SLOTS = int_conf(
    "auron.tpu.mxuAgg.maxSlots", 1 << 17,
    "Dense-table slot cap for the window-table lane; larger tables take "
    "the scatter dense lane.")
AGG_MXU_FORCE = bool_conf(
    "auron.tpu.mxuAgg.force", False,
    "Run the window-table lane on the CPU too (through the kernel's plain "
    "version), as the JAX package runs it off the TPU; on a CUDA device "
    "the lane runs whenever it is planned.")
AGG_MXU_DECIMAL_SCALE = int_conf(
    "auron.tpu.mxuAgg.decimalScale", 100,
    "Fixed-point scale probed for float64 sum columns on the window-table "
    "lane (100 = two decimals); a value that fails the exactness verify "
    "re-runs the partition through the scatter dense lane.")
FUSED_DICT_DEVICE_ENABLE = bool_conf(
    "auron.tpu.fused.dictDevice", True,
    "Device lane for utf8 group keys in fused aggregations "
    "(plan/fused.py _execute_dict_device): every key column "
    "dictionary-encodes on the host against an accumulated per-key "
    "dictionary, the device groups by the packed code id into a dense "
    "table, and the keys decode back through the dictionaries at emit.")
FUSED_DICT_DEVICE_MAX_SLOTS = int_conf(
    "auron.tpu.fused.dictDevice.maxSlots", 1 << 22,
    "Dense code-table ceiling of the dict-device lane; growth past it "
    "re-runs the partition through the generic AggExec engine.")
ENCODING_DICT_ENABLE = bool_conf(
    "auron.tpu.encoding.dict.enable", False,
    "Dictionary-encode utf8 columns at scan decode (the JAX package's "
    "DictColumn).  Not ported: the port's scan raises where it is set "
    "(ROADMAP Queue 1 item 13).")
ENCODING_DECIMAL_ENABLE = bool_conf(
    "auron.tpu.encoding.decimal.enable", False,
    "Lower decimal columns as scaled-integer arithmetic on the device: "
    "precisions <= 18 as scaled int64 (or int32, see "
    "encoding.decimal.int32); unequal-scale comparisons rescale through "
    "the two-limb int128 ops (kernels/decimal128.py).  Results equal the "
    "exact host decimal arithmetic, ANSI and non-ANSI.  Off by default.")
ENCODING_DECIMAL_INT32 = bool_conf(
    "auron.tpu.encoding.decimal.int32", True,
    "With encoding.decimal.enable, store decimals of precision <= 9 as "
    "scaled int32 on the device: a single add/sub of two p <= 9 operands "
    "cannot leave int32; results widen to the declared int64 output.")
STAGE_DEVICE_LOOP_ENABLE = str_conf(
    "auron.tpu.stage.deviceLoop.enable", "auto",
    "Device stage loop (runtime/loop.py): an eligible hash-lane fused "
    "aggregation (plan/stage_compiler.py) folds a chunk of source batches "
    "per step, on a CUDA device as one CUDA graph replay with one host "
    "sync.  'auto' runs it where the port's device is CUDA; 'on' forces it "
    "wherever the stage compiles (the CPU tests, where the same fold body "
    "runs eagerly); 'off' always uses the staged per-batch executor.  A "
    "partial-mode overflow or a table past 2^24 slots falls back "
    "wholesale to the staged path (stage_loop_fallback).")
STAGE_DEVICE_LOOP_CHUNK = int_conf(
    "auron.tpu.stage.deviceLoop.chunkBatches", 8,
    "Batches folded per stage-loop step (one graph replay on a CUDA "
    "device); cancellation is checked between chunks.")
PARTIAL_AGG_SKIPPING_ENABLE = bool_conf(
    "auron.tpu.partialAgg.skipping.enable", True,
    "Pass rows through un-aggregated when partial-agg cardinality is too "
    "high (the generic AggExec's one-shot probe, ops/agg/exec.py).")
PARTIAL_AGG_SKIPPING_RATIO = float_conf(
    "auron.tpu.partialAgg.skipping.ratio", 0.9,
    "Groups-emitted/rows-consumed ratio beyond which a partial AggExec "
    "switches to pass-through.")
PARTIAL_AGG_SKIPPING_MIN_ROWS = int_conf(
    "auron.tpu.partialAgg.skipping.minRows", 50000,
    "Probe window: rows a partial AggExec sees before its one-shot "
    "cardinality probe runs.")
PARTIAL_AGG_SKIPPING_ON_SPILL = bool_conf(
    "auron.tpu.partialAgg.skipping.onSpill", False,
    "Under memory pressure, switch an eligible partial AggExec to "
    "pass-through instead of spilling its buffer (skip before spill; off "
    "keeps the reference's spill-before-skip order).",
    alt_keys=("auron.partialAggSkipping.skipSpill",))
SUGGESTED_MERGING_BATCH_MEM_SIZE = int_conf(
    "auron.suggested.batch.memSize.multiwayMerging", 1 << 20,
    "Target bytes per output chunk of a k-way merge (ops/sort.py "
    "merge_sorted_batches).")
ANSI_ENABLED = bool_conf(
    "spark.sql.ansi.enabled", False,
    "ANSI SQL mode: integral division or modulo by zero and integer "
    "overflow in + - * / raise instead of giving NULL or wrapping, and a "
    "Cast raises on input it cannot convert (TryCast still gives NULL).")
CAST_TRIM_STRING = bool_conf(
    "auron.cast.trimString", True,
    "Trim whitespace before string->numeric/date casts (Spark behavior).")
PARQUET_ENABLE_PAGE_FILTERING = bool_conf(
    "auron.parquet.enable.pageFiltering", True,
    "Row-group pruning with the footers' min/max statistics on a scan "
    "that carries a predicate (ops/pruning.py).")
PARQUET_METADATA_CACHE_SIZE = int_conf(
    "auron.parquet.metadataCacheSize", 1024,
    "Parquet footers cached across scans and bound discovery (ops/scan.py "
    "parquet_metadata).")
SCAN_EAGER_FILE_BYTES = int_conf(
    "auron.tpu.scan.eagerFileBytes", 128 << 20,
    "Local parquet files up to this size decode eagerly per file; larger "
    "files stream through iter_batches for bounded memory.")
SHUFFLE_FILE_CODEC = str_conf(
    "auron.tpu.shuffle.localFileCodec", "raw",
    "Frame codec for rows written to local shuffle .data files (frames "
    "stay self-describing, so any reader handles any mix).")
SPILL_COMPRESSION_CODEC = str_conf(
    "auron.spill.compression.codec", "zstd",
    "Codec for shuffle IPC frames when io.compression.codec is unset.")
IO_COMPRESSION_CODEC = str_conf(
    "io.compression.codec", "lz4",
    "Shuffle IPC frame codec: lz4 | zstd | raw.  Unset, "
    "auron.spill.compression.codec applies.")
SHUFFLE_COMPRESSION_TARGET_BUF_SIZE = int_conf(
    "auron.shuffle.compression.target.buf.size", 4194304,
    "Target frame size for compressed shuffle IPC blocks.")
SHUFFLE_CHECKSUM_ENABLE = bool_conf(
    "auron.tpu.shuffle.checksum", True,
    "CRC32C checksum on every shuffle IPC frame (4 bytes/frame, verified "
    "on read); a mismatch raises ShuffleChecksumError.")
COLUMN_PRUNING_ENABLE = bool_conf(
    "auron.tpu.columnPruning", True,
    "Column-pruning pass over each task's decoded plan "
    "(plan/column_pruning.py): scans narrow to the columns referenced "
    "above them.  Plans from Spark arrive pruned already; this recovers "
    "the behavior for directly-authored IR.")
EXPR_FUSE = bool_conf(
    "auron.tpu.expr.fuse", True,
    "Whole-chain expression programs (exprs/program.py): each eligible "
    "Filter/Project/FilterProject chain runs as ONE program, on a CUDA "
    "device a CUDA graph captured once per (program, bucket rung) and "
    "replayed per batch, cached process-wide by expression fingerprint so "
    "repeated queries and all partitions share it.  Chains with host-only "
    "expressions (strings, UDFs, decimals past the device routes) and ANSI "
    "mode run the eager evaluator; this is the kill-switch.")
EXPR_CACHE_SIZE = int_conf(
    "auron.tpu.expr.cache.size", 256,
    "Bounded LRU capacity of the process-wide expression-program cache "
    "(distinct fingerprints; each entry also holds its per-rung CUDA "
    "graphs).")
COLLAPSE_FILTER_PROJECT = bool_conf(
    "auron.tpu.plan.collapseFilterProject", True,
    "Planner rewrite (plan/planner.py collapse_filter_project): merge "
    "adjacent Filter->Project chains into one FilterProjectExec and "
    "Project->Project into a single Project by substituting bound "
    "references.")

# -- the memory manager (memory/manager.py) and the spill tiers ------------

MEMORY_FRACTION = float_conf(
    "auron.memory.fraction", 0.6,
    "Fraction of the device memory granted to the memory manager.")
PROCESS_VMRSS_MEMORY_FRACTION = float_conf(
    "auron.process.vmrss.memoryFraction", 0.9,
    "On the CPU: the fraction of physical memory (at most 4 GiB of it) "
    "the memory manager's budget is taken from.")
ON_HEAP_SPILL_MEMORY_FRACTION = float_conf(
    "auron.onHeapSpill.memoryFraction", 0.9,
    "Fraction of the memory manager's budget the spill tiers may hold in "
    "host RAM before further runs go to disk files.")
TORCH_DEVICE = str_conf(
    "auron.torch.device", "cuda",
    "Device the PyTorch port runs on: `cuda` (the default; raises when no "
    "card is visible) or `cpu`, where every kernel wrapper runs its plain "
    "PyTorch version.")

# -- observability (bridge/tracing.py, bridge/profiling.py) ------------------

TRACE_ENABLE = bool_conf(
    "auron.tpu.trace.enable", False,
    "Collect execution spans process-wide without an explicit "
    "start_tracing() call (bridge/tracing.py).  Probed once lazily; "
    "disabled tracing stays a one-boolean check at every span site.",
    category="observability")
HISTORY_DIR = str_conf(
    "auron.tpu.history.dir", "",
    "Directory for query event logs; empty uses "
    "<system tempdir>/blaze_history.  The port writes no event log "
    "(auron.tpu.history.enable raises); the statistics store's default "
    "directory rides this one.", category="observability")

# -- the statistics feedback plane (plan/statstore.py, plan/advisor.py) and
# -- adaptive execution (plan/adaptive.py), as the JAX package has them

STATS_ENABLE = bool_conf(
    "auron.tpu.stats.enable", False,
    "Enable the statistics feedback plane: the per-fingerprint "
    "observed-stats store (plan/statstore.py) and the advisor findings "
    "derived from it.  Probed once lazily; disabled it stays a near-free "
    "boolean check — zero writes, zero allocation on the query path.",
    category="observability")
STATS_DIR = str_conf(
    "auron.tpu.stats.dir", "",
    "Directory for the per-fingerprint statistics store; empty uses "
    "<history dir>/stats.", category="observability")
AQE_ENABLE = bool_conf(
    "auron.tpu.aqe.enable", False,
    "Enable adaptive query execution (plan/adaptive.py): the "
    "DagScheduler re-plans not-yet-dispatched consumer stages from the "
    "exact map-output bytes of committed producers — broadcast-join "
    "switch, reduce-partition coalescing, and skew-split.  Probed once "
    "lazily; disabled AQE stays a near-free boolean check at the stage "
    "boundary and the executed plan is byte-identical to the static "
    "plan.", category="observability")
AQE_BROADCAST_THRESHOLD = int_conf(
    "auron.tpu.aqe.broadcastThreshold", 8 << 20,
    "Observed build-side map-output bytes under this rewrite a "
    "shuffle-hash join to a broadcast build at runtime; the advisor's "
    "broadcast findings read the same threshold, so report and rewrite "
    "never disagree.  The reference's default is -1, which inherits its "
    "auron.tpu.stats.advisor.broadcastBytes (8 MiB); the port has the "
    "one key.", category="observability")
AQE_HISTORY_SEED = bool_conf(
    "auron.tpu.aqe.historySeed", False,
    "Seed the plan at bind time from the statistics store's "
    "per-fingerprint quantiles (requires auron.tpu.stats.enable): "
    "pre-broadcast historically-small build sides, shrink partition "
    "counts toward the coalesce target (plan/adaptive.py "
    "COALESCE_TARGET_BYTES), and pre-select the partial-agg "
    "skip strategy when history shows high group cardinality.",
    category="observability")

# -- the stage DAG (plan/stages.py) and task retry (bridge/tasks.py) --------

DAG_SINGLE_TASK_BYTES = int_conf(
    "auron.tpu.dag.singleTaskBytes", 64 << 20,
    "Queries whose total file-scan input is at or below this run as ONE "
    "task with in-process exchanges (plan/stages.py `_run_single_task`, "
    "the Spark-AQE coalesce-to-one-partition analog); larger ones run "
    "staged.  0 disables it.")
TASK_MAX_ATTEMPTS = int_conf(
    "auron.tpu.task.maxAttempts", 4,
    "Bounded per-task attempts for retryable failures (transient IO, a "
    "corrupt frame): the spark.task.maxFailures analog.  Fatal errors and "
    "FetchFailedError never retry in place; 1 disables retry.")
TASK_RETRY_BACKOFF_MS = int_conf(
    "auron.tpu.task.backoff", 100,
    "Base backoff between task attempts in ms; attempt n sleeps "
    "base*2^(n-1) with up to +25% jitter, capped at 10s.")
STAGE_MAX_RECOVERIES = int_conf(
    "auron.tpu.stage.maxRecoveries", 3,
    "Lineage-recovery rounds per query: each FetchFailedError re-runs only "
    "the poisoned producer map task and restarts the consuming stage; "
    "beyond this many rounds the failure propagates.")

# -- the query service (serving/service.py) and the per-query limits
# -- (serving/context.py), as the JAX package names them

SERVING_MAX_CONCURRENT = int_conf(
    "auron.tpu.serving.maxConcurrent", 4,
    "Queries executing at once in the QueryService (serving/service.py), "
    "one pool slot and one CUDA stream each; admitted queries beyond "
    "this wait in the bounded queue.", category="serving")
SERVING_MAX_QUEUE = int_conf(
    "auron.tpu.serving.maxQueue", 32,
    "Bounded admission queue depth: a submission past it is shed at once "
    "with QueryRejected(kind='queue-full').", category="serving")
SERVING_TENANT_MAX_INFLIGHT = int_conf(
    "auron.tpu.serving.tenant.maxInflight", 8,
    "Per-tenant in-flight cap (queued + running): a submission past it "
    "is shed with QueryRejected(kind='tenant-quota').", category="serving")
SERVING_ADMIT_MEM_BYTES = int_conf(
    "auron.tpu.serving.admitMemBytes", 0,
    "Admission ceiling on a query's file-scan bytes: a query estimated "
    "above it is shed with QueryRejected(kind='memory').  0 disables; an "
    "input that cannot be stat'ed always admits.", category="serving")
QUERY_DEADLINE_MS = int_conf(
    "auron.tpu.query.deadlineMs", 0,
    "Default per-query deadline in ms, applied at submission when the "
    "caller passes none: past it the query is cancelled (DeadlineExceeded) "
    "within one batch and torn down.  0 = no deadline.", category="serving")
QUERY_MEM_QUOTA = int_conf(
    "auron.tpu.query.memQuota", 0,
    "Default per-query quota in bytes over the MemManager's consumers: a "
    "breaching query sheds its own state and climbs the degradation "
    "ladder (partial-agg pass-through, then batch-capacity shrink), and "
    "is killed (QueryMemoryExceeded) at its third rung.  0 = no quota.",
    category="serving")

# -- deterministic fault injection (faults.py)

FAULTS_ENABLE = bool_conf(
    "auron.tpu.faults.enable", False,
    "Activate the fault-injection registry (faults.py) from "
    "auron.tpu.faults.rules and .seed: chaos testing only.",
    category="fault-tolerance")
FAULTS_SEED = int_conf(
    "auron.tpu.faults.seed", 0,
    "Seed of the injection decisions: the k-th evaluation of a site fires "
    "as a pure function of (seed, site, k).", category="fault-tolerance")
FAULTS_RULES = str_conf(
    "auron.tpu.faults.rules", "",
    "Comma-separated injection rules: `site=p`, `site=p*max`, "
    "`site@k1+k2`, an optional `:corrupt` action.  The port's sites: "
    "task-start, shuffle-read, quota-breach, admit, cancel-race; a site "
    "of the reference the port lacks raises.", category="fault-tolerance")

# -- the Spark front door (convert/spark.py): the master switch, the UDF
# -- routes and the per-operator switches, as the JAX package has them

ENABLED = bool_conf(
    "auron.enabled", True, "Master switch for native conversion.",
    category="convert")
UDF_FALLBACK_ENABLE = bool_conf(
    "auron.udf.fallback.enable", True,
    "Wrap unsupported expressions as host-evaluated UDFs during plan "
    "conversion (convertExprWithFallback, NativeConverters.scala:399) "
    "instead of rejecting the subtree.  The port converts them as the JAX "
    "package does; running one waits for the host UDF bridge (ROADMAP "
    "item 16).")
UDF_JSON_ENABLED = bool_conf(
    "auron.udf.UDFJson.enabled", True,
    "Convert Hive UDFJson (get_json_object) natively.", category="convert")
UDF_BRICKHOUSE_ENABLED = bool_conf(
    "auron.udf.brickhouse.enabled", False,
    "Convert brickhouse collect/combine_unique UDAFs natively.",
    category="convert")

#: per-operator conversion switches (ref AuronConverters.scala:98-128), by
#: the operator's name in `auron.enable.<op>`
OPERATOR_SWITCHES = {
    op: bool_conf(f"auron.enable.{op}", True,
                  f"Allow converting {op} nodes to the native engine.",
                  category="convert")
    for op in ("scan", "paimon.scan", "iceberg.scan", "hudi.scan",
               "project", "filter", "sort", "union", "smj", "shj",
               "native.join.condition", "bhj", "bnlj", "local.limit",
               "global.limit", "take.ordered.and.project", "collectLimit",
               "aggr", "expand", "window", "window.group.limit", "generate",
               "local.table.scan", "data.writing", "data.writing.parquet",
               "data.writing.orc", "scan.parquet", "scan.parquet.timestamp",
               "scan.orc", "scan.orc.timestamp", "broadcastExchange",
               "shuffleExchange")}


def operator_enabled(op: str) -> bool:
    """Converter gate lookup (ref per-op enable flags,
    AuronConverters.scala:98-128); an operator without a switch is on."""
    opt = OPERATOR_SWITCHES.get(op)
    return True if opt is None else opt.get()


#: keys of the JAX scheduler's branches the port has not ported: the
#: scheduler raises where one of them turns its branch on (ROADMAP items
#: 14 and 16)
UNPORTED_SCHEDULER_KEYS = {
    "auron.tpu.workers.enable": "item 16 (worker-process pool)",
    "auron.tpu.speculation.enable": "item 16 (speculative execution)",
    "auron.tpu.shuffle.service": "item 16 (remote shuffle service)",
    "auron.tpu.cache.enable": "item 16 (subplan and result caches)",
    "auron.tpu.history.enable": "item 16 (query history, its emitters)",
    "auron.tpu.serving.singleFlight": "item 16 (single-flight)",
    "auron.tpu.serving.useWorkerPool": "item 16 (the service's worker "
                                       "pool)",
    "auron.tpu.flightRecorder.enable": "item 16 (the flight recorder)",
    "auron.tpu.shuffle.device": "item 14 (device exchange)",
}


# -- the streaming runtime (streaming/) --------------------------------------
STREAM_EPOCH_INTERVAL_MS = int_conf(
    "auron.tpu.stream.epoch.intervalMs", 0,
    "Target pacing between micro-batch epochs of the streaming runtime "
    "(streaming/executor.py).  0 = run epochs back to back (drain mode); "
    ">0 sleeps out the rest of the interval after each epoch, like "
    "Flink's checkpoint interval.", category="streaming")
STREAM_CHECKPOINT_DIR = str_conf(
    "auron.tpu.stream.checkpoint.dir", "",
    "Directory of the streaming checkpoint manifests (ckpt-NNNNNN.json: "
    "per-partition source offsets, watermark, window-state snapshot, "
    "sink attempt).  Empty = the StreamExecutor makes a private temp "
    "directory.", category="streaming")
STREAM_WATERMARK_LATENESS_MS = int_conf(
    "auron.tpu.stream.watermark.latenessMs", 0,
    "Allowed event-time lateness: the watermark trails the minimum "
    "per-partition max event time by this many ms, so records up to "
    "this late still land in their window before it fires.",
    category="streaming")
STREAM_LATE_SIDE_POLICY = str_conf(
    "auron.tpu.stream.lateSide.policy", "drop",
    "Where records older than the watermark go: `drop` discards them "
    "(counted as stream_late_records), `side` routes them to the "
    "executor's late-side output, `accept` folds them into the pane's "
    "retained accumulator so a re-opened window re-emits corrected "
    "cumulative values.", category="streaming")
STREAM_MAX_RECOVERIES = int_conf(
    "auron.tpu.stream.maxRecoveries", 3,
    "Checkpoint-recovery rounds a streaming query may take: each "
    "retryable epoch failure replays from the last committed manifest, "
    "at most this many times before the error propagates.",
    category="streaming")
