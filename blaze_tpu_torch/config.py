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
    """Typed config key with its default and doc."""

    key: str
    default: Any
    parse: Callable[[str], Any]
    doc: str = ""

    def get(self, session: Optional["ConfSession"] = None) -> Any:
        return (session or conf).get(self)

    @property
    def env_key(self) -> str:
        return "BLAZE_TPU_" + self.key.upper().replace(".", "_")


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


def int_conf(key: str, default: int, doc: str = "") -> ConfigOption:
    return ConfigOption(key, default, int, doc)


def float_conf(key: str, default: float, doc: str = "") -> ConfigOption:
    return ConfigOption(key, default, float, doc)


def bool_conf(key: str, default: bool, doc: str = "") -> ConfigOption:
    return ConfigOption(key, default, _parse_bool, doc)


def str_conf(key: str, default: str, doc: str = "") -> ConfigOption:
    return ConfigOption(key, default, str, doc)


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
            if opt.key in self._overrides:
                return opt.parse(self._overrides[opt.key])
        if opt.env_key in os.environ:
            return opt.parse(os.environ[opt.env_key])
        return opt.default

    def get_raw(self, key: str) -> Optional[str]:
        """The override (or environment) string of `key`, which need not
        be a key the port defines; None where neither sets it."""
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
        return os.environ.get("BLAZE_TPU_" + key.upper().replace(".", "_"))

    def is_set(self, opt: ConfigOption) -> bool:
        with self._lock:
            if opt.key in self._overrides:
                return True
        return opt.env_key in os.environ


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
ANSI_ENABLED = bool_conf(
    "spark.sql.ansi.enabled", False,
    "ANSI SQL mode: integral division or modulo by zero and integer "
    "overflow in + - * / raise instead of giving NULL or wrapping, and a "
    "Cast raises on input it cannot convert (TryCast still gives NULL).")
CAST_TRIM_STRING = bool_conf(
    "auron.cast.trimString", True,
    "Trim whitespace before string->numeric/date casts (Spark behavior).")
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
COLLAPSE_FILTER_PROJECT = bool_conf(
    "auron.tpu.plan.collapseFilterProject", True,
    "Planner rewrite (plan/planner.py collapse_filter_project): merge "
    "adjacent Filter->Project chains into one FilterProjectExec and "
    "Project->Project into a single Project by substituting bound "
    "references.")
TORCH_DEVICE = str_conf(
    "auron.torch.device", "cuda",
    "Device the PyTorch port runs on: `cuda` (the default; raises when no "
    "card is visible) or `cpu`, where every kernel wrapper runs its plain "
    "PyTorch version.")

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
#: keys of the JAX scheduler's branches the port has not ported: the
#: scheduler raises where one of them turns its branch on (ROADMAP items
#: 14 and 16)
UNPORTED_SCHEDULER_KEYS = {
    "auron.tpu.workers.enable": "item 16 (worker-process pool)",
    "auron.tpu.speculation.enable": "item 16 (speculative execution)",
    "auron.tpu.shuffle.service": "item 16 (remote shuffle service)",
    "auron.tpu.cache.enable": "item 16 (subplan cache)",
    "auron.tpu.stats.enable": "item 16 (statistics store)",
    "auron.tpu.aqe.enable": "item 16 (adaptive execution)",
    "auron.tpu.history.enable": "item 15 (query history)",
    "auron.tpu.shuffle.device": "item 14 (device exchange)",
}
