"""Per-fingerprint observed-statistics store — the feedback half of the
adaptive-execution loop (port of blaze_tpu/plan/statstore.py).

At query finish the DAG scheduler (plan/stages.py) hands this module one
*observation*: the plan fingerprint (plan/fingerprint.py), per-shuffle-
boundary partition bytes lifted from the map-output table before
cleanup, task duration samples from the bridge/device_stats.py
reservoirs, and the counter deltas that carry agg-probe ratios, cache
hit rates and host-lane eviction evidence.  Observations merge into one
bounded JSONL record per fingerprint under <history dir>/stats, so the
Nth run of a recurring query reads sharper priors than the first:
quantiles come from bounded-error mergeable sketches, ratios from
accumulated tallies.  The port's records are the JAX package's, byte for
byte, for the same observations.

The reference's per-fingerprint listing (`StatStore.records`,
`summary`) feeds its /stats route and comes with that route (ROADMAP
item 16).  `INGEST_COUNTERS` keeps the reference's names.  A counter whose
subsystem the port lacks (the device exchange, dictionary encoding, the
decimal tiers, the stage-program cache's hits, the scatter lane's
declines) is absent from the port's registry and reads 0.

Design rules:

- Off by default (`auron.tpu.stats.enable`); the probe is lazy and
  disabled sites pay one boolean — zero writes, zero allocation.
- Module scope imports nothing heavy (no torch, no pyarrow): the store
  must be readable from tooling on a machine with neither.
- Deterministic replay: a record is the *last valid JSON line* of its
  fingerprint file; torn trailing lines (crash mid-append) are skipped.
  Re-serializing a replayed record is byte-identical to what was
  written (plain dict/list/float JSON, sorted keys).

The quantile sketch is a deliberately simple mergeable centroid list
(value, weight pairs kept sorted; nearest-neighbour collapse past the
centroid budget).  With budget K the rank error is bounded by the
largest collapsed weight fraction — ~1/K of total weight per merge
step — which is plenty for "is partition 7 really 12x the median"
decisions, and unlike t-digest it is exactly reproducible from its
JSON form.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
from typing import Any, Dict, Iterable, List, Optional

log = logging.getLogger("blaze_tpu_torch.statstore")

__all__ = [
    "STATS_SCHEMA_VERSION", "enabled", "reset_conf_probe", "stats_dir",
    "sketch_new", "sketch_add", "sketch_merge", "sketch_quantile",
    "ingest", "prior", "StatStore",
]

STATS_SCHEMA_VERSION = 1

#: counter deltas an observation may carry; everything else is dropped
#: at ingest so record size stays bounded by this schema, not by what
#: future counter families happen to exist.
INGEST_COUNTERS = (
    "partial_agg_probe_rows", "partial_agg_probe_groups",
    "partial_agg_skip_events",
    "expr_programs_built", "expr_program_cache_hits",
    "expr_fused_batches", "expr_eager_batches",
    "stage_loop_programs_built", "stage_loop_program_cache_hits",
    "stage_loop_fallbacks", "scatter_lane_declines",
    "shuffle_device_bytes", "shuffle_host_bytes",
    "shuffle_barrier_idle_ns", "shuffle_device_overlap_exchanges",
    "aqe_rewrites", "aqe_bytes_saved", "aqe_history_seeds",
    "dict_encoded_columns", "dict_exchange_remaps",
    "decimal_scaled_int32_dispatches", "decimal_scaled_int64_dispatches",
    "decimal_limb_dispatches",
    "host_evictions_string", "host_evictions_decimal",
    "host_evictions_other",
)

#: appended lines per fingerprint file before it is compacted down to
#: its single latest merged record (bounds file growth; replay only
#: ever needs the last line).
_MAX_LINES = 8

#: retention: the most-recently-updated fingerprint records kept on
#: disk; ingest prunes the oldest beyond this (the reference's
#: `auron.tpu.stats.maxFingerprints` default)
MAX_FINGERPRINTS = 256
#: centroids per quantile sketch; merges collapse the closest adjacent
#: centroids past it (the reference's `auron.tpu.stats.sketchCentroids`
#: default)
SKETCH_CENTROIDS = 64

_lock = threading.Lock()
_enabled = False
_conf_probed = False  # lazy one-shot auron.tpu.stats.enable probe


def _probe_conf() -> None:
    global _conf_probed, _enabled
    with _lock:
        if _conf_probed:
            return
        _conf_probed = True
    from blaze_tpu_torch import config
    _enabled = bool(config.STATS_ENABLE.get())


def enabled() -> bool:
    """One near-free boolean at every emit site once probed (the
    auron.tpu.trace.enable pattern)."""
    if not _conf_probed:
        _probe_conf()
    return _enabled


def reset_conf_probe() -> None:
    """Test helper: forget the probe so the next call re-reads
    `auron.tpu.stats.enable`."""
    global _conf_probed, _enabled
    with _lock:
        _conf_probed = False
        _enabled = False


def stats_dir() -> str:
    """Resolved store directory (auron.tpu.stats.dir; empty rides the
    history dir so one retention story covers both)."""
    from blaze_tpu_torch import config
    return config.STATS_DIR.get() or os.path.join(_history_dir(), "stats")


def _history_dir() -> str:
    """`auron.tpu.history.dir`, empty meaning <system tempdir>/
    blaze_history (the reference's bridge/history.py default; the port
    writes no event log there)."""
    from blaze_tpu_torch import config
    return config.HISTORY_DIR.get() or os.path.join(tempfile.gettempdir(),
                                                    "blaze_history")


# ---------------------------------------------------------------------------
# Quantile sketch: sorted (value, weight) centroids, mergeable, bounded.
# ---------------------------------------------------------------------------

def sketch_new() -> Dict[str, Any]:
    return {"centroids": [], "count": 0, "min": None, "max": None}


def _compress(centroids: List[List[float]], budget: int
              ) -> List[List[float]]:
    """Collapse the closest adjacent pair (weighted mean) until within
    budget.  Ties break to the leftmost pair, so compression — and
    therefore every on-disk record — is deterministic."""
    cs = sorted(([float(v), float(w)] for v, w in centroids),
                key=lambda c: c[0])
    while len(cs) > budget:
        best, best_gap = 0, None
        for i in range(len(cs) - 1):
            gap = cs[i + 1][0] - cs[i][0]
            if best_gap is None or gap < best_gap:
                best, best_gap = i, gap
        a, b = cs[best], cs[best + 1]
        w = a[1] + b[1]
        cs[best:best + 2] = [[(a[0] * a[1] + b[0] * b[1]) / w, w]]
    return cs


def sketch_add(sk: Dict[str, Any], values: Iterable[float],
               budget: Optional[int] = None) -> Dict[str, Any]:
    vals = [float(v) for v in values]
    if not vals:
        return sk
    budget = budget or SKETCH_CENTROIDS
    cs = list(sk.get("centroids") or []) + [[v, 1.0] for v in vals]
    sk["centroids"] = _compress(cs, budget)
    sk["count"] = int(sk.get("count") or 0) + len(vals)
    lo, hi = min(vals), max(vals)
    sk["min"] = lo if sk.get("min") is None else min(float(sk["min"]), lo)
    sk["max"] = hi if sk.get("max") is None else max(float(sk["max"]), hi)
    return sk


def sketch_merge(a: Dict[str, Any], b: Dict[str, Any],
                 budget: Optional[int] = None) -> Dict[str, Any]:
    budget = budget or SKETCH_CENTROIDS
    out = sketch_new()
    cs = list(a.get("centroids") or []) + list(b.get("centroids") or [])
    out["centroids"] = _compress(cs, budget) if cs else []
    out["count"] = int(a.get("count") or 0) + int(b.get("count") or 0)
    mins = [x["min"] for x in (a, b) if x.get("min") is not None]
    maxs = [x["max"] for x in (a, b) if x.get("max") is not None]
    out["min"] = min(mins) if mins else None
    out["max"] = max(maxs) if maxs else None
    return out


def sketch_quantile(sk: Dict[str, Any], q: float) -> Optional[float]:
    """Weighted-rank interpolation across centroid midpoints; exact at
    the extremes (min/max are tracked separately)."""
    cs = sk.get("centroids") or []
    total = sum(w for _v, w in cs)
    if not cs or total <= 0:
        return None
    q = min(1.0, max(0.0, float(q)))
    if q <= 0.0:
        return float(sk["min"]) if sk.get("min") is not None else cs[0][0]
    if q >= 1.0:
        return float(sk["max"]) if sk.get("max") is not None else cs[-1][0]
    target = q * total
    run = 0.0
    prev_v, prev_mid = None, 0.0
    for v, w in cs:
        mid = run + w / 2.0
        if target <= mid:
            if prev_v is None or mid == prev_mid:
                return float(v)
            frac = (target - prev_mid) / (mid - prev_mid)
            return float(prev_v + (v - prev_v) * frac)
        run += w
        prev_v, prev_mid = v, mid
    return float(cs[-1][0])


def sketch_spread(sk: Dict[str, Any]) -> Optional[float]:
    """p90 - p10 width: the "are my priors getting sharper" scalar the
    tests and the ETA seeding use."""
    p10, p90 = sketch_quantile(sk, 0.10), sketch_quantile(sk, 0.90)
    if p10 is None or p90 is None:
        return None
    return float(p90 - p10)


# ---------------------------------------------------------------------------
# Record shape and merge.
# ---------------------------------------------------------------------------

def _new_record(fingerprint: str) -> Dict[str, Any]:
    return {
        "v": STATS_SCHEMA_VERSION,
        "fingerprint": fingerprint,
        "run_count": 0,
        "wall_s": sketch_new(),
        "task_ms": sketch_new(),
        "stages": {},
        "counters": {},
        "derived": {},
        "fallback_reasons": {},
    }


def _new_stage(sid: int) -> Dict[str, Any]:
    return {
        "sid": sid,
        "run_count": 0,
        "partitions": 0,
        "tasks": 0,
        "exchange": "",
        "partition_bytes": sketch_new(),
        "total_bytes": sketch_new(),
        "skew": sketch_new(),
        "output_rows": sketch_new(),
        "last_partition_bytes": [],
    }


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if not n:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def _merge_stage(st: Dict[str, Any], obs: Dict[str, Any],
                 budget: int) -> None:
    part_bytes = [float(b) for b in (obs.get("partition_bytes") or [])]
    st["run_count"] = int(st.get("run_count") or 0) + 1
    st["sid"] = int(obs.get("sid", st.get("sid", -1)))
    st["partitions"] = len(part_bytes) or int(obs.get("partitions") or 0)
    st["tasks"] = int(obs.get("tasks") or st.get("tasks") or 0)
    if obs.get("exchange"):
        st["exchange"] = str(obs["exchange"])
    if part_bytes:
        sketch_add(st["partition_bytes"], part_bytes, budget)
        sketch_add(st["total_bytes"], [sum(part_bytes)], budget)
        med = _median(part_bytes)
        if med > 0:
            sketch_add(st["skew"], [max(part_bytes) / med], budget)
        # bounded verbatim copy of the latest run, so the advisor can
        # name the skewed partition ("partition 7 is 12x median")
        st["last_partition_bytes"] = [int(b) for b in part_bytes[:256]]
    if obs.get("output_rows") is not None:
        sketch_add(st["output_rows"], [float(obs["output_rows"])], budget)


def merge_observation(rec: Dict[str, Any], obs: Dict[str, Any]
                      ) -> Dict[str, Any]:
    """Fold one finished run into the fingerprint's record (pure; used
    by ingest() and directly by tests)."""
    budget = SKETCH_CENTROIDS
    rec["run_count"] = int(rec.get("run_count") or 0) + 1
    if obs.get("wall_s") is not None:
        sketch_add(rec["wall_s"], [float(obs["wall_s"])], budget)
    task_ns = obs.get("task_ns") or []
    if task_ns:
        sketch_add(rec["task_ms"], [ns / 1e6 for ns in task_ns], budget)
    counters = rec.setdefault("counters", {})
    for k in INGEST_COUNTERS:
        d = int((obs.get("counters") or {}).get(k, 0))
        if d or k in counters:
            counters[k] = int(counters.get(k, 0)) + d
    for reason, n in (obs.get("fallback_reasons") or {}).items():
        fr = rec.setdefault("fallback_reasons", {})
        fr[str(reason)] = int(fr.get(str(reason), 0)) + int(n)
    stages = rec.setdefault("stages", {})
    for sobs in obs.get("stages") or []:
        sfp = sobs.get("fingerprint")
        if not sfp:
            continue
        st = stages.get(sfp)
        if st is None:
            st = stages[sfp] = _new_stage(int(sobs.get("sid", -1)))
        _merge_stage(st, sobs, budget)
    rec["derived"] = _derive(rec)
    return rec


def _derive(rec: Dict[str, Any]) -> Dict[str, Any]:
    """Ratios recomputed from the accumulated tallies (never merged as
    ratios — the Nth run's ratio weights every run's rows)."""
    c = rec.get("counters") or {}
    out: Dict[str, Any] = {}
    rows = int(c.get("partial_agg_probe_rows", 0))
    if rows:
        out["agg_probe_ratio"] = round(
            int(c.get("partial_agg_probe_groups", 0)) / rows, 6)
    built = int(c.get("expr_programs_built", 0))
    hits = int(c.get("expr_program_cache_hits", 0))
    if built + hits:
        out["expr_cache_hit_rate"] = round(hits / (built + hits), 6)
    sl_built = int(c.get("stage_loop_programs_built", 0))
    sl_hits = int(c.get("stage_loop_program_cache_hits", 0))
    if sl_built + sl_hits:
        out["stage_loop_cache_hit_rate"] = round(
            sl_hits / (sl_built + sl_hits), 6)
    wall = rec.get("wall_s") or {}
    p50 = sketch_quantile(wall, 0.5)
    if p50 is not None:
        out["wall_p50_s"] = round(p50, 6)
        spread = sketch_spread(wall)
        if spread is not None:
            out["wall_spread_s"] = round(spread, 6)
    return out


# ---------------------------------------------------------------------------
# Disk layout: one JSONL file per fingerprint; last valid line wins.
# ---------------------------------------------------------------------------

def _fp_path(root: str, fingerprint: str) -> str:
    safe = "".join(ch for ch in fingerprint if ch.isalnum() or ch in "-_")
    return os.path.join(root, f"fp-{safe}.jsonl")


def _dumps(rec: Dict[str, Any]) -> str:
    return json.dumps(rec, sort_keys=True, separators=(",", ":"))


def _read_last_record(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    for line in reversed(lines):
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue  # torn append; keep scanning backwards
        if isinstance(rec, dict) and rec.get("v") == STATS_SCHEMA_VERSION:
            return rec
    return None


class StatStore:
    """Read/replay view over a stats directory.  Construction touches
    no state; every method re-reads disk so a fresh process replays
    exactly what was written."""

    def __init__(self, root: Optional[str] = None) -> None:
        self.root = root or stats_dir()

    def fingerprints(self) -> List[str]:
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        fps = [n[3:-6] for n in names
               if n.startswith("fp-") and n.endswith(".jsonl")]
        return sorted(fps)

    def record(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        return _read_last_record(_fp_path(self.root, fingerprint))


def prior(fingerprint: Optional[str]) -> Optional[Dict[str, Any]]:
    """Merged record for a fingerprint, or None (store disabled, never
    seen, or unreadable)."""
    if not fingerprint or not enabled():
        return None
    return StatStore().record(fingerprint)


def _prune(root: str) -> None:
    cap = MAX_FINGERPRINTS
    try:
        names = [n for n in os.listdir(root)
                 if n.startswith("fp-") and n.endswith(".jsonl")]
    except OSError:
        return
    if len(names) <= cap:
        return
    paths = [os.path.join(root, n) for n in names]
    try:
        paths.sort(key=lambda p: (os.path.getmtime(p), p))
    except OSError:
        paths.sort()
    for p in paths[:len(paths) - cap]:
        try:
            os.remove(p)
        except OSError:
            pass


def ingest(obs: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """Merge one finished-run observation into its fingerprint record
    and persist it.  Returns the merged record (None when disabled or
    the observation carries no fingerprint).  A failed write is logged
    and returns None: the stats plane never fails a query."""
    if not enabled():
        return None
    fingerprint = obs.get("fingerprint")
    if not fingerprint:
        return None
    try:
        root = stats_dir()
        os.makedirs(root, exist_ok=True)
        path = _fp_path(root, fingerprint)
        with _lock:
            rec = _read_last_record(path) or _new_record(fingerprint)
            merge_observation(rec, obs)
            line = _dumps(rec) + "\n"
            n_lines = 0
            if os.path.exists(path):
                try:
                    with open(path, "r", encoding="utf-8") as f:
                        n_lines = sum(1 for _ in f)
                except OSError:
                    n_lines = 0
            if n_lines + 1 > _MAX_LINES:
                tmp = path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(line)
                os.replace(tmp, path)
            else:
                with open(path, "a", encoding="utf-8") as f:
                    f.write(line)
        _prune(root)
    except Exception:
        log.warning("statstore: ingest of %s failed; the run is not "
                    "recorded", fingerprint, exc_info=True)
        return None
    from blaze_tpu_torch.bridge import device_stats
    device_stats.note_stats(
        ingests=1, runs_merged=1 if rec["run_count"] > 1 else 0,
        fingerprints_last=len(StatStore(root).fingerprints()))
    return rec
