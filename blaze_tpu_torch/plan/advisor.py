"""Structured findings derived from the statistics feedback plane
(port of blaze_tpu/plan/advisor.py): the statstore's merged
per-fingerprint record (plan/statstore.py) plus the finished query's
bottleneck report (bridge/critical_path.py).

Each finding is a small JSON object — ``{"kind", "stage", "summary",
"evidence"}``.  Findings are *advice for the next run* (the adaptive
pass, plan/adaptive.py, reads the same records through
`recommendations`); they never change execution here.  The reference
also embeds them in its query history's ``finished`` event and counts
them in ``stats_advisor_findings``; the port has no history yet
(ROADMAP item 16), so the caller reads them: itest/adaptive.py passes
each traced run's `critical_path.bottleneck_report` with the stored
record, and chip_smoke.py prints the findings.

Kinds:

- ``broadcast_candidate``   a shuffle boundary small enough to broadcast
- ``skew_partition``        one partition >> median: skew-split candidate
- ``host_eviction``         stage-loop/scatter work evicted to the host
- ``low_cache_hit_rate``    expr/stage-loop program cache churns
- ``high_cardinality_agg``  partial-agg probe says grouping won't reduce
- ``dominant_bottleneck``   one wall-clock category owns most of the run
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from blaze_tpu_torch.plan import statstore

__all__ = ["FINDING_KINDS", "SKEW_FACTOR", "findings", "recommendations",
           "broadcast_threshold", "skew_factor"]

FINDING_KINDS = ("broadcast_candidate", "skew_partition", "host_eviction",
                 "low_cache_hit_rate", "high_cardinality_agg",
                 "dominant_bottleneck")

#: a partition whose bytes exceed this multiple of its boundary's median
#: is a skew-split candidate, for the findings and the AQE pass alike
#: (the reference's `auron.tpu.stats.advisor.skewFactor` default, which
#: its `auron.tpu.aqe.skewFactor` inherits)
SKEW_FACTOR = 4.0

#: bridge/critical_path.py category -> what to try, for
#: dominant_bottleneck summaries (the port has no admission queue, so no
#: `admission_wait`)
_BOTTLENECK_HINTS = {
    "scan_decode": "consider narrower projection or scan-share cache",
    "device_compute": "device-bound; check stage-loop chunk sizing",
    "host_compute": "host-bound; check host-lane evictions",
    "exchange_wire": "exchange-bound; broadcast or fewer partitions",
    "barrier_idle": "map->exchange barrier; rebalance producer tasks",
    "dispatch_gap": "scheduler idle; raise task parallelism",
    "retry_backoff": "retries dominate; investigate task failures",
}


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024.0 or unit == "GB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} GB"


def broadcast_threshold() -> int:
    """The single broadcast-bytes threshold shared by advisor findings
    and the AQE pass: `auron.tpu.aqe.broadcastThreshold`."""
    from blaze_tpu_torch import config
    return int(config.AQE_BROADCAST_THRESHOLD.get())


def skew_factor() -> float:
    """The single skew ratio shared by advisor findings and the AQE
    pass: SKEW_FACTOR."""
    return SKEW_FACTOR


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if not n:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def _stage_recommendations(sfp: str, st: Dict[str, Any]
                           ) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    sid = st.get("sid")
    total_p50 = statstore.sketch_quantile(st.get("total_bytes") or {}, 0.5)
    partitions = int(st.get("partitions") or 0)
    thr = broadcast_threshold()
    if total_p50 is not None and 0 < total_p50 <= thr and partitions > 1:
        out.append({
            "rule": "broadcast", "stage": sid, "fingerprint": sfp,
            "threshold": thr,
            "evidence": {"fingerprint": sfp,
                         "total_bytes_p50": round(total_p50, 1),
                         "threshold_bytes": thr,
                         "partitions": partitions},
        })
    last = [float(b) for b in (st.get("last_partition_bytes") or [])]
    med = _median(last)
    factor = skew_factor()
    if last and med > 0:
        worst = max(range(len(last)), key=lambda i: (last[i], -i))
        ratio = last[worst] / med
        if ratio >= factor:
            out.append({
                "rule": "skew_split", "stage": sid, "fingerprint": sfp,
                "threshold": factor,
                "evidence": {"fingerprint": sfp, "partition": worst,
                             "partition_bytes": int(last[worst]),
                             "median_bytes": round(med, 1),
                             "ratio": round(ratio, 2),
                             "factor": factor},
            })
    return out


def recommendations(record: Optional[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """Structured `(rule, threshold, evidence)` records the AQE pass
    (plan/adaptive.py) consumes directly.  The broadcast/skew findings
    below are rendered FROM these records, so the advisor's report and
    the rewrites the engine actually applies share one threshold
    source and can never disagree."""
    out: List[Dict[str, Any]] = []
    rec = record or {}
    for sfp in sorted(rec.get("stages") or {}):
        out.extend(_stage_recommendations(sfp, rec["stages"][sfp]))
    out.sort(key=lambda r: (r["rule"],
                            -1 if r["stage"] is None else int(r["stage"]),
                            r["fingerprint"]))
    return out


def _stage_findings(sfp: str, st: Dict[str, Any]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for r in _stage_recommendations(sfp, st):
        ev = r["evidence"]
        sid = r["stage"]
        if r["rule"] == "broadcast":
            out.append({
                "kind": "broadcast_candidate", "stage": sid,
                "summary": (f"stage {sid} shuffle writes "
                            f"{_fmt_bytes(ev['total_bytes_p50'])} (p50) "
                            f"across {ev['partitions']} partitions: fits "
                            f"broadcast threshold "
                            f"{_fmt_bytes(ev['threshold_bytes'])}"),
                "evidence": dict(ev),
            })
        elif r["rule"] == "skew_split":
            out.append({
                "kind": "skew_partition", "stage": sid,
                "summary": (f"stage {sid} partition {ev['partition']} is "
                            f"{ev['ratio']:.1f}x median "
                            f"({_fmt_bytes(ev['partition_bytes'])} vs "
                            f"{_fmt_bytes(ev['median_bytes'])}): "
                            f"skew-split candidate"),
                "evidence": dict(ev),
            })
    return out


def findings(record: Optional[Dict[str, Any]],
             bottleneck: Optional[Dict[str, Any]] = None
             ) -> List[Dict[str, Any]]:
    """Derive advisor findings; deterministic given (record,
    bottleneck), sorted by (kind, stage)."""
    out: List[Dict[str, Any]] = []
    rec = record or {}
    for sfp in sorted(rec.get("stages") or {}):
        out.extend(_stage_findings(sfp, rec["stages"][sfp]))
    for reason, n in sorted((rec.get("fallback_reasons") or {}).items()):
        if int(n) > 0:
            out.append({
                "kind": "host_eviction", "stage": None,
                "summary": f"host-evicted: {reason} x{int(n)}",
                "evidence": {"reason": reason, "count": int(n)},
            })
    derived = rec.get("derived") or {}
    counters = rec.get("counters") or {}
    for rate_key, built_key, hits_key, what in (
            ("expr_cache_hit_rate", "expr_programs_built",
             "expr_program_cache_hits", "expr-program"),
            ("stage_loop_cache_hit_rate", "stage_loop_programs_built",
             "stage_loop_program_cache_hits", "stage-loop")):
        rate = derived.get(rate_key)
        lookups = (int(counters.get(built_key, 0)) +
                   int(counters.get(hits_key, 0)))
        if rate is not None and lookups >= 8 and rate < 0.5:
            out.append({
                "kind": "low_cache_hit_rate", "stage": None,
                "summary": (f"{what} cache hit rate {rate:.0%} over "
                            f"{lookups} lookups: compile churn"),
                "evidence": {"plane": what, "hit_rate": rate,
                             "lookups": lookups},
            })
    ratio = derived.get("agg_probe_ratio")
    if ratio is not None and ratio >= 0.8:
        out.append({
            "kind": "high_cardinality_agg", "stage": None,
            "summary": (f"partial-agg probe ratio {ratio:.2f} "
                        f"(groups/rows): partial agg barely reduces — "
                        f"skip candidate"),
            "evidence": {
                "agg_probe_ratio": ratio,
                "probe_rows": int(counters.get(
                    "partial_agg_probe_rows", 0)),
                "probe_groups": int(counters.get(
                    "partial_agg_probe_groups", 0))},
        })
    if bottleneck:
        dom = bottleneck.get("dominant")
        frac = float(bottleneck.get("dominant_fraction") or 0.0)
        if dom and frac >= 0.5:
            hint = _BOTTLENECK_HINTS.get(dom, "")
            out.append({
                "kind": "dominant_bottleneck", "stage": None,
                "summary": (f"{dom} owns {frac:.0%} of wall"
                            + (f": {hint}" if hint else "")),
                "evidence": {"category": dom, "fraction": frac,
                             "wall_s": bottleneck.get("wall_s")},
            })
    out.sort(key=lambda f: (f["kind"],
                            -1 if f["stage"] is None else int(f["stage"]),
                            f["summary"]))
    return out
