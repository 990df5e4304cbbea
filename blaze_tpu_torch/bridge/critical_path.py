"""Critical-path and wall-clock category attribution over one query's
span trace (port of blaze_tpu/bridge/critical_path.py; stdlib only).

`attribute(spans)` carves the query's span extent into elementary time
segments and charges each segment to exactly one category, so the
categories always sum to the extent.  Overlapping spans are resolved by
a fixed priority order: a segment covered by both a `task` span and the
`shuffle_exchange` inside it is exchange wire, not host compute.

Categories:

- ``admission_wait``  queue time before execution (admission_wait span)
- ``retry_backoff``   retry backoff sleeps (backoff_wait)
- ``exchange_wire``   exchange spans: data motion
- ``device_compute``  stage-loop chunks, and the port's compilation: the
                      `kernel_build` and `graph_capture` instants, each
                      carrying its duration in attrs["ns"] (where the
                      reference takes `xla_compile`)
- ``scan_decode``     operator:*Scan* time
- ``host_compute``    any other covered time (task bodies, host ops)
- ``barrier_idle``    uncovered time immediately before an exchange
                      segment: the map->exchange barrier
- ``dispatch_gap``    any other uncovered time inside the extent
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

__all__ = ["CATEGORIES", "attribute", "critical_path",
           "bottleneck_report"]

#: attribution priority, highest first; barrier_idle / dispatch_gap are
#: derived from *uncovered* time and never assigned to a span directly.
_PRIORITY = ("admission_wait", "retry_backoff", "exchange_wire",
             "device_compute", "scan_decode", "host_compute")

CATEGORIES = _PRIORITY + ("barrier_idle", "dispatch_gap")

_EXCHANGE_NAMES = ("device_exchange", "rss_exchange", "shuffle_exchange")
#: the port's compile instants (the reference's `xla_compile`)
_COMPILE_NAMES = ("kernel_build", "graph_capture")


def _category(name: str) -> Optional[str]:
    if name == "admission_wait":
        return "admission_wait"
    if name == "backoff_wait":
        return "retry_backoff"
    if name in _EXCHANGE_NAMES:
        return "exchange_wire"
    if name in ("stage_loop_chunk",) + _COMPILE_NAMES:
        return "device_compute"
    if name.startswith("operator:"):
        return "scan_decode" if "Scan" in name else "host_compute"
    if name in ("task", "task_attempt", "worker_task", "stream_epoch",
                "stage_recovery", "explain_analyze"):
        return "host_compute"
    return None


def _intervals(spans: List[dict]) -> List[Tuple[int, int, int]]:
    """(t0, t1, priority_index) per categorized span; malformed records
    are skipped (the device-ledger hardening rules apply here too)."""
    out: List[Tuple[int, int, int]] = []
    for r in spans:
        if not isinstance(r, dict):
            continue
        name = r.get("name")
        if not isinstance(name, str):
            continue
        cat = _category(name)
        if cat is None:
            continue
        try:
            t0 = int(r.get("t0_ns", 0))
            t1 = int(r.get("t1_ns", t0))
        except (TypeError, ValueError):
            continue
        if name in _COMPILE_NAMES:
            # compile instants carry their duration in attrs["ns"]
            try:
                t1 = t0 + max(0, int((r.get("attrs") or {}).get("ns", 0)))
            except (TypeError, ValueError):
                t1 = t0
        if t1 <= t0:
            continue
        out.append((t0, t1, _PRIORITY.index(cat)))
    return out


def _extent(spans: List[dict]) -> Optional[Tuple[int, int]]:
    t0s, t1s = [], []
    for r in spans:
        if not isinstance(r, dict):
            continue
        try:
            t0s.append(int(r.get("t0_ns", 0)))
            t1s.append(int(r.get("t1_ns", r.get("t0_ns", 0))))
        except (TypeError, ValueError):
            continue
    if not t0s:
        return None
    lo, hi = min(t0s), max(t1s)
    return (lo, hi) if hi > lo else None


def attribute(spans: List[dict]) -> Dict[str, float]:
    """Seconds per category plus ``wall_s`` (the span extent).  The
    categories sum to wall_s exactly, by construction."""
    out: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
    ext = _extent(spans)
    if ext is None:
        out["wall_s"] = 0.0
        return out
    lo, hi = ext
    ivs = _intervals(spans)
    points = {lo, hi}
    for t0, t1, _p in ivs:
        points.add(max(lo, min(hi, t0)))
        points.add(max(lo, min(hi, t1)))
    cuts = sorted(points)
    # winning priority per elementary segment; None => uncovered
    seg_cat: List[Optional[int]] = []
    for i in range(len(cuts) - 1):
        s0, s1 = cuts[i], cuts[i + 1]
        if s1 <= s0:
            seg_cat.append(None)
            continue
        best: Optional[int] = None
        for t0, t1, p in ivs:
            if t0 < s1 and t1 > s0 and (best is None or p < best):
                best = p
        seg_cat.append(best)
    # uncovered segments: barrier when the next covered segment is
    # exchange wire (the map->exchange barrier), dispatch gap otherwise
    ex_idx = _PRIORITY.index("exchange_wire")
    n = len(seg_cat)
    idle_kind: List[str] = [""] * n
    nxt: Optional[int] = None
    for i in range(n - 1, -1, -1):
        if seg_cat[i] is None:
            idle_kind[i] = ("barrier_idle" if nxt == ex_idx
                            else "dispatch_gap")
        else:
            nxt = seg_cat[i]
    for i in range(n):
        dur_s = (cuts[i + 1] - cuts[i]) / 1e9
        if dur_s <= 0:
            continue
        cat = (_PRIORITY[seg_cat[i]] if seg_cat[i] is not None
               else idle_kind[i])
        out[cat] += dur_s
    out["wall_s"] = (hi - lo) / 1e9
    return out


def critical_path(spans: List[dict], limit: int = 12) -> List[dict]:
    """Longest-duration root-to-leaf chain through the span tree: start
    at the longest root span, descend into the longest child at each
    step.  Approximate (siblings may overlap) but it names the spans a
    human should look at first."""
    by_parent: Dict[Any, List[dict]] = {}
    roots: List[dict] = []
    sids = set()
    clean = []
    for r in spans:
        if not isinstance(r, dict) or not isinstance(r.get("name"), str):
            continue
        try:
            int(r.get("dur_ns", 0))
        except (TypeError, ValueError):
            continue
        clean.append(r)
        if r.get("sid") is not None:
            sids.add(r["sid"])
    for r in clean:
        parent = r.get("parent")
        if parent is not None and parent in sids:
            by_parent.setdefault(parent, []).append(r)
        else:
            roots.append(r)

    def _dur(r: dict) -> int:
        try:
            return int(r.get("dur_ns", 0))
        except (TypeError, ValueError):
            return 0

    path: List[dict] = []
    node = max(roots, key=lambda r: (_dur(r), str(r.get("name"))),
               default=None)
    while node is not None and len(path) < limit:
        entry: Dict[str, Any] = {
            "name": node.get("name"),
            "dur_s": round(_dur(node) / 1e9, 6),
            "category": _category(node.get("name") or "") or "other",
        }
        attrs = node.get("attrs") or {}
        ctx = node.get("ctx") or {}
        stage = attrs.get("stage", ctx.get("stage"))
        if stage is not None:
            entry["stage"] = stage
        if node.get("worker") is not None:
            entry["worker"] = node["worker"]
        path.append(entry)
        kids = by_parent.get(node.get("sid"), [])
        node = max(kids, key=lambda r: (_dur(r), str(r.get("name"))),
                   default=None)
    return path


def bottleneck_report(spans: List[dict],
                      wall_s: Optional[float] = None
                      ) -> Optional[Dict[str, Any]]:
    """The /query/<qid>/bottleneck payload: category attribution, the
    dominant category, and the critical path.  None when there are no
    usable spans."""
    att = attribute(spans)
    if att.get("wall_s", 0.0) <= 0.0:
        return None
    cats = {c: round(att[c], 6) for c in CATEGORIES}
    covered = {c: v for c, v in cats.items() if v > 0}
    dominant = (max(covered, key=lambda c: (covered[c], c))
                if covered else None)
    report: Dict[str, Any] = {
        "v": 1,
        "wall_s": round(att["wall_s"], 6),
        "categories": cats,
        "dominant": dominant,
        "dominant_fraction": (round(covered[dominant] / att["wall_s"], 4)
                              if dominant else 0.0),
        "critical_path": critical_path(spans),
        "span_count": len(spans),
    }
    if wall_s is not None:
        report["query_wall_s"] = round(float(wall_s), 6)
    return report
