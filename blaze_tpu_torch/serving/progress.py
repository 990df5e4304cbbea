"""Live query-progress registry behind /query/<qid>/progress and
/progress (the port's copy of blaze_tpu/serving/progress.py; its
snapshots have the reference's keys, one for one).

The DAG scheduler (plan/stages.py) notes a query's start, each stage's
start, per-task completions and merged task metrics (rows and bytes) as
it runs, and plan/adaptive.py notes a stage it re-planned;
`progress(qid)` renders that into per-stage done/total counts, row and
byte rates, and an ETA.  The ETA is seeded from the statstore prior for
the plan fingerprint (the p50 wall of earlier runs) and falls back to
extrapolating the fraction done on a cold fingerprint, or after a
re-plan.

Gated with the rest of the statistics plane on `auron.tpu.stats.enable`
(the scheduler checks `statstore.enabled()` before calling in), so the
disabled path allocates nothing.  Stdlib-only.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["note_query_start", "note_stage_start", "note_stage_replan",
           "note_task_done", "note_rows", "note_query_done", "progress",
           "live", "snapshot_all", "reset"]

_lock = threading.Lock()
_live: Dict[str, Dict[str, Any]] = {}
#: finished snapshots kept for late pollers, insertion-ordered
_done: Dict[str, Dict[str, Any]] = {}
_DONE_CAP = 64
_LIVE_CAP = 256


def note_query_start(query_id: str, fingerprint: Optional[str] = None,
                     prior_wall_s: Optional[float] = None) -> None:
    if not query_id:
        return
    with _lock:
        if len(_live) >= _LIVE_CAP and query_id not in _live:
            return
        _live[query_id] = {
            "query_id": query_id,
            "fingerprint": fingerprint,
            "prior_wall_s": prior_wall_s,
            "t0": time.monotonic(),
            "stages": {},
            "replans": 0,
        }


def note_stage_start(query_id: str, sid: int, tasks: int) -> None:
    with _lock:
        q = _live.get(query_id)
        if q is None:
            return
        st = q["stages"].setdefault(int(sid), {
            "tasks_total": 0, "tasks_done": 0, "rows": 0, "bytes": 0})
        # recovery re-runs re-enter a stage; total counts all attempts
        st["tasks_total"] += max(0, int(tasks))


def note_stage_replan(query_id: str, sid: int, tasks: int) -> None:
    """An AQE rewrite replaced stage `sid`'s plan mid-run (new task
    count `tasks`).  Statstore priors describe the *static* plan's
    wall, so the ETA must stop trusting them and re-estimate from the
    observed completion fraction."""
    with _lock:
        q = _live.get(query_id)
        if q is None:
            return
        q["replans"] = int(q.get("replans", 0)) + 1
        st = q["stages"].get(int(sid))
        if st is not None:
            # the rewrite supersedes the stage's pre-planned tasks:
            # re-baseline total on the not-yet-run portion
            st["tasks_total"] = st["tasks_done"] + max(0, int(tasks))


def note_task_done(query_id: str, sid: int) -> None:
    with _lock:
        q = _live.get(query_id)
        if q is None:
            return
        st = q["stages"].get(int(sid))
        if st is not None:
            st["tasks_done"] += 1


def note_rows(query_id: str, sid: int, rows: int = 0,
              bytes_: int = 0) -> None:
    with _lock:
        q = _live.get(query_id)
        if q is None:
            return
        st = q["stages"].setdefault(int(sid), {
            "tasks_total": 0, "tasks_done": 0, "rows": 0, "bytes": 0})
        st["rows"] += max(0, int(rows))
        st["bytes"] += max(0, int(bytes_))


def _render(q: Dict[str, Any], state: str,
            wall_s: Optional[float] = None) -> Dict[str, Any]:
    elapsed = (wall_s if wall_s is not None
               else time.monotonic() - q["t0"])
    elapsed = max(0.0, float(elapsed))
    stages = {str(sid): dict(st) for sid, st in sorted(q["stages"].items())}
    done = sum(st["tasks_done"] for st in q["stages"].values())
    total = sum(st["tasks_total"] for st in q["stages"].values())
    rows = sum(st["rows"] for st in q["stages"].values())
    nbytes = sum(st["bytes"] for st in q["stages"].values())
    replans = int(q.get("replans", 0))
    eta_s: Optional[float] = None
    eta_source: Optional[str] = None
    if state == "running":
        prior = q.get("prior_wall_s")
        if replans > 0:
            # an AQE rewrite changed the task/partition shape mid-run;
            # the prior described the static plan, so re-estimate from
            # the observed fraction instead
            if total > 0 and 0 < done < total and elapsed > 0:
                eta_s = elapsed * (total - done) / done
                eta_source = "fraction-replanned"
        elif prior is not None and prior > 0:
            eta_s = max(0.0, float(prior) - elapsed)
            eta_source = "prior"
        elif total > 0 and 0 < done < total and elapsed > 0:
            eta_s = elapsed * (total - done) / done
            eta_source = "fraction"
    out: Dict[str, Any] = {
        "query_id": q["query_id"],
        "state": state,
        "fingerprint": q.get("fingerprint"),
        "elapsed_s": round(elapsed, 6),
        "stages": stages,
        "tasks_done": done,
        "tasks_total": total,
        "rows": rows,
        "bytes": nbytes,
        "rows_per_s": round(rows / elapsed, 3) if elapsed > 0 else 0.0,
        "bytes_per_s": round(nbytes / elapsed, 3) if elapsed > 0 else 0.0,
        "eta_s": round(eta_s, 6) if eta_s is not None else None,
        "eta_source": eta_source,
        "replans": replans,
    }
    return out


def note_query_done(query_id: str, status: str = "finished",
                    wall_s: Optional[float] = None) -> None:
    with _lock:
        q = _live.pop(query_id, None)
        if q is None:
            return
        snap = _render(q, "done", wall_s=wall_s)
        snap["status"] = status
        _done[query_id] = snap
        while len(_done) > _DONE_CAP:
            _done.pop(next(iter(_done)))


def progress(query_id: str) -> Optional[Dict[str, Any]]:
    """Current progress for a query: a live rendering while it runs,
    the terminal snapshot after, None if never registered."""
    with _lock:
        q = _live.get(query_id)
        if q is not None:
            return _render(q, "running")
        return dict(_done[query_id]) if query_id in _done else None


def live() -> List[str]:
    with _lock:
        return sorted(_live)


def snapshot_all() -> Dict[str, Any]:
    """The /progress listing: every live query rendered, plus recent
    finished snapshots."""
    with _lock:
        running = [_render(q, "running") for _qid, q in
                   sorted(_live.items())]
        recent = list(_done.values())
    return {"running": running, "recent": recent}


def reset() -> None:
    with _lock:
        _live.clear()
        _done.clear()
