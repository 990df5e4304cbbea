"""Adaptive query execution: re-plan at stage boundaries from stats the
engine already collects (port of blaze_tpu/plan/adaptive.py).

Once a producer stage's map outputs are committed, their per-partition
byte sizes are EXACT (the scheduler's map-output table), while
everything the static planner assumed was an estimate.  The scheduler
(plan/stages.py) therefore calls `AqeRuntime.on_producer_commit`
between a stage's map-output commit and its consumer's dispatch;
not-yet-dispatched consumers may be rewritten by three rules:

- **broadcast switch** — the observed build side of a shuffle-hash join
  fits under the broadcast threshold (plan/advisor.py: ONE threshold
  shared with the advisor findings, so report and rewrite can never
  disagree): the join becomes a broadcast build, the probe's exchange
  is elided outright (its producer never runs; the probe subtree is
  inlined into the consumer).
- **partition coalescing** — adjacent tiny reduce partitions merge up
  to `COALESCE_TARGET_BYTES`, so reducers stop paying
  per-partition dispatch tax.  Applied identically to EVERY reader of
  the consumer (hash co-partitioning puts each key at the same index on
  all sides, so unioning the same groups on both join inputs is exact).
- **skew split** — one partition exceeds `advisor.SKEW_FACTOR` x the
  median: its map segments split across N sub-tasks, each joining
  against the full (replicated) build partition; the tiny remainder
  partitions coalesce in the same rewrite (Spark composes
  OptimizeSkewedJoin with CoalesceShufflePartitions the same way).

On top, `seed_plan` is the **history-driven planner**: at bind time the
statstore's per-fingerprint quantiles pre-broadcast historically-small
build sides, shrink partition counts toward the coalesce target, and
pre-select the partial-agg skip strategy — the second run of a
dashboard query plans better than the first.

Contracts every rewrite preserves:

- **fingerprints** — a rewritten stage gets a DERIVED fingerprint
  (plan/fingerprint.py derived_fingerprint), so the statstore never
  sees the static shape's identity on rewritten output;
- **lineage** — derived reader closures delegate to the scheduler's
  live map-output table, so invalidated outputs still surface as
  FetchFailedError naming the original producer map task and recovery
  re-runs exactly that task;
- **bit identity** — every rule is a pure re-bucketing of the same
  shuffle segments (or the standard broadcast equivalence for inner
  joins), so results match the static plan exactly.

All rewrites construct the new plan FULLY before committing any
scheduler mutation; a failure mid-evaluation leaves the static plan
untouched.  Disabled (`auron.tpu.aqe.enable`, default off) the whole
module is one lazily-probed boolean — the executed plan is
byte-identical to the static one.

Under a serving query (serving/context.py), a committed rewrite tells
the live progress registry (`progress.note_stage_replan`, under
`auron.tpu.stats.enable`), so its ETA stops trusting the static plan's
prior; and a rewrite is abandoned, the static plan kept, when the query
is cancelled before the rewrite commits: the scheduler's next check then
raises the cancellation, and nothing of a rewrite is left half made.

Left for ROADMAP item 16, with the subsystems they need: the subplan
cache's refusal of derived fingerprints, and the per-stage placement
table the reference marks an elided stage in.
"""

from __future__ import annotations

import copy
import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger("blaze_tpu_torch.aqe")

__all__ = ["COALESCE_TARGET_BYTES", "SKEW_MAX_SPLITS", "enabled",
           "history_seed_enabled", "reset_conf_probe", "seed_plan",
           "runtime_for", "AqeRuntime"]

#: target bytes per reduce partition after coalescing: adjacent
#: partitions merge greedily until the next would push a group past it;
#: also the history seed's partition-count target (the reference's
#: `auron.tpu.aqe.coalesceTargetBytes` default)
COALESCE_TARGET_BYTES = 16 << 20
#: most sub-tasks one skewed partition splits into, each replicating the
#: build side once (the reference's `auron.tpu.aqe.skewMaxSplits` default)
SKEW_MAX_SPLITS = 8

_lock = threading.Lock()
_enabled = False
_conf_probed = False  # lazy one-shot auron.tpu.aqe.enable probe


def _probe_conf() -> None:
    global _conf_probed, _enabled
    with _lock:
        if _conf_probed:
            return
        _conf_probed = True
    from blaze_tpu_torch import config
    _enabled = bool(config.AQE_ENABLE.get())


def enabled() -> bool:
    """One near-free boolean at the stage boundary once probed (the
    statstore.enabled pattern)."""
    if not _conf_probed:
        _probe_conf()
    return _enabled


def reset_conf_probe() -> None:
    """Test helper: forget the probe so the next call re-reads
    `auron.tpu.aqe.enable`."""
    global _conf_probed, _enabled
    with _lock:
        _conf_probed = False
        _enabled = False


def history_seed_enabled() -> bool:
    if not enabled():
        return False
    from blaze_tpu_torch import config
    return bool(config.AQE_HISTORY_SEED.get())


# -- IR helpers -------------------------------------------------------------


def _walk_nodes(d: Any):
    """Every {"kind": ...} dict node of an IR subtree."""
    stack: List[Any] = [d]
    while stack:
        n = stack.pop()
        if isinstance(n, dict):
            if "kind" in n:
                yield n
            stack.extend(n.values())
        elif isinstance(n, (list, tuple)):
            stack.extend(n)


def _is_stage_reader(d: Any) -> bool:
    return (isinstance(d, dict) and d.get("kind") == "ipc_reader"
            and isinstance(d.get("resource_id"), str)
            and d["resource_id"].startswith("stage://"))


def _rid_sid(rid: str) -> Optional[int]:
    """Producer stage id of a stage:// resource, None for derived rids
    (which embed '#') or anything unparseable."""
    try:
        tail = rid.rsplit("/", 1)[1]
        return int(tail)
    except (IndexError, ValueError):
        return None


def _broadcast_reader_rids(d: Any, in_broadcast: bool = False) -> set:
    """Resource ids of ipc_readers sitting under a broadcast build side
    anywhere in `d` (adaptive execution leaves those readers alone: they
    replay every partition in every task)."""
    rids: set = set()
    if not isinstance(d, dict) or "kind" not in d:
        return rids
    k = d.get("kind")
    if k == "ipc_reader" and in_broadcast:
        rids.add(d.get("resource_id"))
    if k in ("broadcast_join", "broadcast_nested_loop_join"):
        build = d.get("build_side", "right")
        for side in ("left", "right"):
            rids |= _broadcast_reader_rids(d.get(side),
                                           in_broadcast or side == build)
        return rids
    if k == "broadcast_join_build_hash_map":
        return rids | _broadcast_reader_rids(d.get("input"), True)
    for key, val in d.items():
        if isinstance(val, dict) and "kind" in val:
            rids |= _broadcast_reader_rids(val, in_broadcast)
        elif key == "inputs" and isinstance(val, list):
            for v in val:
                rids |= _broadcast_reader_rids(v, in_broadcast)
    return rids


def _stage_reader_nodes(plan: Dict[str, Any]) -> List[Dict[str, Any]]:
    """ipc_reader nodes over stage:// exchanges, excluding readers under
    broadcast build sides (those replay every partition per task and
    must keep their original registration)."""
    excluded = _broadcast_reader_rids(plan)
    return [n for n in _walk_nodes(plan) if _is_stage_reader(n)
            and n["resource_id"] not in excluded]


def _has_scan(plan: Dict[str, Any]) -> bool:
    return any(n.get("kind") in ("parquet_scan", "orc_scan")
               for n in _walk_nodes(plan))


def _rid_refs(stages, rid: str) -> int:
    n = 0
    for st in stages:
        for node in _walk_nodes(st.plan):
            if node.get("kind") == "ipc_reader" \
                    and node.get("resource_id") == rid:
                n += 1
    return n


def _median(values: List[float]) -> float:
    vs = sorted(values)
    n = len(vs)
    if not n:
        return 0.0
    mid = n // 2
    return vs[mid] if n % 2 else (vs[mid - 1] + vs[mid]) / 2.0


def _stage_base_fp(sched, stage) -> str:
    from blaze_tpu_torch.plan import fingerprint as fp_mod
    part = (sched.partitioning_of(stage) if stage.partitioning is not None
            else None)
    return fp_mod.subplan_fingerprint(stage.plan, part, stage.num_tasks)


# -- runtime re-planning ----------------------------------------------------


def runtime_for(sched) -> Optional["AqeRuntime"]:
    """The scheduler's per-run AQE hook, or None when disabled (the
    disabled path stays one boolean; no object, no state)."""
    if not enabled():
        return None
    return AqeRuntime(sched)


class AqeRuntime:
    """Holds the per-run rewrite state; one instance per staged
    run_collect.  All methods run on the scheduler's own thread
    between a producer commit and the next dispatch — never
    concurrently with the stage they rewrite."""

    def __init__(self, sched):
        self._sched = sched
        self._rewritten: set = set()  # consumer sids already rewritten

    # -- entry point -------------------------------------------------------

    def on_producer_commit(self, stage, completed: set,
                           stages_by_id: Dict[int, Any]) -> None:
        """Called by the scheduler right after `stage`'s map outputs
        commit.  Never raises: any failure abandons the rewrite and the
        static plan proceeds untouched."""
        from blaze_tpu_torch.serving.context import is_cancellation
        try:
            self._on_commit(completed, stages_by_id)
        except Exception as e:
            if is_cancellation(e):
                # abandoned: the static plan stays, and the scheduler's
                # next check raises the cancellation
                log.debug("aqe: query cancelled; rewrite after stage %s "
                          "abandoned", stage.sid)
                return
            log.warning("aqe: rewrite evaluation failed after stage %s; "
                        "the static plan proceeds", stage.sid,
                        exc_info=True)

    def _on_commit(self, completed: set,
                   stages_by_id: Dict[int, Any]) -> None:
        for c in self._sched.stages:
            if c.sid in completed or c.sid in self._rewritten:
                continue
            if self._try_broadcast(c, completed, stages_by_id):
                continue
            if self._try_skew_split(c, completed):
                continue
            self._try_coalesce(c, completed)

    # -- shared bookkeeping ------------------------------------------------

    def _commit_rewrite(self, c, rule: str, new_plan, num_tasks: int,
                        derived_fp: str, detail: Dict[str, Any]) -> None:
        query = getattr(self._sched, "_query", None)
        if query is not None:
            query.check()  # a cancelled query's rewrite is abandoned
        c.plan = new_plan
        c.num_tasks = int(num_tasks)
        c.aqe = {"rule": rule, "fingerprint": derived_fp, **detail}
        self._rewritten.add(c.sid)
        from blaze_tpu_torch.bridge import tracing
        tracing.instant("aqe_rewrite", stage=c.sid, rule=rule,
                        tasks=c.num_tasks)
        self._sched.aqe_events.append(
            {"rule": rule, "stage": c.sid, "tasks": c.num_tasks,
             "fingerprint": derived_fp, **detail})
        from blaze_tpu_torch.plan import statstore
        qid = getattr(query, "query_id", None)
        if statstore.enabled() and qid is not None:
            from blaze_tpu_torch.serving import progress
            progress.note_stage_replan(qid, c.sid, c.num_tasks)

    def _join_with_reader_children(self, plan) -> Optional[Dict[str, Any]]:
        """The unique inner hash_join whose children are both direct
        stage readers — and those readers must be the ONLY exchange
        inputs of the plan (so task count is driven by them alone)."""
        joins = [n for n in _walk_nodes(plan)
                 if n.get("kind") == "hash_join"
                 and n.get("join_type", "inner") == "inner"
                 and _is_stage_reader(n.get("left"))
                 and _is_stage_reader(n.get("right"))]
        if len(joins) != 1 or _has_scan(plan):
            return None
        j = joins[0]
        readers = _stage_reader_nodes(plan)
        if len(readers) != 2:
            return None
        if {r["resource_id"] for r in readers} != \
                {j["left"]["resource_id"], j["right"]["resource_id"]}:
            return None
        return j

    # -- rule 1: join-strategy switch --------------------------------------

    def _try_broadcast(self, c, completed: set,
                       stages_by_id: Dict[int, Any]) -> bool:
        """Observed build side fits under the broadcast threshold while
        the probe producer has NOT run yet: switch to a broadcast build
        and elide the probe's exchange entirely — the probe subtree is
        inlined into the consumer, so its shuffle is never written."""
        sched = self._sched
        join = self._join_with_reader_children(c.plan)
        if join is None:
            return False
        build_key = "right" if join.get("build_side", "right") == "right" \
            else "left"
        probe_key = "left" if build_key == "right" else "right"
        build_sid = _rid_sid(join[build_key]["resource_id"])
        probe_sid = _rid_sid(join[probe_key]["resource_id"])
        if build_sid is None or probe_sid is None:
            return False
        if build_sid not in completed or probe_sid in completed:
            return False
        pstage = stages_by_id.get(probe_sid)
        if pstage is None or pstage.partitioning is None:
            return False
        boundary = sched.stage_boundaries.get(build_sid)
        if not boundary:
            return False
        total = sum(int(b) for b in boundary.get("partition_bytes") or [])
        from blaze_tpu_torch.plan import advisor
        if total > advisor.broadcast_threshold():
            return False
        # eliding the probe producer requires both exchanges to feed
        # ONLY this consumer
        if _rid_refs(sched.stages, join[build_key]["resource_id"]) != 1:
            return False
        if _rid_refs(sched.stages, join[probe_key]["resource_id"]) != 1:
            return False

        derived_fp_base = _stage_base_fp(sched, c)
        new_plan = copy.deepcopy(c.plan)
        njoin = self._join_with_reader_children(new_plan)
        if njoin is None:
            return False
        broadcast_id = f"aqe-bc-{sched.run_id}-{c.sid}"
        njoin["kind"] = "broadcast_join"
        njoin["broadcast_id"] = broadcast_id
        njoin[probe_key] = copy.deepcopy(pstage.plan)

        from blaze_tpu_torch.plan import fingerprint as fp_mod
        dfp = fp_mod.derived_fingerprint(
            derived_fp_base, "broadcast",
            {"build_bytes": int(total), "build": build_sid,
             "probe": probe_sid})
        # estimated bytes saved: the probe shuffle that will never be
        # written (scan-size proxy; sentinel value means unknown -> 0)
        saved = sched.scan_input_bytes(pstage.plan)
        if saved >= (1 << 62):
            saved = 0
        self._commit_rewrite(
            c, "broadcast", new_plan, pstage.num_tasks, dfp,
            {"build_bytes": int(total), "broadcast_id": broadcast_id,
             "elided_stage": probe_sid})
        completed.add(probe_sid)
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_aqe(rewrites=1, broadcast_switches=1,
                              stages_elided=1, bytes_saved=int(saved))
        return True

    # -- rule 3: skew split (+ composed coalesce of the remainder) ---------

    def _try_skew_split(self, c, completed: set) -> bool:
        sched = self._sched
        join = self._join_with_reader_children(c.plan)
        if join is None:
            return False
        build_key = "right" if join.get("build_side", "right") == "right" \
            else "left"
        probe_key = "left" if build_key == "right" else "right"
        build, probe = join[build_key], join[probe_key]
        build_sid = _rid_sid(build["resource_id"])
        probe_sid = _rid_sid(probe["resource_id"])
        if build_sid is None or probe_sid is None:
            return False
        if build_sid not in completed or probe_sid not in completed:
            return False
        pb = sched.stage_boundaries.get(probe_sid)
        if not pb or not sched.stage_boundaries.get(build_sid):
            return False
        part_bytes = [int(b) for b in pb.get("partition_bytes") or []]
        n_out = len(part_bytes)
        if n_out < 2 or n_out != int(probe.get("num_partitions", 1)) \
                or n_out != int(build.get("num_partitions", 1)) \
                or c.num_tasks != n_out:
            return False
        med = _median([float(b) for b in part_bytes])
        from blaze_tpu_torch.plan import advisor
        factor = advisor.skew_factor()
        if med <= 0:
            return False
        hot = max(range(n_out), key=lambda i: (part_bytes[i], -i))
        if part_bytes[hot] < factor * med:
            return False
        # splitting needs the probe's per-map file segments
        outputs = sched.map_outputs(probe_sid)
        if not outputs:
            return False  # no local map segments to split
        from blaze_tpu_torch.bridge.resource import get_resource
        if not callable(get_resource(probe["resource_id"])) \
                or not callable(get_resource(build["resource_id"])):
            return False
        maps: List[Tuple[int, int]] = []
        for m in sorted(outputs):
            entry = outputs[m]
            if entry is None:
                return False  # mid-invalidation: recovery first
            _data, off = entry
            ln = int(off[hot + 1] - off[hot])
            if ln:
                maps.append((m, ln))
        n_split = min(SKEW_MAX_SPLITS, len(maps))
        if n_split < 2:
            return False
        # contiguous map-id chunks, balanced by segment bytes: each map
        # goes to the chunk its cumulative start offset falls into, so
        # near-equal segments split evenly and one dominant segment
        # still leaves the rest in their own chunk
        total_hot = sum(ln for _m, ln in maps)
        buckets: List[List[int]] = [[] for _ in range(n_split)]
        acc = 0
        for m, ln in maps:
            j = min(n_split - 1, acc * n_split // total_hot)
            buckets[j].append(m)
            acc += ln
        chunks = [b for b in buckets if b]
        if len(chunks) < 2:
            return False
        # composed task spec: the hot partition's chunks in place, the
        # rest coalesced toward the target (Spark's skew+coalesce pair)
        target_b = COALESCE_TARGET_BYTES
        spec: List[tuple] = []
        group: List[int] = []
        gacc = 0

        def flush():
            nonlocal group, gacc
            if group:
                spec.append(("parts", group))
                group, gacc = [], 0

        for q in range(n_out):
            if q == hot:
                flush()
                for chunk in chunks:
                    spec.append(("maps", hot, chunk))
                continue
            if group and gacc + part_bytes[q] > target_b:
                flush()
            group.append(q)
            gacc += part_bytes[q]
        flush()
        new_n = len(spec)
        coalesced = (n_out - 1) - sum(1 for e in spec if e[0] == "parts")

        probe_rid, build_rid = probe["resource_id"], build["resource_id"]
        new_probe_rid = f"{probe_rid}#aqe-s{c.sid}"
        new_build_rid = f"{build_rid}#aqe-s{c.sid}"

        def probe_blocks(reduce_id: int, _spec=spec, _rid=probe_rid,
                         _sid=probe_sid, _sched=sched):
            from blaze_tpu_torch.bridge.resource import get_resource as _get
            from blaze_tpu_torch.faults import FetchFailedError
            from blaze_tpu_torch.shuffle.reader import FileSegmentBlock
            entry = _spec[reduce_id]
            if entry[0] == "parts":
                src = _get(_rid)
                if src is None:
                    raise KeyError(f"shuffle resource {_rid!r} not found")
                for q in entry[1]:
                    for blk in src(q):
                        yield blk
                return
            _kind, hot_p, map_ids = entry
            # live read of the map-output table: a recovered map task's
            # fresh output is what this sub-task fetches
            outs = _sched.map_outputs(_sid) or {}
            for m in map_ids:
                e = outs.get(m)
                if e is None:
                    raise FetchFailedError(
                        _sid, m, "map output invalidated after worker "
                                 "crash")
                data, off = e
                ln = int(off[hot_p + 1] - off[hot_p])
                if ln:
                    yield FileSegmentBlock(data, int(off[hot_p]), ln,
                                           stage_id=_sid, map_id=m)

        def build_blocks(reduce_id: int, _spec=spec, _rid=build_rid):
            from blaze_tpu_torch.bridge.resource import get_resource as _get
            src = _get(_rid)
            if src is None:
                raise KeyError(f"shuffle resource {_rid!r} not found")
            entry = _spec[reduce_id]
            parts = entry[1] if entry[0] == "parts" else [entry[1]]
            for q in parts:
                for blk in src(q):
                    yield blk

        derived_fp_base = _stage_base_fp(sched, c)
        new_plan = copy.deepcopy(c.plan)
        njoin = self._join_with_reader_children(new_plan)
        if njoin is None:
            return False
        njoin[probe_key]["resource_id"] = new_probe_rid
        njoin[probe_key]["num_partitions"] = new_n
        njoin[build_key]["resource_id"] = new_build_rid
        njoin[build_key]["num_partitions"] = new_n

        from blaze_tpu_torch.plan import fingerprint as fp_mod
        dfp = fp_mod.derived_fingerprint(
            derived_fp_base, "skew_split",
            {"hot": hot, "splits": len(chunks), "partitions": n_out,
             "tasks": new_n})
        self._sched.register_resource(new_probe_rid, probe_blocks)
        self._sched.register_resource(new_build_rid, build_blocks)
        self._commit_rewrite(
            c, "skew_split", new_plan, new_n, dfp,
            {"hot_partition": hot, "hot_bytes": part_bytes[hot],
             "median_bytes": med, "splits": len(chunks),
             "partitions": n_out})
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_aqe(rewrites=1, skew_splits=1,
                              partitions_coalesced=max(0, coalesced))
        return True

    # -- rule 2: partition coalescing --------------------------------------

    def _try_coalesce(self, c, completed: set) -> bool:
        """Merge adjacent tiny reduce partitions up to the target size.
        The SAME grouping applies to every reader of the consumer —
        co-partitioned inputs (both join sides) stay aligned because
        hash partitioning puts a key at the same index on all sides."""
        sched = self._sched
        if _has_scan(c.plan):
            return False
        readers = _stage_reader_nodes(c.plan)
        if not readers:
            return False
        n_out: Optional[int] = None
        prods: set = set()
        for r in readers:
            sid = _rid_sid(r["resource_id"])
            if sid is None:
                return False
            np_ = int(r.get("num_partitions", 1))
            if n_out is None:
                n_out = np_
            elif np_ != n_out:
                return False
            prods.add(sid)
        if not n_out or n_out < 2 or c.num_tasks != n_out:
            return False
        if any(p not in completed for p in prods):
            return False
        from blaze_tpu_torch.bridge.resource import get_resource
        per_part = [0] * n_out
        for p in prods:
            b = sched.stage_boundaries.get(p)
            if not b:
                return False
            pb = b.get("partition_bytes") or []
            if len(pb) != n_out:
                return False
            for i, v in enumerate(pb):
                per_part[i] += int(v)
        for r in readers:
            if not callable(get_resource(r["resource_id"])):
                return False
        target = COALESCE_TARGET_BYTES
        groups: List[List[int]] = []
        cur: List[int] = []
        acc = 0
        for q in range(n_out):
            if cur and acc + per_part[q] > target:
                groups.append(cur)
                cur, acc = [], 0
            cur.append(q)
            acc += per_part[q]
        if cur:
            groups.append(cur)
        if len(groups) >= n_out:
            return False

        rid_map: Dict[str, str] = {}
        closures: Dict[str, Any] = {}
        for r in readers:
            rid = r["resource_id"]
            if rid in rid_map:
                continue
            new_rid = f"{rid}#aqe-c{c.sid}"

            def blocks_for(reduce_id: int, _rid=rid, _groups=groups):
                from blaze_tpu_torch.bridge.resource import \
                    get_resource as _get
                src = _get(_rid)
                if src is None:
                    raise KeyError(f"shuffle resource {_rid!r} not found")
                for q in _groups[reduce_id]:
                    for blk in src(q):
                        yield blk

            rid_map[rid] = new_rid
            closures[new_rid] = blocks_for

        derived_fp_base = _stage_base_fp(sched, c)
        new_plan = copy.deepcopy(c.plan)
        for r in _stage_reader_nodes(new_plan):
            r["num_partitions"] = len(groups)
            r["resource_id"] = rid_map[r["resource_id"]]

        from blaze_tpu_torch.plan import fingerprint as fp_mod
        dfp = fp_mod.derived_fingerprint(
            derived_fp_base, "coalesce",
            {"partitions": n_out, "groups": [list(g) for g in groups]})
        for new_rid, closure in closures.items():
            self._sched.register_resource(new_rid, closure)
        self._commit_rewrite(
            c, "coalesce", new_plan, len(groups), dfp,
            {"partitions": n_out, "groups": len(groups)})
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_aqe(rewrites=1,
                              partitions_coalesced=n_out - len(groups))
        return True


# -- history-driven planning (bind time) ------------------------------------


def _exchange_sfp(ex: Dict[str, Any]) -> Optional[str]:
    """The subplan fingerprint this exchange's producer stage records
    into the statstore — computable at bind time only for LEAF subtrees
    (a nested exchange becomes a run-scoped stage:// reader after the
    split, so non-leaf identities never match across runs)."""
    child = ex.get("input")
    if not isinstance(child, dict):
        return None
    if any(n.get("kind") == "local_exchange" for n in _walk_nodes(child)):
        return None
    part = dict(ex.get("partitioning") or {})
    if part.get("kind") == "single":
        part = {"kind": "single", "num_partitions": 1}
    try:
        from blaze_tpu_torch.plan import create_plan
        n_tasks = max(1, create_plan(child).num_partitions)
    except Exception:
        return None
    from blaze_tpu_torch.plan import fingerprint as fp_mod
    return fp_mod.subplan_fingerprint(child, part, n_tasks)


def _desired_partitions(prior: Dict[str, Any], sfp: str,
                        n_out: int) -> Optional[int]:
    """History-implied partition count: enough partitions of
    COALESCE_TARGET_BYTES each to hold the boundary's p50 total bytes.
    Shrink-only — history never raises parallelism above the static
    plan."""
    from blaze_tpu_torch.plan import statstore
    st = (prior.get("stages") or {}).get(sfp)
    if not st:
        return None
    p50 = statstore.sketch_quantile(st.get("total_bytes") or {}, 0.5)
    if p50 is None or p50 <= 0:
        return None
    new_n = max(1, -(-int(p50) // COALESCE_TARGET_BYTES))
    return new_n if new_n < n_out else None


def _agg_skip_ratio() -> float:
    from blaze_tpu_torch import config
    return float(config.PARTIAL_AGG_SKIPPING_RATIO.get())


def seed_plan(plan: Dict[str, Any], sched=None) -> Dict[str, Any]:
    """Bind-time history seeding: returns the (deep-copied) rewritten
    plan, or `plan` unchanged when seeding is off, no prior exists, or
    anything at all goes wrong — a corrupted or empty statstore always
    falls back to static planning with zero errors."""
    if not history_seed_enabled():
        return plan
    try:
        return _seed_plan(plan, sched)
    except Exception:
        log.warning("aqe: history seeding failed; static plan kept",
                    exc_info=True)
        return plan


def _seed_plan(plan: Dict[str, Any], sched) -> Dict[str, Any]:
    from blaze_tpu_torch.plan import advisor, statstore
    from blaze_tpu_torch.plan import fingerprint as fp_mod
    if not statstore.enabled():
        return plan
    prior = statstore.prior(fp_mod.plan_fingerprint(plan))
    if not prior:
        return plan
    by_fp: Dict[str, Dict[str, dict]] = {}
    for rec in advisor.recommendations(prior):
        by_fp.setdefault(rec["fingerprint"], {})[rec["rule"]] = rec

    seeds: List[dict] = []
    new_plan = copy.deepcopy(plan)

    # 1) pre-broadcast historically-small build sides: splice out BOTH
    # exchanges of the join (broadcast needs no co-partitioning)
    for node in _walk_nodes(new_plan):
        if node.get("kind") != "hash_join" \
                or node.get("join_type", "inner") != "inner":
            continue
        build_key = "right" if node.get("build_side", "right") == "right" \
            else "left"
        probe_key = "left" if build_key == "right" else "right"
        build = node.get(build_key)
        if not isinstance(build, dict) \
                or build.get("kind") != "local_exchange":
            continue
        sfp = _exchange_sfp(build)
        rec = by_fp.get(sfp, {}).get("broadcast") if sfp else None
        if rec is None:
            continue
        dfp = fp_mod.derived_fingerprint(sfp, "seed_broadcast",
                                         {"threshold": rec["threshold"]})
        node["kind"] = "broadcast_join"
        node["broadcast_id"] = f"aqe-seed-{dfp[:16]}"
        node[build_key] = build["input"]
        probe = node.get(probe_key)
        if isinstance(probe, dict) and probe.get("kind") == "local_exchange":
            node[probe_key] = probe["input"]
        seeds.append({"rule": "seed_broadcast", "fingerprint": dfp,
                      "evidence": dict(rec["evidence"])})

    # 2) shrink partition counts toward the coalesce target.  Join
    # children must stay co-partitioned: both sides move to ONE unified
    # count (the max of the sides' desires keeps the most parallelism).
    handled: set = set()
    for node in _walk_nodes(new_plan):
        if node.get("kind") not in ("hash_join", "sort_merge_join"):
            continue
        left, right = node.get("left"), node.get("right")
        if not (isinstance(left, dict)
                and left.get("kind") == "local_exchange"
                and isinstance(right, dict)
                and right.get("kind") == "local_exchange"):
            continue
        handled.add(id(left))
        handled.add(id(right))
        desires = []
        for side in (left, right):
            part = side.get("partitioning") or {}
            if part.get("kind") != "hash":
                desires = []
                break
            n_out = int(part.get("num_partitions", 1))
            sfp = _exchange_sfp(side)
            if sfp is None or "skew_split" in by_fp.get(sfp, {}):
                continue  # keep partitions for the runtime skew rule
            want = _desired_partitions(prior, sfp, n_out)
            if want is not None:
                desires.append(want)
        if not desires:
            continue
        unified = max(desires)
        for side in (left, right):
            n_out = int(side["partitioning"].get("num_partitions", 1))
            if unified < n_out:
                side["partitioning"]["num_partitions"] = unified
                seeds.append({"rule": "seed_partitions",
                              "from": n_out, "to": unified})
    for node in _walk_nodes(new_plan):
        if node.get("kind") != "local_exchange" or id(node) in handled:
            continue
        part = node.get("partitioning") or {}
        if part.get("kind") != "hash":
            continue
        n_out = int(part.get("num_partitions", 1))
        sfp = _exchange_sfp(node)
        if sfp is None or "skew_split" in by_fp.get(sfp, {}):
            continue
        want = _desired_partitions(prior, sfp, n_out)
        if want is not None:
            node["partitioning"]["num_partitions"] = want
            seeds.append({"rule": "seed_partitions",
                          "from": n_out, "to": want})

    # 3) pre-select the partial-agg skip strategy when history already
    # shows the grouping barely reduces (the probe would decide the
    # same thing — this just skips the probe's buffering warm-up).
    # `supports_partial_skipping` survives the protobuf round trip and
    # the planner threads it to AggExec as skip_partial_hint.
    ratio = (prior.get("derived") or {}).get("agg_probe_ratio")
    if ratio is not None and float(ratio) >= _agg_skip_ratio():
        for node in _walk_nodes(new_plan):
            if node.get("kind") != "hash_agg" or not node.get("groupings"):
                continue
            modes = [a.get("mode", "partial")
                     for a in node.get("aggs") or []]
            if modes and all(m == "partial" for m in modes) \
                    and not node.get("supports_partial_skipping"):
                node["supports_partial_skipping"] = True
                seeds.append({"rule": "seed_agg_skip",
                              "ratio": float(ratio)})

    if not seeds:
        return plan
    from blaze_tpu_torch.bridge import device_stats, tracing
    device_stats.note_aqe(history_seeds=len(seeds))
    tracing.instant("aqe_history_seed", seeds=len(seeds))
    if sched is not None:
        for s in seeds:
            sched.aqe_events.append({"stage": None, **s})
    return new_plan
