"""Adaptive execution and the statistics plane end to end: the legs of
chip_smoke.py's `adaptive` phase, each a plan of bench.py's AQE benchmark
(`join_plan`, `agg_plan`) at a Spark job's sizes, run static and then
adaptive through the port's DagScheduler with
`auron.tpu.dag.singleTaskBytes` 0 (staged):

  broadcast  a dim of 2^18 keys (int64 k, float64 w; ~4 MiB) hash-joined
             with a fact of 2^24 rows (int64 k uniform over the dim's
             keys, float64 v; ~256 MiB) through hash exchanges of 32
             partitions, the dim the build side; the default thresholds
             (broadcast 8 MiB): the build fits, so the join becomes a
             broadcast and the fact's exchange never runs;
  skew       the same dim with a fact whose keys are 0 for 70% of its rows,
             160 partitions, `auron.tpu.aqe.broadcastThreshold` 0: the hot
             partition splits by map segments (skew factor 4, at most 8
             splits) and the rest coalesce toward 16 MiB;
  coalesce   a partial sum by key (2^16 keys) over 2^24 rows, a hash
             exchange of 200 partitions (Spark's default shuffle
             partitions), the final sum: the 200 tiny partitions coalesce;
  history    the broadcast leg twice in a fresh statistics store: the
             broadcast leg's adaptive run records the build side's
             boundary, and a second run with `auron.tpu.aqe.historySeed`
             pre-broadcasts it at bind time (`aqe_history_seeds`); its
             static and first runs are the broadcast leg's.

Every adaptive run also has the statistics store on (a directory of its
leg's own; the history leg's is the broadcast leg's), so each leg leaves
a record, and is traced, so that the advisor's findings (plan/advisor.py)
for the record and the run's bottleneck report (bridge/critical_path.py)
are reported.  The fact tables are 8 files, so 8 map
tasks write each exchange.  A run's result must equal its static run's
(order-insensitive, bit for bit: every rule re-buckets the same shuffle
segments) and its pandas oracle (the joins bit for bit; the sums within
1e-9 relative), compared by `digest` (the row count and a 64-bit hash
sum, order-insensitive), and show the counter deltas its leg names
(`MUST_SHOW`): a failing rule is swallowed and the static plan kept,
so the deltas are what shows a rule ran at all, and the warning it logs
fails the run.

    python -m blaze_tpu_torch.itest.adaptive --rows-log2 16 --device cpu
    python -m blaze_tpu_torch.itest.adaptive
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

LEGS = ("broadcast", "skew", "coalesce", "history")
FACT_FILES = 8
HOT_FRAC = 0.7
PARTITIONS = {"broadcast": 32, "skew": 160, "coalesce": 200,
              "history": 32}
#: (counter, least delta) each leg's adaptive run must show; the history
#: leg's are its second run's
MUST_SHOW = {
    "broadcast": (("aqe_broadcast_switches", 1), ("aqe_stages_elided", 1),
                  ("aqe_bytes_saved", 1)),
    "skew": (("aqe_skew_splits", 1), ("aqe_partitions_coalesced", 1)),
    "coalesce": (("aqe_partitions_coalesced", 1),),
    "history": (("aqe_history_seeds", 1),),
}
REL = 1e-9
#: the loggers whose warnings fail a run (`logged_warnings`)
WARNING_LOGGERS = ("blaze_tpu_torch.aqe", "blaze_tpu_torch.statstore")

_SCHEMA = lambda a, b: {"fields": [  # noqa: E731
    {"name": a, "type": {"id": "int64"}, "nullable": True},
    {"name": b, "type": {"id": "float64"}, "nullable": True}]}


def leg_conf(leg: str, stats_dir: str) -> Dict[str, Any]:
    """The adaptive run's conf: AQE and the statistics store on, the
    default thresholds unless the leg says otherwise."""
    conf = {"auron.tpu.aqe.enable": "true",
            "auron.tpu.stats.enable": "true",
            "auron.tpu.stats.dir": stats_dir}
    if leg == "skew":
        conf["auron.tpu.aqe.broadcastThreshold"] = "0"
    if leg == "history":
        conf["auron.tpu.aqe.historySeed"] = "true"
    return conf


# -- data and plans ---------------------------------------------------------

def write_splits(root: str, name: str, t: pa.Table,
                 nsplit: int) -> List[List[str]]:
    paths = []
    step = -(-t.num_rows // nsplit)
    for i in range(nsplit):
        p = os.path.join(root, f"{name}-{i}.parquet")
        pq.write_table(t.slice(i * step, step), p)
        paths.append([p])
    return paths


def make_data(root: str, rows_log2: int = 24, seed: int = 17) -> Dict:
    """The dim (rows / 64 keys), the uniform and the skewed fact
    (2^rows_log2 rows each) and the aggregation's input (rows / 256
    keys), as tables and as parquet files."""
    rng = np.random.default_rng(seed)
    n = 1 << rows_log2
    dim_keys = max(2, n >> 6)
    dim = pa.table({"k": pa.array(np.arange(dim_keys, dtype=np.int64)),
                    "w": pa.array(rng.random(dim_keys))})
    uniform = pa.table({"k": pa.array(rng.integers(0, dim_keys, n)),
                        "v": pa.array(rng.random(n))})
    skewed = pa.table({"k": pa.array(np.where(
        rng.random(n) < HOT_FRAC, 0, rng.integers(1, dim_keys, n))),
        "v": pa.array(rng.random(n))})
    agg = pa.table({"k": pa.array(rng.integers(0, max(2, n >> 8), n)),
                    "v": pa.array(rng.random(n))})
    tables = {"dim": dim, "uniform": uniform, "skewed": skewed, "agg": agg}
    with ThreadPoolExecutor(4) as pool:  # pyarrow releases the GIL
        futures = {name: pool.submit(write_splits, root, name, t,
                                     2 if name == "dim" else FACT_FILES)
                   for name, t in tables.items()}
        paths = {name: f.result() for name, f in futures.items()}
    return {"tables": tables, "paths": paths, "rows": n,
            "dim_keys": dim_keys}


def _exchange(inp: Dict, nparts: int) -> Dict:
    return {"kind": "local_exchange",
            "partitioning": {"kind": "hash",
                             "exprs": [{"kind": "column", "index": 0}],
                             "num_partitions": nparts},
            "input": inp}


def _scan(schema: Dict, groups: List[List[str]]) -> Dict:
    return {"kind": "parquet_scan", "schema": schema, "file_groups": groups}


def join_plan(data: Dict, fact: str, nparts: int) -> Dict:
    """dim (the build side, left) shuffle-joined with `fact`."""
    return {"kind": "hash_join", "join_type": "inner",
            "left": _exchange(_scan(_SCHEMA("k", "w"),
                                    data["paths"]["dim"]), nparts),
            "right": _exchange(_scan(_SCHEMA("k", "v"),
                                     data["paths"][fact]), nparts),
            "left_keys": [{"kind": "column", "index": 0}],
            "right_keys": [{"kind": "column", "index": 0}],
            "build_side": "left"}


def agg_plan(data: Dict, nparts: int) -> Dict:
    """Partial sum by key -> hash exchange -> final sum."""
    def agg(mode, col, inp):
        return {"kind": "hash_agg", "input": inp,
                "groupings": [{"expr": col("k", 0), "name": "k"}],
                "aggs": [{"fn": "sum", "mode": mode, "name": "s",
                          "args": [col("v", 1)]}]}
    by_name = lambda n, _i: {"kind": "column", "name": n}  # noqa: E731
    by_index = lambda _n, i: {"kind": "column", "index": i}  # noqa: E731
    return agg("final", by_index, _exchange(agg(
        "partial", by_name, _scan(_SCHEMA("k", "v"),
                                  data["paths"]["agg"])), nparts))


def plan_for(leg: str, data: Dict) -> Dict:
    if leg == "coalesce":
        return agg_plan(data, PARTITIONS[leg])
    fact = "skewed" if leg == "skew" else "uniform"
    return join_plan(data, fact, PARTITIONS[leg])


# -- results and oracles ----------------------------------------------------

def digest(columns: List[np.ndarray]) -> tuple:
    """An order-insensitive fingerprint of a table's rows: the row count
    and the wrapping sum of a 64-bit mix of each row's value bits.  Two
    tables with the same rows in any order give the same pair; different
    rows collide with a chance of about 2^-64."""
    n = len(columns[0]) if columns else 0
    h = np.zeros(n, dtype=np.uint64)
    for i, col in enumerate(columns):
        np.bitwise_xor(h, np.ascontiguousarray(col).view(np.uint64), out=h)
        np.multiply(h, np.uint64(0x9E3779B97F4A7C15), out=h)
        np.add(h, np.uint64(i + 1), out=h)
        np.bitwise_xor(h, h >> np.uint64(29), out=h)
    return (n, int(h.sum(dtype=np.uint64)))


def table_digest(t: pa.Table) -> tuple:
    return digest([c.to_numpy() for c in t.columns])


def join_oracle(data: Dict, fact: str) -> tuple:
    """pandas' inner join of the dim and `fact` (each fact key looked up in
    the dim's unique keys; a key the dim lacks drops its row), in the
    engine's column order (the dim's k, w, then the fact's k, v), as a
    digest."""
    import pandas as pd
    dim = data["tables"]["dim"].to_pandas()
    df = data["tables"][fact].to_pandas()
    df["w"] = df["k"].map(pd.Series(dim["w"].to_numpy(), index=dim["k"]))
    df = df[df["k"].isin(dim["k"])]
    k = df["k"].to_numpy()
    return digest([k, df["w"].to_numpy(), k, df["v"].to_numpy()])


def agg_oracle(data: Dict):
    """pandas' sum by key, ordered by key."""
    return data["tables"]["agg"].to_pandas().groupby(
        "k", as_index=False)["v"].sum().sort_values("k")


def agg_error(got: pa.Table, want) -> Optional[str]:
    """Keys exact, sums within REL of pandas' (its order of adds is not
    the engine's)."""
    g = got.to_pandas().sort_values("k")
    if not np.array_equal(g["k"].to_numpy(), want["k"].to_numpy()):
        return f"keys differ: {len(g)} against the oracle's {len(want)}"
    a, b = g["s"].to_numpy(), want["v"].to_numpy()
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
    return None if rel <= REL else f"sums off by {rel:.3g} relative"


# -- runs -------------------------------------------------------------------

def _set_conf(conf: Dict[str, Any]) -> None:
    from blaze_tpu_torch import config
    from blaze_tpu_torch.plan import adaptive, statstore
    for k, v in conf.items():
        config.conf.set(k, v)
    adaptive.reset_conf_probe()
    statstore.reset_conf_probe()


def _unset_conf(conf: Dict[str, Any]) -> None:
    from blaze_tpu_torch import config
    from blaze_tpu_torch.plan import adaptive, statstore
    for k in conf:
        config.conf.unset(k)
    adaptive.reset_conf_probe()
    statstore.reset_conf_probe()


class _Warnings(logging.Handler):
    def __init__(self) -> None:
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


@contextlib.contextmanager
def logged_warnings():
    """The warnings plan/adaptive.py and plan/statstore.py log inside the
    block: a rule or a history seed that failed and left the static plan,
    an ingest that failed.  The rules swallow their errors, so these are
    what shows one."""
    h = _Warnings()
    loggers = [logging.getLogger(n) for n in WARNING_LOGGERS]
    for lg in loggers:
        lg.addHandler(h)
    try:
        yield h.messages
    finally:
        for lg in loggers:
            lg.removeHandler(h)


def run_plan(plan: Dict, conf: Dict[str, Any], work_dir: str,
             traced: bool = False) -> Dict:
    """One run of `plan` under `conf`: its table, wall, tasks per stage
    (after any rewrite), events, the aqe/stats counter deltas and the
    warnings logged; `traced`, also the run's bottleneck report
    (bridge/critical_path.py over its spans, the critical path left
    out)."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.bridge import critical_path, device_stats, tracing
    from blaze_tpu_torch.plan.stages import DagScheduler
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    _set_conf(conf)
    if traced:
        tracing.start_tracing()
    try:
        before = device_stats.snapshot()
        sched = DagScheduler(work_dir=work_dir)
        with logged_warnings() as warnings:
            t0 = time.perf_counter()
            out = sched.run_collect(copy.deepcopy(plan))
            wall = time.perf_counter() - t0
        after = device_stats.snapshot()
    finally:
        spans = tracing.stop_tracing() if traced else []
        _unset_conf(conf)
        config.conf.unset(config.DAG_SINGLE_TASK_BYTES.key)
    bottleneck = critical_path.bottleneck_report(spans, wall) \
        if spans else None
    if bottleneck:
        bottleneck.pop("critical_path")
    delta = {k: after[k] - before.get(k, 0) for k in after
             if k.startswith(("aqe_", "stats_")) and not k.endswith("_last")
             and after[k] != before.get(k, 0)}
    elided = {e["elided_stage"] for e in sched.aqe_events
              if "elided_stage" in e}
    return {"table": out, "wall_s": wall,
            "stages": len(sched.stages),
            "tasks": {st.sid: st.num_tasks for st in sched.stages
                      if st.sid not in elided},
            "elided": sorted(elided),
            "stage_walls": dict(sched.stage_walls),
            "events": list(sched.aqe_events), "delta": delta,
            "fingerprint": sched.stats_fingerprint,
            "warnings": warnings, "bottleneck": bottleneck,
            "task_runs": {k: v for k, v in sched.task_runs.items()
                          if v != 1},
            "leaks": {k: v for k, v in sched.leak_report().items() if v}}


def findings(stats_dir: str, fingerprint: Optional[str],
             bottleneck: Optional[Dict] = None) -> List[Dict]:
    """The advisor's findings for the stored record of `fingerprint` and
    a run's bottleneck report."""
    from blaze_tpu_torch.plan import advisor, statstore
    rec = statstore.StatStore(stats_dir).record(fingerprint or "")
    return advisor.findings(rec, bottleneck) if rec else []


def _oracle(leg: str, data: Dict):
    """The leg's pandas oracle, computed once per data set."""
    fact = "agg" if leg == "coalesce" else \
        "skewed" if leg == "skew" else "uniform"
    cache = data.setdefault("oracles", {})
    if fact not in cache:
        cache[fact] = agg_oracle(data) if fact == "agg" else \
            join_oracle(data, fact)
    return cache[fact]


def _checked(leg: str, data: Dict, r: Dict) -> Dict:
    """Replace a run's table by its digest, its row count and its
    difference from the oracle (None where equal)."""
    t = r.pop("table")
    want = _oracle(leg, data)
    r["digest"] = table_digest(t)
    r["rows"] = t.num_rows
    if leg == "coalesce":
        r["oracle_error"] = agg_error(t, want)
    else:
        r["oracle_error"] = None if r["digest"] == want else \
            f"{t.num_rows} rows differ from the oracle's {want[0]}"
    return r


def run_leg(leg: str, data: Dict, root: str,
            counted: Callable[[], Any] = contextlib.nullcontext,
            broadcast: Optional[Dict] = None) -> Dict:
    """The leg static and then adaptive, the adaptive run inside
    `counted()` (chip_smoke.py counts the kernels' launches there); its
    checks' failures in `failures`.  The history leg is the broadcast leg
    (`broadcast`, that leg's result, run here where not given) and one
    more run: the broadcast leg's adaptive run, made in a fresh store,
    recorded the build side's boundary, and the history leg's seeded run
    reads it from the same store."""
    plan = plan_for(leg, data)
    if leg == "history":
        if broadcast is None:
            broadcast = run_leg("broadcast", data, root)
        static, earlier = broadcast["static"], broadcast["adaptive"]
        stats_dir = broadcast["stats_dir"]
    else:
        static = _checked(leg, data, run_plan(
            plan, {}, os.path.join(root, f"{leg}-static")))
        earlier, stats_dir = [], os.path.join(root, f"stats-{leg}")
    with counted():
        run = run_plan(plan, leg_conf(leg, stats_dir),
                       os.path.join(root, f"{leg}-aqe"), traced=True)
    runs = earlier + [_checked(leg, data, run)]
    labels = ["static"] + [f"adaptive {i}" for i in range(len(runs))]
    failures = [f"{leg} {label}: {r['oracle_error']}"
                for label, r in zip(labels, [static] + runs)
                if r["oracle_error"]]
    for label, r in zip(labels[1:], runs):
        if r["digest"] != static["digest"]:
            failures.append(f"{leg} {label}: differs from the static run")
        if r["task_runs"] or r["leaks"]:
            failures.append(f"{leg} {label}: tasks ran twice "
                            f"{r['task_runs']} or leaked {r['leaks']}")
        if r["warnings"]:
            failures.append(f"{leg} {label}: {r['warnings']}")
    shown = runs[-1]["delta"]
    for key, least in MUST_SHOW[leg]:
        if shown.get(key, 0) < least:
            failures.append(f"{leg}: {key} moved by {shown.get(key, 0)}, "
                            f"expected at least {least}")
    return {"leg": leg, "partitions": PARTITIONS[leg],
            "rows": static["rows"], "static": static, "adaptive": runs,
            "stats_dir": stats_dir,
            "findings": findings(stats_dir, runs[-1]["fingerprint"],
                                 runs[-1]["bottleneck"]),
            "failures": failures}


def main(argv=None) -> int:
    from blaze_tpu_torch import config
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows-log2", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--legs", default=",".join(LEGS))
    args = ap.parse_args(argv)
    config.conf.set(config.TORCH_DEVICE.key, args.device)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        data = make_data(root, args.rows_log2)
        for leg in args.legs.split(","):
            out[leg] = run_leg(leg, data, root,
                               broadcast=out.get("broadcast"))
    failures = [f for r in out.values() for f in r["failures"]]
    print(json.dumps({"rows_log2": args.rows_log2, "device": args.device,
                      "legs": out, "failures": failures}, default=str))
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
