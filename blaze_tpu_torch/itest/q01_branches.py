"""Two branches of TPC-DS q01 over four stages, as TaskDefinitions the JAX
package's runtime accepts unchanged, with the function that runs them
through the port's runtime (`itest/q01.py` `run_stages`) and pyarrow
oracles.

  1  map  (n_maps)     q01's map stage (itest/q01.py `stage1_td`)
  2  ctr  (n_reduces)  ipc_reader -> final hash_agg sum by (customer,
                       store) -> shuffle_writer hash(ctr_store_sk) into
                       n_reduces: the re-exchange of ctr
                       (blaze_tpu/itest/queries.py:162-163)
  3a avg  (n_reduces)  ipc_reader -> partial hash_agg avg(ctr_total_return)
                       by ctr_store_sk -> final hash_agg avg -> project
                       (avg_store_sk, avg_return, avg_return * 1.2 as
                       threshold) -> shuffle_writer single
                       (queries.py:164-168 and the `*` of :172-174)
  4a      (1)          ipc_reader -> sort avg_store_sk asc, fetch 100 ->
                       limit 100 (queries.py `sort_limit`)
  3b top  (n_reduces)  ipc_reader -> sort (ctr_total_return desc nulls
                       last, ctr_customer_sk asc nulls first, ctr_store_sk
                       asc), fetch 100 -> shuffle_writer single (Spark's
                       TakeOrderedAndProject over ctr)
  4b      (1)          ipc_reader -> the same sort, fetch 100 -> limit 100

Stages 3a and 3b both read stage 2's shuffle.  avg never fuses, so stage
3a runs the generic aggregation engine (ops/agg/exec.py); the sorts run
SortExec (ops/sort.py), on the device from 1024 rows up.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.itest import q01

CTR_RESOURCE = "q01_ctr_shuffle"
AVG_RESOURCE = "q01_avg_shuffle"
TOP_RESOURCE = "q01_top_shuffle"
LIMIT = 100

#: q01's stage counters plus the generic engine's and the sort's
STAGE_COUNTERS = q01.STAGE_COUNTERS + ("sort_device_runs",
                                       "passthrough_rows")

_I64 = {"id": "int64"}
_F64 = {"id": "float64"}
CTR_SCHEMA_D = {"fields": [
    {"name": "ctr_customer_sk", "type": _I64, "nullable": True},
    {"name": "ctr_store_sk", "type": _I64, "nullable": True},
    {"name": "ctr_total_return", "type": _F64, "nullable": True},
]}
AVG_SCHEMA_D = {"fields": [
    {"name": "avg_store_sk", "type": _I64, "nullable": True},
    {"name": "avg_return", "type": _F64, "nullable": True},
    {"name": "threshold", "type": _F64, "nullable": True},
]}
#: (column, descending, nulls_first) of the top-returns order
TOP_ORDER = [("ctr_total_return", True, False),
             ("ctr_customer_sk", False, True),
             ("ctr_store_sk", False, True)]

STAGES = ("map", "ctr", "avg", "avg_limit", "top", "top_limit")


def _ci(i):
    return {"kind": "column", "index": i}


def _reader(resource, schema, n_parts):
    return {"kind": "ipc_reader", "resource_id": resource, "schema": schema,
            "num_partitions": n_parts}


def _writer(inp, partitioning, out_dir, task):
    return {"kind": "shuffle_writer", "input": inp,
            "partitioning": partitioning,
            "data_file": os.path.join(out_dir, f"shuffle_{task}.data"),
            "index_file": os.path.join(out_dir, f"shuffle_{task}.index")}


def _td(stage_id, task, n_tasks, plan) -> Dict:
    return {"stage_id": stage_id, "partition_id": task,
            "num_partitions": n_tasks, "plan": plan}


def _top_sort(inp) -> Dict:
    names = [f["name"] for f in CTR_SCHEMA_D["fields"]]
    return {"kind": "sort", "input": inp, "fetch": LIMIT,
            "specs": [{"expr": _ci(names.index(c)), "descending": d,
                       "nulls_first": nf} for c, d, nf in TOP_ORDER]}


def ctr_td(r, n_reduces, out_dir) -> Dict:
    plan = q01.stage2_td(r, n_reduces)["plan"]
    return _td(2, r, n_reduces, _writer(
        plan, {"kind": "hash", "exprs": [_ci(1)],
               "num_partitions": n_reduces}, out_dir, r))


def avg_td(r, n_reduces, out_dir) -> Dict:
    partial = {"kind": "hash_agg",
               "input": _reader(CTR_RESOURCE, CTR_SCHEMA_D, n_reduces),
               "groupings": [{"expr": _ci(1), "name": "avg_store_sk"}],
               "aggs": [{"fn": "avg", "mode": "partial",
                         "name": "avg_return", "args": [_ci(2)]}]}
    final = {"kind": "hash_agg", "input": partial,
             "groupings": [{"expr": _ci(0), "name": "avg_store_sk"}],
             "aggs": [{"fn": "avg", "mode": "final", "name": "avg_return",
                       "args": [_ci(1), _ci(2)]}]}
    proj = {"kind": "project", "input": final,
            "exprs": [_ci(0), _ci(1),
                      {"kind": "binary", "op": "*", "l": _ci(1),
                       "r": {"kind": "literal", "value": 1.2,
                             "type": _F64}}],
            "names": ["avg_store_sk", "avg_return", "threshold"]}
    return _td(3, r, n_reduces, _writer(proj, {"kind": "single"}, out_dir,
                                        r))


def avg_limit_td() -> Dict:
    srt = {"kind": "sort", "input": _reader(AVG_RESOURCE, AVG_SCHEMA_D, 1),
           "specs": [{"expr": _ci(0), "descending": False,
                      "nulls_first": True}],
           "fetch": LIMIT}
    return _td(4, 0, 1, {"kind": "limit", "limit": LIMIT, "input": srt})


def top_td(r, n_reduces, out_dir) -> Dict:
    return _td(5, r, n_reduces, _writer(
        _top_sort(_reader(CTR_RESOURCE, CTR_SCHEMA_D, n_reduces)),
        {"kind": "single"}, out_dir, r))


def top_limit_td() -> Dict:
    return _td(6, 0, 1, {"kind": "limit", "limit": LIMIT, "input": _top_sort(
        _reader(TOP_RESOURCE, CTR_SCHEMA_D, 1))})


def stage_dirs(tmpdir) -> Dict[str, str]:
    """The directory each shuffle-writing stage writes its files into."""
    return {name: os.path.join(tmpdir, name)
            for name in ("map", "ctr", "avg", "top")}


def stages(sr_paths, lo, hi, tmpdir, n_maps, n_reduces) -> List[q01.Stage]:
    """The six stages, in an order that runs each after what it reads."""
    d = stage_dirs(tmpdir)
    for path in d.values():
        os.makedirs(path, exist_ok=True)
    S = q01.Stage
    return [
        S("map", lambda m: q01.stage1_td(sr_paths, lo, hi, m, d["map"],
                                         n_maps, n_reduces),
          n_maps, out_dir=d["map"], out_partitions=n_reduces),
        S("ctr", lambda r: ctr_td(r, n_reduces, d["ctr"]), n_reduces,
          out_dir=d["ctr"], out_partitions=n_reduces, reads="map",
          resource=q01.SHUFFLE_RESOURCE),
        S("avg", lambda r: avg_td(r, n_reduces, d["avg"]), n_reduces,
          out_dir=d["avg"], out_partitions=1, reads="ctr",
          resource=CTR_RESOURCE),
        S("avg_limit", lambda _t: avg_limit_td(), 1, reads="avg",
          resource=AVG_RESOURCE),
        S("top", lambda r: top_td(r, n_reduces, d["top"]), n_reduces,
          out_dir=d["top"], out_partitions=1, reads="ctr",
          resource=CTR_RESOURCE),
        S("top_limit", lambda _t: top_limit_td(), 1, reads="top",
          resource=TOP_RESOURCE),
    ]


def run_branches(sr_paths, lo, hi, tmpdir, n_maps, n_reduces
                 ) -> Dict[str, Dict]:
    """All six stages through the port's runtime (`q01.run_stages`)."""
    return q01.run_stages(stages(sr_paths, lo, hi, tmpdir, n_maps,
                                 n_reduces), STAGE_COUNTERS)


def table(batches) -> pa.Table:
    return pa.Table.from_batches(batches).combine_chunks()


# ---------------------------------------------------------------------------
# oracles
# ---------------------------------------------------------------------------

def avg_oracle(ctr: pa.Table) -> pa.Table:
    """Over ctr (itest/q01.py `oracle`): avg(ctr_total_return) by store,
    sorted by store (nulls first), first LIMIT rows."""
    g = ctr.group_by("ctr_store_sk").aggregate(
        [("ctr_total_return", "mean")]).rename_columns(
        ["avg_store_sk", "avg_return"])
    key = g["avg_store_sk"]
    null = np.asarray(key.is_null())
    order = np.lexsort((np.asarray(key.fill_null(0)), ~null))
    return g.take(pa.array(order)).slice(0, LIMIT)


def top_order(ctr: pa.Table) -> np.ndarray:
    """Row order of ctr under TOP_ORDER (stable)."""
    keys = []
    for name, desc, nulls_first in TOP_ORDER:
        col = ctr[name]
        null = np.asarray(col.is_null())
        v = np.asarray(col.fill_null(0).to_numpy(zero_copy_only=False))
        v = np.where(null, 0, v)
        keys.append(null if not nulls_first else ~null)
        keys.append(-v if desc else v)
    # np.lexsort: the last key is the primary one
    return np.lexsort(tuple(reversed(keys)))


def top_oracle(ctr: pa.Table) -> pa.Table:
    """The ctr rows (itest/q01.py `oracle`) in TOP_ORDER, all of them (a
    check compares its first LIMIT rows, ties aside)."""
    return ctr.take(pa.array(top_order(ctr)))


def check_avg(got: pa.Table, want: pa.Table, rel: float) -> float:
    """Store keys and order exact, averages within `rel`; returns the
    largest relative error.  Raises AssertionError naming what differs."""
    if got["avg_store_sk"].to_pylist() != want["avg_store_sk"].to_pylist():
        raise AssertionError(
            f"avg-by-store keys differ: {got['avg_store_sk'].to_pylist()} "
            f"against {want['avg_store_sk'].to_pylist()}")
    err = _max_rel(got["avg_return"], want["avg_return"], "avg_return")
    thr = _max_rel(got["threshold"], pa.compute.multiply(want["avg_return"],
                                                         1.2), "threshold")
    err = max(err, thr)
    if err > rel:
        raise AssertionError(f"averages differ by {err:.3e} relative "
                             f"(limit {rel:.0e})")
    return err


def check_top(got: pa.Table, ordered: pa.Table, rel: float) -> float:
    """The first LIMIT rows of `ordered` (top_oracle) against `got`: keys
    and order exact and totals within `rel`, except that rows whose totals
    tie (equal in cents: the data are cents) may come in another order
    among themselves, and the last tie run may be cut elsewhere.  Returns
    the largest relative error of the totals."""
    n = got.num_rows
    if n != min(LIMIT, ordered.num_rows):
        raise AssertionError(f"top returns: {n} rows, expected "
                             f"{min(LIMIT, ordered.num_rows)}")
    want = ordered.slice(0, n)
    err = _max_rel(got["ctr_total_return"], want["ctr_total_return"],
                   "ctr_total_return")
    if err > rel:
        raise AssertionError(f"top returns: totals differ by {err:.3e} "
                             f"relative (limit {rel:.0e})")
    keys = ("ctr_customer_sk", "ctr_store_sk")
    g_keys = list(zip(*(got[k].to_pylist() for k in keys)))
    w_keys = list(zip(*(want[k].to_pylist() for k in keys)))
    if g_keys == w_keys:
        return err
    # a row out of the oracle's order must tie (in cents) with the row
    # the oracle has there, and belong to that tie run of the oracle
    g_cents = np.round(np.asarray(got["ctr_total_return"]) * 100)
    w_cents = np.round(np.asarray(want["ctr_total_return"]) * 100)
    bad = [i for i in range(n) if g_keys[i] != w_keys[i]]
    need = {g_cents[i] for i in bad}
    runs: Dict[float, set] = {}
    cents = np.round(np.asarray(ordered["ctr_total_return"]) * 100)
    for k, c in zip(zip(*(ordered[k].to_pylist() for k in keys)), cents):
        if c in need:
            runs.setdefault(c, set()).add(k)
    for i in bad:
        if g_cents[i] != w_cents[i] or g_keys[i] not in runs[g_cents[i]]:
            raise AssertionError(f"top returns: row {i} is {g_keys[i]}, "
                                 f"the oracle's is {w_keys[i]}, outside a "
                                 f"tie")
    if len(set(g_keys)) != n:
        raise AssertionError("top returns: a row appears twice")
    return err


def _max_rel(a, b, name) -> float:
    x = np.asarray(a.fill_null(np.nan), dtype=np.float64)
    y = np.asarray(b.fill_null(np.nan), dtype=np.float64)
    if not np.array_equal(np.isnan(x), np.isnan(y)):
        raise AssertionError(f"{name}: NULLs differ")
    ok = ~np.isnan(y)
    if not ok.any():
        return 0.0
    return float(np.max(np.abs(x[ok] - y[ok])
                        / np.maximum(np.abs(y[ok]), 1e-300)))


def device_sorts(res: Dict[str, Dict]) -> Tuple[int, int]:
    """(sorts of the run that had DEVICE_SORT_MIN_ROWS rows or more, the
    `sort_device_runs` the stages counted).  The two agree when every
    such sort ran on the device: the stage-3b tasks' and stage 4b's (the
    avg branch's stage 4a reads one row per store)."""
    from blaze_tpu_torch.ops.sort import DEVICE_SORT_MIN_ROWS
    ran = sum(res[st]["counters"].get("sort_device_runs", 0)
              for st in ("avg_limit", "top", "top_limit"))
    rows = top_input_rows(res)
    return sum(r >= DEVICE_SORT_MIN_ROWS for r in rows), ran


def top_input_rows(res: Dict[str, Dict]) -> List[int]:
    """Rows each sort of the top branch reads: one per stage-3b task (its
    partition of stage 2's shuffle), then stage 4b's."""
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionReader
    rows = []
    written = res["ctr"]["shuffle"]
    for part in range(len(res["top"]["outputs"])):
        n = 0
        for data, _index, offs in written:
            n += _frame_rows(data, offs[part], offs[part + 1],
                             IpcCompressionReader)
        rows.append(n)
    n = 0
    for data, _index, offs in res["top"]["shuffle"]:
        n += _frame_rows(data, offs[0], offs[1], IpcCompressionReader)
    rows.append(n)
    return rows


def _frame_rows(path, start, end, reader_cls) -> int:
    if end <= start:
        return 0
    import io
    with open(path, "rb") as f:
        f.seek(start)
        buf = f.read(end - start)
    return sum(b.num_rows for b in reader_cls(io.BytesIO(buf)).read_batches())
