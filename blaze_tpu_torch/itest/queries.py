"""TPC-DS q01 as a plan-IR dict with its pandas oracle (a copy of the
plan-dict helpers and the `q01` function of blaze_tpu/itest/queries.py).

Fact tables are read from parquet file splits; exchanges are
`local_exchange` nodes, which plan/stages.py `DagScheduler` cuts into
stages; aggregations use partial/final pairs as a Spark plan emits them.
`q01` returns (plan_dict, oracle), the oracle computing the
expected frame with pandas.

q01: customers returning more than 1.2x their store's average (BASELINE
config #1).  Date keys follow tpcds_data.gen_date_dim: sk = 2450815 +
day, d_year = 1998 + day // 365.
"""

from __future__ import annotations

import uuid
from typing import Dict, List, Tuple

import pyarrow as pa

from blaze_tpu_torch.plan.types import schema_to_dict
from blaze_tpu_torch.schema import Schema

D0 = 2450815  # first d_date_sk


def _day_range(start_day: int, end_day: int) -> Tuple[int, int]:
    return D0 + start_day, D0 + end_day


def c(name: str) -> dict:
    return {"kind": "column", "name": name}


def ci(index: int) -> dict:
    return {"kind": "column", "index": index}


def lit(v, t: str = "int64") -> dict:
    return {"kind": "literal", "value": v, "type": {"id": t}}


def binop(op: str, l: dict, r: dict) -> dict:
    return {"kind": "binary", "op": op, "l": l, "r": r}


def scan(paths: Dict[str, List[List[str]]], tables: Dict[str, pa.Table],
         name: str) -> dict:
    return {"kind": "parquet_scan",
            "schema": schema_to_dict(Schema.from_arrow(tables[name].schema)),
            "file_groups": paths[name]}


def filter_(inp: dict, *preds: dict) -> dict:
    return {"kind": "filter", "input": inp, "predicates": list(preds)}


def project(inp: dict, exprs: List[dict], names: List[str]) -> dict:
    return {"kind": "project", "input": inp, "exprs": exprs, "names": names}


def exchange(inp: dict, keys: List[dict], partitions: int) -> dict:
    return {"kind": "local_exchange",
            "partitioning": {"kind": "hash", "exprs": keys,
                             "num_partitions": partitions},
            "stage_id": uuid.uuid4().int % (1 << 31),
            "input": inp}


def join(kind: str, left: dict, right: dict, lkeys: List[dict],
         rkeys: List[dict], jt: str = "inner", build: str = "right",
         flt: dict = None) -> dict:
    d = {"kind": kind, "left": left, "right": right, "left_keys": lkeys,
         "right_keys": rkeys, "join_type": jt}
    if kind != "sort_merge_join":
        d["build_side"] = build
    if kind == "broadcast_join":
        d["broadcast_id"] = f"itest-{uuid.uuid4().hex[:10]}"
    if flt is not None:
        d["join_filter"] = flt
    return d


def agg(inp: dict, groups: List[Tuple[dict, str]],
        aggs: List[Tuple[str, str, str, List[dict]]]) -> dict:
    """aggs: (fn, mode, name, args)."""
    return {"kind": "hash_agg", "input": inp,
            "groupings": [{"expr": e, "name": n} for e, n in groups],
            "aggs": [{"fn": f, "mode": m, "name": n, "args": a}
                     for f, m, n, a in aggs]}


def sort_limit(inp: dict, specs: List[Tuple[dict, bool]], limit: int) -> dict:
    return {"kind": "limit", "limit": limit,
            "input": {"kind": "sort", "input": inp,
                      "specs": [{"expr": e, "descending": d,
                                 "nulls_first": not d} for e, d in specs],
                      "fetch": limit}}


def _partial_final(inp: dict, group_names: List[Tuple[dict, str]],
                   fns: List[Tuple[str, str, List[dict]]],
                   partitions: int) -> dict:
    """partial agg -> hash exchange on the group keys -> final agg (the
    two-stage pair Spark emits; acc columns rebind positionally)."""
    partial = agg(inp, group_names,
                  [(f, "partial", n, a) for f, n, a in fns])
    ng = len(group_names)
    ex = exchange(partial, [ci(i) for i in range(ng)], partitions)
    final_groups = [(ci(i), name) for i, (_e, name) in
                    enumerate(group_names)]
    final_aggs = []
    pos = ng
    for f, n, _a in fns:
        nacc = 2 if f == "avg" else 1
        final_aggs.append((f, "final", n,
                           [ci(pos + t) for t in range(nacc)]))
        pos += nacc
    return agg(ex, final_groups, final_aggs)


# ---------------------------------------------------------------------------
# q01
# ---------------------------------------------------------------------------

def q01(paths, tables, partitions: int = 2):
    sr, dd, st, cu = (tables["store_returns"], tables["date_dim"],
                      tables["store"], tables["customer"])

    dd_flt = filter_(scan(paths, tables, "date_dim"),
                     binop("==", c("d_year"), lit(2000, "int32")))
    sr_dd = join("broadcast_join", scan(paths, tables, "store_returns"),
                 dd_flt, [c("sr_returned_date_sk")], [c("d_date_sk")])
    ctr = _partial_final(
        sr_dd,
        [(c("sr_customer_sk"), "ctr_customer_sk"),
         (c("sr_store_sk"), "ctr_store_sk")],
        [("sum", "ctr_total_return", [c("sr_return_amt")])],
        partitions)

    # avg(ctr_total_return) by store over a re-exchange of ctr
    avg_in = exchange(ctr, [ci(1)], partitions)
    avg_by_store = agg(
        agg(avg_in, [(ci(1), "avg_store_sk")],
            [("avg", "partial", "avg_return", [ci(2)])]),
        [(ci(0), "avg_store_sk")],
        [("avg", "final", "avg_return", [ci(1), ci(2)])])

    ctr2 = exchange(ctr, [ci(1)], partitions)
    joined = join("sort_merge_join", ctr2, avg_by_store, [ci(1)], [ci(0)])
    flt = filter_(joined, binop(">", c("ctr_total_return"),
                                binop("*", c("avg_return"),
                                      lit(1.2, "float64"))))
    st_flt = filter_(scan(paths, tables, "store"),
                     binop("==", c("s_state"), lit("TN", "utf8")))
    j_store = join("broadcast_join", flt, st_flt,
                   [c("ctr_store_sk")], [c("s_store_sk")])
    j_cust = join("broadcast_join", j_store,
                  scan(paths, tables, "customer"),
                  [c("ctr_customer_sk")], [c("c_customer_sk")])
    proj = project(j_cust, [c("c_customer_id")], ["c_customer_id"])
    single = exchange(proj, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        srd, ddd = sr.to_pandas(), dd.to_pandas()
        std, cud = st.to_pandas(), cu.to_pandas()
        m = srd.merge(ddd[ddd.d_year == 2000],
                      left_on="sr_returned_date_sk", right_on="d_date_sk")
        # GROUP BY keeps the NULL-customer group (SQL semantics); only the
        # final inner join to customer drops it
        ctr = (m.groupby(["sr_customer_sk", "sr_store_sk"],
                         as_index=False, dropna=False)
               .sr_return_amt.sum()
               .rename(columns={"sr_return_amt": "ctr_total"}))
        avg = ctr.groupby("sr_store_sk", as_index=False).ctr_total.mean() \
            .rename(columns={"ctr_total": "avg_return"})
        j = ctr.merge(avg, on="sr_store_sk")
        j = j[j.ctr_total > 1.2 * j.avg_return]
        j = j.merge(std[std.s_state == "TN"], left_on="sr_store_sk",
                    right_on="s_store_sk")
        j = j.merge(cud, left_on="sr_customer_sk", right_on="c_customer_sk")
        out = j[["c_customer_id"]].sort_values("c_customer_id")[:100]
        return out.reset_index(drop=True)

    return plan, oracle
