"""TPC-DS queries as plan-IR dicts with their pandas oracles (a copy of
the plan-dict helpers and of every query builder of
blaze_tpu/itest/queries.py: `q01`, `q06`, `_brand_revenue`, `q03`,
`q42`, `q52`, `q55`, `q17`, `q18`, `q95`, `_ratio_over_window`, `q12`,
`q20`, `q98`, `q51`, `q67`, `q07`, `q19` and `gq1`).

Fact tables are read from parquet file splits; exchanges are
`local_exchange` nodes, which plan/stages.py `DagScheduler` cuts into
stages; aggregations use partial/final pairs as a Spark plan emits them.
Each builder returns (plan_dict, oracle), the oracle computing the
expected frame with pandas; `QUERIES` maps a name to its builder and the
tables it reads, and `plans` builds several at once.

  q01  customers returning more than 1.2x their store's average
       (BASELINE config #1);
  q06  items above 1.2x their category's average price, counted by
       store (BASELINE config #2: hash join + group-by);
  q03, q42, q52, q55  revenue by brand (or category) in one month:
       date_dim ⨝ store_sales ⨝ item, grouped by utf8 keys;
  q17  store_sales ⨝ store_returns ⨝ catalog_sales through two shuffled
       hash joins on two-column keys, each table in its own date window,
       counts and averages by (i_item_id, s_state) (BASELINE config #3);
  q18  catalog sales joined to demographics, customer, address (an IN
       list) and item, averaged over ROLLUP(i_item_id, ca_country,
       ca_state, ca_county): an Expand into five grouping sets
       (BASELINE config #3);
  q95  web orders shipped from more than one warehouse and never
       returned: EXISTS as a semi join with a `!=` join filter and NOT
       EXISTS as an anti join, both shuffled on the order number, then a
       per-order sum and one global row (BASELINE config #4);
  q12, q20, q98  revenue by item in a 31-day window and its share of the
       item's class total, a whole-partition window sum;
  q51  running sums of daily web and store revenue per item (a running
       window sum each), joined by a full outer sort-merge join;
  q67  ROLLUP(category, class) of store revenue, then rank() within the
       category, kept to rank 10;
  q19  brand revenue through date, item, customer (a shuffled hash
       join), address and store joins, sorted by a descending sum;
  q07  store sales of men with a college education in 2000 under an
       e-mail-less promotion: four broadcasts, four averages by item;
  gq1  posexplode of each web session's list of clicked items, renamed,
       joined to item, clicks counted by category.

Date keys follow tpcds_data.gen_date_dim: sk = 2450815 + day, d_year =
1998 + day // 365, d_moy = (day % 365) // 31 + 1 (at most 12).

q06 averages the price by category as a partial `avg` directly under a
final one, with no exchange between them, as the reference's plan does.
Its result is right only while `item` is one file: with item split in n
files, each file averages on its own and the broadcast build holds n rows
per category.  Drivers keep item in one file (itest/q06.py).
"""

from __future__ import annotations

import uuid
from typing import Callable, Dict, List, Tuple

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


# ---------------------------------------------------------------------------
# q06
# ---------------------------------------------------------------------------

def q06(paths, tables, partitions: int = 4):
    ss, it = tables["store_sales"], tables["item"]

    cat_avg = agg(
        agg(scan(paths, tables, "item"), [(c("i_category"), "cat")],
            [("avg", "partial", "avg_price", [c("i_current_price")])]),
        [(ci(0), "cat")],
        [("avg", "final", "avg_price", [ci(1), ci(2)])])
    it_j = join("broadcast_join", scan(paths, tables, "item"), cat_avg,
                [c("i_category")], [c("cat")])
    it_flt = filter_(it_j, binop(">", c("i_current_price"),
                                 binop("*", c("avg_price"),
                                       lit(1.2, "float64"))))
    ss_j = join("broadcast_join", scan(paths, tables, "store_sales"),
                it_flt, [c("ss_item_sk")], [c("i_item_sk")])
    counted = _partial_final(
        ss_j, [(c("ss_store_sk"), "store")],
        [("count", "cnt", [c("ss_sold_date_sk")])], partitions)
    single = exchange(counted, [ci(0)], 1)
    plan = {"kind": "sort", "input": single,
            "specs": [{"expr": ci(0), "descending": False,
                       "nulls_first": True}]}

    def oracle():
        ssd, itd = ss.to_pandas(), it.to_pandas()
        avg = itd.groupby("i_category", as_index=False) \
            .i_current_price.mean().rename(
                columns={"i_current_price": "avg_price"})
        j = itd.merge(avg, on="i_category")
        sel = j[j.i_current_price > 1.2 * j.avg_price]
        m = ssd.merge(sel, left_on="ss_item_sk", right_on="i_item_sk")
        out = (m.groupby("ss_store_sk", as_index=False)
               .agg(cnt=("ss_sold_date_sk", "count"))
               .rename(columns={"ss_store_sk": "store"})
               .sort_values("store"))
        return out.reset_index(drop=True)

    return plan, oracle


# ---------------------------------------------------------------------------
# the brand-revenue family
# ---------------------------------------------------------------------------

def _brand_revenue(paths, tables, partitions, moy, price_col,
                   group_cols=("i_brand_id", "i_brand")):
    """The q03/q42/q52/q55 shape: dd(moy) ⨝ ss ⨝ item, revenue by brand."""
    ss, it, dd = tables["store_sales"], tables["item"], tables["date_dim"]

    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_moy"), lit(moy, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    groups = [(c("d_year"), "d_year")] + \
        [(c(g), g) for g in group_cols]
    rev = _partial_final(j_it, groups,
                         [("sum", "revenue", [c(price_col)])], partitions)
    single = exchange(rev, [ci(0)], 1)
    n = len(groups)
    plan = sort_limit(single, [(ci(n), True), (ci(1), False)], 100)

    def oracle():
        ssd, itd, ddd = (ss.to_pandas(), it.to_pandas(), dd.to_pandas())
        m = ssd.merge(ddd[ddd.d_moy == moy], left_on="ss_sold_date_sk",
                      right_on="d_date_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        out = (m.groupby(["d_year"] + list(group_cols), as_index=False)
               .agg(revenue=(price_col, "sum")))
        out = out.sort_values(["revenue", list(out.columns)[1]],
                              ascending=[False, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q03(paths, tables, partitions: int = 2):
    return _brand_revenue(paths, tables, partitions, 11,
                          "ss_ext_sales_price")


def q42(paths, tables, partitions: int = 2):
    return _brand_revenue(paths, tables, partitions, 12,
                          "ss_ext_sales_price", ("i_category",))


def q52(paths, tables, partitions: int = 2):
    return _brand_revenue(paths, tables, partitions, 12,
                          "ss_ext_sales_price")


def q55(paths, tables, partitions: int = 2):
    return _brand_revenue(paths, tables, partitions, 11,
                          "ss_sales_price")


#: name -> (builder, the tables it reads)
# ---------------------------------------------------------------------------
# q17 shape: ss -> sr -> cs with three date roles, grouped stats
# ---------------------------------------------------------------------------

SS_WINDOW = _day_range(730, 820)      # Q1 2000
SR_CS_WINDOW = _day_range(730, 1003)  # Q1-Q3 2000


def q17(paths, tables, partitions: int = 4):
    ss, sr, cs = (tables["store_sales"], tables["store_returns"],
                  tables["catalog_sales"])
    st, it = tables["store"], tables["item"]

    ss_f = filter_(scan(paths, tables, "store_sales"),
                   binop(">=", c("ss_sold_date_sk"), lit(SS_WINDOW[0])),
                   binop("<=", c("ss_sold_date_sk"), lit(SS_WINDOW[1])))
    sr_f = filter_(scan(paths, tables, "store_returns"),
                   binop(">=", c("sr_returned_date_sk"),
                         lit(SR_CS_WINDOW[0])),
                   binop("<=", c("sr_returned_date_sk"),
                         lit(SR_CS_WINDOW[1])))
    cs_f = filter_(scan(paths, tables, "catalog_sales"),
                   binop(">=", c("cs_sold_date_sk"), lit(SR_CS_WINDOW[0])),
                   binop("<=", c("cs_sold_date_sk"), lit(SR_CS_WINDOW[1])))

    ss_ex = exchange(ss_f, [c("ss_ticket_number"), c("ss_item_sk")],
                     partitions)
    sr_ex = exchange(sr_f, [c("sr_ticket_number"), c("sr_item_sk")],
                     partitions)
    ss_sr = join("hash_join", ss_ex, sr_ex,
                 [c("ss_ticket_number"), c("ss_item_sk")],
                 [c("sr_ticket_number"), c("sr_item_sk")])

    left_ex = exchange(ss_sr, [c("sr_customer_sk"), c("sr_item_sk")],
                       partitions)
    cs_ex = exchange(cs_f, [c("cs_bill_customer_sk"), c("cs_item_sk")],
                     partitions)
    three = join("hash_join", left_ex, cs_ex,
                 [c("sr_customer_sk"), c("sr_item_sk")],
                 [c("cs_bill_customer_sk"), c("cs_item_sk")])

    j_it = join("broadcast_join", three, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    j_st = join("broadcast_join", j_it, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])

    stats = _partial_final(
        j_st,
        [(c("i_item_id"), "i_item_id"), (c("s_state"), "s_state")],
        [("count", "store_sales_cnt", [c("ss_quantity")]),
         ("avg", "store_sales_avg", [c("ss_quantity")]),
         ("count", "store_returns_cnt", [c("sr_return_quantity")]),
         ("avg", "store_returns_avg", [c("sr_return_quantity")]),
         ("count", "catalog_sales_cnt", [c("cs_quantity")]),
         ("avg", "catalog_sales_avg", [c("cs_quantity")])],
        partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, srd, csd = ss.to_pandas(), sr.to_pandas(), cs.to_pandas()
        std, itd = st.to_pandas(), it.to_pandas()
        ssd = ssd[(ssd.ss_sold_date_sk >= SS_WINDOW[0]) &
                  (ssd.ss_sold_date_sk <= SS_WINDOW[1])]
        srd = srd[(srd.sr_returned_date_sk >= SR_CS_WINDOW[0]) &
                  (srd.sr_returned_date_sk <= SR_CS_WINDOW[1])]
        csd = csd[(csd.cs_sold_date_sk >= SR_CS_WINDOW[0]) &
                  (csd.cs_sold_date_sk <= SR_CS_WINDOW[1])]
        m = ssd.merge(srd, left_on=["ss_ticket_number", "ss_item_sk"],
                      right_on=["sr_ticket_number", "sr_item_sk"])
        m = m.dropna(subset=["sr_customer_sk"]).merge(
            csd, left_on=["sr_customer_sk", "sr_item_sk"],
            right_on=["cs_bill_customer_sk", "cs_item_sk"])
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        out = m.groupby(["i_item_id", "s_state"], as_index=False).agg(
            store_sales_cnt=("ss_quantity", "count"),
            store_sales_avg=("ss_quantity", "mean"),
            store_returns_cnt=("sr_return_quantity", "count"),
            store_returns_avg=("sr_return_quantity", "mean"),
            catalog_sales_cnt=("cs_quantity", "count"),
            catalog_sales_avg=("cs_quantity", "mean"))
        out = out.sort_values(["i_item_id", "s_state"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


# ---------------------------------------------------------------------------
# q18 shape: demographics joins + ROLLUP via Expand grouping sets
# ---------------------------------------------------------------------------

Y1998 = _day_range(0, 364)
Q18_STATES = ["TX", "OH", "IL"]


Q18_COLS = ["i_item_id", "ca_country", "ca_state", "ca_county"]


def q18_sets(tables) -> "pd.DataFrame":
    """q18's oracle before its sort and limit: all five grouping sets of
    the ROLLUP, one frame per set in the order g_id 0, 1, 3, 7, 15,
    concatenated (the reference oracle's `concat`)."""
    import pandas as pd
    csd = tables["catalog_sales"].to_pandas()
    cdd = tables["customer_demographics"].to_pandas()
    cud, cad = tables["customer"].to_pandas(), \
        tables["customer_address"].to_pandas()
    itd = tables["item"].to_pandas()
    csd = csd[(csd.cs_sold_date_sk >= Y1998[0]) &
              (csd.cs_sold_date_sk <= Y1998[1])]
    cdd = cdd[(cdd.cd_gender == "F") &
              (cdd.cd_education_status == "Unknown")]
    m = csd.merge(cdd, left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
    m = m.merge(cud, left_on="cs_bill_customer_sk",
                right_on="c_customer_sk")
    m = m.merge(cad[cad.ca_state.isin(Q18_STATES)],
                left_on="c_current_addr_sk", right_on="ca_address_sk")
    m = m.merge(itd, left_on="cs_item_sk", right_on="i_item_sk")
    frames = []
    cols = Q18_COLS
    for kept, gid in ((4, 0), (3, 1), (2, 3), (1, 7), (0, 15)):
        keys = cols[:kept]
        if keys:
            g = m.groupby(keys, as_index=False, dropna=False).agg(
                agg1=("cs_quantity", "mean"),
                agg2=("cs_list_price", "mean"),
                agg3=("cs_coupon_amt", "mean"),
                agg4=("cs_net_profit", "mean"))
        else:
            g = pd.DataFrame({
                "agg1": [m.cs_quantity.mean()],
                "agg2": [m.cs_list_price.mean()],
                "agg3": [m.cs_coupon_amt.mean()],
                "agg4": [m.cs_net_profit.mean()]})
        for col_name in cols[kept:]:
            g[col_name] = None
        g["g_id"] = gid
        frames.append(g[cols + ["g_id", "agg1", "agg2", "agg3",
                                "agg4"]])
    return pd.concat(frames, ignore_index=True)


def q18(paths, tables, partitions: int = 4):
    cs_f = filter_(scan(paths, tables, "catalog_sales"),
                   binop(">=", c("cs_sold_date_sk"), lit(Y1998[0])),
                   binop("<=", c("cs_sold_date_sk"), lit(Y1998[1])))
    cd_f = filter_(scan(paths, tables, "customer_demographics"),
                   binop("==", c("cd_gender"), lit("F", "utf8")),
                   binop("==", c("cd_education_status"),
                         lit("Unknown", "utf8")))
    j_cd = join("broadcast_join", cs_f, cd_f,
                [c("cs_bill_cdemo_sk")], [c("cd_demo_sk")])

    cs_ex = exchange(j_cd, [c("cs_bill_customer_sk")], partitions)
    cu_ex = exchange(scan(paths, tables, "customer"),
                     [c("c_customer_sk")], partitions)
    j_cu = join("hash_join", cs_ex, cu_ex,
                [c("cs_bill_customer_sk")], [c("c_customer_sk")])

    ca_f = filter_(scan(paths, tables, "customer_address"),
                   {"kind": "in_list", "child": c("ca_state"),
                    "values": Q18_STATES, "negated": False})
    j_ca = join("broadcast_join", j_cu, ca_f,
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    j_it = join("broadcast_join", j_ca, scan(paths, tables, "item"),
                [c("cs_item_sk")], [c("i_item_sk")])

    # ROLLUP(i_item_id, ca_country, ca_state, ca_county): 5 grouping sets
    # (ref expand_exec.rs:506 fan-out; Spark emits Expand + grouping id)
    nul = {"kind": "literal", "value": None, "type": {"id": "utf8"}}
    grp = [c("i_item_id"), c("ca_country"), c("ca_state"), c("ca_county")]
    aggs_src = [c("cs_quantity"), c("cs_list_price"), c("cs_coupon_amt"),
                c("cs_net_profit")]
    projections = []
    for kept, gid in ((4, 0), (3, 1), (2, 3), (1, 7), (0, 15)):
        row = [grp[i] if i < kept else nul for i in range(4)]
        row.append(lit(gid))
        row.extend(aggs_src)
        projections.append(row)
    expanded = {"kind": "expand", "input": j_it,
                "projections": projections,
                "names": ["i_item_id", "ca_country", "ca_state",
                          "ca_county", "g_id", "cs_quantity",
                          "cs_list_price", "cs_coupon_amt",
                          "cs_net_profit"]}

    stats = _partial_final(
        expanded,
        [(ci(0), "i_item_id"), (ci(1), "ca_country"), (ci(2), "ca_state"),
         (ci(3), "ca_county"), (ci(4), "g_id")],
        [("avg", "agg1", [ci(5)]), ("avg", "agg2", [ci(6)]),
         ("avg", "agg3", [ci(7)]), ("avg", "agg4", [ci(8)])],
        partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single,
                      [(ci(4), False), (ci(0), False), (ci(1), False),
                       (ci(2), False), (ci(3), False)], 100)

    def oracle():
        out = q18_sets(tables)
        out = out.sort_values(["g_id"] + Q18_COLS)[:100]
        return out.reset_index(drop=True)

    return plan, oracle



# ---------------------------------------------------------------------------
# q95 shape: EXISTS (filtered semi join) + NOT EXISTS (anti join)
# ---------------------------------------------------------------------------

Q95_WINDOW = _day_range(761, 821)


def q95(paths, tables, partitions: int = 4):
    ws, wr, ca = (tables["web_sales"], tables["web_returns"],
                  tables["customer_address"])

    ws1 = filter_(scan(paths, tables, "web_sales"),
                  binop(">=", c("ws_ship_date_sk"), lit(Q95_WINDOW[0])),
                  binop("<=", c("ws_ship_date_sk"), lit(Q95_WINDOW[1])),
                  binop("<=", c("ws_web_site_sk"), lit(2)))
    ca_f = filter_(scan(paths, tables, "customer_address"),
                   binop("==", c("ca_state"), lit("IL", "utf8")))
    ws1 = join("broadcast_join", ws1, ca_f,
               [c("ws_ship_addr_sk")], [c("ca_address_sk")])
    ws1 = project(ws1,
                  [c("ws_order_number"), c("ws_warehouse_sk"),
                   c("ws_ext_ship_cost"), c("ws_net_profit")],
                  ["ws_order_number", "ws_warehouse_sk",
                   "ws_ext_ship_cost", "ws_net_profit"])
    ws1_ex = exchange(ws1, [ci(0)], partitions)

    ws_all = project(scan(paths, tables, "web_sales"),
                     [c("ws_order_number"), c("ws_warehouse_sk")],
                     ["wh_order_number", "wh_warehouse_sk"])
    ws_all_ex = exchange(ws_all, [ci(0)], partitions)

    # EXISTS ws2 with same order, different warehouse: semi join with a
    # joined-schema filter (left 4 cols + right 2 cols)
    semi = join("hash_join", ws1_ex, ws_all_ex, [ci(0)], [ci(0)],
                jt="left_semi",
                flt=binop("!=", ci(1), ci(5)))

    wr_ex = exchange(project(scan(paths, tables, "web_returns"),
                             [c("wr_order_number")], ["wr_order_number"]),
                     [ci(0)], partitions)
    anti = join("hash_join", semi, wr_ex, [ci(0)], [ci(0)],
                jt="left_anti")

    # per-order sums (orders are co-partitioned after the exchange), then
    # one global row: count(distinct order) = count of per-order groups
    per_order = agg(
        agg(anti, [(ci(0), "ws_order_number")],
            [("sum", "partial", "ship_cost", [ci(2)]),
             ("sum", "partial", "net_profit", [ci(3)])]),
        [(ci(0), "ws_order_number")],
        [("sum", "final", "ship_cost", [ci(1)]),
         ("sum", "final", "net_profit", [ci(2)])])
    single = exchange(per_order, [ci(0)], 1)
    totals = agg(
        agg(single, [],
            [("count", "partial", "order_count", [ci(0)]),
             ("sum", "partial", "total_ship_cost", [ci(1)]),
             ("sum", "partial", "total_net_profit", [ci(2)])]),
        [],
        [("count", "final", "order_count", [ci(0)]),
         ("sum", "final", "total_ship_cost", [ci(1)]),
         ("sum", "final", "total_net_profit", [ci(2)])])
    plan = totals

    def oracle():
        import pandas as pd
        wsd, wrd, cad = ws.to_pandas(), wr.to_pandas(), ca.to_pandas()
        f = wsd[(wsd.ws_ship_date_sk >= Q95_WINDOW[0]) &
                (wsd.ws_ship_date_sk <= Q95_WINDOW[1]) &
                (wsd.ws_web_site_sk <= 2)]
        f = f.merge(cad[cad.ca_state == "IL"],
                    left_on="ws_ship_addr_sk", right_on="ca_address_sk")
        # EXISTS: some ws row of the same order with a different
        # warehouse.  A row's own warehouse is one of its order's, so its
        # order has two or more distinct ones (a NULL warehouse, as in
        # SQL, differs from none)
        n_wh = wsd.groupby("ws_order_number").ws_warehouse_sk.nunique()
        if len(f):
            f = f[(f.ws_order_number.map(n_wh).fillna(0) >= 2).to_numpy()
                  & f.ws_warehouse_sk.notna().to_numpy()]
        f = f[~f.ws_order_number.isin(set(wrd.wr_order_number))]
        # SQL SUM over zero rows is NULL, not pandas' 0.0
        return pd.DataFrame({
            "order_count": [f.ws_order_number.nunique()],
            "total_ship_cost": [f.ws_ext_ship_cost.sum() if len(f)
                                else None],
            "total_net_profit": [f.ws_net_profit.sum() if len(f)
                                 else None]})

    return plan, oracle


# ---------------------------------------------------------------------------
# the window family: ratio to a class total, cumulative sums, rank
# ---------------------------------------------------------------------------

def _ratio_over_window(paths, tables, partitions, fact, date_col,
                       item_col, price_col, window):
    """The q12/q20/q98 shape: revenue by item, plus each item's share of
    its class total via an UNBOUNDED window aggregate."""
    ft, it = tables[fact], tables["item"]

    f = filter_(scan(paths, tables, fact),
                binop(">=", c(date_col), lit(window[0])),
                binop("<=", c(date_col), lit(window[1])))
    j = join("broadcast_join", f, scan(paths, tables, "item"),
             [c(item_col)], [c("i_item_sk")])
    rev = _partial_final(
        j, [(c("i_item_id"), "i_item_id"), (c("i_class"), "i_class")],
        [("sum", "itemrevenue", [c(price_col)])], partitions)
    # co-locate each class in one partition, sort, whole-partition window
    ex = exchange(rev, [ci(1)], 1)
    srt = {"kind": "sort", "input": ex,
           "specs": [{"expr": ci(1), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(0), "descending": False,
                      "nulls_first": True}]}
    win = {"kind": "window", "input": srt,
           "functions": [{"kind": "agg", "fn": "sum",
                          "name": "classrevenue", "running": False,
                          "args": [ci(2)]}],
           "partition_by": [ci(1)], "order_by": []}
    plan = project(
        win,
        [ci(0), ci(1), ci(2),
         binop("/", binop("*", ci(2), lit(100.0, "float64")), ci(3))],
        ["i_item_id", "i_class", "itemrevenue", "revenueratio"])

    def oracle():
        fd, itd = ft.to_pandas(), it.to_pandas()
        m = fd[(fd[date_col] >= window[0]) & (fd[date_col] <= window[1])]
        m = m.merge(itd, left_on=item_col, right_on="i_item_sk")
        out = (m.groupby(["i_item_id", "i_class"], as_index=False)
               .agg(itemrevenue=(price_col, "sum")))
        out["revenueratio"] = out.itemrevenue * 100.0 / \
            out.groupby("i_class").itemrevenue.transform("sum")
        return out.reset_index(drop=True)

    return plan, oracle


Q12_WINDOW = _day_range(730, 760)


def q12(paths, tables, partitions: int = 2):
    return _ratio_over_window(paths, tables, partitions, "web_sales",
                              "ws_sold_date_sk", "ws_item_sk",
                              "ws_ext_sales_price", Q12_WINDOW)


def q20(paths, tables, partitions: int = 2):
    return _ratio_over_window(paths, tables, partitions, "catalog_sales",
                              "cs_sold_date_sk", "cs_item_sk",
                              "cs_sales_price", Q12_WINDOW)


def q98(paths, tables, partitions: int = 2):
    return _ratio_over_window(paths, tables, partitions, "store_sales",
                              "ss_sold_date_sk", "ss_item_sk",
                              "ss_ext_sales_price", Q12_WINDOW)


Q51_WINDOW = _day_range(700, 760)


def q51(paths, tables, partitions: int = 2):
    """Cumulative web vs store revenue per item/date (FULL OUTER join of
    two windowed streams — the q51 shape with max-over-cumulative)."""
    ws, ss = tables["web_sales"], tables["store_sales"]

    def daily(fact, date_col, item_col, price_col):
        f = filter_(scan(paths, tables, fact),
                    binop(">=", c(date_col), lit(Q51_WINDOW[0])),
                    binop("<=", c(date_col), lit(Q51_WINDOW[1])))
        d = _partial_final(
            f, [(c(item_col), "item_sk"), (c(date_col), "date_sk")],
            [("sum", "rev", [c(price_col)])], partitions)
        ex = exchange(d, [ci(0)], 1)
        srt = {"kind": "sort", "input": ex,
               "specs": [{"expr": ci(0), "descending": False,
                          "nulls_first": True},
                         {"expr": ci(1), "descending": False,
                          "nulls_first": True}]}
        return {"kind": "window", "input": srt,
                "functions": [{"kind": "agg", "fn": "sum",
                               "name": "cume", "running": True,
                               "args": [ci(2)]}],
                "partition_by": [ci(0)],
                "order_by": [{"expr": ci(1), "descending": False,
                              "nulls_first": True}]}

    web = daily("web_sales", "ws_sold_date_sk", "ws_item_sk",
                "ws_ext_sales_price")
    store = daily("store_sales", "ss_sold_date_sk", "ss_item_sk",
                  "ss_ext_sales_price")
    j = join("sort_merge_join", web, store, [ci(0), ci(1)],
             [ci(0), ci(1)], jt="full")
    flt = filter_(j, binop(">", ci(3), {"kind": "coalesce",
                                        "args": [ci(7), lit(0.0,
                                                            "float64")]}))
    plan = sort_limit(flt, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        wsd, ssd = ws.to_pandas(), ss.to_pandas()

        def cume(fd, date_col, item_col, price_col):
            f = fd[(fd[date_col] >= Q51_WINDOW[0]) &
                   (fd[date_col] <= Q51_WINDOW[1])]
            d = (f.groupby([item_col, date_col], as_index=False)
                 .agg(rev=(price_col, "sum"))
                 .rename(columns={item_col: "item_sk",
                                  date_col: "date_sk"}))
            d = d.sort_values(["item_sk", "date_sk"])
            d["cume"] = d.groupby("item_sk").rev.cumsum()
            return d

        w = cume(wsd, "ws_sold_date_sk", "ws_item_sk",
                 "ws_ext_sales_price").rename(columns={
                     "item_sk": "item_w", "date_sk": "date_w",
                     "rev": "rev_w", "cume": "cume_w"})
        s = cume(ssd, "ss_sold_date_sk", "ss_item_sk",
                 "ss_ext_sales_price").rename(columns={
                     "item_sk": "item_s", "date_sk": "date_s",
                     "rev": "rev_s", "cume": "cume_s"})
        # FULL join keeps both key sets (8 columns), like the engine plan
        m = w.merge(s, left_on=["item_w", "date_w"],
                    right_on=["item_s", "date_s"], how="outer")
        m = m[m.cume_w > m.cume_s.fillna(0.0)]
        out = m[["item_w", "date_w", "rev_w", "cume_w",
                 "item_s", "date_s", "rev_s", "cume_s"]]
        out = out.sort_values(["item_w", "date_w"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q67(paths, tables, partitions: int = 2):
    """Rollup(category, class) of store revenue + rank() within category
    by revenue desc, rank <= 10 (the q67 shape: Expand + window rank)."""
    ss, it, dd = tables["store_sales"], tables["item"], tables["date_dim"]

    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(1999, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    nul = {"kind": "literal", "value": None, "type": {"id": "utf8"}}
    projections = []
    for kept, gid in ((2, 0), (1, 1), (0, 3)):
        row = [c("i_category") if kept >= 1 else nul,
               c("i_class") if kept >= 2 else nul,
               lit(gid), c("ss_ext_sales_price")]
        projections.append(row)
    expanded = {"kind": "expand", "input": j_it,
                "projections": projections,
                "names": ["i_category", "i_class", "g_id",
                          "ss_ext_sales_price"]}
    rev = _partial_final(
        expanded,
        [(ci(0), "i_category"), (ci(1), "i_class"), (ci(2), "g_id")],
        [("sum", "sumsales", [ci(3)])], partitions)
    ex = exchange(rev, [ci(0)], 1)
    srt = {"kind": "sort", "input": ex,
           "specs": [{"expr": ci(0), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(3), "descending": True,
                      "nulls_first": False}]}
    win = {"kind": "window", "input": srt,
           "functions": [{"kind": "rank", "name": "rk"}],
           "partition_by": [ci(0)],
           "order_by": [{"expr": ci(3), "descending": True,
                         "nulls_first": False}]}
    flt = filter_(win, binop("<=", ci(4), lit(10)))
    plan = sort_limit(flt, [(ci(0), False), (ci(4), False)], 100)

    def oracle():
        import pandas as pd
        ssd, itd, ddd = ss.to_pandas(), it.to_pandas(), dd.to_pandas()
        m = ssd.merge(ddd[ddd.d_year == 1999],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        frames = []
        for kept, gid in ((2, 0), (1, 1), (0, 3)):
            keys = ["i_category", "i_class"][:kept] if kept else []
            if keys:
                g = m.groupby(keys, as_index=False, dropna=False).agg(
                    sumsales=("ss_ext_sales_price", "sum"))
            else:
                g = pd.DataFrame(
                    {"sumsales": [m.ss_ext_sales_price.sum()]})
            for col_name in ["i_category", "i_class"][kept:]:
                g[col_name] = None
            g["g_id"] = gid
            frames.append(g[["i_category", "i_class", "g_id",
                             "sumsales"]])
        allf = pd.concat(frames, ignore_index=True)
        allf["rk"] = (allf.sort_values("sumsales", ascending=False)
                      .groupby("i_category", dropna=False)
                      .sumsales.rank(method="min", ascending=False))
        allf = allf[allf.rk <= 10]
        out = allf.sort_values(["i_category", "rk"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q07(paths, tables, partitions: int = 4):
    """ss ⨝ cd(gender/edu) ⨝ dd ⨝ item ⨝ promotion, avg stats by item."""
    ss, cd, it = (tables["store_sales"], tables["customer_demographics"],
                  tables["item"])
    pr, dd = tables["promotion"], tables["date_dim"]

    cd_f = filter_(scan(paths, tables, "customer_demographics"),
                   binop("==", c("cd_gender"), lit("M", "utf8")),
                   binop("==", c("cd_education_status"),
                         lit("College", "utf8")))
    j_cd = join("broadcast_join", scan(paths, tables, "store_sales"),
                cd_f, [c("ss_cdemo_sk")], [c("cd_demo_sk")])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(2000, "int32")))
    j_dd = join("broadcast_join", j_cd, dd_f,
                [c("ss_sold_date_sk")], [c("d_date_sk")])
    pr_f = filter_(scan(paths, tables, "promotion"),
                   binop("==", c("p_channel_email"), lit("N", "utf8")))
    j_pr = join("broadcast_join", j_dd, pr_f,
                [c("ss_promo_sk")], [c("p_promo_sk")])
    j_it = join("broadcast_join", j_pr, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    stats = _partial_final(
        j_it, [(c("i_item_id"), "i_item_id")],
        [("avg", "agg1", [c("ss_quantity")]),
         ("avg", "agg2", [c("ss_list_price")]),
         ("avg", "agg3", [c("ss_coupon_amt")]),
         ("avg", "agg4", [c("ss_sales_price")])], partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        ssd, cdd, itd = ss.to_pandas(), cd.to_pandas(), it.to_pandas()
        prd, ddd = pr.to_pandas(), dd.to_pandas()
        m = ssd.merge(cdd[(cdd.cd_gender == "M") &
                          (cdd.cd_education_status == "College")],
                      left_on="ss_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(ddd[ddd.d_year == 2000], left_on="ss_sold_date_sk",
                    right_on="d_date_sk")
        m = m.merge(prd[prd.p_channel_email == "N"],
                    left_on="ss_promo_sk", right_on="p_promo_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        out = m.groupby("i_item_id", as_index=False).agg(
            agg1=("ss_quantity", "mean"), agg2=("ss_list_price", "mean"),
            agg3=("ss_coupon_amt", "mean"),
            agg4=("ss_sales_price", "mean"))
        return out.sort_values("i_item_id")[:100].reset_index(drop=True)

    return plan, oracle


def q19(paths, tables, partitions: int = 2):
    """Brand revenue through customer/address joins (q19 shape without
    the manager filter; exercises the 4-join chain)."""
    ss, it, dd = tables["store_sales"], tables["item"], tables["date_dim"]
    cu, ca, st = (tables["customer"], tables["customer_address"],
                  tables["store"])

    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(1999, "int32")),
                   binop("==", c("d_moy"), lit(11, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    cs_ex = exchange(j_it, [c("ss_customer_sk")], partitions)
    cu_ex = exchange(scan(paths, tables, "customer"),
                     [c("c_customer_sk")], partitions)
    j_cu = join("hash_join", cs_ex, cu_ex, [c("ss_customer_sk")],
                [c("c_customer_sk")])
    j_ca = join("broadcast_join", j_cu,
                scan(paths, tables, "customer_address"),
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    j_st = join("broadcast_join", j_ca, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    rev = _partial_final(
        j_st, [(c("i_brand_id"), "brand_id"), (c("i_brand"), "brand")],
        [("sum", "ext_price", [c("ss_ext_sales_price")])], partitions)
    single = exchange(rev, [ci(0)], 1)
    plan = sort_limit(single, [(ci(2), True), (ci(0), False)], 100)

    def oracle():
        ssd, itd, ddd = ss.to_pandas(), it.to_pandas(), dd.to_pandas()
        cud, cad, std = cu.to_pandas(), ca.to_pandas(), st.to_pandas()
        m = ssd.merge(ddd[(ddd.d_year == 1999) & (ddd.d_moy == 11)],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(cud, left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        m = m.merge(cad, left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        out = (m.groupby(["i_brand_id", "i_brand"], as_index=False)
               .agg(ext_price=("ss_ext_sales_price", "sum")))
        out = out.sort_values(["ext_price", "i_brand_id"],
                              ascending=[False, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def gq1(paths, tables, partitions: int = 2):
    """Generate-bearing workload: posexplode the clickstream list column,
    join items, count clicks by category (exercises inventory row 19
    through the integration harness)."""
    wc, it = tables["web_clickstreams"], tables["item"]

    gen = {"kind": "generate",
           "input": scan(paths, tables, "web_clickstreams"),
           "generator": {"kind": "posexplode",
                         "child": c("wc_clicked_items"), "outer": False},
           "required_cols": [0]}
    renamed = {"kind": "rename_columns", "input": gen,
               "names": ["wc_session_sk", "pos", "item_sk"]}
    j = join("broadcast_join", renamed, scan(paths, tables, "item"),
             [ci(2)], [c("i_item_sk")])
    counted = _partial_final(
        j, [(c("i_category"), "i_category")],
        [("count", "clicks", [ci(0)])], partitions)
    single = exchange(counted, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        import pandas as pd
        wcd = wc.to_pandas()
        itd = it.to_pandas()
        rows = []
        for _sess, items in zip(wcd.wc_session_sk,
                                wcd.wc_clicked_items):
            if items is not None:
                rows.extend(items)
        e = pd.DataFrame({"item_sk": rows})
        m = e.merge(itd, left_on="item_sk", right_on="i_item_sk")
        out = (m.groupby("i_category", as_index=False)
               .agg(clicks=("item_sk", "count"))
               .sort_values("i_category"))
        return out.reset_index(drop=True)

    return plan, oracle


QUERIES: Dict[str, Tuple[Callable, list]] = {
    "q01": (q01, ["store_returns", "date_dim", "store", "customer"]),
    "q17": (q17, ["store_sales", "store_returns", "catalog_sales",
                  "store", "item"]),
    "q18": (q18, ["catalog_sales", "customer_demographics", "customer",
                  "customer_address", "item"]),
    "q03": (q03, ["store_sales", "item", "date_dim"]),
    "q06": (q06, ["store_sales", "item"]),
    "q42": (q42, ["store_sales", "item", "date_dim"]),
    "q52": (q52, ["store_sales", "item", "date_dim"]),
    "q55": (q55, ["store_sales", "item", "date_dim"]),
    "q95": (q95, ["web_sales", "web_returns", "customer_address"]),
    "q12": (q12, ["web_sales", "item"]),
    "q20": (q20, ["catalog_sales", "item"]),
    "q98": (q98, ["store_sales", "item"]),
    "q51": (q51, ["web_sales", "store_sales"]),
    "q67": (q67, ["store_sales", "item", "date_dim"]),
    "q19": (q19, ["store_sales", "item", "date_dim", "customer",
                  "customer_address", "store"]),
    "q07": (q07, ["store_sales", "customer_demographics", "item",
                  "promotion", "date_dim"]),
    "gq1": (gq1, ["web_clickstreams", "item"]),
}


#: the queries of this module; importing the itest package adds the
#: breadth of queries_ext.py and queries_ext2.py to QUERIES
BASE_QUERIES = tuple(QUERIES)


def plans(paths: Dict, tables: Dict, partitions: int,
          names: List[str]) -> Dict:
    """name -> (plan dict, oracle) for each query in `names`."""
    return {n: QUERIES[n][0](paths, tables, partitions) for n in names}
