"""TPC-DS breadth, first batch: 48 more query functions with their pandas
oracles (a copy of blaze_tpu/itest/queries_ext.py, over the plan-dict
helpers of itest/queries.py; each returns the reference's plan
dict).

Same contract as queries.py: each returns (plan_dict, oracle);
the oracles are pandas (the QueryResultComparator analog,
ref dev/auron-it/.../QueryResultComparator.scala).  The shapes: the
multi-stage ones (q23/q14/q64), intersect/except (q38/q87),
exists/in-subquery (q10/q35/q69), q24, the ss-sr-cs chains, rollups,
disjunction filters, case-when bucket pivots, the time and household
demographic dimensions and the full-outer customer-item matrix (q97).
Importing the module registers them in `queries.QUERIES`.

Date windows use the same day arithmetic as tpcds_data.gen_date_dim.
"""

from __future__ import annotations

import pandas as pd

from blaze_tpu_torch.itest.queries import (QUERIES, _day_range, _partial_final,
                                     agg, binop, c, ci, exchange, filter_,
                                     join, lit, project, scan, sort_limit)

W1 = _day_range(60, 150)   # ~3 month window
Y1999 = _day_range(365, 729)


def _case(branches, otherwise=None):
    d = {"kind": "case", "branches": [[w, t] for w, t in branches]}
    if otherwise is not None:
        d["else"] = otherwise
    return d


def _global_agg(inp, fns):
    """partial -> single exchange -> final, no group keys."""
    partial = agg(inp, [], [(f, "partial", n, a) for f, n, a in fns])
    ex = exchange(partial, [], 1)
    final = []
    pos = 0
    for f, n, _a in fns:
        nacc = 2 if f == "avg" else 1
        final.append((f, "final", n, [ci(pos + t) for t in range(nacc)]))
        pos += nacc
    return agg(ex, [], final)


def _exists(left, right_plan, lkeys, rkeys, partitions):
    """EXISTS via the existence join (left rows + bool column)."""
    l_ex = exchange(left, lkeys, partitions)
    r_ex = exchange(right_plan, rkeys, partitions)
    return join("hash_join", l_ex, r_ex, lkeys, rkeys, jt="existence")


# ---------------------------------------------------------------------------
# exists / in-subquery family: q10, q35, q69
# ---------------------------------------------------------------------------

def _exists_family(paths, tables, partitions, *, want_web, want_cat,
                   negate_other):
    """customer ⨝ ca ⨝ cd with EXISTS store_sales AND
    (EXISTS web | EXISTS catalog)  (q10/q35) or AND NOT EXISTS for q69."""
    cu, ca, cd = (tables["customer"], tables["customer_address"],
                  tables["customer_demographics"])
    ss, ws, cs = (tables["store_sales"], tables["web_sales"],
                  tables["catalog_sales"])

    ss_c = project(filter_(scan(paths, tables, "store_sales"),
                           binop(">=", c("ss_sold_date_sk"), lit(W1[0])),
                           binop("<=", c("ss_sold_date_sk"), lit(W1[1]))),
                   [c("ss_customer_sk")], ["ss_customer_sk"])
    ws_c = project(filter_(scan(paths, tables, "web_sales"),
                           binop(">=", c("ws_sold_date_sk"), lit(W1[0])),
                           binop("<=", c("ws_sold_date_sk"), lit(W1[1]))),
                   [c("ws_bill_customer_sk")], ["ws_customer_sk"])
    cs_c = project(filter_(scan(paths, tables, "catalog_sales"),
                           binop(">=", c("cs_sold_date_sk"), lit(W1[0])),
                           binop("<=", c("cs_sold_date_sk"), lit(W1[1]))),
                   [c("cs_bill_customer_sk")], ["cs_customer_sk"])

    base = project(scan(paths, tables, "customer"),
                   [c("c_customer_sk"), c("c_current_addr_sk"),
                    c("c_current_cdemo_sk"), c("c_birth_year")],
                   ["c_customer_sk", "c_current_addr_sk",
                    "c_current_cdemo_sk", "c_birth_year"])
    # semi join: EXISTS store sale in window
    semi = join("hash_join", exchange(base, [ci(0)], partitions),
                exchange(ss_c, [ci(0)], partitions),
                [ci(0)], [ci(0)], jt="left_semi")
    # existence joins for the disjunction legs
    e1 = _exists(semi, ws_c, [ci(0)], [ci(0)], partitions)  # +exists_w
    e2 = _exists(e1, cs_c, [ci(0)], [ci(0)], partitions)    # +exists_c
    if negate_other:  # q69: NOT EXISTS web AND NOT EXISTS catalog
        cond = binop("and", {"kind": "not", "child": ci(4)},
                     {"kind": "not", "child": ci(5)})
    elif want_web and want_cat:  # q10/q35: EXISTS web OR EXISTS catalog
        cond = binop("or", ci(4), ci(5))
    else:
        cond = ci(4) if want_web else ci(5)
    flt = filter_(e2, cond)

    j_ca = join("broadcast_join", flt,
                scan(paths, tables, "customer_address"),
                [ci(1)], [c("ca_address_sk")])
    j_cd = join("broadcast_join", j_ca,
                scan(paths, tables, "customer_demographics"),
                [ci(2)], [c("cd_demo_sk")])
    counted = _partial_final(
        j_cd,
        [(c("cd_gender"), "cd_gender"),
         (c("cd_education_status"), "cd_education_status")],
        [("count", "cnt", [ci(0)]),
         ("min", "min_by", [c("c_birth_year")]),
         ("max", "max_by", [c("c_birth_year")]),
         ("avg", "avg_by", [c("c_birth_year")])], partitions)
    single = exchange(counted, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        cud, cad, cdd = cu.to_pandas(), ca.to_pandas(), cd.to_pandas()
        ssd, wsd, csd = ss.to_pandas(), ws.to_pandas(), cs.to_pandas()
        in_w = lambda df, k: set(df[(df[k + "_sold_date_sk"] >= W1[0]) &
                                    (df[k + "_sold_date_sk"] <= W1[1])]
                                 [_cust_col(k)])
        s_set = in_w(ssd, "ss")
        w_set = in_w(wsd, "ws")
        c_set = in_w(csd, "cs")
        f = cud[cud.c_customer_sk.isin(s_set)]
        if negate_other:
            f = f[~f.c_customer_sk.isin(w_set) &
                  ~f.c_customer_sk.isin(c_set)]
        else:
            f = f[f.c_customer_sk.isin(w_set) |
                  f.c_customer_sk.isin(c_set)]
        m = f.merge(cad, left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        m = m.merge(cdd, left_on="c_current_cdemo_sk",
                    right_on="cd_demo_sk")
        out = m.groupby(["cd_gender", "cd_education_status"],
                        as_index=False).agg(
            cnt=("c_customer_sk", "count"),
            min_by=("c_birth_year", "min"),
            max_by=("c_birth_year", "max"),
            avg_by=("c_birth_year", "mean"))
        out = out.sort_values(["cd_gender",
                               "cd_education_status"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def _cust_col(prefix):
    return {"ss": "ss_customer_sk", "ws": "ws_bill_customer_sk",
            "cs": "cs_bill_customer_sk"}[prefix]


def q10(paths, tables, partitions: int = 2):
    return _exists_family(paths, tables, partitions, want_web=True,
                          want_cat=True, negate_other=False)


def q35(paths, tables, partitions: int = 2):
    return _exists_family(paths, tables, partitions, want_web=True,
                          want_cat=True, negate_other=False)


def q69(paths, tables, partitions: int = 2):
    return _exists_family(paths, tables, partitions, want_web=False,
                          want_cat=False, negate_other=True)


# ---------------------------------------------------------------------------
# intersect / except family: q38, q87  (+ q14 cross-channel items)
# ---------------------------------------------------------------------------

def _channel_customers(paths, tables, prefix, fact, partitions):
    f = filter_(scan(paths, tables, fact),
                binop(">=", c(prefix + "_sold_date_sk"), lit(W1[0])),
                binop("<=", c(prefix + "_sold_date_sk"), lit(W1[1])))
    p = project(f, [c(_cust_col(prefix))], ["customer_sk"])
    # distinct via group-by (how Spark plans INTERSECT legs)
    return _partial_final(p, [(ci(0), "customer_sk")],
                          [("count", "cnt", [ci(0)])], partitions)


def _set_op_customers(paths, tables, partitions, op):
    """count(*) of customers in store INTERSECT/EXCEPT web & catalog."""
    ss_d = _channel_customers(paths, tables, "ss", "store_sales",
                              partitions)
    ws_d = _channel_customers(paths, tables, "ws", "web_sales", partitions)
    cs_d = _channel_customers(paths, tables, "cs", "catalog_sales",
                              partitions)
    jt = "left_semi" if op == "intersect" else "left_anti"
    step1 = join("hash_join", exchange(ss_d, [ci(0)], partitions),
                 exchange(ws_d, [ci(0)], partitions), [ci(0)], [ci(0)],
                 jt=jt)
    step2 = join("hash_join", exchange(step1, [ci(0)], partitions),
                 exchange(cs_d, [ci(0)], partitions), [ci(0)], [ci(0)],
                 jt=jt)
    plan = _global_agg(step2, [("count", "num_customers", [ci(0)])])

    ss, ws, cs = (tables["store_sales"], tables["web_sales"],
                  tables["catalog_sales"])

    def oracle():
        in_w = lambda df, k: set(df[(df[k + "_sold_date_sk"] >= W1[0]) &
                                    (df[k + "_sold_date_sk"] <= W1[1])]
                                 [_cust_col(k)].dropna())
        s = in_w(ss.to_pandas(), "ss")
        w = in_w(ws.to_pandas(), "ws")
        cset = in_w(cs.to_pandas(), "cs")
        n = len(s & w & cset) if op == "intersect" else len(s - w - cset)
        return pd.DataFrame({"num_customers": [n]})

    return plan, oracle


def q38(paths, tables, partitions: int = 2):
    return _set_op_customers(paths, tables, partitions, "intersect")


def q87(paths, tables, partitions: int = 2):
    return _set_op_customers(paths, tables, partitions, "except")


def q14(paths, tables, partitions: int = 2):
    """Cross-channel items: brands whose items sold in ALL three channels
    (the q14 intersect CTE), revenue from store sales of those items."""
    ss, cs, ws, it = (tables["store_sales"], tables["catalog_sales"],
                      tables["web_sales"], tables["item"])

    def items(prefix, fact, col):
        f = filter_(scan(paths, tables, fact),
                    binop(">=", c(prefix + "_sold_date_sk"), lit(W1[0])),
                    binop("<=", c(prefix + "_sold_date_sk"), lit(W1[1])))
        return _partial_final(project(f, [c(col)], ["item_sk"]),
                              [(ci(0), "item_sk")],
                              [("count", "cnt", [ci(0)])], partitions)

    ss_i = items("ss", "store_sales", "ss_item_sk")
    cs_i = items("cs", "catalog_sales", "cs_item_sk")
    ws_i = items("ws", "web_sales", "ws_item_sk")
    both = join("hash_join", exchange(ss_i, [ci(0)], partitions),
                exchange(cs_i, [ci(0)], partitions), [ci(0)], [ci(0)],
                jt="left_semi")
    cross = join("hash_join", exchange(both, [ci(0)], partitions),
                 exchange(ws_i, [ci(0)], partitions), [ci(0)], [ci(0)],
                 jt="left_semi")

    ss_f = filter_(scan(paths, tables, "store_sales"),
                   binop(">=", c("ss_sold_date_sk"), lit(W1[0])),
                   binop("<=", c("ss_sold_date_sk"), lit(W1[1])))
    sold = join("hash_join", exchange(ss_f, [c("ss_item_sk")], partitions),
                exchange(cross, [ci(0)], partitions),
                [c("ss_item_sk")], [ci(0)], jt="left_semi")
    j_it = join("broadcast_join", sold, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    rev = _partial_final(
        j_it, [(c("i_brand_id"), "brand_id")],
        [("sum", "sales", [c("ss_ext_sales_price")]),
         ("count", "number_sales", [c("ss_ext_sales_price")])],
        partitions)
    single = exchange(rev, [ci(0)], 1)
    plan = sort_limit(single, [(ci(1), True), (ci(0), False)], 100)

    def oracle():
        ssd, csd, wsd = ss.to_pandas(), cs.to_pandas(), ws.to_pandas()
        itd = it.to_pandas()
        win = lambda df, k, col: set(
            df[(df[k + "_sold_date_sk"] >= W1[0]) &
               (df[k + "_sold_date_sk"] <= W1[1])][col])
        cross_items = (win(ssd, "ss", "ss_item_sk") &
                       win(csd, "cs", "cs_item_sk") &
                       win(wsd, "ws", "ws_item_sk"))
        f = ssd[(ssd.ss_sold_date_sk >= W1[0]) &
                (ssd.ss_sold_date_sk <= W1[1]) &
                ssd.ss_item_sk.isin(cross_items)]
        m = f.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        out = m.groupby("i_brand_id", as_index=False).agg(
            sales=("ss_ext_sales_price", "sum"),
            number_sales=("ss_ext_sales_price", "count"))
        out = out.sort_values(["sales", "i_brand_id"],
                              ascending=[False, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


# ---------------------------------------------------------------------------
# multi-stage: q23 (frequent items + best customers), q24, q64
# ---------------------------------------------------------------------------

def q23(paths, tables, partitions: int = 2):
    """Catalog sales restricted to frequently-sold items AND
    best-by-spend customers (two independent agg sub-pipelines feeding
    semi joins — the q23 multi-stage skeleton)."""
    ss, cs = tables["store_sales"], tables["catalog_sales"]

    # frequent items: sold on >= 4 distinct tickets in the window
    ss_f = filter_(scan(paths, tables, "store_sales"),
                   binop(">=", c("ss_sold_date_sk"), lit(W1[0])),
                   binop("<=", c("ss_sold_date_sk"), lit(W1[1])))
    item_cnt = _partial_final(ss_f, [(c("ss_item_sk"), "item_sk")],
                              [("count", "cnt", [c("ss_ticket_number")])],
                              partitions)
    freq = filter_(item_cnt, binop(">=", ci(1), lit(4)))

    # best customers: total quantity*price above 500
    spend = project(scan(paths, tables, "store_sales"),
                    [c("ss_customer_sk"),
                     binop("*", {"kind": "cast", "child": c("ss_quantity"),
                                 "type": {"id": "float64"}},
                           c("ss_sales_price"))],
                    ["customer_sk", "spend"])
    cust_spend = _partial_final(spend, [(ci(0), "customer_sk")],
                                [("sum", "total", [ci(1)])], partitions)
    best = filter_(cust_spend, binop(">", ci(1), lit(500.0, "float64")))

    cs_f = filter_(scan(paths, tables, "catalog_sales"),
                   binop(">=", c("cs_sold_date_sk"), lit(W1[0])),
                   binop("<=", c("cs_sold_date_sk"), lit(W1[1])))
    semi_i = join("hash_join",
                  exchange(cs_f, [c("cs_item_sk")], partitions),
                  exchange(freq, [ci(0)], partitions),
                  [c("cs_item_sk")], [ci(0)], jt="left_semi")
    semi_c = join("hash_join",
                  exchange(semi_i, [c("cs_bill_customer_sk")], partitions),
                  exchange(best, [ci(0)], partitions),
                  [c("cs_bill_customer_sk")], [ci(0)], jt="left_semi")
    sales = project(semi_c,
                    [binop("*", {"kind": "cast", "child": c("cs_quantity"),
                                 "type": {"id": "float64"}},
                           c("cs_list_price"))], ["sales"])
    plan = _global_agg(sales, [("sum", "total_sales", [ci(0)])])

    def oracle():
        ssd, csd = ss.to_pandas(), cs.to_pandas()
        w = ssd[(ssd.ss_sold_date_sk >= W1[0]) &
                (ssd.ss_sold_date_sk <= W1[1])]
        freq_items = set(
            w.groupby("ss_item_sk").ss_ticket_number.count()
            .loc[lambda s: s >= 4].index)
        spend = ssd.assign(sp=ssd.ss_quantity * ssd.ss_sales_price) \
            .groupby("ss_customer_sk").sp.sum()
        best_c = set(spend.loc[spend > 500.0].index)
        f = csd[(csd.cs_sold_date_sk >= W1[0]) &
                (csd.cs_sold_date_sk <= W1[1]) &
                csd.cs_item_sk.isin(freq_items) &
                csd.cs_bill_customer_sk.isin(best_c)]
        total = (f.cs_quantity * f.cs_list_price).sum()
        return pd.DataFrame({"total_sales": [total if len(f) else None]})

    return plan, oracle


def q24(paths, tables, partitions: int = 2):
    """ss ⨝ sr ⨝ store ⨝ item ⨝ customer: per-customer/store netpaid,
    HAVING netpaid > 0.05 * avg(netpaid) — the scalar-subquery threshold
    via a broadcast nested-loop join (ref q24, the reference's best-case
    3.3x query)."""
    ss, sr, st = (tables["store_sales"], tables["store_returns"],
                  tables["store"])
    it, cu = tables["item"], tables["customer"]

    ss_ex = exchange(scan(paths, tables, "store_sales"),
                     [c("ss_ticket_number"), c("ss_item_sk")], partitions)
    sr_ex = exchange(scan(paths, tables, "store_returns"),
                     [c("sr_ticket_number"), c("sr_item_sk")], partitions)
    ss_sr = join("hash_join", ss_ex, sr_ex,
                 [c("ss_ticket_number"), c("ss_item_sk")],
                 [c("sr_ticket_number"), c("sr_item_sk")])
    j_st = join("broadcast_join", ss_sr,
                filter_(scan(paths, tables, "store"),
                        binop("==", c("s_state"), lit("TN", "utf8"))),
                [c("ss_store_sk")], [c("s_store_sk")])
    j_it = join("broadcast_join", j_st, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    j_cu = join("hash_join",
                exchange(j_it, [c("ss_customer_sk")], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [c("ss_customer_sk")], [c("c_customer_sk")])
    netpaid = _partial_final(
        j_cu,
        [(c("c_customer_id"), "c_customer_id"),
         (c("s_store_name"), "s_store_name")],
        [("sum", "netpaid", [c("ss_sales_price")])], partitions)
    avg_np = _global_agg(netpaid, [("avg", "avg_netpaid", [ci(2)])])
    # scalar threshold: cross (BNLJ) against the single avg row
    crossed = {"kind": "broadcast_nested_loop_join",
               "left": netpaid, "right": avg_np, "join_type": "inner",
               "build_side": "right"}
    flt = filter_(crossed, binop(">", ci(2),
                                 binop("*", ci(3), lit(0.05, "float64"))))
    picked = project(flt, [ci(0), ci(1), ci(2)],
                     ["c_customer_id", "s_store_name", "netpaid"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, srd = ss.to_pandas(), sr.to_pandas()
        std, itd, cud = st.to_pandas(), it.to_pandas(), cu.to_pandas()
        m = ssd.merge(srd, left_on=["ss_ticket_number", "ss_item_sk"],
                      right_on=["sr_ticket_number", "sr_item_sk"])
        m = m.merge(std[std.s_state == "TN"], left_on="ss_store_sk",
                    right_on="s_store_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(cud, left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        np_ = m.groupby(["c_customer_id", "s_store_name"],
                        as_index=False).agg(
            netpaid=("ss_sales_price", "sum"))
        np_ = np_[np_.netpaid > 0.05 * np_.netpaid.mean()]
        out = np_.sort_values(["c_customer_id", "s_store_name"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q64(paths, tables, partitions: int = 2):
    """The widest join tree: ss ⨝ sr ⨝ customer ⨝ cd ⨝ hd ⨝ ca ⨝ dd ⨝
    item ⨝ store ⨝ promotion (9 joins), grouped sale/refund stats."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cu, cd, hd = (tables["customer"], tables["customer_demographics"],
                  tables["household_demographics"])
    ca, dd, it = (tables["customer_address"], tables["date_dim"],
                  tables["item"])
    st, pr = tables["store"], tables["promotion"]

    ss_ex = exchange(scan(paths, tables, "store_sales"),
                     [c("ss_ticket_number"), c("ss_item_sk")], partitions)
    sr_ex = exchange(scan(paths, tables, "store_returns"),
                     [c("sr_ticket_number"), c("sr_item_sk")], partitions)
    j = join("hash_join", ss_ex, sr_ex,
             [c("ss_ticket_number"), c("ss_item_sk")],
             [c("sr_ticket_number"), c("sr_item_sk")])
    j = join("hash_join",
             exchange(j, [c("ss_customer_sk")], partitions),
             exchange(scan(paths, tables, "customer"),
                      [c("c_customer_sk")], partitions),
             [c("ss_customer_sk")], [c("c_customer_sk")])
    j = join("broadcast_join", j,
             scan(paths, tables, "customer_demographics"),
             [c("ss_cdemo_sk")], [c("cd_demo_sk")])
    j = join("broadcast_join", j,
             scan(paths, tables, "household_demographics"),
             [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j = join("broadcast_join", j,
             scan(paths, tables, "customer_address"),
             [c("ss_addr_sk")], [c("ca_address_sk")])
    j = join("broadcast_join", j,
             filter_(scan(paths, tables, "date_dim"),
                     binop("==", c("d_year"), lit(1999, "int32"))),
             [c("ss_sold_date_sk")], [c("d_date_sk")])
    j = join("broadcast_join", j,
             filter_(scan(paths, tables, "item"),
                     binop("<=", c("i_current_price"),
                           lit(60.0, "float64"))),
             [c("ss_item_sk")], [c("i_item_sk")])
    j = join("broadcast_join", j, scan(paths, tables, "store"),
             [c("ss_store_sk")], [c("s_store_sk")])
    j = join("broadcast_join", j, scan(paths, tables, "promotion"),
             [c("ss_promo_sk")], [c("p_promo_sk")])
    stats = _partial_final(
        j,
        [(c("i_item_id"), "item_id"), (c("s_store_name"), "store_name"),
         (c("ca_state"), "ca_state")],
        [("count", "cnt", [c("ss_ticket_number")]),
         ("sum", "sales", [c("ss_ext_sales_price")]),
         ("sum", "refunds", [c("sr_return_amt")])], partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single,
                      [(ci(0), False), (ci(1), False), (ci(2), False)],
                      100)

    def oracle():
        m = ss.to_pandas().merge(
            sr.to_pandas(),
            left_on=["ss_ticket_number", "ss_item_sk"],
            right_on=["sr_ticket_number", "sr_item_sk"])
        m = m.merge(cu.to_pandas(), left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        m = m.merge(cd.to_pandas(), left_on="ss_cdemo_sk",
                    right_on="cd_demo_sk")
        m = m.merge(hd.to_pandas(), left_on="ss_hdemo_sk",
                    right_on="hd_demo_sk")
        m = m.merge(ca.to_pandas(), left_on="ss_addr_sk",
                    right_on="ca_address_sk")
        ddd = dd.to_pandas()
        m = m.merge(ddd[ddd.d_year == 1999], left_on="ss_sold_date_sk",
                    right_on="d_date_sk")
        itd = it.to_pandas()
        m = m.merge(itd[itd.i_current_price <= 60.0],
                    left_on="ss_item_sk", right_on="i_item_sk")
        m = m.merge(st.to_pandas(), left_on="ss_store_sk",
                    right_on="s_store_sk")
        m = m.merge(pr.to_pandas(), left_on="ss_promo_sk",
                    right_on="p_promo_sk")
        out = m.groupby(["i_item_id", "s_store_name", "ca_state"],
                        as_index=False).agg(
            cnt=("ss_ticket_number", "count"),
            sales=("ss_ext_sales_price", "sum"),
            refunds=("sr_return_amt", "sum"))
        out.columns = ["item_id", "store_name", "ca_state", "cnt",
                       "sales", "refunds"]
        out = out.sort_values(["item_id", "store_name",
                               "ca_state"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


# ---------------------------------------------------------------------------
# ss-sr-cs chains (q25, q29) — q17 skeleton with different measures
# ---------------------------------------------------------------------------

def _ss_sr_cs(paths, tables, partitions, measures, oracle_aggs):
    from blaze_tpu_torch.itest.queries import SR_CS_WINDOW, SS_WINDOW
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
    ss_sr = join("hash_join",
                 exchange(ss_f, [c("ss_ticket_number"), c("ss_item_sk")],
                          partitions),
                 exchange(sr_f, [c("sr_ticket_number"), c("sr_item_sk")],
                          partitions),
                 [c("ss_ticket_number"), c("ss_item_sk")],
                 [c("sr_ticket_number"), c("sr_item_sk")])
    three = join("hash_join",
                 exchange(ss_sr, [c("sr_customer_sk"), c("sr_item_sk")],
                          partitions),
                 exchange(cs_f, [c("cs_bill_customer_sk"),
                                 c("cs_item_sk")], partitions),
                 [c("sr_customer_sk"), c("sr_item_sk")],
                 [c("cs_bill_customer_sk"), c("cs_item_sk")])
    j_it = join("broadcast_join", three, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    j_st = join("broadcast_join", j_it, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    stats = _partial_final(
        j_st,
        [(c("i_item_id"), "i_item_id"), (c("s_store_name"),
                                         "s_store_name")],
        measures, partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        from blaze_tpu_torch.itest.queries import SR_CS_WINDOW, SS_WINDOW
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
        out = m.groupby(["i_item_id", "s_store_name"],
                        as_index=False).agg(**oracle_aggs)
        out = out.sort_values(["i_item_id", "s_store_name"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q25(paths, tables, partitions: int = 2):
    return _ss_sr_cs(
        paths, tables, partitions,
        [("sum", "store_profit", [c("ss_net_profit")]),
         ("sum", "return_loss", [c("sr_net_loss")]),
         ("sum", "catalog_profit", [c("cs_net_profit")])],
        {"store_profit": ("ss_net_profit", "sum"),
         "return_loss": ("sr_net_loss", "sum"),
         "catalog_profit": ("cs_net_profit", "sum")})


def q29(paths, tables, partitions: int = 2):
    return _ss_sr_cs(
        paths, tables, partitions,
        [("sum", "store_qty", [c("ss_quantity")]),
         ("sum", "return_qty", [c("sr_return_quantity")]),
         ("sum", "catalog_qty", [c("cs_quantity")])],
        {"store_qty": ("ss_quantity", "sum"),
         "return_qty": ("sr_return_quantity", "sum"),
         "catalog_qty": ("cs_quantity", "sum")})


QUERIES.update({
    "q10": (q10, ["customer", "customer_address",
                  "customer_demographics", "store_sales", "web_sales",
                  "catalog_sales"]),
    "q14": (q14, ["store_sales", "catalog_sales", "web_sales", "item"]),
    "q23": (q23, ["store_sales", "catalog_sales"]),
    "q24": (q24, ["store_sales", "store_returns", "store", "item",
                  "customer"]),
    "q25": (q25, ["store_sales", "store_returns", "catalog_sales",
                  "store", "item"]),
    "q29": (q29, ["store_sales", "store_returns", "catalog_sales",
                  "store", "item"]),
    "q35": (q35, ["customer", "customer_address",
                  "customer_demographics", "store_sales", "web_sales",
                  "catalog_sales"]),
    "q38": (q38, ["store_sales", "web_sales", "catalog_sales"]),
    "q64": (q64, ["store_sales", "store_returns", "customer",
                  "customer_demographics", "household_demographics",
                  "customer_address", "date_dim", "item", "store",
                  "promotion"]),
    "q69": (q69, ["customer", "customer_address",
                  "customer_demographics", "store_sales", "web_sales",
                  "catalog_sales"]),
    "q87": (q87, ["store_sales", "web_sales", "catalog_sales"]),
})


# ---------------------------------------------------------------------------
# second batch: rollups, disjunctions, case-pivots, time/hd dims, q97
# ---------------------------------------------------------------------------

def q26(paths, tables, partitions: int = 2):
    """q07's catalog twin: cs ⨝ cd ⨝ dd ⨝ promo ⨝ item, avg stats."""
    cs, cd, it = (tables["catalog_sales"],
                  tables["customer_demographics"], tables["item"])
    pr, dd = tables["promotion"], tables["date_dim"]

    cd_f = filter_(scan(paths, tables, "customer_demographics"),
                   binop("==", c("cd_gender"), lit("F", "utf8")),
                   binop("==", c("cd_education_status"),
                         lit("Primary", "utf8")))
    j_cd = join("broadcast_join", scan(paths, tables, "catalog_sales"),
                cd_f, [c("cs_bill_cdemo_sk")], [c("cd_demo_sk")])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(2000, "int32")))
    j_dd = join("broadcast_join", j_cd, dd_f,
                [c("cs_sold_date_sk")], [c("d_date_sk")])
    pr_f = filter_(scan(paths, tables, "promotion"),
                   binop("==", c("p_channel_event"), lit("N", "utf8")))
    j_pr = join("broadcast_join", j_dd, pr_f,
                [c("cs_promo_sk")], [c("p_promo_sk")])
    j_it = join("broadcast_join", j_pr, scan(paths, tables, "item"),
                [c("cs_item_sk")], [c("i_item_sk")])
    stats = _partial_final(
        j_it, [(c("i_item_id"), "i_item_id")],
        [("avg", "agg1", [c("cs_quantity")]),
         ("avg", "agg2", [c("cs_list_price")]),
         ("avg", "agg3", [c("cs_coupon_amt")]),
         ("avg", "agg4", [c("cs_sales_price")])], partitions)
    single = exchange(stats, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        csd, cdd, itd = cs.to_pandas(), cd.to_pandas(), it.to_pandas()
        prd, ddd = pr.to_pandas(), dd.to_pandas()
        m = csd.merge(cdd[(cdd.cd_gender == "F") &
                          (cdd.cd_education_status == "Primary")],
                      left_on="cs_bill_cdemo_sk", right_on="cd_demo_sk")
        m = m.merge(ddd[ddd.d_year == 2000], left_on="cs_sold_date_sk",
                    right_on="d_date_sk")
        m = m.merge(prd[prd.p_channel_event == "N"],
                    left_on="cs_promo_sk", right_on="p_promo_sk")
        m = m.merge(itd, left_on="cs_item_sk", right_on="i_item_sk")
        out = m.groupby("i_item_id", as_index=False).agg(
            agg1=("cs_quantity", "mean"), agg2=("cs_list_price", "mean"),
            agg3=("cs_coupon_amt", "mean"),
            agg4=("cs_sales_price", "mean"))
        return out.sort_values("i_item_id")[:100].reset_index(drop=True)

    return plan, oracle


def _rollup2(paths, tables, partitions, filt_preds, filt_oracle,
             measure_col, measure_name):
    """q27/q36 shape: ss (+dd/+store filter) rollup(i_category, i_class)
    via Expand, aggregated measure."""
    ss, it, dd, st = (tables["store_sales"], tables["item"],
                      tables["date_dim"], tables["store"])

    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(1999, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    st_f = filter_(scan(paths, tables, "store"), *filt_preds)
    j_st = join("broadcast_join", j_dd, st_f,
                [c("ss_store_sk")], [c("s_store_sk")])
    j_it = join("broadcast_join", j_st, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    nul = {"kind": "literal", "value": None, "type": {"id": "utf8"}}
    projections = []
    for kept, gid in ((2, 0), (1, 1), (0, 3)):
        projections.append(
            [c("i_category") if kept >= 1 else nul,
             c("i_class") if kept >= 2 else nul,
             lit(gid), c(measure_col)])
    expanded = {"kind": "expand", "input": j_it,
                "projections": projections,
                "names": ["i_category", "i_class", "g_id", measure_col]}
    out_agg = _partial_final(
        expanded,
        [(ci(0), "i_category"), (ci(1), "i_class"), (ci(2), "g_id")],
        [("sum", measure_name, [ci(3)])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False),
                               (ci(2), False)], 100)

    def oracle():
        ssd, itd = ss.to_pandas(), it.to_pandas()
        ddd, std = dd.to_pandas(), st.to_pandas()
        m = ssd.merge(ddd[ddd.d_year == 1999],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(filt_oracle(std), left_on="ss_store_sk",
                    right_on="s_store_sk")
        m = m.merge(itd, left_on="ss_item_sk", right_on="i_item_sk")
        frames = []
        for kept, gid in ((2, 0), (1, 1), (0, 3)):
            keys = ["i_category", "i_class"][:kept] if kept else []
            if keys:
                g = m.groupby(keys, as_index=False, dropna=False).agg(
                    v=(measure_col, "sum"))
            else:
                g = pd.DataFrame({"v": [m[measure_col].sum()]})
            for cn in ["i_category", "i_class"][kept:]:
                g[cn] = None
            g["g_id"] = gid
            frames.append(g[["i_category", "i_class", "g_id", "v"]])
        allf = pd.concat(frames, ignore_index=True).rename(
            columns={"v": measure_name})
        out = allf.sort_values(["i_category", "i_class", "g_id"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q27(paths, tables, partitions: int = 2):
    return _rollup2(paths, tables, partitions,
                    [binop("==", c("s_state"), lit("TN", "utf8"))],
                    lambda std: std[std.s_state == "TN"],
                    "ss_quantity", "qty_sum")


def q36(paths, tables, partitions: int = 2):
    return _rollup2(paths, tables, partitions,
                    [binop("!=", c("s_state"), lit("XX", "utf8"))],
                    lambda std: std[std.s_state != "XX"],
                    "ss_net_profit", "profit_sum")


def q43(paths, tables, partitions: int = 2):
    """Store revenue pivoted by day-of-week (case-when sums)."""
    ss, dd, st = (tables["store_sales"], tables["date_dim"],
                  tables["store"])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(1999, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_st = join("broadcast_join", j_dd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    day_exprs = []
    names = []
    for dow in range(7):
        day_exprs.append(_case(
            [(binop("==", c("d_dow"), lit(dow, "int32")),
              c("ss_ext_sales_price"))],
            lit(0.0, "float64")))
        names.append(f"d{dow}_sales")
    proj = project(j_st, [c("s_store_name")] + day_exprs,
                   ["s_store_name"] + names)
    out_agg = _partial_final(
        proj, [(ci(0), "s_store_name")],
        [("sum", n, [ci(i + 1)]) for i, n in enumerate(names)],
        partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        ssd, ddd, std = ss.to_pandas(), dd.to_pandas(), st.to_pandas()
        m = ssd.merge(ddd[ddd.d_year == 1999],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        for dow in range(7):
            m[f"d{dow}_sales"] = m.ss_ext_sales_price.where(
                m.d_dow == dow, 0.0)
        out = m.groupby("s_store_name", as_index=False)[
            [f"d{d}_sales" for d in range(7)]].sum()
        return out.sort_values("s_store_name")[:100] \
            .reset_index(drop=True)

    return plan, oracle


def q46(paths, tables, partitions: int = 2):
    """ss ⨝ dd(weekend) ⨝ store ⨝ hd(dep=4 OR vehicle=3) ⨝ ca: sales by
    city (the q46 household-demographics shape)."""
    ss, dd, st = (tables["store_sales"], tables["date_dim"],
                  tables["store"])
    hd, ca = (tables["household_demographics"],
              tables["customer_address"])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("or", binop("==", c("d_dow"), lit(6, "int32")),
                         binop("==", c("d_dow"), lit(0, "int32"))))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_st = join("broadcast_join", j_dd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   binop("or",
                         binop("==", c("hd_dep_count"), lit(4, "int32")),
                         binop("==", c("hd_vehicle_count"),
                               lit(3, "int32"))))
    j_hd = join("broadcast_join", j_st, hd_f,
                [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j_ca = join("hash_join",
                exchange(j_hd, [c("ss_addr_sk")], partitions),
                exchange(scan(paths, tables, "customer_address"),
                         [c("ca_address_sk")], partitions),
                [c("ss_addr_sk")], [c("ca_address_sk")])
    out_agg = _partial_final(
        j_ca,
        [(c("ca_city"), "ca_city"),
         (c("ss_ticket_number"), "ss_ticket_number")],
        [("sum", "amt", [c("ss_coupon_amt")]),
         ("sum", "profit", [c("ss_net_profit")])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, ddd, std = ss.to_pandas(), dd.to_pandas(), st.to_pandas()
        hdd, cad = hd.to_pandas(), ca.to_pandas()
        m = ssd.merge(ddd[(ddd.d_dow == 6) | (ddd.d_dow == 0)],
                      left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hdd[(hdd.hd_dep_count == 4) |
                        (hdd.hd_vehicle_count == 3)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(cad, left_on="ss_addr_sk", right_on="ca_address_sk")
        out = m.groupby(["ca_city", "ss_ticket_number"],
                        as_index=False).agg(
            amt=("ss_coupon_amt", "sum"),
            profit=("ss_net_profit", "sum"))
        out = out.sort_values(["ca_city", "ss_ticket_number"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q48(paths, tables, partitions: int = 2):
    """OR-disjunction over (marital x education x price band): the q48
    multi-arm predicate, sum(ss_quantity)."""
    ss, cd = tables["store_sales"], tables["customer_demographics"]
    j_cd = join("broadcast_join", scan(paths, tables, "store_sales"),
                scan(paths, tables, "customer_demographics"),
                [c("ss_cdemo_sk")], [c("cd_demo_sk")])
    arm = lambda ms, ed, lo, hi: binop(
        "and", binop("and", binop("==", c("cd_marital_status"),
                                  lit(ms, "utf8")),
                     binop("==", c("cd_education_status"),
                           lit(ed, "utf8"))),
        binop("and", binop(">=", c("ss_sales_price"),
                           lit(lo, "float64")),
              binop("<=", c("ss_sales_price"), lit(hi, "float64"))))
    flt = filter_(j_cd, binop("or", binop("or",
                                          arm("M", "4 yr Degree", 100.0,
                                              150.0),
                                          arm("D", "Primary", 50.0,
                                              100.0)),
                              arm("W", "College", 150.0, 200.0)))
    plan = _global_agg(flt, [("sum", "qty", [c("ss_quantity")])])

    def oracle():
        m = ss.to_pandas().merge(cd.to_pandas(),
                                 left_on="ss_cdemo_sk",
                                 right_on="cd_demo_sk")
        keep = (((m.cd_marital_status == "M") &
                 (m.cd_education_status == "4 yr Degree") &
                 m.ss_sales_price.between(100.0, 150.0)) |
                ((m.cd_marital_status == "D") &
                 (m.cd_education_status == "Primary") &
                 m.ss_sales_price.between(50.0, 100.0)) |
                ((m.cd_marital_status == "W") &
                 (m.cd_education_status == "College") &
                 m.ss_sales_price.between(150.0, 200.0)))
        f = m[keep]
        return pd.DataFrame(
            {"qty": [f.ss_quantity.sum() if len(f) else None]})

    return plan, oracle


def q50(paths, tables, partitions: int = 2):
    """ss ⨝ sr return-latency buckets (case-when day-difference pivot)."""
    ss, sr, st = (tables["store_sales"], tables["store_returns"],
                  tables["store"])
    ss_ex = exchange(scan(paths, tables, "store_sales"),
                     [c("ss_ticket_number"), c("ss_item_sk")], partitions)
    sr_ex = exchange(scan(paths, tables, "store_returns"),
                     [c("sr_ticket_number"), c("sr_item_sk")], partitions)
    j = join("hash_join", ss_ex, sr_ex,
             [c("ss_ticket_number"), c("ss_item_sk")],
             [c("sr_ticket_number"), c("sr_item_sk")])
    j_st = join("broadcast_join", j, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    diff = binop("-", c("sr_returned_date_sk"), c("ss_sold_date_sk"))
    bucket = lambda lo, hi: _case(
        [(binop("and", binop(">", diff, lit(lo)),
                binop("<=", diff, lit(hi))), lit(1))], lit(0))
    proj = project(
        j_st,
        [c("s_store_name"),
         _case([(binop("<=", diff, lit(30)), lit(1))], lit(0)),
         bucket(30, 60), bucket(60, 90), bucket(90, 120),
         _case([(binop(">", diff, lit(120)), lit(1))], lit(0))],
        ["s_store_name", "d30", "d60", "d90", "d120", "dmore"])
    out_agg = _partial_final(
        proj, [(ci(0), "s_store_name")],
        [("sum", n, [ci(i + 1)]) for i, n in
         enumerate(["d30", "d60", "d90", "d120", "dmore"])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = ss.to_pandas().merge(
            sr.to_pandas(),
            left_on=["ss_ticket_number", "ss_item_sk"],
            right_on=["sr_ticket_number", "sr_item_sk"])
        m = m.merge(st.to_pandas(), left_on="ss_store_sk",
                    right_on="s_store_sk")
        d = m.sr_returned_date_sk - m.ss_sold_date_sk
        m = m.assign(
            d30=(d <= 30).astype(int),
            d60=((d > 30) & (d <= 60)).astype(int),
            d90=((d > 60) & (d <= 90)).astype(int),
            d120=((d > 90) & (d <= 120)).astype(int),
            dmore=(d > 120).astype(int))
        out = m.groupby("s_store_name", as_index=False)[
            ["d30", "d60", "d90", "d120", "dmore"]].sum()
        return out.sort_values("s_store_name")[:100] \
            .reset_index(drop=True)

    return plan, oracle


def q65(paths, tables, partitions: int = 2):
    """Items whose store revenue <= 0.1 * the store's average item
    revenue (two-level aggregation + join on the threshold)."""
    ss, it, st = (tables["store_sales"], tables["item"],
                  tables["store"])
    rev = _partial_final(
        scan(paths, tables, "store_sales"),
        [(c("ss_store_sk"), "store_sk"), (c("ss_item_sk"), "item_sk")],
        [("sum", "revenue", [c("ss_sales_price")])], partitions)
    avg_in = exchange(rev, [ci(0)], partitions)
    avg_rev = agg(
        agg(avg_in, [(ci(0), "store_sk")],
            [("avg", "partial", "ave", [ci(2)])]),
        [(ci(0), "store_sk")],
        [("avg", "final", "ave", [ci(1), ci(2)])])
    j = join("sort_merge_join", exchange(rev, [ci(0)], partitions),
             avg_rev, [ci(0)], [ci(0)])
    flt = filter_(j, binop("<=", ci(2),
                           binop("*", ci(4), lit(0.1, "float64"))))
    j_st = join("broadcast_join", flt, scan(paths, tables, "store"),
                [ci(0)], [c("s_store_sk")])
    j_it = join("broadcast_join", j_st, scan(paths, tables, "item"),
                [ci(1)], [c("i_item_sk")])
    picked = project(j_it, [c("s_store_name"), c("i_item_id"), ci(2)],
                     ["s_store_name", "i_item_id", "revenue"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd = ss.to_pandas()
        rev = ssd.groupby(["ss_store_sk", "ss_item_sk"],
                          as_index=False).agg(
            revenue=("ss_sales_price", "sum"))
        ave = rev.groupby("ss_store_sk", as_index=False) \
            .revenue.mean().rename(columns={"revenue": "ave"})
        m = rev.merge(ave, on="ss_store_sk")
        m = m[m.revenue <= 0.1 * m.ave]
        m = m.merge(st.to_pandas(), left_on="ss_store_sk",
                    right_on="s_store_sk")
        m = m.merge(it.to_pandas(), left_on="ss_item_sk",
                    right_on="i_item_sk")
        out = m[["s_store_name", "i_item_id", "revenue"]] \
            .sort_values(["s_store_name", "i_item_id"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def _ticket_counts(paths, tables, partitions, hd_preds, hd_oracle,
                   lo, hi):
    """q73/q34/q79 family: per-(ticket, customer) item counts for a
    household-demographics selection, HAVING count BETWEEN lo AND hi,
    joined back to customer."""
    ss, hd, cu = (tables["store_sales"],
                  tables["household_demographics"], tables["customer"])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   *hd_preds)
    j_hd = join("broadcast_join", scan(paths, tables, "store_sales"),
                hd_f, [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    cnt = _partial_final(
        j_hd,
        [(c("ss_ticket_number"), "ticket"),
         (c("ss_customer_sk"), "customer_sk")],
        [("count", "cnt", [c("ss_item_sk")])], partitions)
    flt = filter_(cnt, binop("and", binop(">=", ci(2), lit(lo)),
                             binop("<=", ci(2), lit(hi))))
    j_cu = join("hash_join", exchange(flt, [ci(1)], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [ci(1)], [c("c_customer_sk")])
    picked = project(j_cu, [c("c_customer_id"), ci(0), ci(2)],
                     ["c_customer_id", "ticket", "cnt"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(2), True), (ci(0), False),
                               (ci(1), False)], 100)

    def oracle():
        ssd, hdd = ss.to_pandas(), hd.to_pandas()
        cud = cu.to_pandas()
        m = ssd.merge(hd_oracle(hdd), left_on="ss_hdemo_sk",
                      right_on="hd_demo_sk")
        g = m.groupby(["ss_ticket_number", "ss_customer_sk"],
                      as_index=False).agg(cnt=("ss_item_sk", "count"))
        g = g[(g.cnt >= lo) & (g.cnt <= hi)]
        g = g.merge(cud, left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        out = g[["c_customer_id", "ss_ticket_number", "cnt"]].rename(
            columns={"ss_ticket_number": "ticket"})
        out = out.sort_values(["cnt", "c_customer_id", "ticket"],
                              ascending=[False, True, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q73(paths, tables, partitions: int = 2):
    """Tickets by high-dependency households (q73 shape)."""
    return _ticket_counts(
        paths, tables, partitions,
        [binop(">", c("hd_dep_count"), lit(6, "int32"))],
        lambda hdd: hdd[hdd.hd_dep_count > 6], 1, 5)



def q93(paths, tables, partitions: int = 2):
    """ss LEFT JOIN sr (+reason): per-customer actual sales where
    returned quantity is deducted (case-when over the outer side)."""
    ss, sr, re = (tables["store_sales"], tables["store_returns"],
                  tables["reason"])
    sr_re = join("broadcast_join", scan(paths, tables, "store_returns"),
                 filter_(scan(paths, tables, "reason"),
                         binop("<=", c("r_reason_sk"), lit(20))),
                 [c("sr_reason_sk")], [c("r_reason_sk")])
    j = join("hash_join",
             exchange(scan(paths, tables, "store_sales"),
                      [c("ss_ticket_number"), c("ss_item_sk")],
                      partitions),
             exchange(sr_re, [c("sr_ticket_number"), c("sr_item_sk")],
                      partitions),
             [c("ss_ticket_number"), c("ss_item_sk")],
             [c("sr_ticket_number"), c("sr_item_sk")], jt="left")
    act = project(
        j,
        [c("ss_customer_sk"),
         _case([({"kind": "is_not_null", "child": c("sr_ticket_number")},
                 binop("*",
                       {"kind": "cast",
                        "child": binop("-", c("ss_quantity"),
                                       c("sr_return_quantity")),
                        "type": {"id": "float64"}},
                       c("ss_sales_price")))],
               binop("*", {"kind": "cast", "child": c("ss_quantity"),
                           "type": {"id": "float64"}},
                     c("ss_sales_price")))],
        ["ss_customer_sk", "act_sales"])
    out_agg = _partial_final(act, [(ci(0), "ss_customer_sk")],
                             [("sum", "sumsales", [ci(1)])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(1), False), (ci(0), False)], 100)

    def oracle():
        ssd, srd, red = ss.to_pandas(), sr.to_pandas(), re.to_pandas()
        srj = srd.merge(red[red.r_reason_sk <= 20],
                        left_on="sr_reason_sk", right_on="r_reason_sk")
        m = ssd.merge(srj, how="left",
                      left_on=["ss_ticket_number", "ss_item_sk"],
                      right_on=["sr_ticket_number", "sr_item_sk"])
        act = m.ss_quantity * m.ss_sales_price
        returned = (m.ss_quantity - m.sr_return_quantity) * \
            m.ss_sales_price
        m = m.assign(act_sales=returned.where(
            m.sr_ticket_number.notna(), act))
        out = m.groupby("ss_customer_sk", as_index=False).agg(
            sumsales=("act_sales", "sum"))
        out = out.sort_values(["sumsales", "ss_customer_sk"],
                              ascending=[True, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q96(paths, tables, partitions: int = 2):
    """count(*) of evening high-dependency store traffic: ss ⨝
    time_dim(hour=20) ⨝ hd(dep=7) ⨝ store."""
    ss, td, hd = (tables["store_sales"], tables["time_dim"],
                  tables["household_demographics"])
    td_f = filter_(scan(paths, tables, "time_dim"),
                   binop("==", c("t_hour"), lit(20, "int32")),
                   binop(">=", c("t_minute"), lit(30, "int32")))
    j_td = join("broadcast_join", scan(paths, tables, "store_sales"),
                td_f, [c("ss_sold_time_sk")], [c("t_time_sk")])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   binop("==", c("hd_dep_count"), lit(7, "int32")))
    j_hd = join("broadcast_join", j_td, hd_f,
                [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j_st = join("broadcast_join", j_hd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    plan = _global_agg(j_st, [("count", "cnt", [c("ss_ticket_number")])])

    def oracle():
        ssd, tdd, hdd = ss.to_pandas(), td.to_pandas(), hd.to_pandas()
        m = ssd.merge(tdd[(tdd.t_hour == 20) & (tdd.t_minute >= 30)],
                      left_on="ss_sold_time_sk", right_on="t_time_sk")
        m = m.merge(hdd[hdd.hd_dep_count == 7],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        return pd.DataFrame({"cnt": [len(m)]})

    return plan, oracle


def q97(paths, tables, partitions: int = 2):
    """FULL OUTER of distinct store vs catalog customer-item pairs:
    counts of store-only / catalog-only / both (the q97 matrix)."""
    ss, cs = tables["store_sales"], tables["catalog_sales"]
    ss_d = _partial_final(
        project(scan(paths, tables, "store_sales"),
                [c("ss_customer_sk"), c("ss_item_sk")],
                ["customer_sk", "item_sk"]),
        [(ci(0), "customer_sk"), (ci(1), "item_sk")],
        [("count", "cnt", [ci(0)])], partitions)
    cs_d = _partial_final(
        project(scan(paths, tables, "catalog_sales"),
                [c("cs_bill_customer_sk"), c("cs_item_sk")],
                ["customer_sk", "item_sk"]),
        [(ci(0), "customer_sk"), (ci(1), "item_sk")],
        [("count", "cnt", [ci(0)])], partitions)
    j = join("sort_merge_join", exchange(ss_d, [ci(0), ci(1)], partitions),
             exchange(cs_d, [ci(0), ci(1)], partitions),
             [ci(0), ci(1)], [ci(0), ci(1)], jt="full")
    both = _case([(binop("and",
                         {"kind": "is_not_null", "child": ci(0)},
                         {"kind": "is_not_null", "child": ci(3)}),
                   lit(1))], lit(0))
    s_only = _case([(binop("and",
                           {"kind": "is_not_null", "child": ci(0)},
                           {"kind": "is_null", "child": ci(3)}),
                     lit(1))], lit(0))
    c_only = _case([(binop("and",
                           {"kind": "is_null", "child": ci(0)},
                           {"kind": "is_not_null", "child": ci(3)}),
                     lit(1))], lit(0))
    proj = project(j, [s_only, c_only, both],
                   ["store_only", "catalog_only", "store_and_catalog"])
    plan = _global_agg(proj,
                       [("sum", "store_only", [ci(0)]),
                        ("sum", "catalog_only", [ci(1)]),
                        ("sum", "store_and_catalog", [ci(2)])])

    def oracle():
        s = set(map(tuple, ss.to_pandas()[
            ["ss_customer_sk", "ss_item_sk"]].values))
        cset = set(map(tuple, cs.to_pandas()[
            ["cs_bill_customer_sk", "cs_item_sk"]].values))
        return pd.DataFrame({
            "store_only": [len(s - cset)],
            "catalog_only": [len(cset - s)],
            "store_and_catalog": [len(s & cset)]})

    return plan, oracle


def q28(paths, tables, partitions: int = 2):
    """Six price-band global aggregates unioned (the q28 bucket shape)."""
    ss = tables["store_sales"]
    bands = [(0.0, 50.0), (50.0, 100.0), (100.0, 150.0),
             (150.0, 200.0), (200.0, 250.0), (250.0, 300.0)]
    legs = []
    for i, (lo, hi) in enumerate(bands):
        f = filter_(scan(paths, tables, "store_sales"),
                    binop(">=", c("ss_list_price"), lit(lo, "float64")),
                    binop("<", c("ss_list_price"), lit(hi, "float64")))
        leg = _global_agg(f, [("avg", "avg_price", [c("ss_list_price")]),
                              ("count", "cnt", [c("ss_list_price")])])
        legs.append(project(leg, [lit(i), ci(0), ci(1)],
                            ["band", "avg_price", "cnt"]))
    u = {"kind": "union", "inputs": legs}
    plan = sort_limit(u, [(ci(0), False)], 10)

    def oracle():
        ssd = ss.to_pandas()
        rows = []
        for i, (lo, hi) in enumerate(bands):
            f = ssd[(ssd.ss_list_price >= lo) & (ssd.ss_list_price < hi)]
            rows.append({"band": i,
                         "avg_price": f.ss_list_price.mean()
                         if len(f) else None,
                         "cnt": len(f)})
        return pd.DataFrame(rows)

    return plan, oracle


def q15(paths, tables, partitions: int = 2):
    """Catalog sales by customer zip-state (in-list + threshold OR): the
    q15 disjunction over ca columns."""
    cs, cu, ca, dd = (tables["catalog_sales"], tables["customer"],
                      tables["customer_address"], tables["date_dim"])
    j_cu = join("hash_join",
                exchange(scan(paths, tables, "catalog_sales"),
                         [c("cs_bill_customer_sk")], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [c("cs_bill_customer_sk")], [c("c_customer_sk")])
    j_ca = join("broadcast_join", j_cu,
                scan(paths, tables, "customer_address"),
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(2000, "int32")),
                   binop("==", c("d_qoy"), lit(1, "int32")))
    j_dd = join("broadcast_join", j_ca, dd_f,
                [c("cs_sold_date_sk")], [c("d_date_sk")])
    flt = filter_(j_dd, binop(
        "or",
        {"kind": "in_list", "child": c("ca_state"),
         "values": ["CA", "WA", "GA"], "type": {"id": "utf8"}},
        binop(">", c("cs_sales_price"), lit(240.0, "float64"))))
    out_agg = _partial_final(flt, [(c("ca_state"), "ca_state")],
                             [("sum", "total", [c("cs_sales_price")])],
                             partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = cs.to_pandas().merge(cu.to_pandas(),
                                 left_on="cs_bill_customer_sk",
                                 right_on="c_customer_sk")
        m = m.merge(ca.to_pandas(), left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        ddd = dd.to_pandas()
        m = m.merge(ddd[(ddd.d_year == 2000) & (ddd.d_qoy == 1)],
                    left_on="cs_sold_date_sk", right_on="d_date_sk")
        m = m[m.ca_state.isin(["CA", "WA", "GA"]) |
              (m.cs_sales_price > 240.0)]
        out = m.groupby("ca_state", as_index=False).agg(
            total=("cs_sales_price", "sum"))
        return out.sort_values("ca_state")[:100].reset_index(drop=True)

    return plan, oracle


def q13(paths, tables, partitions: int = 2):
    """Demographic/address disjunction with avg/sum measures (q13)."""
    ss, cd, ca, hd = (tables["store_sales"],
                      tables["customer_demographics"],
                      tables["customer_address"],
                      tables["household_demographics"])
    j_cd = join("broadcast_join", scan(paths, tables, "store_sales"),
                scan(paths, tables, "customer_demographics"),
                [c("ss_cdemo_sk")], [c("cd_demo_sk")])
    j_hd = join("broadcast_join", j_cd,
                scan(paths, tables, "household_demographics"),
                [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j_ca = join("hash_join",
                exchange(j_hd, [c("ss_addr_sk")], partitions),
                exchange(scan(paths, tables, "customer_address"),
                         [c("ca_address_sk")], partitions),
                [c("ss_addr_sk")], [c("ca_address_sk")])
    arm1 = binop("and",
                 binop("==", c("cd_marital_status"), lit("M", "utf8")),
                 binop(">=", c("hd_dep_count"), lit(3, "int32")))
    arm2 = binop("and",
                 binop("==", c("cd_marital_status"), lit("S", "utf8")),
                 {"kind": "in_list", "child": c("ca_state"),
                  "values": ["TX", "OH", "IL"], "type": {"id": "utf8"}})
    flt = filter_(j_ca, binop("or", arm1, arm2))
    plan = _global_agg(flt,
                       [("avg", "avg_quantity", [c("ss_quantity")]),
                        ("avg", "avg_ext_price",
                         [c("ss_ext_sales_price")]),
                        ("sum", "sum_wholesale", [c("ss_net_profit")])])

    def oracle():
        m = ss.to_pandas().merge(cd.to_pandas(),
                                 left_on="ss_cdemo_sk",
                                 right_on="cd_demo_sk")
        m = m.merge(hd.to_pandas(), left_on="ss_hdemo_sk",
                    right_on="hd_demo_sk")
        m = m.merge(ca.to_pandas(), left_on="ss_addr_sk",
                    right_on="ca_address_sk")
        keep = (((m.cd_marital_status == "M") & (m.hd_dep_count >= 3)) |
                ((m.cd_marital_status == "S") &
                 m.ca_state.isin(["TX", "OH", "IL"])))
        f = m[keep]
        return pd.DataFrame({
            "avg_quantity": [f.ss_quantity.mean() if len(f) else None],
            "avg_ext_price": [f.ss_ext_sales_price.mean()
                              if len(f) else None],
            "sum_wholesale": [f.ss_net_profit.sum()
                              if len(f) else None]})

    return plan, oracle


QUERIES.update({
    "q13": (q13, ["store_sales", "customer_demographics",
                  "customer_address", "household_demographics"]),
    "q15": (q15, ["catalog_sales", "customer", "customer_address",
                  "date_dim"]),
    "q26": (q26, ["catalog_sales", "customer_demographics", "item",
                  "promotion", "date_dim"]),
    "q27": (q27, ["store_sales", "item", "date_dim", "store"]),
    "q28": (q28, ["store_sales"]),
    "q36": (q36, ["store_sales", "item", "date_dim", "store"]),
    "q43": (q43, ["store_sales", "date_dim", "store"]),
    "q46": (q46, ["store_sales", "date_dim", "store",
                  "household_demographics", "customer_address"]),
    "q48": (q48, ["store_sales", "customer_demographics"]),
    "q50": (q50, ["store_sales", "store_returns", "store"]),
    "q65": (q65, ["store_sales", "item", "store"]),
    "q73": (q73, ["store_sales", "household_demographics", "customer"]),
    "q93": (q93, ["store_sales", "store_returns", "reason"]),
    "q96": (q96, ["store_sales", "time_dim",
                  "household_demographics", "store"]),
    "q97": (q97, ["store_sales", "catalog_sales"]),
})


# ---------------------------------------------------------------------------
# third batch: window lag (q47/q57), hd-count tickets (q34/q68/q79),
# time buckets (q88), catalog anti/semi (q94-shape) and ship-latency (q99)
# ---------------------------------------------------------------------------

def _lag_over_monthly(paths, tables, partitions, fact, date_col, item_col,
                      price_col):
    """The q47/q57 shape: monthly brand revenue with LAG/LEAD over the
    (brand, year) window ordered by month."""
    ft, it, dd = tables[fact], tables["item"], tables["date_dim"]

    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("==", c("d_year"), lit(1999, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, fact), dd_f,
                [c(date_col)], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c(item_col)], [c("i_item_sk")])
    rev = _partial_final(
        j_it,
        [(c("i_brand_id"), "brand_id"), (c("d_moy"), "moy")],
        [("sum", "sum_sales", [c(price_col)])], partitions)
    ex = exchange(rev, [ci(0)], 1)
    srt = {"kind": "sort", "input": ex,
           "specs": [{"expr": ci(0), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(1), "descending": False,
                      "nulls_first": True}]}
    win = {"kind": "window", "input": srt,
           "functions": [
               {"kind": "lag", "name": "psum", "offset": 1,
                "expr": ci(2)},
               {"kind": "lead", "name": "nsum", "offset": 1,
                "expr": ci(2)}],
           "partition_by": [ci(0)],
           "order_by": [{"expr": ci(1), "descending": False,
                         "nulls_first": True}]}
    plan = sort_limit(win, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        fd, itd, ddd = ft.to_pandas(), it.to_pandas(), dd.to_pandas()
        m = fd.merge(ddd[ddd.d_year == 1999], left_on=date_col,
                     right_on="d_date_sk")
        m = m.merge(itd, left_on=item_col, right_on="i_item_sk")
        g = (m.groupby(["i_brand_id", "d_moy"], as_index=False)
             .agg(sum_sales=(price_col, "sum"))
             .rename(columns={"i_brand_id": "brand_id", "d_moy": "moy"}))
        g = g.sort_values(["brand_id", "moy"]).reset_index(drop=True)
        g["psum"] = g.groupby("brand_id").sum_sales.shift(1)
        g["nsum"] = g.groupby("brand_id").sum_sales.shift(-1)
        return g.sort_values(["brand_id", "moy"])[:100] \
            .reset_index(drop=True)

    return plan, oracle


def q47(paths, tables, partitions: int = 2):
    return _lag_over_monthly(paths, tables, partitions, "store_sales",
                             "ss_sold_date_sk", "ss_item_sk",
                             "ss_sales_price")


def q57(paths, tables, partitions: int = 2):
    return _lag_over_monthly(paths, tables, partitions, "catalog_sales",
                             "cs_sold_date_sk", "cs_item_sk",
                             "cs_sales_price")


def q34(paths, tables, partitions: int = 2):
    """q34 shape: ticket counts for buy-potential households with a
    vehicle (distinct hd selection from q73).  NOTE the synthetic
    generator makes ss_ticket_number unique per row, so the HAVING lower
    bound is 1 (a >=2 bound would select nothing and test only the
    empty path — review-caught)."""
    return _ticket_counts(
        paths, tables, partitions,
        [binop("or",
               binop("==", c("hd_buy_potential"), lit(">10000", "utf8")),
               binop("==", c("hd_buy_potential"),
                     lit("Unknown", "utf8"))),
         binop(">", c("hd_vehicle_count"), lit(0, "int32"))],
        lambda hdd: hdd[(hdd.hd_buy_potential.isin([">10000",
                                                    "Unknown"])) &
                        (hdd.hd_vehicle_count > 0)], 1, 20)



def q68(paths, tables, partitions: int = 2):
    """q46's sibling: start-of-month (d_dom <= 2) city sales with
    extended amounts by ticket — the real q68 pairs this day-of-month
    filter with demographic predicates."""
    ss, dd, st = (tables["store_sales"], tables["date_dim"],
                  tables["store"])
    hd, ca = (tables["household_demographics"],
              tables["customer_address"])
    dd_f = filter_(scan(paths, tables, "date_dim"),
                   binop("<=", c("d_dom"), lit(2, "int32")))
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                dd_f, [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_st = join("broadcast_join", j_dd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   binop("or",
                         binop("==", c("hd_dep_count"), lit(3, "int32")),
                         binop("==", c("hd_vehicle_count"),
                               lit(4, "int32"))))
    j_hd = join("broadcast_join", j_st, hd_f,
                [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j_ca = join("hash_join",
                exchange(j_hd, [c("ss_addr_sk")], partitions),
                exchange(scan(paths, tables, "customer_address"),
                         [c("ca_address_sk")], partitions),
                [c("ss_addr_sk")], [c("ca_address_sk")])
    out_agg = _partial_final(
        j_ca,
        [(c("ca_city"), "ca_city"),
         (c("ss_ticket_number"), "ss_ticket_number")],
        [("sum", "ext_price", [c("ss_ext_sales_price")]),
         ("sum", "list_price", [c("ss_list_price")])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, ddd, std = ss.to_pandas(), dd.to_pandas(), st.to_pandas()
        hdd, cad = hd.to_pandas(), ca.to_pandas()
        m = ssd.merge(ddd[ddd.d_dom <= 2], left_on="ss_sold_date_sk",
                      right_on="d_date_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        m = m.merge(hdd[(hdd.hd_dep_count == 3) |
                        (hdd.hd_vehicle_count == 4)],
                    left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(cad, left_on="ss_addr_sk", right_on="ca_address_sk")
        out = m.groupby(["ca_city", "ss_ticket_number"],
                        as_index=False).agg(
            ext_price=("ss_ext_sales_price", "sum"),
            list_price=("ss_list_price", "sum"))
        out = out.sort_values(["ca_city", "ss_ticket_number"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q79(paths, tables, partitions: int = 2):
    """Per-ticket profit for high-dep or no-vehicle households (q79)."""
    ss, hd, st, cu = (tables["store_sales"],
                      tables["household_demographics"],
                      tables["store"], tables["customer"])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   binop("or",
                         binop("==", c("hd_dep_count"), lit(6, "int32")),
                         binop(">", c("hd_vehicle_count"),
                               lit(2, "int32"))))
    j_hd = join("broadcast_join", scan(paths, tables, "store_sales"),
                hd_f, [c("ss_hdemo_sk")], [c("hd_demo_sk")])
    j_st = join("broadcast_join", j_hd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    g = _partial_final(
        j_st,
        [(c("ss_ticket_number"), "ticket"),
         (c("ss_customer_sk"), "customer_sk"),
         (c("s_store_name"), "s_store_name")],
        [("sum", "amt", [c("ss_coupon_amt")]),
         ("sum", "profit", [c("ss_net_profit")])], partitions)
    j_cu = join("hash_join", exchange(g, [ci(1)], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [ci(1)], [c("c_customer_sk")])
    picked = project(j_cu, [c("c_customer_id"), ci(0), ci(2), ci(3),
                            ci(4)],
                     ["c_customer_id", "ticket", "s_store_name", "amt",
                      "profit"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, hdd = ss.to_pandas(), hd.to_pandas()
        std, cud = st.to_pandas(), cu.to_pandas()
        m = ssd.merge(hdd[(hdd.hd_dep_count == 6) |
                          (hdd.hd_vehicle_count > 2)],
                      left_on="ss_hdemo_sk", right_on="hd_demo_sk")
        m = m.merge(std, left_on="ss_store_sk", right_on="s_store_sk")
        g = m.groupby(["ss_ticket_number", "ss_customer_sk",
                       "s_store_name"], as_index=False).agg(
            amt=("ss_coupon_amt", "sum"),
            profit=("ss_net_profit", "sum"))
        g = g.merge(cud, left_on="ss_customer_sk",
                    right_on="c_customer_sk")
        out = g[["c_customer_id", "ss_ticket_number", "s_store_name",
                 "amt", "profit"]].rename(
            columns={"ss_ticket_number": "ticket"})
        out = out.sort_values(["c_customer_id", "ticket"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q88(paths, tables, partitions: int = 2):
    """Eight half-hour traffic counts unioned (the q88 time-bucket
    shape over time_dim + household_demographics)."""
    ss, td, hd = (tables["store_sales"], tables["time_dim"],
                  tables["household_demographics"])
    hd_f = filter_(scan(paths, tables, "household_demographics"),
                   binop("<=", c("hd_dep_count"), lit(5, "int32")))
    legs = []
    buckets = [(8, 0, 30), (8, 30, 60), (9, 0, 30), (9, 30, 60),
               (10, 0, 30), (10, 30, 60), (11, 0, 30), (11, 30, 60)]
    for i, (hour, mlo, mhi) in enumerate(buckets):
        td_f = filter_(scan(paths, tables, "time_dim"),
                       binop("==", c("t_hour"), lit(hour, "int32")),
                       binop(">=", c("t_minute"), lit(mlo, "int32")),
                       binop("<", c("t_minute"), lit(mhi, "int32")))
        j_td = join("broadcast_join", scan(paths, tables, "store_sales"),
                    td_f, [c("ss_sold_time_sk")], [c("t_time_sk")])
        j_hd = join("broadcast_join", j_td, hd_f,
                    [c("ss_hdemo_sk")], [c("hd_demo_sk")])
        leg = _global_agg(j_hd, [("count", "cnt",
                                  [c("ss_ticket_number")])])
        legs.append(project(leg, [lit(i), ci(0)], ["bucket", "cnt"]))
    u = {"kind": "union", "inputs": legs}
    plan = sort_limit(u, [(ci(0), False)], 10)

    def oracle():
        ssd, tdd, hdd = ss.to_pandas(), td.to_pandas(), hd.to_pandas()
        hsel = hdd[hdd.hd_dep_count <= 5]
        rows = []
        for i, (hour, mlo, mhi) in enumerate(buckets):
            t = tdd[(tdd.t_hour == hour) & (tdd.t_minute >= mlo) &
                    (tdd.t_minute < mhi)]
            m = ssd.merge(t, left_on="ss_sold_time_sk",
                          right_on="t_time_sk")
            m = m.merge(hsel, left_on="ss_hdemo_sk",
                        right_on="hd_demo_sk")
            rows.append({"bucket": i, "cnt": len(m)})
        return pd.DataFrame(rows)

    return plan, oracle


def q94(paths, tables, partitions: int = 2):
    """Catalog orders shipped cross-warehouse with no return: q94 is the
    catalog twin of q95 (EXISTS different-warehouse + NOT EXISTS
    return)."""
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]

    base = project(filter_(scan(paths, tables, "catalog_sales"),
                           binop("<=", c("cs_call_center_sk"), lit(3))),
                   [c("cs_order_number"), c("cs_warehouse_sk"),
                    c("cs_ext_sales_price"), c("cs_net_profit")],
                   ["order_number", "warehouse_sk", "price", "profit"])
    base_ex = exchange(base, [ci(0)], partitions)
    all_cs = project(scan(paths, tables, "catalog_sales"),
                     [c("cs_order_number"), c("cs_warehouse_sk")],
                     ["o2", "w2"])
    all_ex = exchange(all_cs, [ci(0)], partitions)
    semi = join("hash_join", base_ex, all_ex, [ci(0)], [ci(0)],
                jt="left_semi", flt=binop("!=", ci(1), ci(5)))
    cr_ex = exchange(project(scan(paths, tables, "catalog_returns"),
                             [c("cr_order_number")], ["cr_order_number"]),
                     [ci(0)], partitions)
    anti = join("hash_join", semi, cr_ex, [ci(0)], [ci(0)],
                jt="left_anti")
    per_order = agg(
        agg(anti, [(ci(0), "order_number")],
            [("sum", "partial", "price", [ci(2)]),
             ("sum", "partial", "profit", [ci(3)])]),
        [(ci(0), "order_number")],
        [("sum", "final", "price", [ci(1)]),
         ("sum", "final", "profit", [ci(2)])])
    single = exchange(per_order, [ci(0)], 1)
    plan = _global_agg(single,
                       [("count", "order_count", [ci(0)]),
                        ("sum", "total_price", [ci(1)]),
                        ("sum", "total_profit", [ci(2)])])

    def oracle():
        csd, crd = cs.to_pandas(), cr.to_pandas()
        f = csd[csd.cs_call_center_sk <= 3]
        wh = csd.groupby("cs_order_number").cs_warehouse_sk.agg(set)
        ok = f[f.apply(lambda r: bool(
            wh.get(r.cs_order_number, set()) - {r.cs_warehouse_sk}),
            axis=1)] if len(f) else f
        ok = ok[~ok.cs_order_number.isin(set(crd.cr_order_number))]
        return pd.DataFrame({
            "order_count": [ok.cs_order_number.nunique()],
            "total_price": [ok.cs_ext_sales_price.sum() if len(ok)
                            else None],
            "total_profit": [ok.cs_net_profit.sum() if len(ok)
                             else None]})

    return plan, oracle


def q99(paths, tables, partitions: int = 2):
    """Catalog ship-latency buckets by warehouse (the q99 case-when
    pivot over cs_ship_date - cs_sold_date)."""
    cs, wh = tables["catalog_sales"], tables["warehouse"]
    j_wh = join("broadcast_join", scan(paths, tables, "catalog_sales"),
                scan(paths, tables, "warehouse"),
                [c("cs_warehouse_sk")], [c("w_warehouse_sk")])
    diff = binop("-", c("cs_ship_date_sk"), c("cs_sold_date_sk"))
    bucket = lambda lo, hi: _case(
        [(binop("and", binop(">", diff, lit(lo)),
                binop("<=", diff, lit(hi))), lit(1))], lit(0))
    proj = project(
        j_wh,
        [c("w_warehouse_name"),
         _case([(binop("<=", diff, lit(30)), lit(1))], lit(0)),
         bucket(30, 60), bucket(60, 90), bucket(90, 120),
         _case([(binop(">", diff, lit(120)), lit(1))], lit(0))],
        ["w_warehouse_name", "d30", "d60", "d90", "d120", "dmore"])
    out_agg = _partial_final(
        proj, [(ci(0), "w_warehouse_name")],
        [("sum", n, [ci(i + 1)]) for i, n in
         enumerate(["d30", "d60", "d90", "d120", "dmore"])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = cs.to_pandas().merge(wh.to_pandas(),
                                 left_on="cs_warehouse_sk",
                                 right_on="w_warehouse_sk")
        d = m.cs_ship_date_sk - m.cs_sold_date_sk
        m = m.assign(
            d30=(d <= 30).astype(int),
            d60=((d > 30) & (d <= 60)).astype(int),
            d90=((d > 60) & (d <= 90)).astype(int),
            d120=((d > 90) & (d <= 120)).astype(int),
            dmore=(d > 120).astype(int))
        out = m.groupby("w_warehouse_name", as_index=False)[
            ["d30", "d60", "d90", "d120", "dmore"]].sum()
        return out.sort_values("w_warehouse_name")[:100] \
            .reset_index(drop=True)

    return plan, oracle


QUERIES.update({
    "q34": (q34, ["store_sales", "household_demographics", "customer"]),
    "q47": (q47, ["store_sales", "item", "date_dim"]),
    "q57": (q57, ["catalog_sales", "item", "date_dim"]),
    "q68": (q68, ["store_sales", "date_dim", "store",
                  "household_demographics", "customer_address"]),
    "q79": (q79, ["store_sales", "household_demographics", "store",
                  "customer"]),
    "q88": (q88, ["store_sales", "time_dim",
                  "household_demographics"]),
    "q94": (q94, ["catalog_sales", "catalog_returns"]),
    "q99": (q99, ["catalog_sales", "warehouse"]),
})


# ---------------------------------------------------------------------------
# fourth batch: year-over-year self joins (q04/q11/q31), weekly self join
# (q59), web ship buckets (q62), warehouse month pivot (q66), rank over
# state rollup (q70), windowed deviation (q89), above-average web (q92)
# ---------------------------------------------------------------------------

def _yearly_customer_totals(paths, tables, partitions, fact, cust_col,
                            date_col, price_col, year):
    f = join("broadcast_join", scan(paths, tables, fact),
             filter_(scan(paths, tables, "date_dim"),
                     binop("==", c("d_year"), lit(year, "int32"))),
             [c(date_col)], [c("d_date_sk")])
    return _partial_final(f, [(c(cust_col), "customer_sk")],
                          [("sum", "total", [c(price_col)])], partitions)


def _yoy_growth(paths, tables, partitions, fact, cust_col, date_col,
                price_col):
    """The q04/q11 skeleton: customers whose year-2 spend grew vs year 1
    in THIS channel (the real queries compare growth across channels;
    the self-join-on-customer shape is identical)."""
    cu = tables["customer"]
    y1 = _yearly_customer_totals(paths, tables, partitions, fact,
                                 cust_col, date_col, price_col, 1999)
    y2 = _yearly_customer_totals(paths, tables, partitions, fact,
                                 cust_col, date_col, price_col, 2000)
    j = join("hash_join", exchange(y1, [ci(0)], partitions),
             exchange(y2, [ci(0)], partitions), [ci(0)], [ci(0)])
    grown = filter_(j, binop(">", ci(3), ci(1)))
    j_cu = join("hash_join", exchange(grown, [ci(0)], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [ci(0)], [c("c_customer_sk")])
    picked = project(j_cu, [c("c_customer_id"), ci(1), ci(3)],
                     ["c_customer_id", "year1_total", "year2_total"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    ft, dd = tables[fact], tables["date_dim"]

    def oracle():
        fd, ddd, cud = ft.to_pandas(), dd.to_pandas(), cu.to_pandas()

        def year_tot(y):
            m = fd.merge(ddd[ddd.d_year == y], left_on=date_col,
                         right_on="d_date_sk")
            return (m.groupby(cust_col, as_index=False)
                    .agg(total=(price_col, "sum")))

        a = year_tot(1999).rename(columns={"total": "year1_total"})
        b = year_tot(2000).rename(columns={"total": "year2_total"})
        m = a.merge(b, on=cust_col)
        m = m[m.year2_total > m.year1_total]
        m = m.merge(cud, left_on=cust_col, right_on="c_customer_sk")
        out = m[["c_customer_id", "year1_total", "year2_total"]] \
            .sort_values("c_customer_id")[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q04(paths, tables, partitions: int = 2):
    return _yoy_growth(paths, tables, partitions, "catalog_sales",
                       "cs_bill_customer_sk", "cs_sold_date_sk",
                       "cs_sales_price")


def q11(paths, tables, partitions: int = 2):
    return _yoy_growth(paths, tables, partitions, "web_sales",
                       "ws_bill_customer_sk", "ws_sold_date_sk",
                       "ws_ext_sales_price")


def q31(paths, tables, partitions: int = 2):
    """County quarter-over-quarter growth: ss by (county, quarter) self-
    joined across q1->q2, compared against the same web growth."""
    ss, ws = tables["store_sales"], tables["web_sales"]
    ca, dd, cu = (tables["customer_address"], tables["date_dim"],
                  tables["customer"])

    def county_q(fact, cust_col, date_col, price_col, qoy, name):
        f = join("broadcast_join", scan(paths, tables, fact),
                 filter_(scan(paths, tables, "date_dim"),
                         binop("==", c("d_year"), lit(2000, "int32")),
                         binop("==", c("d_qoy"), lit(qoy, "int32"))),
                 [c(date_col)], [c("d_date_sk")])
        j_cu = join("hash_join", exchange(f, [c(cust_col)], partitions),
                    exchange(scan(paths, tables, "customer"),
                             [c("c_customer_sk")], partitions),
                    [c(cust_col)], [c("c_customer_sk")])
        j_ca = join("broadcast_join", j_cu,
                    scan(paths, tables, "customer_address"),
                    [c("c_current_addr_sk")], [c("ca_address_sk")])
        return _partial_final(j_ca, [(c("ca_county"), "county")],
                              [("sum", name, [c(price_col)])],
                              partitions)

    ss1 = county_q("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                   "ss_ext_sales_price", 1, "ss1")
    ss2 = county_q("store_sales", "ss_customer_sk", "ss_sold_date_sk",
                   "ss_ext_sales_price", 2, "ss2")
    ws1 = county_q("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                   "ws_ext_sales_price", 1, "ws1")
    ws2 = county_q("web_sales", "ws_bill_customer_sk", "ws_sold_date_sk",
                   "ws_ext_sales_price", 2, "ws2")
    j = join("sort_merge_join", exchange(ss1, [ci(0)], partitions),
             exchange(ss2, [ci(0)], partitions), [ci(0)], [ci(0)])
    j = join("sort_merge_join", j,
             exchange(ws1, [ci(0)], partitions), [ci(0)], [ci(0)])
    j = join("sort_merge_join", j,
             exchange(ws2, [ci(0)], partitions), [ci(0)], [ci(0)])
    # web growth > store growth  <=>  ws2/ws1 > ss2/ss1, cross-
    # multiplied (all sums positive): ws2*ss1 > ss2*ws1
    grown = filter_(j, binop(">", binop("*", ci(7), ci(1)),
                             binop("*", ci(3), ci(5))))
    picked = project(grown, [ci(0), ci(1), ci(3), ci(5), ci(7)],
                     ["county", "ss1", "ss2", "ws1", "ws2"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        ssd, wsd = ss.to_pandas(), ws.to_pandas()
        cad, ddd, cud = (ca.to_pandas(), dd.to_pandas(),
                         cu.to_pandas())

        def cq(fd, cust_col, date_col, price_col, qoy):
            m = fd.merge(ddd[(ddd.d_year == 2000) & (ddd.d_qoy == qoy)],
                         left_on=date_col, right_on="d_date_sk")
            m = m.merge(cud, left_on=cust_col, right_on="c_customer_sk")
            m = m.merge(cad, left_on="c_current_addr_sk",
                        right_on="ca_address_sk")
            return (m.groupby("ca_county", as_index=False)
                    .agg(v=(price_col, "sum"))
                    .rename(columns={"ca_county": "county"}))

        s1 = cq(ssd, "ss_customer_sk", "ss_sold_date_sk",
                "ss_ext_sales_price", 1).rename(columns={"v": "ss1"})
        s2 = cq(ssd, "ss_customer_sk", "ss_sold_date_sk",
                "ss_ext_sales_price", 2).rename(columns={"v": "ss2"})
        w1 = cq(wsd, "ws_bill_customer_sk", "ws_sold_date_sk",
                "ws_ext_sales_price", 1).rename(columns={"v": "ws1"})
        w2 = cq(wsd, "ws_bill_customer_sk", "ws_sold_date_sk",
                "ws_ext_sales_price", 2).rename(columns={"v": "ws2"})
        m = s1.merge(s2, on="county").merge(w1, on="county") \
            .merge(w2, on="county")
        m = m[m.ws2 * m.ss1 > m.ss2 * m.ws1]
        out = m.sort_values("county")[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q59(paths, tables, partitions: int = 2):
    """Weekly store revenue: this-year vs next-year same-week self join
    (the q59 d_week_seq shape)."""
    ss, dd, st = (tables["store_sales"], tables["date_dim"],
                  tables["store"])

    def weekly(year):
        f = join("broadcast_join", scan(paths, tables, "store_sales"),
                 filter_(scan(paths, tables, "date_dim"),
                         binop("==", c("d_year"), lit(year, "int32"))),
                 [c("ss_sold_date_sk")], [c("d_date_sk")])
        j_st = join("broadcast_join", f, scan(paths, tables, "store"),
                    [c("ss_store_sk")], [c("s_store_sk")])
        # week-of-year aligns weeks ACROSS years (d_week_seq is global)
        wk = binop("%", c("d_week_seq"), lit(53))
        p = project(j_st, [c("s_store_name"), wk,
                           c("ss_ext_sales_price")],
                    ["store_name", "wk", "price"])
        return _partial_final(
            p, [(ci(0), "store_name"), (ci(1), "wk")],
            [("sum", "sales", [ci(2)])], partitions)

    a = weekly(1999)
    b = weekly(2000)
    j = join("sort_merge_join",
             exchange(a, [ci(0), ci(1)], partitions),
             exchange(b, [ci(0), ci(1)], partitions),
             [ci(0), ci(1)], [ci(0), ci(1)])
    picked = project(j, [ci(0), ci(1), ci(2), ci(5)],
                     ["store_name", "wk", "sales_y1", "sales_y2"])
    single = exchange(picked, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ssd, ddd, std = ss.to_pandas(), dd.to_pandas(), st.to_pandas()

        def wkly(year):
            m = ssd.merge(ddd[ddd.d_year == year],
                          left_on="ss_sold_date_sk",
                          right_on="d_date_sk")
            m = m.merge(std, left_on="ss_store_sk",
                        right_on="s_store_sk")
            m["wk"] = m.d_week_seq % 53
            return (m.groupby(["s_store_name", "wk"], as_index=False)
                    .agg(sales=("ss_ext_sales_price", "sum"))
                    .rename(columns={"s_store_name": "store_name"}))

        m = wkly(1999).merge(wkly(2000), on=["store_name", "wk"],
                             suffixes=("_y1", "_y2"))
        out = m.rename(columns={"sales_y1": "sales_y1",
                                "sales_y2": "sales_y2"})
        out = out.sort_values(["store_name", "wk"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q62(paths, tables, partitions: int = 2):
    """Web ship-latency buckets by site (q62 shape; q99's web twin over
    ws_ship_date - ws_sold_date grouped by web site)."""
    ws = tables["web_sales"]
    diff = binop("-", c("ws_ship_date_sk"), c("ws_sold_date_sk"))
    bucket = lambda lo, hi: _case(
        [(binop("and", binop(">", diff, lit(lo)),
                binop("<=", diff, lit(hi))), lit(1))], lit(0))
    proj = project(
        scan(paths, tables, "web_sales"),
        [c("ws_web_site_sk"),
         _case([(binop("<=", diff, lit(30)), lit(1))], lit(0)),
         bucket(30, 60), bucket(60, 90), bucket(90, 120),
         _case([(binop(">", diff, lit(120)), lit(1))], lit(0))],
        ["web_site_sk", "d30", "d60", "d90", "d120", "dmore"])
    out_agg = _partial_final(
        proj, [(ci(0), "web_site_sk")],
        [("sum", n, [ci(i + 1)]) for i, n in
         enumerate(["d30", "d60", "d90", "d120", "dmore"])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = ws.to_pandas()
        d = m.ws_ship_date_sk - m.ws_sold_date_sk
        m = m.assign(
            d30=(d <= 30).astype(int),
            d60=((d > 30) & (d <= 60)).astype(int),
            d90=((d > 60) & (d <= 90)).astype(int),
            d120=((d > 90) & (d <= 120)).astype(int),
            dmore=(d > 120).astype(int))
        out = m.groupby("ws_web_site_sk", as_index=False)[
            ["d30", "d60", "d90", "d120", "dmore"]].sum() \
            .rename(columns={"ws_web_site_sk": "web_site_sk"})
        return out.sort_values("web_site_sk")[:100] \
            .reset_index(drop=True)

    return plan, oracle


def q66(paths, tables, partitions: int = 2):
    """Warehouse monthly sales pivot (q66 shape: 12 case-when month sums
    by warehouse over web sales)."""
    ws, wh, dd = (tables["web_sales"], tables["warehouse"],
                  tables["date_dim"])
    j_dd = join("broadcast_join", scan(paths, tables, "web_sales"),
                filter_(scan(paths, tables, "date_dim"),
                        binop("==", c("d_year"), lit(1999, "int32"))),
                [c("ws_sold_date_sk")], [c("d_date_sk")])
    j_wh = join("broadcast_join", j_dd, scan(paths, tables, "warehouse"),
                [c("ws_warehouse_sk")], [c("w_warehouse_sk")])
    month_exprs = [
        _case([(binop("==", c("d_moy"), lit(m, "int32")),
                c("ws_ext_sales_price"))], lit(0.0, "float64"))
        for m in range(1, 13)]
    names = [f"m{m:02d}_sales" for m in range(1, 13)]
    proj = project(j_wh, [c("w_warehouse_name")] + month_exprs,
                   ["w_warehouse_name"] + names)
    out_agg = _partial_final(
        proj, [(ci(0), "w_warehouse_name")],
        [("sum", n, [ci(i + 1)]) for i, n in enumerate(names)],
        partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = ws.to_pandas().merge(
            dd.to_pandas().query("d_year == 1999"),
            left_on="ws_sold_date_sk", right_on="d_date_sk")
        m = m.merge(wh.to_pandas(), left_on="ws_warehouse_sk",
                    right_on="w_warehouse_sk")
        for mo in range(1, 13):
            m[f"m{mo:02d}_sales"] = m.ws_ext_sales_price.where(
                m.d_moy == mo, 0.0)
        out = m.groupby("w_warehouse_name", as_index=False)[
            [f"m{mo:02d}_sales" for mo in range(1, 13)]].sum()
        return out.sort_values("w_warehouse_name")[:100] \
            .reset_index(drop=True)

    return plan, oracle


def q70(paths, tables, partitions: int = 2):
    """State/county profit rollup + rank() within state (q70 shape)."""
    ss, st, dd = (tables["store_sales"], tables["store"],
                  tables["date_dim"])
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                filter_(scan(paths, tables, "date_dim"),
                        binop("==", c("d_year"), lit(2000, "int32"))),
                [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_st = join("broadcast_join", j_dd, scan(paths, tables, "store"),
                [c("ss_store_sk")], [c("s_store_sk")])
    nul = {"kind": "literal", "value": None, "type": {"id": "utf8"}}
    projections = []
    for kept, gid in ((2, 0), (1, 1), (0, 3)):
        projections.append(
            [c("s_state") if kept >= 1 else nul,
             c("s_store_name") if kept >= 2 else nul,
             lit(gid), c("ss_net_profit")])
    expanded = {"kind": "expand", "input": j_st,
                "projections": projections,
                "names": ["s_state", "s_store_name", "g_id",
                          "ss_net_profit"]}
    rolled = _partial_final(
        expanded,
        [(ci(0), "s_state"), (ci(1), "s_store_name"), (ci(2), "g_id")],
        [("sum", "total_profit", [ci(3)])], partitions)
    ex = exchange(rolled, [ci(0)], 1)
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
    flt = filter_(win, binop("<=", ci(4), lit(5)))
    plan = sort_limit(flt, [(ci(0), False), (ci(4), False)], 100)

    def oracle():
        m = ss.to_pandas().merge(
            dd.to_pandas().query("d_year == 2000"),
            left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(st.to_pandas(), left_on="ss_store_sk",
                    right_on="s_store_sk")
        frames = []
        for kept, gid in ((2, 0), (1, 1), (0, 3)):
            keys = ["s_state", "s_store_name"][:kept] if kept else []
            if keys:
                g = m.groupby(keys, as_index=False, dropna=False).agg(
                    total_profit=("ss_net_profit", "sum"))
            else:
                g = pd.DataFrame(
                    {"total_profit": [m.ss_net_profit.sum()]})
            for cn in ["s_state", "s_store_name"][kept:]:
                g[cn] = None
            g["g_id"] = gid
            frames.append(g[["s_state", "s_store_name", "g_id",
                             "total_profit"]])
        allf = pd.concat(frames, ignore_index=True)
        allf["rk"] = (allf.sort_values("total_profit", ascending=False)
                      .groupby("s_state", dropna=False)
                      .total_profit.rank(method="min", ascending=False))
        allf = allf[allf.rk <= 5]
        out = allf.sort_values(["s_state", "rk"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q89(paths, tables, partitions: int = 2):
    """Monthly class revenue vs the class's yearly average: window AVG
    partition + deviation filter (q89 shape)."""
    ss, it, dd = (tables["store_sales"], tables["item"],
                  tables["date_dim"])
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                filter_(scan(paths, tables, "date_dim"),
                        binop("==", c("d_year"), lit(1999, "int32"))),
                [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    rev = _partial_final(
        j_it,
        [(c("i_category"), "i_category"), (c("i_class"), "i_class"),
         (c("d_moy"), "d_moy")],
        [("sum", "sum_sales", [c("ss_sales_price")])], partitions)
    ex = exchange(rev, [ci(0)], 1)
    srt = {"kind": "sort", "input": ex,
           "specs": [{"expr": ci(0), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(1), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(2), "descending": False,
                      "nulls_first": True}]}
    win = {"kind": "window", "input": srt,
           "functions": [{"kind": "agg", "fn": "avg",
                          "name": "avg_monthly", "running": False,
                          "args": [ci(3)]}],
           "partition_by": [ci(0), ci(1)], "order_by": []}
    flt = filter_(win, binop(">", ci(3),
                             binop("*", ci(4), lit(1.1, "float64"))))
    plan = sort_limit(flt, [(ci(0), False), (ci(1), False),
                            (ci(2), False)], 100)

    def oracle():
        m = ss.to_pandas().merge(
            dd.to_pandas().query("d_year == 1999"),
            left_on="ss_sold_date_sk", right_on="d_date_sk")
        m = m.merge(it.to_pandas(), left_on="ss_item_sk",
                    right_on="i_item_sk")
        g = (m.groupby(["i_category", "i_class", "d_moy"],
                       as_index=False)
             .agg(sum_sales=("ss_sales_price", "sum")))
        g["avg_monthly"] = g.groupby(["i_category", "i_class"]) \
            .sum_sales.transform("mean")
        g = g[g.sum_sales > 1.1 * g.avg_monthly]
        out = g.sort_values(["i_category", "i_class", "d_moy"])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q92(paths, tables, partitions: int = 2):
    """Web sales above 1.3x the item's average discount: per-item avg
    subquery joined back (q92/q65-family threshold shape)."""
    ws = tables["web_sales"]
    per_item = _partial_final(
        scan(paths, tables, "web_sales"),
        [(c("ws_item_sk"), "item_sk")],
        [("avg", "avg_price", [c("ws_ext_sales_price")])], partitions)
    j = join("hash_join",
             exchange(scan(paths, tables, "web_sales"),
                      [c("ws_item_sk")], partitions),
             exchange(per_item, [ci(0)], partitions),
             [c("ws_item_sk")], [ci(0)])
    flt = filter_(j, binop(">", c("ws_ext_sales_price"),
                           binop("*", c("avg_price"),
                                 lit(1.3, "float64"))))
    total = project(flt, [c("ws_ext_sales_price")], ["p"])
    plan = _global_agg(total, [("sum", "total_excess", [ci(0)]),
                               ("count", "n_rows", [ci(0)])])

    def oracle():
        m = ws.to_pandas()
        avg = m.groupby("ws_item_sk").ws_ext_sales_price \
            .transform("mean")
        f = m[m.ws_ext_sales_price > 1.3 * avg]
        return pd.DataFrame({
            "total_excess": [f.ws_ext_sales_price.sum() if len(f)
                             else None],
            "n_rows": [len(f)]})

    return plan, oracle


QUERIES.update({
    "q04": (q04, ["catalog_sales", "date_dim", "customer"]),
    "q11": (q11, ["web_sales", "date_dim", "customer"]),
    "q31": (q31, ["store_sales", "web_sales", "customer_address",
                  "date_dim", "customer"]),
    "q59": (q59, ["store_sales", "date_dim", "store"]),
    "q62": (q62, ["web_sales"]),
    "q66": (q66, ["web_sales", "warehouse", "date_dim"]),
    "q70": (q70, ["store_sales", "store", "date_dim"]),
    "q89": (q89, ["store_sales", "item", "date_dim"]),
    "q92": (q92, ["web_sales"]),
})


# ---------------------------------------------------------------------------
# fifth batch: 3-channel manufacturer union (q33/q56/q60), zip in-list
# (q45), am/pm scalar ratio over BNLJ (q90)
# ---------------------------------------------------------------------------

def _three_channel_by_item_attr(paths, tables, partitions, attr,
                                attr_filter_vals):
    """q33/q56/q60 shape: per-channel revenue for items in a category
    selection, all three channels unioned, re-aggregated by item attr."""
    ss, cs, ws, it, dd = (tables["store_sales"], tables["catalog_sales"],
                          tables["web_sales"], tables["item"],
                          tables["date_dim"])
    it_f = filter_(scan(paths, tables, "item"),
                   {"kind": "in_list", "child": c("i_category"),
                    "values": list(attr_filter_vals),
                    "type": {"id": "utf8"}})
    legs = []
    for fact, date_col, item_col, price_col in (
            ("store_sales", "ss_sold_date_sk", "ss_item_sk",
             "ss_ext_sales_price"),
            ("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
             "cs_ext_sales_price"),
            ("web_sales", "ws_sold_date_sk", "ws_item_sk",
             "ws_ext_sales_price")):
        j_dd = join("broadcast_join", scan(paths, tables, fact),
                    filter_(scan(paths, tables, "date_dim"),
                            binop("==", c("d_year"), lit(1999, "int32")),
                            binop("==", c("d_moy"), lit(5, "int32"))),
                    [c(date_col)], [c("d_date_sk")])
        j_it = join("broadcast_join", j_dd, it_f,
                    [c(item_col)], [c("i_item_sk")])
        leg = _partial_final(j_it, [(c(attr), "attr")],
                             [("sum", "total_sales", [c(price_col)])],
                             partitions)
        legs.append(leg)
    u = {"kind": "union", "inputs": legs}
    merged = _partial_final(u, [(ci(0), "attr")],
                            [("sum", "total_sales", [ci(1)])], partitions)
    single = exchange(merged, [ci(0)], 1)
    plan = sort_limit(single, [(ci(1), True), (ci(0), False)], 100)

    def oracle():
        itd = it.to_pandas()
        isel = itd[itd.i_category.isin(attr_filter_vals)]
        ddd = dd.to_pandas()
        dsel = ddd[(ddd.d_year == 1999) & (ddd.d_moy == 5)]
        frames = []
        for tbl, date_col, item_col, price_col in (
                (ss, "ss_sold_date_sk", "ss_item_sk",
                 "ss_ext_sales_price"),
                (cs, "cs_sold_date_sk", "cs_item_sk",
                 "cs_ext_sales_price"),
                (ws, "ws_sold_date_sk", "ws_item_sk",
                 "ws_ext_sales_price")):
            m = tbl.to_pandas().merge(dsel, left_on=date_col,
                                      right_on="d_date_sk")
            m = m.merge(isel, left_on=item_col, right_on="i_item_sk")
            frames.append(m.groupby(attr, as_index=False)
                          .agg(total_sales=(price_col, "sum")))
        allf = pd.concat(frames, ignore_index=True)
        out = (allf.groupby(attr, as_index=False).total_sales.sum()
               .rename(columns={attr: "attr"}))
        out = out.sort_values(["total_sales", "attr"],
                              ascending=[False, True])[:100]
        return out.reset_index(drop=True)

    return plan, oracle


def q33(paths, tables, partitions: int = 2):
    return _three_channel_by_item_attr(paths, tables, partitions,
                                       "i_manufact_id", ["Books"])


def q56(paths, tables, partitions: int = 2):
    return _three_channel_by_item_attr(paths, tables, partitions,
                                       "i_item_id", ["Home", "Music"])


def q60(paths, tables, partitions: int = 2):
    return _three_channel_by_item_attr(paths, tables, partitions,
                                       "i_item_id", ["Sports"])


def q45(paths, tables, partitions: int = 2):
    """Web sales by customer zip, kept when the zip prefix is in a list
    OR the item is in a chosen set (the q45 disjunction)."""
    ws, cu, ca, it = (tables["web_sales"], tables["customer"],
                      tables["customer_address"], tables["item"])
    j_cu = join("hash_join",
                exchange(scan(paths, tables, "web_sales"),
                         [c("ws_bill_customer_sk")], partitions),
                exchange(scan(paths, tables, "customer"),
                         [c("c_customer_sk")], partitions),
                [c("ws_bill_customer_sk")], [c("c_customer_sk")])
    j_ca = join("broadcast_join", j_cu,
                scan(paths, tables, "customer_address"),
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    j_it = join("broadcast_join", j_ca, scan(paths, tables, "item"),
                [c("ws_item_sk")], [c("i_item_sk")])
    zip2 = {"kind": "scalar_function", "name": "substring",
            "args": [c("ca_zip"), lit(1, "int32"), lit(2, "int32")],
            "return_type": {"id": "utf8"}}
    flt = filter_(j_it, binop(
        "or",
        {"kind": "in_list", "child": zip2,
         "values": ["85", "86", "88"], "type": {"id": "utf8"}},
        {"kind": "in_list", "child": c("i_item_sk"),
         "values": [2, 3, 5, 7, 11, 13, 17, 19],
         "type": {"id": "int64"}}))
    out_agg = _partial_final(
        flt, [(c("ca_zip"), "ca_zip")],
        [("sum", "total", [c("ws_ext_sales_price")])], partitions)
    single = exchange(out_agg, [ci(0)], 1)
    plan = sort_limit(single, [(ci(0), False)], 100)

    def oracle():
        m = ws.to_pandas().merge(cu.to_pandas(),
                                 left_on="ws_bill_customer_sk",
                                 right_on="c_customer_sk")
        m = m.merge(ca.to_pandas(), left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        m = m.merge(it.to_pandas(), left_on="ws_item_sk",
                    right_on="i_item_sk")
        keep = (m.ca_zip.str[:2].isin(["85", "86", "88"]) |
                m.ws_item_sk.isin([2, 3, 5, 7, 11, 13, 17, 19]))
        f = m[keep]
        out = f.groupby("ca_zip", as_index=False).agg(
            total=("ws_ext_sales_price", "sum"))
        return out.sort_values("ca_zip")[:100].reset_index(drop=True)

    return plan, oracle


def q90(paths, tables, partitions: int = 2):
    """AM/PM sales-count ratio: two global counts combined through a
    broadcast nested-loop join (the q90 scalar-ratio shape)."""
    ss, td = tables["store_sales"], tables["time_dim"]

    def bucket_count(h_lo, h_hi, name):
        td_f = filter_(scan(paths, tables, "time_dim"),
                       binop(">=", c("t_hour"), lit(h_lo, "int32")),
                       binop("<", c("t_hour"), lit(h_hi, "int32")))
        j = join("broadcast_join", scan(paths, tables, "store_sales"),
                 td_f, [c("ss_sold_time_sk")], [c("t_time_sk")])
        return _global_agg(j, [("count", name,
                                [c("ss_ticket_number")])])

    am = bucket_count(8, 12, "amc")
    pm = bucket_count(14, 18, "pmc")
    crossed = {"kind": "broadcast_nested_loop_join",
               "left": am, "right": pm, "join_type": "inner",
               "build_side": "right"}
    ratio = project(
        crossed,
        [ci(0), ci(1),
         binop("/", {"kind": "cast", "child": ci(0),
                     "type": {"id": "float64"}},
               {"kind": "cast", "child": ci(1),
                "type": {"id": "float64"}})],
        ["am_count", "pm_count", "am_pm_ratio"])
    plan = ratio

    def oracle():
        ssd, tdd = ss.to_pandas(), td.to_pandas()
        am_n = len(ssd.merge(
            tdd[(tdd.t_hour >= 8) & (tdd.t_hour < 12)],
            left_on="ss_sold_time_sk", right_on="t_time_sk"))
        pm_n = len(ssd.merge(
            tdd[(tdd.t_hour >= 14) & (tdd.t_hour < 18)],
            left_on="ss_sold_time_sk", right_on="t_time_sk"))
        return pd.DataFrame({"am_count": [am_n], "pm_count": [pm_n],
                             "am_pm_ratio": [am_n / pm_n]})

    return plan, oracle


QUERIES.update({
    "q33": (q33, ["store_sales", "catalog_sales", "web_sales", "item",
                  "date_dim"]),
    "q45": (q45, ["web_sales", "customer", "customer_address", "item"]),
    "q56": (q56, ["store_sales", "catalog_sales", "web_sales", "item",
                  "date_dim"]),
    "q60": (q60, ["store_sales", "catalog_sales", "web_sales", "item",
                  "date_dim"]),
    "q90": (q90, ["store_sales", "time_dim"]),
})
