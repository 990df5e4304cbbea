"""TPC-DS breadth, second batch: the 35 query functions that complete all
99, with their pandas oracles (a copy of blaze_tpu/itest/queries_ext2.py,
over the helpers of itest/queries.py and queries_ext.py; each
returns the reference's plan dict).

Same contract as queries.py and queries_ext.py: each returns
(plan_dict, oracle).  Shapes follow the TPC-DS originals over the
synthetic schema subset (inventory snapshots, extended return tables);
monetary and statistical functions simplify as the earlier batches do
(stddev -> count/avg pairs).  Importing the module registers them in
`queries.QUERIES`.

Date arithmetic mirrors tpcds_data.gen_date_dim: sk = 2450815 + day,
d_year = 1998 + day//365.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from blaze_tpu_torch.itest.queries import (D0, QUERIES, _day_range,
                                     _partial_final, agg, binop, c, ci,
                                     exchange, filter_, join, lit, project,
                                     scan, sort_limit)
from blaze_tpu_torch.itest.queries_ext import _case, _global_agg


def _year(frame, col):
    return 1998 + (frame[col] - D0) // 365


def _top(inp: dict, specs, limit: int) -> dict:
    """Global ORDER BY + LIMIT: coalesce to ONE partition first (a
    per-partition limit would return partitions x limit rows)."""
    return sort_limit(exchange(inp, [], 1), specs, limit)


# ---------------------------------------------------------------------------
# inventory family: q21 q22 q37 q39 q72 q82
# ---------------------------------------------------------------------------

def q21(paths, tables, partitions: int = 2):
    """Inventory before/after a pivot date by warehouse+item, keeping
    items whose after/before ratio stays within [2/3, 3/2]."""
    inv, wh, it = (tables["inventory"], tables["warehouse"],
                   tables["item"])
    pivot = D0 + 400
    lo, hi = pivot - 30, pivot + 30
    base = filter_(scan(paths, tables, "inventory"),
                   binop(">=", c("inv_date_sk"), lit(lo)),
                   binop("<=", c("inv_date_sk"), lit(hi)))
    j_wh = join("broadcast_join", base, scan(paths, tables, "warehouse"),
                [c("inv_warehouse_sk")], [c("w_warehouse_sk")])
    j_it = join("broadcast_join", j_wh, scan(paths, tables, "item"),
                [c("inv_item_sk")], [c("i_item_sk")])
    before = _case([(binop("<", c("inv_date_sk"), lit(pivot)),
                     c("inv_quantity_on_hand"))], lit(0))
    after = _case([(binop(">=", c("inv_date_sk"), lit(pivot)),
                    c("inv_quantity_on_hand"))], lit(0))
    proj = project(j_it, [c("w_warehouse_name"), c("i_item_id"),
                          before, after],
                   ["w_warehouse_name", "i_item_id", "before_q",
                    "after_q"])
    sums = _partial_final(
        proj, [(ci(0), "w_warehouse_name"), (ci(1), "i_item_id")],
        [("sum", "inv_before", [ci(2)]), ("sum", "inv_after", [ci(3)])],
        partitions)
    flt = filter_(
        sums,
        binop(">", c("inv_before"), lit(0)),
        binop(">=", binop("*", c("inv_after"), lit(3)),
              binop("*", c("inv_before"), lit(2))),
        binop("<=", binop("*", c("inv_after"), lit(2)),
              binop("*", c("inv_before"), lit(3))))
    plan = _top(flt, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        d = inv.to_pandas().merge(
            wh.to_pandas(), left_on="inv_warehouse_sk",
            right_on="w_warehouse_sk").merge(
            it.to_pandas(), left_on="inv_item_sk", right_on="i_item_sk")
        d = d[(d.inv_date_sk >= lo) & (d.inv_date_sk <= hi)]
        d["before_q"] = np.where(d.inv_date_sk < pivot,
                                 d.inv_quantity_on_hand, 0)
        d["after_q"] = np.where(d.inv_date_sk >= pivot,
                                d.inv_quantity_on_hand, 0)
        g = d.groupby(["w_warehouse_name", "i_item_id"],
                      as_index=False)[["before_q", "after_q"]].sum()
        g = g[(g.before_q > 0) & (g.after_q * 3 >= g.before_q * 2)
              & (g.after_q * 2 <= g.before_q * 3)]
        g = g.sort_values(["w_warehouse_name", "i_item_id"]).head(100)
        return g.rename(columns={"before_q": "inv_before",
                                 "after_q": "inv_after"}) \
            .reset_index(drop=True)

    return plan, oracle


def q22(paths, tables, partitions: int = 2):
    """Average quantity-on-hand ROLLUP(category, brand) via Expand."""
    inv, it = tables["inventory"], tables["item"]
    lo, hi = D0 + 300, D0 + 600
    base = filter_(scan(paths, tables, "inventory"),
                   binop(">=", c("inv_date_sk"), lit(lo)),
                   binop("<=", c("inv_date_sk"), lit(hi)))
    j_it = join("broadcast_join", base, scan(paths, tables, "item"),
                [c("inv_item_sk")], [c("i_item_sk")])
    projections = []
    for gid, keep in enumerate([(True, True), (True, False),
                                (False, False)]):
        projections.append([
            c("i_category") if keep[0] else lit(None, "utf8"),
            c("i_brand") if keep[1] else lit(None, "utf8"),
            lit(gid), c("inv_quantity_on_hand")])
    expanded = {"kind": "expand", "input": j_it,
                "projections": projections,
                "names": ["i_category", "i_brand", "g_id", "qoh"]}
    stats = _partial_final(
        expanded,
        [(ci(0), "i_category"), (ci(1), "i_brand"), (ci(2), "g_id")],
        [("avg", "qoh", [ci(3)])], partitions)
    plan = _top(project(stats, [ci(0), ci(1), ci(3)],
                        ["i_category", "i_brand", "qoh"]),
                [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        d = inv.to_pandas().merge(
            it.to_pandas(), left_on="inv_item_sk", right_on="i_item_sk")
        d = d[(d.inv_date_sk >= lo) & (d.inv_date_sk <= hi)]
        outs = []
        full = d.groupby(["i_category", "i_brand"], as_index=False) \
            .inv_quantity_on_hand.mean()
        outs.append(full.rename(
            columns={"inv_quantity_on_hand": "qoh"}))
        cat = d.groupby(["i_category"], as_index=False) \
            .inv_quantity_on_hand.mean()
        cat["i_brand"] = None
        outs.append(cat.rename(columns={"inv_quantity_on_hand": "qoh"}))
        tot = pd.DataFrame({"i_category": [None], "i_brand": [None],
                            "qoh": [d.inv_quantity_on_hand.mean()]})
        outs.append(tot)
        allr = pd.concat(outs, ignore_index=True)[
            ["i_category", "i_brand", "qoh"]]
        return allr.sort_values(
            ["i_category", "i_brand"], na_position="first") \
            .head(100).reset_index(drop=True)

    return plan, oracle


def q37(paths, tables, partitions: int = 2):
    """Items in a price band with healthy on-hand inventory that also
    sold through catalog."""
    inv, it, cs = (tables["inventory"], tables["item"],
                   tables["catalog_sales"])
    it_f = filter_(scan(paths, tables, "item"),
                   binop(">=", c("i_current_price"), lit(20)),
                   binop("<=", c("i_current_price"), lit(50)))
    j_inv = join("broadcast_join", scan(paths, tables, "inventory"),
                 it_f, [c("inv_item_sk")], [c("i_item_sk")])
    inv_ok = filter_(j_inv,
                     binop(">=", c("inv_quantity_on_hand"), lit(100)),
                     binop("<=", c("inv_quantity_on_hand"), lit(500)))
    cs_ex = exchange(project(scan(paths, tables, "catalog_sales"),
                             [c("cs_item_sk")], ["cs_item_sk"]),
                     [ci(0)], partitions)
    inv_ex = exchange(project(inv_ok, [c("i_item_id"),
                                       c("i_current_price"),
                                       c("i_item_sk")],
                              ["i_item_id", "i_current_price",
                               "i_item_sk"]),
                      [ci(2)], partitions)
    semi = join("hash_join", inv_ex, cs_ex, [ci(2)], [ci(0)],
                jt="left_semi")
    dedup = _partial_final(
        semi, [(ci(0), "i_item_id"), (ci(1), "i_current_price")],
        [("count", "cnt", [ci(2)])], partitions)
    plan = _top(project(dedup, [ci(0), ci(1)],
                        ["i_item_id", "i_current_price"]),
                [(ci(0), False)], 100)

    def oracle():
        itd = it.to_pandas()
        itd = itd[(itd.i_current_price >= 20) & (itd.i_current_price <= 50)]
        d = inv.to_pandas().merge(itd, left_on="inv_item_sk",
                                  right_on="i_item_sk")
        d = d[(d.inv_quantity_on_hand >= 100)
              & (d.inv_quantity_on_hand <= 500)]
        d = d[d.i_item_sk.isin(set(cs.to_pandas().cs_item_sk))]
        g = d[["i_item_id", "i_current_price"]].drop_duplicates()
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)

    return plan, oracle


def q39(paths, tables, partitions: int = 2):
    """Inventory spread by item/warehouse/month: count+avg stats for two
    consecutive months joined on (item, warehouse) — the q39 two-month
    variance pairing with stdev simplified to count/avg (as q17 does)."""
    inv = tables["inventory"]
    m1_lo, m1_hi = D0 + 365, D0 + 395
    m2_lo, m2_hi = D0 + 396, D0 + 426

    def month_stats(lo, hi):
        base = filter_(scan(paths, tables, "inventory"),
                       binop(">=", c("inv_date_sk"), lit(lo)),
                       binop("<=", c("inv_date_sk"), lit(hi)))
        return _partial_final(
            base,
            [(c("inv_item_sk"), "item_sk"),
             (c("inv_warehouse_sk"), "warehouse_sk")],
            [("count", "cnt", [c("inv_quantity_on_hand")]),
             ("avg", "mean_qoh", [c("inv_quantity_on_hand")])],
            partitions)

    m1 = exchange(month_stats(m1_lo, m1_hi), [ci(0), ci(1)], partitions)
    m2 = exchange(month_stats(m2_lo, m2_hi), [ci(0), ci(1)], partitions)
    j = join("sort_merge_join", m1, m2, [ci(0), ci(1)], [ci(0), ci(1)])
    flt = filter_(j, binop(">", ci(2), lit(1)), binop(">", ci(6), lit(1)))
    proj = project(flt, [ci(0), ci(1), ci(3), ci(7)],
                   ["item_sk", "warehouse_sk", "mean1", "mean2"])
    plan = _top(proj, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        d = inv.to_pandas()

        def stats(lo, hi):
            m = d[(d.inv_date_sk >= lo) & (d.inv_date_sk <= hi)]
            return m.groupby(["inv_item_sk", "inv_warehouse_sk"]) \
                .inv_quantity_on_hand.agg(["count", "mean"]).reset_index()

        a = stats(m1_lo, m1_hi)
        b = stats(m2_lo, m2_hi)
        m = a.merge(b, on=["inv_item_sk", "inv_warehouse_sk"])
        m = m[(m.count_x > 1) & (m.count_y > 1)]
        out = m.rename(columns={
            "inv_item_sk": "item_sk", "inv_warehouse_sk": "warehouse_sk",
            "mean_x": "mean1", "mean_y": "mean2"})[
            ["item_sk", "warehouse_sk", "mean1", "mean2"]]
        return out.sort_values(["item_sk", "warehouse_sk"]) \
            .head(100).reset_index(drop=True)

    return plan, oracle


def q72(paths, tables, partitions: int = 2):
    """Catalog demand vs inventory: orders where on-hand quantity at the
    nearest weekly snapshot falls below the ordered quantity, counted by
    item."""
    cs, inv, it = (tables["catalog_sales"], tables["inventory"],
                   tables["item"])
    lo, hi = _day_range(365, 500)
    cs_f = project(
        filter_(scan(paths, tables, "catalog_sales"),
                binop(">=", c("cs_sold_date_sk"), lit(lo)),
                binop("<=", c("cs_sold_date_sk"), lit(hi))),
        [c("cs_item_sk"), c("cs_quantity")], ["item_sk", "quantity"])
    cs_ex = exchange(cs_f, [ci(0)], partitions)
    inv_f = project(
        filter_(scan(paths, tables, "inventory"),
                binop(">=", c("inv_date_sk"), lit(lo)),
                binop("<=", c("inv_date_sk"), lit(hi))),
        [c("inv_item_sk"), c("inv_quantity_on_hand")],
        ["inv_item_sk", "qoh"])
    inv_ex = exchange(inv_f, [ci(0)], partitions)
    j = join("hash_join", cs_ex, inv_ex, [ci(0)], [ci(0)],
             flt=binop("<", ci(3), ci(1)))
    j_it = join("broadcast_join", j, scan(paths, tables, "item"),
                [ci(0)], [c("i_item_sk")])
    cnt = _partial_final(j_it, [(c("i_item_id"), "i_item_id")],
                         [("count", "low_stock_cnt", [ci(0)])],
                         partitions)
    plan = _top(cnt, [(ci(1), True), (ci(0), False)], 100)

    def oracle():
        csd = cs.to_pandas()
        csd = csd[(csd.cs_sold_date_sk >= lo) & (csd.cs_sold_date_sk <= hi)]
        invd = inv.to_pandas()
        invd = invd[(invd.inv_date_sk >= lo) & (invd.inv_date_sk <= hi)]
        m = csd.merge(invd, left_on="cs_item_sk", right_on="inv_item_sk")
        m = m[m.inv_quantity_on_hand < m.cs_quantity]
        m = m.merge(tables["item"].to_pandas(), left_on="cs_item_sk",
                    right_on="i_item_sk")
        g = m.groupby("i_item_id").size().reset_index(
            name="low_stock_cnt")
        return g.sort_values(["low_stock_cnt", "i_item_id"],
                             ascending=[False, True]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q82(paths, tables, partitions: int = 2):
    """q37's store twin: priced items with mid-range inventory that sold
    in store."""
    inv, it, ss = (tables["inventory"], tables["item"],
                   tables["store_sales"])
    it_f = filter_(scan(paths, tables, "item"),
                   binop(">=", c("i_current_price"), lit(30)),
                   binop("<=", c("i_current_price"), lit(60)))
    j_inv = join("broadcast_join", scan(paths, tables, "inventory"),
                 it_f, [c("inv_item_sk")], [c("i_item_sk")])
    inv_ok = filter_(j_inv,
                     binop(">=", c("inv_quantity_on_hand"), lit(100)),
                     binop("<=", c("inv_quantity_on_hand"), lit(500)))
    ss_ex = exchange(project(scan(paths, tables, "store_sales"),
                             [c("ss_item_sk")], ["ss_item_sk"]),
                     [ci(0)], partitions)
    inv_ex = exchange(project(inv_ok, [c("i_item_id"),
                                       c("i_current_price"),
                                       c("i_item_sk")],
                              ["i_item_id", "i_current_price",
                               "i_item_sk"]),
                      [ci(2)], partitions)
    semi = join("hash_join", inv_ex, ss_ex, [ci(2)], [ci(0)],
                jt="left_semi")
    dedup = _partial_final(
        semi, [(ci(0), "i_item_id"), (ci(1), "i_current_price")],
        [("count", "cnt", [ci(2)])], partitions)
    plan = _top(project(dedup, [ci(0), ci(1)],
                        ["i_item_id", "i_current_price"]),
                [(ci(0), False)], 100)

    def oracle():
        itd = it.to_pandas()
        itd = itd[(itd.i_current_price >= 30) & (itd.i_current_price <= 60)]
        d = inv.to_pandas().merge(itd, left_on="inv_item_sk",
                                  right_on="i_item_sk")
        d = d[(d.inv_quantity_on_hand >= 100)
              & (d.inv_quantity_on_hand <= 500)]
        d = d[d.i_item_sk.isin(set(ss.to_pandas().ss_item_sk))]
        g = d[["i_item_id", "i_current_price"]].drop_duplicates()
        return g.sort_values("i_item_id").head(100).reset_index(drop=True)

    return plan, oracle


# ---------------------------------------------------------------------------
# returns family: q16 q30 q32 q40 q41 q49 q81 q83 q85 q91
# ---------------------------------------------------------------------------

def q16(paths, tables, partitions: int = 2):
    """q94's catalog original: cross-warehouse shipped orders with no
    return — count + totals."""
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    lo, hi = _day_range(60, 120)
    base = project(
        filter_(scan(paths, tables, "catalog_sales"),
                binop(">=", c("cs_ship_date_sk"), lit(lo)),
                binop("<=", c("cs_ship_date_sk"), lit(hi))),
        [c("cs_order_number"), c("cs_warehouse_sk"),
         c("cs_ext_sales_price"), c("cs_net_profit")],
        ["order_number", "warehouse_sk", "price", "profit"])
    base_ex = exchange(base, [ci(0)], partitions)
    all_cs = exchange(project(scan(paths, tables, "catalog_sales"),
                              [c("cs_order_number"),
                               c("cs_warehouse_sk")], ["o2", "w2"]),
                      [ci(0)], partitions)
    semi = join("hash_join", base_ex, all_cs, [ci(0)], [ci(0)],
                jt="left_semi", flt=binop("!=", ci(1), ci(5)))
    cr_ex = exchange(project(scan(paths, tables, "catalog_returns"),
                             [c("cr_order_number")], ["cr_order_number"]),
                     [ci(0)], partitions)
    anti = join("hash_join", semi, cr_ex, [ci(0)], [ci(0)],
                jt="left_anti")
    per_order = _partial_final(
        anti, [(ci(0), "order_number")],
        [("sum", "price", [ci(2)]), ("sum", "profit", [ci(3)])],
        partitions)
    single = exchange(per_order, [ci(0)], 1)
    plan = _global_agg(single,
                       [("count", "order_count", [ci(0)]),
                        ("sum", "total_price", [ci(1)]),
                        ("sum", "total_profit", [ci(2)])])

    def oracle():
        csd, crd = cs.to_pandas(), cr.to_pandas()
        f = csd[(csd.cs_ship_date_sk >= lo) & (csd.cs_ship_date_sk <= hi)]
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


def q30(paths, tables, partitions: int = 2):
    """Web-return customers whose yearly state total exceeds 1.2x the
    state average (q01's web-returns twin over wr + customer/address)."""
    wr, cu, ca = (tables["web_returns"], tables["customer"],
                  tables["customer_address"])
    lo, hi = _day_range(730, 1094)  # year 2000
    base = filter_(scan(paths, tables, "web_returns"),
                   binop(">=", c("wr_returned_date_sk"), lit(lo)),
                   binop("<=", c("wr_returned_date_sk"), lit(hi)))
    j_cu = join("broadcast_join", base, scan(paths, tables, "customer"),
                [c("wr_returning_customer_sk")], [c("c_customer_sk")])
    j_ca = join("broadcast_join", j_cu,
                scan(paths, tables, "customer_address"),
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    ctr = _partial_final(
        j_ca,
        [(c("wr_returning_customer_sk"), "ctr_customer_sk"),
         (c("ca_state"), "ctr_state")],
        [("sum", "ctr_total_return", [c("wr_return_amt")])], partitions)
    avg_in = exchange(ctr, [ci(1)], partitions)
    avg_by_state = agg(
        agg(avg_in, [(ci(1), "avg_state")],
            [("avg", "partial", "avg_return", [ci(2)])]),
        [(ci(0), "avg_state")],
        [("avg", "final", "avg_return", [ci(1), ci(2)])])
    ctr2 = exchange(ctr, [ci(1)], partitions)
    joined = join("sort_merge_join", ctr2, avg_by_state, [ci(1)], [ci(0)])
    flt = filter_(joined, binop(">", c("ctr_total_return"),
                                binop("*", c("avg_return"),
                                      lit(1.2, "float64"))))
    j_id = join("broadcast_join", flt, scan(paths, tables, "customer"),
                [ci(0)], [c("c_customer_sk")])
    proj = project(j_id, [c("c_customer_id"), c("ctr_total_return")],
                   ["c_customer_id", "ctr_total_return"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        d = wr.to_pandas()
        d = d[(d.wr_returned_date_sk >= lo) & (d.wr_returned_date_sk <= hi)]
        d = d.merge(cu.to_pandas(), left_on="wr_returning_customer_sk",
                    right_on="c_customer_sk")
        d = d.merge(ca.to_pandas(), left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        g = d.groupby(["wr_returning_customer_sk", "ca_state"],
                      as_index=False).wr_return_amt.sum()
        avg = g.groupby("ca_state").wr_return_amt.mean().rename("avg")
        m = g.join(avg, on="ca_state")
        m = m[m.wr_return_amt > 1.2 * m.avg]
        m = m.merge(cu.to_pandas(), left_on="wr_returning_customer_sk",
                    right_on="c_customer_sk")
        out = m[["c_customer_id", "wr_return_amt"]].rename(
            columns={"wr_return_amt": "ctr_total_return"})
        return out.sort_values("c_customer_id").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q32(paths, tables, partitions: int = 2):
    """Excess-discount catalog sales: coupon amounts above 1.3x the
    item's average during a window (scalar-average join)."""
    cs = tables["catalog_sales"]
    lo, hi = _day_range(200, 290)
    base = filter_(scan(paths, tables, "catalog_sales"),
                   binop(">=", c("cs_sold_date_sk"), lit(lo)),
                   binop("<=", c("cs_sold_date_sk"), lit(hi)))
    avg_item = _partial_final(
        project(base, [c("cs_item_sk"), c("cs_coupon_amt")],
                ["item_sk", "coupon"]),
        [(ci(0), "item_sk")],
        [("avg", "avg_coupon", [ci(1)])], partitions)
    base2 = exchange(project(base, [c("cs_item_sk"), c("cs_coupon_amt")],
                             ["i2", "c2"]), [ci(0)], partitions)
    j = join("hash_join", base2, exchange(avg_item, [ci(0)], partitions),
             [ci(0)], [ci(0)],
             flt=binop(">", ci(1), binop("*", ci(3), lit(1.3, "float64"))))
    single = exchange(project(j, [ci(1)], ["excess"]), [], 1)
    plan = _global_agg(single, [("sum", "excess_discount", [ci(0)])])

    def oracle():
        d = cs.to_pandas()
        d = d[(d.cs_sold_date_sk >= lo) & (d.cs_sold_date_sk <= hi)]
        avg = d.groupby("cs_item_sk").cs_coupon_amt.mean().rename("avg")
        m = d.join(avg, on="cs_item_sk")
        ex = m[m.cs_coupon_amt > 1.3 * m.avg]
        return pd.DataFrame({"excess_discount":
                             [ex.cs_coupon_amt.sum() if len(ex)
                              else None]})

    return plan, oracle


def q40(paths, tables, partitions: int = 2):
    """Catalog sales value before/after a pivot date by warehouse+item,
    returns subtracted (cs left-join cr on order+item)."""
    cs, cr, wh = (tables["catalog_sales"], tables["catalog_returns"],
                  tables["warehouse"])
    pivot = D0 + 420
    lo, hi = pivot - 30, pivot + 30
    base = project(
        filter_(scan(paths, tables, "catalog_sales"),
                binop(">=", c("cs_sold_date_sk"), lit(lo)),
                binop("<=", c("cs_sold_date_sk"), lit(hi))),
        [c("cs_order_number"), c("cs_item_sk"), c("cs_warehouse_sk"),
         c("cs_sales_price"), c("cs_sold_date_sk")],
        ["order_number", "item_sk", "warehouse_sk", "price", "sold_sk"])
    base_ex = exchange(base, [ci(0), ci(1)], partitions)
    cr_ex = exchange(project(scan(paths, tables, "catalog_returns"),
                             [c("cr_order_number"), c("cr_item_sk"),
                              c("cr_return_amount")],
                             ["ro", "ri", "ramt"]),
                     [ci(0), ci(1)], partitions)
    j = join("hash_join", base_ex, cr_ex, [ci(0), ci(1)],
             [ci(0), ci(1)], jt="left")
    net = binop("-", ci(3),
                {"kind": "coalesce", "args": [ci(7), lit(0.0, "float64")]})
    before = _case([(binop("<", ci(4), lit(pivot)), net)],
                   lit(0.0, "float64"))
    after = _case([(binop(">=", ci(4), lit(pivot)), net)],
                  lit(0.0, "float64"))
    j_wh = join("broadcast_join",
                project(j, [ci(2), before, after],
                        ["warehouse_sk", "before_v", "after_v"]),
                scan(paths, tables, "warehouse"),
                [ci(0)], [c("w_warehouse_sk")])
    sums = _partial_final(
        j_wh, [(c("w_state"), "w_state")],
        [("sum", "sales_before", [ci(1)]),
         ("sum", "sales_after", [ci(2)])], partitions)
    plan = _top(sums, [(ci(0), False)], 100)

    def oracle():
        d = cs.to_pandas()
        d = d[(d.cs_sold_date_sk >= lo) & (d.cs_sold_date_sk <= hi)]
        # a multi-return order contributes once per matching return row
        # in the join; merge WITHOUT pre-aggregation to mirror that
        m = d.merge(cr.to_pandas()[["cr_order_number", "cr_item_sk",
                                    "cr_return_amount"]],
                    left_on=["cs_order_number", "cs_item_sk"],
                    right_on=["cr_order_number", "cr_item_sk"],
                    how="left")
        m["net"] = m.cs_sales_price - m.cr_return_amount.fillna(0.0)
        m["before_v"] = np.where(m.cs_sold_date_sk < pivot, m.net, 0.0)
        m["after_v"] = np.where(m.cs_sold_date_sk >= pivot, m.net, 0.0)
        m = m.merge(wh.to_pandas(), left_on="cs_warehouse_sk",
                    right_on="w_warehouse_sk")
        g = m.groupby("w_state", as_index=False)[
            ["before_v", "after_v"]].sum()
        g = g.rename(columns={"before_v": "sales_before",
                              "after_v": "sales_after"})
        return g.sort_values("w_state").head(100).reset_index(drop=True)

    return plan, oracle


def q41(paths, tables, partitions: int = 2):
    """Distinct item ids within a manufacturer band (q41's
    manufacturer-window distinct-product probe)."""
    it = tables["item"]
    base = filter_(scan(paths, tables, "item"),
                   binop(">=", c("i_manufact_id"), lit(700)),
                   binop("<=", c("i_manufact_id"), lit(740)),
                   binop("<", c("i_current_price"), lit(50)))
    dedup = _partial_final(base, [(c("i_item_id"), "i_item_id")],
                           [("count", "cnt", [c("i_item_sk")])],
                           partitions)
    plan = _top(project(dedup, [ci(0)], ["i_item_id"]),
                [(ci(0), False)], 100)

    def oracle():
        d = it.to_pandas()
        d = d[(d.i_manufact_id >= 700) & (d.i_manufact_id <= 740)
              & (d.i_current_price < 50)]
        out = pd.DataFrame({"i_item_id":
                            sorted(d.i_item_id.unique())[:100]})
        return out

    return plan, oracle


def q49(paths, tables, partitions: int = 2):
    """Worst return ratios per channel: returns/sales by order for web +
    catalog + store, unioned with channel tags, rank-limited."""
    ws, wr = tables["web_sales"], tables["web_returns"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    ss, sr = tables["store_sales"], tables["store_returns"]

    def channel(sales_tbl, ret_tbl, s_key, s_amt, r_key, r_amt, tag):
        s = _partial_final(
            project(scan(paths, tables, sales_tbl),
                    [c(s_key), c(s_amt)], ["k", "amt"]),
            [(ci(0), "k")], [("sum", "sales", [ci(1)])], partitions)
        r = _partial_final(
            project(scan(paths, tables, ret_tbl),
                    [c(r_key), c(r_amt)], ["k", "ramt"]),
            [(ci(0), "k")], [("sum", "returns", [ci(1)])], partitions)
        j = join("sort_merge_join", exchange(s, [ci(0)], partitions),
                 exchange(r, [ci(0)], partitions), [ci(0)], [ci(0)])
        ratio = binop("/", ci(3), ci(1))
        return project(j, [lit(tag, "utf8"), ci(0), ratio],
                       ["channel", "k", "ratio"])

    u = {"kind": "union", "inputs": [
        channel("web_sales", "web_returns", "ws_order_number",
                "ws_ext_sales_price", "wr_order_number", "wr_return_amt",
                "web"),
        channel("catalog_sales", "catalog_returns", "cs_order_number",
                "cs_ext_sales_price", "cr_order_number",
                "cr_return_amount", "catalog"),
        channel("store_sales", "store_returns", "ss_ticket_number",
                "ss_ext_sales_price", "sr_ticket_number",
                "sr_return_amt", "store")]}
    flt = filter_(u, binop(">", ci(2), lit(0.7, "float64")))
    cnt = _partial_final(flt, [(ci(0), "channel")],
                         [("count", "bad_orders", [ci(1)]),
                          ("avg", "avg_ratio", [ci(2)])], partitions)
    plan = _top(cnt, [(ci(0), False)], 10)

    def oracle():
        outs = []
        for sd, rd, sk, sa, rk, ra, tag in [
                (ws, wr, "ws_order_number", "ws_ext_sales_price",
                 "wr_order_number", "wr_return_amt", "web"),
                (cs, cr, "cs_order_number", "cs_ext_sales_price",
                 "cr_order_number", "cr_return_amount", "catalog"),
                (ss, sr, "ss_ticket_number", "ss_ext_sales_price",
                 "sr_ticket_number", "sr_return_amt", "store")]:
            s = sd.to_pandas().groupby(sk)[sa].sum()
            r = rd.to_pandas().groupby(rk)[ra].sum()
            m = pd.concat([s.rename("sales"), r.rename("returns")],
                          axis=1, join="inner")
            m["ratio"] = m["returns"] / m["sales"]
            bad = m[m.ratio > 0.7]
            outs.append((tag, len(bad),
                         bad.ratio.mean() if len(bad) else None))
        out = pd.DataFrame(outs, columns=["channel", "bad_orders",
                                          "avg_ratio"])
        return out.sort_values("channel").reset_index(drop=True)

    return plan, oracle


def q81(paths, tables, partitions: int = 2):
    """q30's catalog twin: catalog-return customers above 1.2x their
    state's average return."""
    cr, cu, ca = (tables["catalog_returns"], tables["customer"],
                  tables["customer_address"])
    lo, hi = _day_range(730, 1094)
    base = filter_(scan(paths, tables, "catalog_returns"),
                   binop(">=", c("cr_returned_date_sk"), lit(lo)),
                   binop("<=", c("cr_returned_date_sk"), lit(hi)))
    j_cu = join("broadcast_join", base, scan(paths, tables, "customer"),
                [c("cr_returning_customer_sk")], [c("c_customer_sk")])
    j_ca = join("broadcast_join", j_cu,
                scan(paths, tables, "customer_address"),
                [c("c_current_addr_sk")], [c("ca_address_sk")])
    ctr = _partial_final(
        j_ca,
        [(c("cr_returning_customer_sk"), "ctr_customer_sk"),
         (c("ca_state"), "ctr_state")],
        [("sum", "ctr_total_return", [c("cr_return_amount")])],
        partitions)
    avg_in = exchange(ctr, [ci(1)], partitions)
    avg_by_state = agg(
        agg(avg_in, [(ci(1), "avg_state")],
            [("avg", "partial", "avg_return", [ci(2)])]),
        [(ci(0), "avg_state")],
        [("avg", "final", "avg_return", [ci(1), ci(2)])])
    ctr2 = exchange(ctr, [ci(1)], partitions)
    joined = join("sort_merge_join", ctr2, avg_by_state, [ci(1)], [ci(0)])
    flt = filter_(joined, binop(">", c("ctr_total_return"),
                                binop("*", c("avg_return"),
                                      lit(1.2, "float64"))))
    j_id = join("broadcast_join", flt, scan(paths, tables, "customer"),
                [ci(0)], [c("c_customer_sk")])
    proj = project(j_id, [c("c_customer_id"), c("ctr_total_return")],
                   ["c_customer_id", "ctr_total_return"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        d = cr.to_pandas()
        d = d[(d.cr_returned_date_sk >= lo) & (d.cr_returned_date_sk <= hi)]
        d = d.merge(cu.to_pandas(), left_on="cr_returning_customer_sk",
                    right_on="c_customer_sk")
        d = d.merge(ca.to_pandas(), left_on="c_current_addr_sk",
                    right_on="ca_address_sk")
        g = d.groupby(["cr_returning_customer_sk", "ca_state"],
                      as_index=False).cr_return_amount.sum()
        avg = g.groupby("ca_state").cr_return_amount.mean().rename("avg")
        m = g.join(avg, on="ca_state")
        m = m[m.cr_return_amount > 1.2 * m.avg]
        m = m.merge(cu.to_pandas(), left_on="cr_returning_customer_sk",
                    right_on="c_customer_sk")
        out = m[["c_customer_id", "cr_return_amount"]].rename(
            columns={"cr_return_amount": "ctr_total_return"})
        return out.sort_values("c_customer_id").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q83(paths, tables, partitions: int = 2):
    """Return quantities equal-footing across the three channels by
    item: sr/cr/wr joined on item id."""
    sr, cr, wr, it = (tables["store_returns"], tables["catalog_returns"],
                      tables["web_returns"], tables["item"])
    lo, hi = _day_range(365, 729)

    def chan(tbl, item_col, amt_col, date_col, out):
        base = filter_(scan(paths, tables, tbl),
                       binop(">=", c(date_col), lit(lo)),
                       binop("<=", c(date_col), lit(hi)))
        j_it = join("broadcast_join", base, scan(paths, tables, "item"),
                    [c(item_col)], [c("i_item_sk")])
        return _partial_final(j_it, [(c("i_item_id"), "i_item_id")],
                              [("sum", out, [c(amt_col)])], partitions)

    s = exchange(chan("store_returns", "sr_item_sk", "sr_return_amt",
                      "sr_returned_date_sk", "s_amt"), [ci(0)],
                 partitions)
    cch = exchange(chan("catalog_returns", "cr_item_sk",
                        "cr_return_amount", "cr_returned_date_sk",
                        "c_amt"), [ci(0)], partitions)
    w = exchange(chan("web_returns", "wr_item_sk", "wr_return_amt",
                      "wr_returned_date_sk", "w_amt"), [ci(0)],
                 partitions)
    j1 = join("sort_merge_join", s, cch, [ci(0)], [ci(0)])
    j2 = join("sort_merge_join", j1, w, [ci(0)], [ci(0)])
    proj = project(j2, [ci(0), ci(1), ci(3), ci(5)],
                   ["i_item_id", "sr_amt", "cr_amt", "wr_amt"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        itd = tables["item"].to_pandas()

        def chan_df(tbl, item_col, amt_col, date_col, out):
            d = tbl.to_pandas()
            d = d[(d[date_col] >= lo) & (d[date_col] <= hi)]
            d = d.merge(itd, left_on=item_col, right_on="i_item_sk")
            return d.groupby("i_item_id")[amt_col].sum().rename(out)

        a = chan_df(sr, "sr_item_sk", "sr_return_amt",
                    "sr_returned_date_sk", "sr_amt")
        b = chan_df(cr, "cr_item_sk", "cr_return_amount",
                    "cr_returned_date_sk", "cr_amt")
        cc = chan_df(wr, "wr_item_sk", "wr_return_amt",
                     "wr_returned_date_sk", "wr_amt")
        m = pd.concat([a, b, cc], axis=1, join="inner").reset_index()
        return m.sort_values("i_item_id").head(100).reset_index(drop=True)

    return plan, oracle


def q85(paths, tables, partitions: int = 2):
    """Web returns by reason with quantity/amount averages (reason ⨝
    wr, the q85 reason-breakdown shape)."""
    wr, rs = tables["web_returns"], tables["reason"]
    j = join("broadcast_join", scan(paths, tables, "web_returns"),
             scan(paths, tables, "reason"),
             [c("wr_reason_sk")], [c("r_reason_sk")])
    stats = _partial_final(
        j, [(c("r_reason_desc"), "r_reason_desc")],
        [("count", "cnt", [c("wr_order_number")]),
         ("avg", "avg_amt", [c("wr_return_amt")]),
         ("avg", "avg_loss", [c("wr_net_loss")])], partitions)
    plan = _top(stats, [(ci(0), False)], 100)

    def oracle():
        d = wr.to_pandas().merge(rs.to_pandas(),
                                 left_on="wr_reason_sk",
                                 right_on="r_reason_sk")
        g = d.groupby("r_reason_desc").agg(
            cnt=("wr_order_number", "count"),
            avg_amt=("wr_return_amt", "mean"),
            avg_loss=("wr_net_loss", "mean")).reset_index()
        return g.sort_values("r_reason_desc").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q91(paths, tables, partitions: int = 2):
    """Call-center catalog returns by month: cr grouped by call center
    and return month."""
    cr = tables["catalog_returns"]
    lo, hi = _day_range(365, 729)
    base = filter_(scan(paths, tables, "catalog_returns"),
                   binop(">=", c("cr_returned_date_sk"), lit(lo)),
                   binop("<=", c("cr_returned_date_sk"), lit(hi)))
    j_dd = join("broadcast_join", base, scan(paths, tables, "date_dim"),
                [c("cr_returned_date_sk")], [c("d_date_sk")])
    sums = _partial_final(
        j_dd,
        [(c("cr_call_center_sk"), "call_center"), (c("d_moy"), "moy")],
        [("sum", "returns_loss", [c("cr_net_loss")])], partitions)
    plan = _top(sums, [(ci(2), True), (ci(0), False), (ci(1), False)],
                100)

    def oracle():
        d = cr.to_pandas()
        d = d[(d.cr_returned_date_sk >= lo) & (d.cr_returned_date_sk <= hi)]
        dd = tables["date_dim"].to_pandas()
        d = d.merge(dd, left_on="cr_returned_date_sk",
                    right_on="d_date_sk")
        g = d.groupby(["cr_call_center_sk", "d_moy"], as_index=False) \
            .cr_net_loss.sum()
        g = g.rename(columns={"cr_call_center_sk": "call_center",
                              "d_moy": "moy",
                              "cr_net_loss": "returns_loss"})
        return g.sort_values(["returns_loss", "call_center", "moy"],
                             ascending=[False, True, True]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


QUERIES.update({
    "q16": (q16, ["catalog_sales", "catalog_returns"]),
    "q21": (q21, ["inventory", "warehouse", "item"]),
    "q22": (q22, ["inventory", "item"]),
    "q30": (q30, ["web_returns", "customer", "customer_address"]),
    "q32": (q32, ["catalog_sales"]),
    "q37": (q37, ["inventory", "item", "catalog_sales"]),
    "q39": (q39, ["inventory"]),
    "q40": (q40, ["catalog_sales", "catalog_returns", "warehouse"]),
    "q41": (q41, ["item"]),
    "q49": (q49, ["web_sales", "web_returns", "catalog_sales",
                  "catalog_returns", "store_sales", "store_returns"]),
    "q72": (q72, ["catalog_sales", "inventory", "item"]),
    "q81": (q81, ["catalog_returns", "customer", "customer_address"]),
    "q82": (q82, ["inventory", "item", "store_sales"]),
    "q83": (q83, ["store_returns", "catalog_returns", "web_returns",
                  "item"]),
    "q85": (q85, ["web_returns", "reason"]),
    "q91": (q91, ["catalog_returns", "date_dim"]),
})


# ---------------------------------------------------------------------------
# channel/ratio family: q02 q05 q08 q09 q44 q53 q54 q58 q61 q63 q71 q74
#                       q75 q76 q77 q78 q80 q84 q86
# ---------------------------------------------------------------------------

def q02(paths, tables, partitions: int = 2):
    """Web+catalog weekly revenue per day-of-week, adjacent-year ratio
    (join on week_seq vs week_seq+53)."""
    ws, cs, dd = (tables["web_sales"], tables["catalog_sales"],
                  tables["date_dim"])

    def weekly(year):
        dd_f = filter_(scan(paths, tables, "date_dim"),
                       binop("==", c("d_year"), lit(year, "int32")))
        w = join("broadcast_join",
                 project(scan(paths, tables, "web_sales"),
                         [c("ws_sold_date_sk"), c("ws_ext_sales_price")],
                         ["date_sk", "price"]),
                 dd_f, [ci(0)], [c("d_date_sk")])
        cch = join("broadcast_join",
                   project(scan(paths, tables, "catalog_sales"),
                           [c("cs_sold_date_sk"),
                            c("cs_ext_sales_price")],
                           ["date_sk", "price"]),
                   dd_f, [ci(0)], [c("d_date_sk")])
        wk64 = {"kind": "cast", "child": c("d_week_seq"),
                "type": {"id": "int64"}}  # both year legs hash the SAME
        #         width: int32 vs int64 keys murmur to different
        #         partitions (Spark inserts this cast too)
        u = {"kind": "union", "inputs": [
            project(w, [wk64, ci(1)], ["week_seq", "price"]),
            project(cch, [wk64, ci(1)], ["week_seq", "price"])]}
        return _partial_final(u, [(ci(0), "week_seq")],
                              [("sum", "rev", [ci(1)])], partitions)

    y1 = exchange(weekly(1999), [ci(0)], partitions)
    y2 = project(weekly(2000), [binop("-", ci(0), lit(53)), ci(1)],
                 ["week_seq_m53", "rev2"])
    j = join("sort_merge_join", y1, exchange(y2, [ci(0)], partitions),
             [ci(0)], [ci(0)])
    ratio = project(j, [ci(0), binop("/", ci(3), ci(1))],
                    ["week_seq", "ratio"])
    plan = _top(ratio, [(ci(0), False)], 100)

    def oracle():
        ddd = dd.to_pandas()

        def weekly_df(year):
            d = ddd[ddd.d_year == year]
            w = ws.to_pandas().merge(d, left_on="ws_sold_date_sk",
                                     right_on="d_date_sk")[
                ["d_week_seq", "ws_ext_sales_price"]].rename(
                columns={"ws_ext_sales_price": "price"})
            cc = cs.to_pandas().merge(d, left_on="cs_sold_date_sk",
                                      right_on="d_date_sk")[
                ["d_week_seq", "cs_ext_sales_price"]].rename(
                columns={"cs_ext_sales_price": "price"})
            u = pd.concat([w, cc], ignore_index=True)
            return u.groupby("d_week_seq").price.sum()

        a, b = weekly_df(1999), weekly_df(2000)
        b.index = b.index - 53
        m = pd.concat([a.rename("rev"), b.rename("rev2")], axis=1,
                      join="inner")
        m["ratio"] = m.rev2 / m.rev
        out = m.reset_index().rename(columns={"d_week_seq": "week_seq"})[
            ["week_seq", "ratio"]]
        return out.sort_values("week_seq").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q05(paths, tables, partitions: int = 2):
    """Per-channel sales vs returns vs net profit/loss summary."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    ws, wr = tables["web_sales"], tables["web_returns"]

    def leg(sales_tbl, s_amt, s_profit, ret_tbl, r_amt, r_loss, tag):
        s = project(scan(paths, tables, sales_tbl),
                    [lit(tag, "utf8"), c(s_amt), c(s_profit),
                     lit(0.0, "float64"), lit(0.0, "float64")],
                    ["channel", "sales", "profit", "returns", "loss"])
        r = project(scan(paths, tables, ret_tbl),
                    [lit(tag, "utf8"), lit(0.0, "float64"),
                     lit(0.0, "float64"), c(r_amt), c(r_loss)],
                    ["channel", "sales", "profit", "returns", "loss"])
        return [s, r]

    legs = (leg("store_sales", "ss_ext_sales_price", "ss_net_profit",
                "store_returns", "sr_return_amt", "sr_net_loss",
                "store channel") +
            leg("catalog_sales", "cs_ext_sales_price", "cs_net_profit",
                "catalog_returns", "cr_return_amount", "cr_net_loss",
                "catalog channel") +
            leg("web_sales", "ws_ext_sales_price", "ws_net_profit",
                "web_returns", "wr_return_amt", "wr_net_loss",
                "web channel"))
    u = {"kind": "union", "inputs": legs}
    sums = _partial_final(
        u, [(ci(0), "channel")],
        [("sum", "sales", [ci(1)]), ("sum", "returns", [ci(3)]),
         ("sum", "profit", [ci(2)]), ("sum", "loss", [ci(4)])],
        partitions)
    plan = _top(sums, [(ci(0), False)], 10)

    def oracle():
        rows = []
        for tag, sd, sa, sp, rd, ra, rl in [
                ("store channel", ss, "ss_ext_sales_price",
                 "ss_net_profit", sr, "sr_return_amt", "sr_net_loss"),
                ("catalog channel", cs, "cs_ext_sales_price",
                 "cs_net_profit", cr, "cr_return_amount", "cr_net_loss"),
                ("web channel", ws, "ws_ext_sales_price",
                 "ws_net_profit", wr, "wr_return_amt", "wr_net_loss")]:
            sdf, rdf = sd.to_pandas(), rd.to_pandas()
            rows.append((tag, sdf[sa].sum(), rdf[ra].sum(),
                         sdf[sp].sum(), rdf[rl].sum()))
        out = pd.DataFrame(rows, columns=["channel", "sales", "returns",
                                          "profit", "loss"])
        return out.sort_values("channel").reset_index(drop=True)

    return plan, oracle


def q08(paths, tables, partitions: int = 2):
    """Store sales for customers whose zip prefix matches the store's
    short list (q08's zip-prefix semi join, simplified to a customer
    address prefix filter)."""
    ss, st, cu, ca = (tables["store_sales"], tables["store"],
                      tables["customer"], tables["customer_address"])
    ca_f = filter_(scan(paths, tables, "customer_address"),
                   binop("<", c("ca_zip"), lit("20000", "utf8")))
    j_cu = join("broadcast_join", scan(paths, tables, "customer"),
                ca_f, [c("c_current_addr_sk")], [c("ca_address_sk")])
    cu_ex = exchange(project(j_cu, [c("c_customer_sk")], ["cust_sk"]),
                     [ci(0)], partitions)
    ss_ex = exchange(project(scan(paths, tables, "store_sales"),
                             [c("ss_customer_sk"), c("ss_store_sk"),
                              c("ss_net_profit")],
                             ["cust", "store_sk", "profit"]),
                     [ci(0)], partitions)
    semi = join("hash_join", ss_ex, cu_ex, [ci(0)], [ci(0)],
                jt="left_semi")
    j_st = join("broadcast_join", semi, scan(paths, tables, "store"),
                [ci(1)], [c("s_store_sk")])
    sums = _partial_final(j_st, [(c("s_store_name"), "s_store_name")],
                          [("sum", "net_profit", [ci(2)])], partitions)
    plan = _top(sums, [(ci(0), False)], 100)

    def oracle():
        cad = ca.to_pandas()
        ok_addr = set(cad[cad.ca_zip < "20000"].ca_address_sk)
        cud = cu.to_pandas()
        ok_cust = set(cud[cud.c_current_addr_sk.isin(ok_addr)]
                      .c_customer_sk)
        d = ss.to_pandas()
        d = d[d.ss_customer_sk.isin(ok_cust)]
        d = d.merge(st.to_pandas(), left_on="ss_store_sk",
                    right_on="s_store_sk")
        g = d.groupby("s_store_name", as_index=False).ss_net_profit.sum()
        g = g.rename(columns={"ss_net_profit": "net_profit"})
        return g.sort_values("s_store_name").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q09(paths, tables, partitions: int = 2):
    """Five quantity-band conditional aggregates over store_sales in one
    pass (the q09 case-bucket probe)."""
    ss = tables["store_sales"]
    bands = [(1, 20), (21, 40), (41, 60), (61, 80), (81, 100)]
    exprs = []
    names = []
    for i, (lo, hi) in enumerate(bands):
        inband = binop("and",
                       binop(">=", c("ss_quantity"), lit(lo, "int32")),
                       binop("<=", c("ss_quantity"), lit(hi, "int32")))
        exprs.append(_case([(inband, lit(1))], lit(0)))
        names.append(f"cnt_{i}")
        exprs.append(_case([(inband, c("ss_ext_sales_price"))],
                           lit(0.0, "float64")))
        names.append(f"amt_{i}")
    proj = project(scan(paths, tables, "store_sales"), exprs, names)
    single = exchange(proj, [], 1)
    plan = _global_agg(single,
                       [("sum", n, [ci(i)])
                        for i, n in enumerate(names)])

    def oracle():
        d = ss.to_pandas()
        vals = {}
        for i, (lo, hi) in enumerate(bands):
            m = d[(d.ss_quantity >= lo) & (d.ss_quantity <= hi)]
            vals[f"cnt_{i}"] = [len(m)]
            vals[f"amt_{i}"] = [m.ss_ext_sales_price.sum()]
        return pd.DataFrame(vals)

    return plan, oracle


def q44(paths, tables, partitions: int = 2):
    """Best and worst items by average net profit: two rank windows
    (asc + desc) joined on rank (the q44 ascender/descender pairing)."""
    ss, it = tables["store_sales"], tables["item"]
    avg_item = _partial_final(
        project(scan(paths, tables, "store_sales"),
                [c("ss_item_sk"), c("ss_net_profit")],
                ["item_sk", "profit"]),
        [(ci(0), "item_sk")], [("avg", "avg_profit", [ci(1)])],
        partitions)
    ex = exchange(avg_item, [], 1)

    def ranked(desc):
        srt = {"kind": "sort", "input": ex,
               "specs": [{"expr": ci(1), "descending": desc,
                          "nulls_first": not desc},
                         {"expr": ci(0), "descending": False,
                          "nulls_first": True}]}
        win = {"kind": "window", "input": srt,
               "functions": [{"kind": "row_number", "name": "rnk"}],
               "partition_by": [],
               "order_by": [{"expr": ci(1), "descending": desc,
                             "nulls_first": not desc}]}
        return filter_(win, binop("<=", ci(2), lit(10, "int32")))

    best = ranked(True)
    worst = ranked(False)
    j = join("broadcast_join", best, worst, [ci(2)], [ci(2)])
    j_it1 = join("broadcast_join", j, scan(paths, tables, "item"),
                 [ci(0)], [c("i_item_sk")])
    j_it2 = join("broadcast_join", j_it1, scan(paths, tables, "item"),
                 [ci(3)], [c("i_item_sk")])
    nb = len(["item_sk", "avg_profit", "rnk"]) * 2
    it_w = len(it.schema.names)
    proj = project(j_it2,
                   [ci(2), ci(nb + 1), ci(nb + it_w + 1)],
                   ["rnk", "best_item_id", "worst_item_id"])
    plan = _top(proj, [(ci(0), False)], 10)

    def oracle():
        d = ss.to_pandas().groupby("ss_item_sk", as_index=False) \
            .ss_net_profit.mean()
        d = d.sort_values(["ss_net_profit", "ss_item_sk"],
                          ascending=[False, True]).reset_index(drop=True)
        best = d.head(10).copy()
        best["rnk"] = np.arange(1, len(best) + 1)
        d2 = d.sort_values(["ss_net_profit", "ss_item_sk"],
                           ascending=[True, True]).reset_index(drop=True)
        worst = d2.head(10).copy()
        worst["rnk"] = np.arange(1, len(worst) + 1)
        itd = it.to_pandas()
        m = best.merge(worst, on="rnk")
        m = m.merge(itd, left_on="ss_item_sk_x", right_on="i_item_sk")
        m = m.merge(itd, left_on="ss_item_sk_y", right_on="i_item_sk",
                    suffixes=("", "_w"))
        out = m[["rnk", "i_item_id", "i_item_id_w"]].rename(
            columns={"i_item_id": "best_item_id",
                     "i_item_id_w": "worst_item_id"})
        return out.sort_values("rnk").reset_index(drop=True)

    return plan, oracle


def _quarterly_window(paths, tables, partitions, group_col, out_name):
    """q53/q63 shape: quarterly item-group revenue vs the group's
    all-quarter average (sum > 1.1x avg)."""
    ss, it, dd = (tables["store_sales"], tables["item"],
                  tables["date_dim"])
    j_dd = join("broadcast_join", scan(paths, tables, "store_sales"),
                scan(paths, tables, "date_dim"),
                [c("ss_sold_date_sk")], [c("d_date_sk")])
    j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                [c("ss_item_sk")], [c("i_item_sk")])
    rev = _partial_final(
        j_it,
        [(c(group_col), out_name), (c("d_year"), "year"),
         (c("d_qoy"), "qoy")],
        [("sum", "sum_sales", [c("ss_sales_price")])], partitions)
    ex = exchange(rev, [], 1)
    srt = {"kind": "sort", "input": ex,
           "specs": [{"expr": ci(0), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(1), "descending": False,
                      "nulls_first": True},
                     {"expr": ci(2), "descending": False,
                      "nulls_first": True}]}
    # whole-partition frame = window agg with NO order_by (the wire
    # has no frame spec; Spark expresses the same thing the same way)
    win = {"kind": "window", "input": srt,
           "functions": [{"kind": "agg", "name": "avg_quarterly",
                          "fn": "avg", "args": [ci(3)]}],
           "partition_by": [ci(0)],
           "order_by": []}
    flt = filter_(win, binop(">", ci(3),
                             binop("*", ci(4), lit(1.1, "float64"))))
    proj = project(flt, [ci(0), ci(1), ci(2), ci(3)],
                   [out_name, "year", "qoy", "sum_sales"])
    plan = _top(proj, [(ci(0), False), (ci(1), False), (ci(2), False)],
                100)

    def oracle():
        m = ss.to_pandas().merge(dd.to_pandas(),
                                 left_on="ss_sold_date_sk",
                                 right_on="d_date_sk")
        m = m.merge(it.to_pandas(), left_on="ss_item_sk",
                    right_on="i_item_sk")
        g = m.groupby([group_col, "d_year", "d_qoy"], as_index=False) \
            .ss_sales_price.sum()
        avg = g.groupby(group_col).ss_sales_price.mean().rename("avg")
        g = g.join(avg, on=group_col)
        g = g[g.ss_sales_price > 1.1 * g.avg]
        out = g.rename(columns={group_col: out_name, "d_year": "year",
                                "d_qoy": "qoy",
                                "ss_sales_price": "sum_sales"})[
            [out_name, "year", "qoy", "sum_sales"]]
        return out.sort_values([out_name, "year", "qoy"]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q53(paths, tables, partitions: int = 2):
    return _quarterly_window(paths, tables, partitions, "i_manufact_id",
                             "manufact_id")


def q63(paths, tables, partitions: int = 2):
    return _quarterly_window(paths, tables, partitions, "i_manager_id",
                             "manager_id")


def q54(paths, tables, partitions: int = 2):
    """Revenue-band customer segmentation: customers active in a month
    bucketed by 50-unit total-revenue bands, counted per band."""
    ss, cu = tables["store_sales"], tables["customer"]
    lo, hi = _day_range(730, 760)
    active = filter_(scan(paths, tables, "store_sales"),
                     binop(">=", c("ss_sold_date_sk"), lit(lo)),
                     binop("<=", c("ss_sold_date_sk"), lit(hi)))
    totals = _partial_final(
        project(active, [c("ss_customer_sk"), c("ss_ext_sales_price")],
                ["cust", "price"]),
        [(ci(0), "cust")], [("sum", "revenue", [ci(1)])], partitions)
    band = {"kind": "cast",
            "child": binop("/", ci(1), lit(50.0, "float64")),
            "type": {"id": "int64"}}
    counts = _partial_final(
        project(totals, [band], ["segment"]),
        [(ci(0), "segment")], [("count", "num_customers", [ci(0)])],
        partitions)
    plan = _top(counts, [(ci(0), False)], 100)

    def oracle():
        d = ss.to_pandas()
        d = d[(d.ss_sold_date_sk >= lo) & (d.ss_sold_date_sk <= hi)]
        g = d.groupby("ss_customer_sk").ss_ext_sales_price.sum()
        seg = (g / 50.0).astype(np.int64)
        out = seg.value_counts().sort_index().reset_index()
        out.columns = ["segment", "num_customers"]
        return out.sort_values("segment").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q58(paths, tables, partitions: int = 2):
    """Items whose revenue is within 10% of the three-channel average in
    every channel."""
    ss, cs, ws, it = (tables["store_sales"], tables["catalog_sales"],
                      tables["web_sales"], tables["item"])
    lo, hi = _day_range(365, 455)

    def chan(tbl, date_col, item_col, amt_col, out):
        base = filter_(scan(paths, tables, tbl),
                       binop(">=", c(date_col), lit(lo)),
                       binop("<=", c(date_col), lit(hi)))
        j_it = join("broadcast_join", base, scan(paths, tables, "item"),
                    [c(item_col)], [c("i_item_sk")])
        return _partial_final(j_it, [(c("i_item_id"), "i_item_id")],
                              [("sum", out, [c(amt_col)])], partitions)

    s = exchange(chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
                      "ss_ext_sales_price", "ss_rev"), [ci(0)],
                 partitions)
    cc = exchange(chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                       "cs_ext_sales_price", "cs_rev"), [ci(0)],
                  partitions)
    w = exchange(chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                      "ws_ext_sales_price", "ws_rev"), [ci(0)],
                 partitions)
    j1 = join("sort_merge_join", s, cc, [ci(0)], [ci(0)])
    j2 = join("sort_merge_join", j1, w, [ci(0)], [ci(0)])
    avg = binop("/", binop("+", binop("+", ci(1), ci(3)), ci(5)),
                lit(3.0, "float64"))
    proj = project(j2, [ci(0), ci(1), ci(3), ci(5), avg],
                   ["i_item_id", "ss_rev", "cs_rev", "ws_rev", "avg_rev"])
    within = lambda col: binop(
        "and",
        binop(">=", col, binop("*", ci(4), lit(0.9, "float64"))),
        binop("<=", col, binop("*", ci(4), lit(1.1, "float64"))))
    flt = filter_(proj, within(ci(1)), within(ci(2)), within(ci(3)))
    plan = _top(flt, [(ci(0), False)], 100)

    def oracle():
        itd = it.to_pandas()

        def chan_df(tbl, date_col, item_col, amt_col, out):
            d = tbl.to_pandas()
            d = d[(d[date_col] >= lo) & (d[date_col] <= hi)]
            d = d.merge(itd, left_on=item_col, right_on="i_item_sk")
            return d.groupby("i_item_id")[amt_col].sum().rename(out)

        a = chan_df(ss, "ss_sold_date_sk", "ss_item_sk",
                    "ss_ext_sales_price", "ss_rev")
        b = chan_df(cs, "cs_sold_date_sk", "cs_item_sk",
                    "cs_ext_sales_price", "cs_rev")
        cc2 = chan_df(ws, "ws_sold_date_sk", "ws_item_sk",
                      "ws_ext_sales_price", "ws_rev")
        m = pd.concat([a, b, cc2], axis=1, join="inner").reset_index()
        m["avg_rev"] = (m.ss_rev + m.cs_rev + m.ws_rev) / 3.0
        for col in ("ss_rev", "cs_rev", "ws_rev"):
            m = m[(m[col] >= 0.9 * m.avg_rev) & (m[col] <= 1.1 * m.avg_rev)]
        return m.sort_values("i_item_id").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q61(paths, tables, partitions: int = 2):
    """Promotional vs total store revenue ratio (one-row output)."""
    ss, pr = tables["store_sales"], tables["promotion"]
    lo, hi = _day_range(400, 430)
    base = filter_(scan(paths, tables, "store_sales"),
                   binop(">=", c("ss_sold_date_sk"), lit(lo)),
                   binop("<=", c("ss_sold_date_sk"), lit(hi)))
    pr_f = filter_(scan(paths, tables, "promotion"),
                   binop("==", c("p_channel_email"), lit("Y", "utf8")))
    promo = join("broadcast_join", base, pr_f,
                 [c("ss_promo_sk")], [c("p_promo_sk")])
    promo_sum = _global_agg(
        exchange(project(promo, [c("ss_ext_sales_price")], ["p"]),
                 [], 1),
        [("sum", "promotions", [ci(0)])])
    total_sum = _global_agg(
        exchange(project(base, [c("ss_ext_sales_price")], ["t"]),
                 [], 1),
        [("sum", "total", [ci(0)])])
    j = {"kind": "broadcast_nested_loop_join", "join_type": "inner",
         "left": promo_sum, "right": total_sum, "build_side": "right"}
    plan = project(j, [ci(0), ci(1),
                       binop("/", binop("*", ci(0),
                                        lit(100.0, "float64")), ci(1))],
                   ["promotions", "total", "promo_pct"])

    def oracle():
        d = ss.to_pandas()
        d = d[(d.ss_sold_date_sk >= lo) & (d.ss_sold_date_sk <= hi)]
        prd = pr.to_pandas()
        ok = set(prd[prd.p_channel_email == "Y"].p_promo_sk)
        p = d[d.ss_promo_sk.isin(ok)].ss_ext_sales_price.sum()
        t = d.ss_ext_sales_price.sum()
        return pd.DataFrame({"promotions": [p], "total": [t],
                             "promo_pct": [p * 100.0 / t]})

    return plan, oracle


def q71(paths, tables, partitions: int = 2):
    """Brand revenue by hour across the three channels in one union
    (q71's time-of-day brand breakdown, ext_price by brand+hour)."""
    ss, cs, ws = (tables["store_sales"], tables["catalog_sales"],
                  tables["web_sales"])
    it, td = tables["item"], tables["time_dim"]

    legs = []
    # only store_sales carries a time key in the synthetic schema; the
    # union shape keeps all three channels with web/catalog at hour -1
    s_leg = join("broadcast_join",
                 project(scan(paths, tables, "store_sales"),
                         [c("ss_item_sk"), c("ss_ext_sales_price"),
                          c("ss_sold_time_sk")],
                         ["item_sk", "price", "time_sk"]),
                 scan(paths, tables, "time_dim"),
                 [ci(2)], [c("t_time_sk")])
    legs.append(project(s_leg, [ci(0), ci(1), c("t_hour")],
                        ["item_sk", "price", "hour"]))
    legs.append(project(scan(paths, tables, "catalog_sales"),
                        [c("cs_item_sk"), c("cs_ext_sales_price"),
                         lit(-1, "int32")],
                        ["item_sk", "price", "hour"]))
    legs.append(project(scan(paths, tables, "web_sales"),
                        [c("ws_item_sk"), c("ws_ext_sales_price"),
                         lit(-1, "int32")],
                        ["item_sk", "price", "hour"]))
    u = {"kind": "union", "inputs": legs}
    j_it = join("broadcast_join", u, scan(paths, tables, "item"),
                [ci(0)], [c("i_item_sk")])
    rev = _partial_final(
        j_it, [(c("i_brand_id"), "brand_id"), (ci(2), "hour")],
        [("sum", "ext_price", [ci(1)])], partitions)
    plan = _top(rev, [(ci(2), True), (ci(0), False), (ci(1), False)],
                100)

    def oracle():
        itd = it.to_pandas()
        tdd = td.to_pandas()
        s = ss.to_pandas().merge(tdd, left_on="ss_sold_time_sk",
                                 right_on="t_time_sk")
        s = s[["ss_item_sk", "ss_ext_sales_price", "t_hour"]]
        s.columns = ["item_sk", "price", "hour"]
        cc = cs.to_pandas()[["cs_item_sk", "cs_ext_sales_price"]].copy()
        cc["hour"] = -1
        cc.columns = ["item_sk", "price", "hour"]
        w = ws.to_pandas()[["ws_item_sk", "ws_ext_sales_price"]].copy()
        w["hour"] = -1
        w.columns = ["item_sk", "price", "hour"]
        u2 = pd.concat([s, cc, w], ignore_index=True)
        u2 = u2.merge(itd, left_on="item_sk", right_on="i_item_sk")
        g = u2.groupby(["i_brand_id", "hour"], as_index=False) \
            .price.sum()
        g = g.rename(columns={"i_brand_id": "brand_id",
                              "price": "ext_price"})
        return g.sort_values(["ext_price", "brand_id", "hour"],
                             ascending=[False, True, True]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q74(paths, tables, partitions: int = 2):
    """Year-over-year customer spend growth, web faster than store
    (q74 = q11 over AVG instead of SUM)."""
    ss, ws, cu = (tables["store_sales"], tables["web_sales"],
                  tables["customer"])
    y1_lo, y1_hi = _day_range(365, 729)
    y2_lo, y2_hi = _day_range(730, 1094)

    def totals(tbl, date_col, cust_col, amt_col, lo, hi, out):
        base = filter_(scan(paths, tables, tbl),
                       binop(">=", c(date_col), lit(lo)),
                       binop("<=", c(date_col), lit(hi)))
        return _partial_final(
            project(base, [c(cust_col), c(amt_col)], ["cust", "amt"]),
            [(ci(0), "cust")], [("avg", out, [ci(1)])], partitions)

    s1 = exchange(totals("store_sales", "ss_sold_date_sk",
                         "ss_customer_sk", "ss_ext_sales_price",
                         y1_lo, y1_hi, "s1"), [ci(0)], partitions)
    s2 = exchange(totals("store_sales", "ss_sold_date_sk",
                         "ss_customer_sk", "ss_ext_sales_price",
                         y2_lo, y2_hi, "s2"), [ci(0)], partitions)
    w1 = exchange(totals("web_sales", "ws_sold_date_sk",
                         "ws_bill_customer_sk", "ws_ext_sales_price",
                         y1_lo, y1_hi, "w1"), [ci(0)], partitions)
    w2 = exchange(totals("web_sales", "ws_sold_date_sk",
                         "ws_bill_customer_sk", "ws_ext_sales_price",
                         y2_lo, y2_hi, "w2"), [ci(0)], partitions)
    j = join("sort_merge_join",
             join("sort_merge_join",
                  join("sort_merge_join", s1, s2, [ci(0)], [ci(0)]),
                  w1, [ci(0)], [ci(0)]),
             w2, [ci(0)], [ci(0)])
    flt = filter_(j,
                  binop(">", ci(1), lit(0.0, "float64")),
                  binop(">", ci(5), lit(0.0, "float64")),
                  binop(">", binop("/", ci(7), ci(5)),
                        binop("/", ci(3), ci(1))))
    j_cu = join("broadcast_join", flt, scan(paths, tables, "customer"),
                [ci(0)], [c("c_customer_sk")])
    proj = project(j_cu, [c("c_customer_id")], ["customer_id"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        ssd, wsd = ss.to_pandas(), ws.to_pandas()

        def tot(df, dc, cc2, ac, lo, hi):
            d = df[(df[dc] >= lo) & (df[dc] <= hi)]
            return d.groupby(cc2)[ac].mean()

        s1d = tot(ssd, "ss_sold_date_sk", "ss_customer_sk",
                  "ss_ext_sales_price", y1_lo, y1_hi)
        s2d = tot(ssd, "ss_sold_date_sk", "ss_customer_sk",
                  "ss_ext_sales_price", y2_lo, y2_hi)
        w1d = tot(wsd, "ws_sold_date_sk", "ws_bill_customer_sk",
                  "ws_ext_sales_price", y1_lo, y1_hi)
        w2d = tot(wsd, "ws_sold_date_sk", "ws_bill_customer_sk",
                  "ws_ext_sales_price", y2_lo, y2_hi)
        m = pd.concat([s1d.rename("s1"), s2d.rename("s2"),
                       w1d.rename("w1"), w2d.rename("w2")],
                      axis=1, join="inner")
        m = m[(m.s1 > 0) & (m.w1 > 0) & (m.w2 / m.w1 > m.s2 / m.s1)]
        cud = cu.to_pandas()
        out = cud[cud.c_customer_sk.isin(m.index)][["c_customer_id"]]
        out = out.rename(columns={"c_customer_id": "customer_id"})
        return out.sort_values("customer_id").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q75(paths, tables, partitions: int = 2):
    """Yearly brand sales net of returns across all three channels,
    consecutive-year delta (q75's declining-brand scan)."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    ws, wr = tables["web_sales"], tables["web_returns"]
    it, dd = tables["item"], tables["date_dim"]

    def chan(sales_tbl, date_col, item_col, qty_col, ret_tbl,
             r_item_col, r_date_col):
        j_dd = join("broadcast_join", scan(paths, tables, sales_tbl),
                    scan(paths, tables, "date_dim"),
                    [c(date_col)], [c("d_date_sk")])
        j_it = join("broadcast_join", j_dd, scan(paths, tables, "item"),
                    [c(item_col)], [c("i_item_sk")])
        sales = project(j_it, [c("i_brand_id"), c("d_year"), c(qty_col),
                               lit(0, "int32")],
                        ["brand_id", "year", "qty", "rqty"])
        rj_dd = join("broadcast_join", scan(paths, tables, ret_tbl),
                     scan(paths, tables, "date_dim"),
                     [c(r_date_col)], [c("d_date_sk")])
        rj_it = join("broadcast_join", rj_dd,
                     scan(paths, tables, "item"),
                     [c(r_item_col)], [c("i_item_sk")])
        rets = project(rj_it, [c("i_brand_id"), c("d_year"),
                               lit(0, "int32"), lit(1, "int32")],
                       ["brand_id", "year", "qty", "rqty"])
        return [sales, rets]

    legs = (chan("store_sales", "ss_sold_date_sk", "ss_item_sk",
                 "ss_quantity", "store_returns", "sr_item_sk",
                 "sr_returned_date_sk") +
            chan("catalog_sales", "cs_sold_date_sk", "cs_item_sk",
                 "cs_quantity", "catalog_returns", "cr_item_sk",
                 "cr_returned_date_sk") +
            chan("web_sales", "ws_sold_date_sk", "ws_item_sk",
                 "ws_quantity", "web_returns", "wr_item_sk",
                 "wr_returned_date_sk"))
    u = {"kind": "union", "inputs": legs}
    yearly = _partial_final(
        u, [(ci(0), "brand_id"), (ci(1), "year")],
        [("sum", "qty", [ci(2)]), ("sum", "rqty", [ci(3)])], partitions)
    net = project(yearly, [ci(0), ci(1), binop("-", ci(2), ci(3))],
                  ["brand_id", "year", "net_qty"])
    y1 = exchange(filter_(net, binop("==", ci(1), lit(1999, "int32"))),
                  [ci(0)], partitions)
    y2 = exchange(filter_(net, binop("==", ci(1), lit(2000, "int32"))),
                  [ci(0)], partitions)
    j = join("sort_merge_join", y1, y2, [ci(0)], [ci(0)])
    flt = filter_(j, binop("<", ci(5), ci(2)))
    proj = project(flt, [ci(0), ci(2), ci(5)],
                   ["brand_id", "net_1999", "net_2000"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        itd, ddd = it.to_pandas(), dd.to_pandas()
        frames = []
        for sd, dc, ic, qc, rd, ric, rdc in [
                (ss, "ss_sold_date_sk", "ss_item_sk", "ss_quantity",
                 sr, "sr_item_sk", "sr_returned_date_sk"),
                (cs, "cs_sold_date_sk", "cs_item_sk", "cs_quantity",
                 cr, "cr_item_sk", "cr_returned_date_sk"),
                (ws, "ws_sold_date_sk", "ws_item_sk", "ws_quantity",
                 wr, "wr_item_sk", "wr_returned_date_sk")]:
            s = sd.to_pandas().merge(ddd, left_on=dc,
                                     right_on="d_date_sk")
            s = s.merge(itd, left_on=ic, right_on="i_item_sk")
            s = s[["i_brand_id", "d_year", qc]].rename(
                columns={qc: "qty"})
            s["rqty"] = 0
            r = rd.to_pandas().merge(ddd, left_on=rdc,
                                     right_on="d_date_sk")
            r = r.merge(itd, left_on=ric, right_on="i_item_sk")
            r = r[["i_brand_id", "d_year"]].copy()
            r["qty"] = 0
            r["rqty"] = 1
            frames.extend([s, r])
        u2 = pd.concat(frames, ignore_index=True)
        g = u2.groupby(["i_brand_id", "d_year"], as_index=False)[
            ["qty", "rqty"]].sum()
        g["net"] = g.qty - g.rqty
        a = g[g.d_year == 1999].set_index("i_brand_id").net
        b = g[g.d_year == 2000].set_index("i_brand_id").net
        m = pd.concat([a.rename("net_1999"), b.rename("net_2000")],
                      axis=1, join="inner")
        m = m[m.net_2000 < m.net_1999].reset_index().rename(
            columns={"i_brand_id": "brand_id"})
        return m.sort_values("brand_id").head(100).reset_index(drop=True)

    return plan, oracle


def q76(paths, tables, partitions: int = 2):
    """Null-key sales counts per channel/year (q76 counts rows whose
    dimension key is NULL; sr_customer_sk carries real nulls)."""
    sr, ss, dd = (tables["store_returns"], tables["store_sales"],
                  tables["date_dim"])
    legs = []
    sr_null = filter_(scan(paths, tables, "store_returns"),
                      {"kind": "is_null", "child": c("sr_customer_sk")})
    j1 = join("broadcast_join", sr_null, scan(paths, tables, "date_dim"),
              [c("sr_returned_date_sk")], [c("d_date_sk")])
    legs.append(project(j1, [lit("store_returns", "utf8"), c("d_year"),
                             c("sr_return_amt")],
                        ["channel", "year", "amt"]))
    j2 = join("broadcast_join", scan(paths, tables, "store_sales"),
              scan(paths, tables, "date_dim"),
              [c("ss_sold_date_sk")], [c("d_date_sk")])
    legs.append(project(j2, [lit("store_sales", "utf8"), c("d_year"),
                             c("ss_ext_sales_price")],
                        ["channel", "year", "amt"]))
    u = {"kind": "union", "inputs": legs}
    sums = _partial_final(
        u, [(ci(0), "channel"), (ci(1), "year")],
        [("count", "cnt", [ci(2)]), ("sum", "amt", [ci(2)])], partitions)
    plan = _top(sums, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        ddd = dd.to_pandas()
        srd = sr.to_pandas()
        a = srd[srd.sr_customer_sk.isna()].merge(
            ddd, left_on="sr_returned_date_sk", right_on="d_date_sk")
        a = a.groupby("d_year").sr_return_amt.agg(["count", "sum"]) \
            .reset_index()
        a["channel"] = "store_returns"
        b = ss.to_pandas().merge(ddd, left_on="ss_sold_date_sk",
                                 right_on="d_date_sk")
        b = b.groupby("d_year").ss_ext_sales_price \
            .agg(["count", "sum"]).reset_index()
        b["channel"] = "store_sales"
        out = pd.concat([a, b], ignore_index=True).rename(
            columns={"d_year": "year", "count": "cnt", "sum": "amt"})[
            ["channel", "year", "cnt", "amt"]]
        return out.sort_values(["channel", "year"]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q77(paths, tables, partitions: int = 2):
    """Per-channel profit & loss rollup: sales profit and return loss by
    channel with an Expand total row."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    ws, wr = tables["web_sales"], tables["web_returns"]

    legs = []
    for tag, sales_tbl, p_col, ret_tbl, l_col in [
            ("store", "store_sales", "ss_net_profit", "store_returns",
             "sr_net_loss"),
            ("catalog", "catalog_sales", "cs_net_profit",
             "catalog_returns", "cr_net_loss"),
            ("web", "web_sales", "ws_net_profit", "web_returns",
             "wr_net_loss")]:
        legs.append(project(scan(paths, tables, sales_tbl),
                            [lit(tag, "utf8"), c(p_col),
                             lit(0.0, "float64")],
                            ["channel", "profit", "loss"]))
        legs.append(project(scan(paths, tables, ret_tbl),
                            [lit(tag, "utf8"), lit(0.0, "float64"),
                             c(l_col)],
                            ["channel", "profit", "loss"]))
    u = {"kind": "union", "inputs": legs}
    expanded = {"kind": "expand", "input": u,
                "projections": [
                    [ci(0), lit(0), ci(1), ci(2)],
                    [lit(None, "utf8"), lit(1), ci(1), ci(2)]],
                "names": ["channel", "g_id", "profit", "loss"]}
    sums = _partial_final(
        expanded, [(ci(0), "channel"), (ci(1), "g_id")],
        [("sum", "profit", [ci(2)]), ("sum", "loss", [ci(3)])],
        partitions)
    proj = project(sums, [ci(0), ci(2), ci(3)],
                   ["channel", "profit", "loss"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        rows = []
        tp = tl = 0.0
        for tag, sd, pc2, rd, lc in [
                ("store", ss, "ss_net_profit", sr, "sr_net_loss"),
                ("catalog", cs, "cs_net_profit", cr, "cr_net_loss"),
                ("web", ws, "ws_net_profit", wr, "wr_net_loss")]:
            p = sd.to_pandas()[pc2].sum()
            l = rd.to_pandas()[lc].sum()
            rows.append((tag, p, l))
            tp += p
            tl += l
        rows.append((None, tp, tl))
        out = pd.DataFrame(rows, columns=["channel", "profit", "loss"])
        return out.sort_values("channel", na_position="first") \
            .head(100).reset_index(drop=True)

    return plan, oracle


def q78(paths, tables, partitions: int = 2):
    """Customer-item yearly sums per channel excluding returned sales,
    web/store quantity ratio (q78's unreturned-sales comparison)."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    ws, wr = tables["web_sales"], tables["web_returns"]
    lo, hi = _day_range(730, 1094)

    ss_f = filter_(scan(paths, tables, "store_sales"),
                   binop(">=", c("ss_sold_date_sk"), lit(lo)),
                   binop("<=", c("ss_sold_date_sk"), lit(hi)))
    ss_ex = exchange(project(ss_f, [c("ss_ticket_number"),
                                    c("ss_item_sk"), c("ss_customer_sk"),
                                    c("ss_quantity")],
                             ["ticket", "item", "cust", "qty"]),
                     [ci(0), ci(1)], partitions)
    sr_ex = exchange(project(scan(paths, tables, "store_returns"),
                             [c("sr_ticket_number"), c("sr_item_sk")],
                             ["rt", "ri"]),
                     [ci(0), ci(1)], partitions)
    ss_anti = join("hash_join", ss_ex, sr_ex, [ci(0), ci(1)],
                   [ci(0), ci(1)], jt="left_anti")
    s_tot = _partial_final(ss_anti, [(ci(2), "cust")],
                           [("sum", "s_qty", [ci(3)])], partitions)

    ws_f = filter_(scan(paths, tables, "web_sales"),
                   binop(">=", c("ws_sold_date_sk"), lit(lo)),
                   binop("<=", c("ws_sold_date_sk"), lit(hi)))
    ws_ex = exchange(project(ws_f, [c("ws_order_number"),
                                    c("ws_item_sk"),
                                    c("ws_bill_customer_sk"),
                                    c("ws_quantity")],
                             ["order", "item", "cust", "qty"]),
                     [ci(0), ci(1)], partitions)
    wr_ex = exchange(project(scan(paths, tables, "web_returns"),
                             [c("wr_order_number"), c("wr_item_sk")],
                             ["ro", "ri"]),
                     [ci(0), ci(1)], partitions)
    ws_anti = join("hash_join", ws_ex, wr_ex, [ci(0), ci(1)],
                   [ci(0), ci(1)], jt="left_anti")
    w_tot = _partial_final(ws_anti, [(ci(2), "cust")],
                           [("sum", "w_qty", [ci(3)])], partitions)

    j = join("sort_merge_join", exchange(s_tot, [ci(0)], partitions),
             exchange(w_tot, [ci(0)], partitions), [ci(0)], [ci(0)])
    ratio = project(j, [ci(0), ci(1), ci(3),
                        binop("/", {"kind": "cast", "child": ci(3),
                                    "type": {"id": "float64"}},
                              {"kind": "cast", "child": ci(1),
                               "type": {"id": "float64"}})],
                    ["cust", "s_qty", "w_qty", "ratio"])
    plan = _top(ratio, [(ci(3), True), (ci(0), False)], 100)

    def oracle():
        ssd = ss.to_pandas()
        ssd = ssd[(ssd.ss_sold_date_sk >= lo) & (ssd.ss_sold_date_sk <= hi)]
        srd = sr.to_pandas()
        ret = set(zip(srd.sr_ticket_number, srd.sr_item_sk))
        keep = ~ssd.apply(lambda r: (r.ss_ticket_number, r.ss_item_sk)
                          in ret, axis=1)
        s_tot_d = ssd[keep].groupby("ss_customer_sk").ss_quantity.sum()
        wsd = ws.to_pandas()
        wsd = wsd[(wsd.ws_sold_date_sk >= lo) & (wsd.ws_sold_date_sk <= hi)]
        wrd = wr.to_pandas()
        wret = set(zip(wrd.wr_order_number, wrd.wr_item_sk))
        wkeep = ~wsd.apply(lambda r: (r.ws_order_number, r.ws_item_sk)
                           in wret, axis=1)
        w_tot_d = wsd[wkeep].groupby("ws_bill_customer_sk") \
            .ws_quantity.sum()
        m = pd.concat([s_tot_d.rename("s_qty"), w_tot_d.rename("w_qty")],
                      axis=1, join="inner").reset_index().rename(
            columns={"index": "cust"})
        m["ratio"] = m.w_qty.astype(float) / m.s_qty.astype(float)
        return m.sort_values(["ratio", "cust"],
                             ascending=[False, True]).head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q80(paths, tables, partitions: int = 2):
    """Sales minus returns per channel in a date window (q80's channel
    P&L with returns netted by order/ticket+item)."""
    ss, sr = tables["store_sales"], tables["store_returns"]
    cs, cr = tables["catalog_sales"], tables["catalog_returns"]
    ws, wr = tables["web_sales"], tables["web_returns"]
    lo, hi = _day_range(365, 455)

    def leg(tag, sales_tbl, date_col, key_cols, amt_col, ret_tbl,
            r_keys, r_amt):
        base = filter_(scan(paths, tables, sales_tbl),
                       binop(">=", c(date_col), lit(lo)),
                       binop("<=", c(date_col), lit(hi)))
        s_ex = exchange(project(base, [c(k) for k in key_cols] +
                                [c(amt_col)],
                                ["k0", "k1", "amt"]),
                        [ci(0), ci(1)], partitions)
        r_ex = exchange(project(scan(paths, tables, ret_tbl),
                                [c(k) for k in r_keys] + [c(r_amt)],
                                ["rk0", "rk1", "ramt"]),
                        [ci(0), ci(1)], partitions)
        j = join("hash_join", s_ex, r_ex, [ci(0), ci(1)],
                 [ci(0), ci(1)], jt="left")
        net = binop("-", ci(2),
                    {"kind": "coalesce",
                     "args": [ci(5), lit(0.0, "float64")]})
        return project(j, [lit(tag, "utf8"), net], ["channel", "net"])

    u = {"kind": "union", "inputs": [
        leg("store", "store_sales", "ss_sold_date_sk",
            ["ss_ticket_number", "ss_item_sk"], "ss_ext_sales_price",
            "store_returns", ["sr_ticket_number", "sr_item_sk"],
            "sr_return_amt"),
        leg("catalog", "catalog_sales", "cs_sold_date_sk",
            ["cs_order_number", "cs_item_sk"], "cs_ext_sales_price",
            "catalog_returns", ["cr_order_number", "cr_item_sk"],
            "cr_return_amount"),
        leg("web", "web_sales", "ws_sold_date_sk",
            ["ws_order_number", "ws_item_sk"], "ws_ext_sales_price",
            "web_returns", ["wr_order_number", "wr_item_sk"],
            "wr_return_amt")]}
    sums = _partial_final(u, [(ci(0), "channel")],
                          [("sum", "net_sales", [ci(1)])], partitions)
    plan = _top(sums, [(ci(0), False)], 10)

    def oracle():
        rows = []
        for tag, sd, dc, ks, ac, rd, rks, ra in [
                ("store", ss, "ss_sold_date_sk",
                 ["ss_ticket_number", "ss_item_sk"],
                 "ss_ext_sales_price", sr,
                 ["sr_ticket_number", "sr_item_sk"], "sr_return_amt"),
                ("catalog", cs, "cs_sold_date_sk",
                 ["cs_order_number", "cs_item_sk"],
                 "cs_ext_sales_price", cr,
                 ["cr_order_number", "cr_item_sk"], "cr_return_amount"),
                ("web", ws, "ws_sold_date_sk",
                 ["ws_order_number", "ws_item_sk"],
                 "ws_ext_sales_price", wr,
                 ["wr_order_number", "wr_item_sk"], "wr_return_amt")]:
            sdf = sd.to_pandas()
            sdf = sdf[(sdf[dc] >= lo) & (sdf[dc] <= hi)]
            rdf = rd.to_pandas()[rks + [ra]]
            m = sdf.merge(rdf, left_on=ks, right_on=rks, how="left")
            net = (m[ac] - m[ra].fillna(0.0)).sum()
            rows.append((tag, net))
        out = pd.DataFrame(rows, columns=["channel", "net_sales"])
        return out.sort_values("channel").reset_index(drop=True)

    return plan, oracle


def q84(paths, tables, partitions: int = 2):
    """Customer lookup by city + demographic bands (q84's income-band
    ident list, buy-potential standing in for the band table)."""
    cu, ca, cd = (tables["customer"], tables["customer_address"],
                  tables["customer_demographics"])
    ca_f = filter_(scan(paths, tables, "customer_address"),
                   binop("==", c("ca_city"), lit("city_7", "utf8")))
    j_ca = join("broadcast_join", scan(paths, tables, "customer"),
                ca_f, [c("c_current_addr_sk")], [c("ca_address_sk")])
    cd_f = filter_(scan(paths, tables, "customer_demographics"),
                   binop("==", c("cd_marital_status"), lit("M", "utf8")))
    j_cd = join("broadcast_join", j_ca, cd_f,
                [c("c_current_cdemo_sk")], [c("cd_demo_sk")])
    proj = project(j_cd, [c("c_customer_id")], ["customer_id"])
    plan = _top(proj, [(ci(0), False)], 100)

    def oracle():
        cad = ca.to_pandas()
        ok = set(cad[cad.ca_city == "city_7"].ca_address_sk)
        cdd = cd.to_pandas()
        okd = set(cdd[cdd.cd_marital_status == "M"].cd_demo_sk)
        d = cu.to_pandas()
        d = d[d.c_current_addr_sk.isin(ok)
              & d.c_current_cdemo_sk.isin(okd)]
        out = d[["c_customer_id"]].rename(
            columns={"c_customer_id": "customer_id"})
        return out.sort_values("customer_id").head(100) \
            .reset_index(drop=True)

    return plan, oracle


def q86(paths, tables, partitions: int = 2):
    """ROLLUP(category, class) web net profit with Expand (q86 is q67's
    web profit sibling)."""
    ws, it = tables["web_sales"], tables["item"]
    j_it = join("broadcast_join", scan(paths, tables, "web_sales"),
                scan(paths, tables, "item"),
                [c("ws_item_sk")], [c("i_item_sk")])
    projections = []
    for gid, keep in enumerate([(True, True), (True, False),
                                (False, False)]):
        projections.append([
            c("i_category") if keep[0] else lit(None, "utf8"),
            c("i_class") if keep[1] else lit(None, "utf8"),
            lit(gid), c("ws_net_profit")])
    expanded = {"kind": "expand", "input": j_it,
                "projections": projections,
                "names": ["i_category", "i_class", "g_id", "profit"]}
    sums = _partial_final(
        expanded,
        [(ci(0), "i_category"), (ci(1), "i_class"), (ci(2), "g_id")],
        [("sum", "total_profit", [ci(3)])], partitions)
    proj = project(sums, [ci(0), ci(1), ci(3)],
                   ["i_category", "i_class", "total_profit"])
    plan = _top(proj, [(ci(0), False), (ci(1), False)], 100)

    def oracle():
        d = ws.to_pandas().merge(it.to_pandas(), left_on="ws_item_sk",
                                 right_on="i_item_sk")
        outs = []
        full = d.groupby(["i_category", "i_class"], as_index=False) \
            .ws_net_profit.sum()
        outs.append(full)
        cat = d.groupby(["i_category"], as_index=False) \
            .ws_net_profit.sum()
        cat["i_class"] = None
        outs.append(cat)
        outs.append(pd.DataFrame({"i_category": [None],
                                  "i_class": [None],
                                  "ws_net_profit":
                                  [d.ws_net_profit.sum()]}))
        allr = pd.concat(outs, ignore_index=True).rename(
            columns={"ws_net_profit": "total_profit"})[
            ["i_category", "i_class", "total_profit"]]
        return allr.sort_values(["i_category", "i_class"],
                                na_position="first").head(100) \
            .reset_index(drop=True)

    return plan, oracle


QUERIES.update({
    "q02": (q02, ["web_sales", "catalog_sales", "date_dim"]),
    "q05": (q05, ["store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns"]),
    "q08": (q08, ["store_sales", "store", "customer",
                  "customer_address"]),
    "q09": (q09, ["store_sales"]),
    "q44": (q44, ["store_sales", "item"]),
    "q53": (q53, ["store_sales", "item", "date_dim"]),
    "q54": (q54, ["store_sales", "customer"]),
    "q58": (q58, ["store_sales", "catalog_sales", "web_sales", "item"]),
    "q61": (q61, ["store_sales", "promotion"]),
    "q63": (q63, ["store_sales", "item", "date_dim"]),
    "q71": (q71, ["store_sales", "catalog_sales", "web_sales", "item",
                  "time_dim"]),
    "q74": (q74, ["store_sales", "web_sales", "customer"]),
    "q75": (q75, ["store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns", "item",
                  "date_dim"]),
    "q76": (q76, ["store_returns", "store_sales", "date_dim"]),
    "q77": (q77, ["store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns"]),
    "q78": (q78, ["store_sales", "store_returns", "web_sales",
                  "web_returns"]),
    "q80": (q80, ["store_sales", "store_returns", "catalog_sales",
                  "catalog_returns", "web_sales", "web_returns"]),
    "q84": (q84, ["customer", "customer_address",
                  "customer_demographics"]),
    "q86": (q86, ["web_sales", "item"]),
})
