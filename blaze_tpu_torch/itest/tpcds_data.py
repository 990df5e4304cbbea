"""Synthetic TPC-DS-shaped tables for the queries of itest/queries.py,
queries_ext.py and queries_ext2.py (a copy of every generator of
blaze_tpu/itest/tpcds_data.py: `gen_store_returns`, `gen_store_sales`,
`gen_catalog_sales`, `gen_catalog_returns`, `gen_web_sales`,
`gen_web_returns`, `gen_inventory`, `gen_date_dim`, `gen_time_dim`,
`gen_store`, `gen_warehouse`, `gen_customer`,
`gen_customer_demographics`, `gen_household_demographics`,
`gen_customer_address`, `gen_item`, `gen_promotion`, `gen_reason`,
`gen_web_clickstreams`, and `write_parquet_splits`, with the helpers
they use), and `make_tables` and `write_splits` for the query modules.
The same seed gives the same values as the JAX package's generator: same
columns, types and key relationships as TPC-DS, scaled by `scale` (1.0 ~
SF1 row counts).  Nothing is downloaded.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

SF1_ROWS = {
    "inventory": 783_000,
    "household_demographics": 7_200,
    "time_dim": 86_400,
    "reason": 35,
    "store_returns": 287_514,
    "store_sales": 2_880_404,
    "catalog_sales": 1_441_548,
    "web_sales": 719_384,
    "web_returns": 71_763,
    "store": 12,
    "customer": 100_000,
    "customer_address": 50_000,
    "customer_demographics": 1_920_800,
    "date_dim": 73_049,
    "item": 18_000,
    "warehouse": 5,
    "promotion": 300,
    "web_clickstreams": 50_000,
}

#: the fact tables split into several files; every other table is a
#: dimension and stays one file
FACTS = ("store_sales", "store_returns", "catalog_sales", "catalog_returns",
         "web_sales", "web_returns", "inventory", "web_clickstreams")

SALES_DATE_DAYS = 1826  # TPC-DS facts span ~5 years (1998-2002)


def _date_ordered(tbl: pa.Table, date_col: str) -> pa.Table:
    """Fact tables come out of dsdgen in date order, so real TPC-DS parquet
    loads carry strong date-key clustering; sort to match."""
    return tbl.sort_by([(date_col, "ascending")])


def _rows(name: str, scale: float) -> int:
    base = SF1_ROWS[name]
    if name in ("store", "date_dim", "warehouse", "promotion",
                "household_demographics", "time_dim", "reason"):
        return base  # dimension tables do not scale
    if name == "customer_demographics":
        # fixed-size cross-product dimension in TPC-DS
        return min(base, max(1, int(base * max(scale, 0.01))))
    return max(1, int(base * scale))


def gen_date_dim(scale: float, seed: int = 11) -> pa.Table:
    n = _rows("date_dim", scale)
    sk = np.arange(2450815, 2450815 + n)
    year = 1998 + (np.arange(n) // 365)
    moy = (np.arange(n) % 365) // 31 + 1
    return pa.table({
        "d_date_sk": pa.array(sk),
        "d_year": pa.array(year.astype(np.int32)),
        "d_moy": pa.array(np.minimum(moy, 12).astype(np.int32)),
        "d_dom": pa.array(((np.arange(n) % 31) + 1).astype(np.int32)),
        "d_dow": pa.array((np.arange(n) % 7).astype(np.int32)),
        "d_week_seq": pa.array((np.arange(n) // 7 + 1).astype(np.int32)),
        "d_qoy": pa.array((((np.minimum(moy, 12) - 1) // 3) + 1)
                          .astype(np.int32)),
    })


def gen_store(scale: float, seed: int = 12) -> pa.Table:
    n = _rows("store", scale)
    rng = np.random.default_rng(seed)
    states = np.array(["TN", "CA", "NY", "TX", "WA"])
    return pa.table({
        "s_store_sk": pa.array(np.arange(1, n + 1)),
        "s_state": pa.array(states[rng.integers(0, len(states), n)]),
        "s_store_name": pa.array([f"store_{i}" for i in range(1, n + 1)]),
    })


def gen_customer(scale: float, seed: int = 13) -> pa.Table:
    n = _rows("customer", scale)
    rng = np.random.default_rng(seed)
    return pa.table({
        "c_customer_sk": pa.array(np.arange(1, n + 1)),
        "c_customer_id": pa.array([f"C{i:011d}" for i in range(1, n + 1)]),
        "c_current_addr_sk": pa.array(
            rng.integers(1, _rows("customer_address", scale) + 1, n)),
        "c_current_cdemo_sk": pa.array(
            rng.integers(1, _rows("customer_demographics", scale) + 1, n)),
        "c_birth_year": pa.array(
            rng.integers(1924, 1993, n).astype(np.int32)),
    })


def gen_store_returns(scale: float, seed: int = 14) -> pa.Table:
    n = _rows("store_returns", scale)
    rng = np.random.default_rng(seed)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    null_mask = rng.random(n) < 0.02
    cust = rng.integers(1, _rows("customer", scale) + 1, n).astype(float)
    cust[null_mask] = np.nan
    return _date_ordered(pa.table({
        "sr_returned_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "sr_customer_sk": pa.array(
            np.where(null_mask, None, cust).tolist(), type=pa.int64()),
        "sr_store_sk": pa.array(rng.integers(1, _rows("store", scale) + 1, n)),
        "sr_return_amt": pa.array(np.round(rng.random(n) * 500, 2)),
        "sr_ticket_number": pa.array(np.arange(1, n + 1)),
        "sr_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "sr_return_quantity": pa.array(
            rng.integers(1, 50, n).astype(np.int32)),
        "sr_reason_sk": pa.array(rng.integers(1, 36, n)),
        "sr_net_loss": pa.array(np.round(rng.random(n) * 60, 2)),
    }), "sr_returned_date_sk")


def gen_store_sales(scale: float, seed: int = 15) -> pa.Table:
    n = _rows("store_sales", scale)
    rng = np.random.default_rng(seed)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    return _date_ordered(pa.table({
        "ss_sold_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "ss_customer_sk": pa.array(
            rng.integers(1, _rows("customer", scale) + 1, n)),
        "ss_store_sk": pa.array(rng.integers(1, _rows("store", scale) + 1, n)),
        "ss_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "ss_ext_sales_price": pa.array(np.round(rng.random(n) * 300, 2)),
        "ss_quantity": pa.array(rng.integers(1, 100, n).astype(np.int32)),
        "ss_ticket_number": pa.array(np.arange(1, n + 1)),
        "ss_cdemo_sk": pa.array(
            rng.integers(1, _rows("customer_demographics", scale) + 1, n)),
        "ss_promo_sk": pa.array(rng.integers(1, 301, n)),
        "ss_list_price": pa.array(np.round(rng.random(n) * 320, 2)),
        "ss_coupon_amt": pa.array(np.round(rng.random(n) * 40, 2)),
        "ss_sales_price": pa.array(np.round(rng.random(n) * 280, 2)),
        "ss_net_profit": pa.array(np.round(rng.random(n) * 120 - 20, 2)),
        "ss_hdemo_sk": pa.array(rng.integers(1, 7_201, n)),
        "ss_addr_sk": pa.array(
            rng.integers(1, _rows("customer_address", scale) + 1, n)),
        "ss_sold_time_sk": pa.array(rng.integers(0, 86_400, n)),
    }), "ss_sold_date_sk")


def gen_catalog_sales(scale: float, seed: int = 17) -> pa.Table:
    n = _rows("catalog_sales", scale)
    rng = np.random.default_rng(seed)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    sold = rng.integers(2450815, 2450815 + date_n, n)
    return _date_ordered(pa.table({
        "cs_sold_date_sk": pa.array(sold),
        "cs_bill_customer_sk": pa.array(
            rng.integers(1, _rows("customer", scale) + 1, n)),
        "cs_bill_cdemo_sk": pa.array(
            rng.integers(1, _rows("customer_demographics", scale) + 1, n)),
        "cs_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "cs_quantity": pa.array(rng.integers(1, 100, n).astype(np.int32)),
        "cs_list_price": pa.array(np.round(rng.random(n) * 300, 2)),
        "cs_coupon_amt": pa.array(np.round(rng.random(n) * 50, 2)),
        "cs_sales_price": pa.array(np.round(rng.random(n) * 250, 2)),
        "cs_net_profit": pa.array(np.round(rng.random(n) * 100 - 20, 2)),
        "cs_promo_sk": pa.array(rng.integers(1, 301, n)),
        "cs_ext_sales_price": pa.array(np.round(rng.random(n) * 280, 2)),
        "cs_ship_date_sk": pa.array(sold + rng.integers(1, 150, n)),
        "cs_warehouse_sk": pa.array(
            rng.integers(1, _rows("warehouse", scale) + 1, n)),
        "cs_order_number": pa.array(rng.integers(1, max(1, n // 2) + 1,
                                                 n)),
        "cs_ship_mode_sk": pa.array(rng.integers(1, 21, n)),
        "cs_call_center_sk": pa.array(rng.integers(1, 7, n)),
    }), "cs_sold_date_sk")


def gen_catalog_returns(scale: float, seed: int = 28) -> pa.Table:
    n = max(1, int(144_067 * scale))
    rng = np.random.default_rng(seed)
    cs_n = _rows("catalog_sales", scale)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    return _date_ordered(pa.table({
        "cr_order_number": pa.array(
            rng.integers(1, max(1, cs_n // 2) + 1, n)),
        "cr_return_amount": pa.array(np.round(rng.random(n) * 90, 2)),
        "cr_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "cr_returning_customer_sk": pa.array(
            rng.integers(1, _rows("customer", scale) + 1, n)),
        "cr_returned_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "cr_call_center_sk": pa.array(rng.integers(1, 7, n)),
        "cr_net_loss": pa.array(np.round(rng.random(n) * 70, 2)),
    }), "cr_returned_date_sk")


def gen_web_sales(scale: float, seed: int = 18) -> pa.Table:
    n = _rows("web_sales", scale)
    rng = np.random.default_rng(seed)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    n_orders = max(1, n // 3)  # ~3 line items per order
    return _date_ordered(pa.table({
        "ws_ship_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "ws_ship_addr_sk": pa.array(
            rng.integers(1, _rows("customer_address", scale) + 1, n)),
        "ws_web_site_sk": pa.array(rng.integers(1, 31, n)),
        "ws_order_number": pa.array(rng.integers(1, n_orders + 1, n)),
        "ws_warehouse_sk": pa.array(
            rng.integers(1, _rows("warehouse", scale) + 1, n)),
        "ws_ext_ship_cost": pa.array(np.round(rng.random(n) * 100, 2)),
        "ws_net_profit": pa.array(np.round(rng.random(n) * 200 - 40, 2)),
        "ws_sold_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "ws_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "ws_ext_sales_price": pa.array(np.round(rng.random(n) * 300, 2)),
        "ws_bill_customer_sk": pa.array(
            rng.integers(1, _rows("customer", scale) + 1, n)),
        "ws_quantity": pa.array(rng.integers(1, 100, n).astype(np.int32)),
        "ws_sales_price": pa.array(np.round(rng.random(n) * 260, 2)),
    }), "ws_sold_date_sk")


def gen_web_returns(scale: float, seed: int = 19) -> pa.Table:
    n = _rows("web_returns", scale)
    rng = np.random.default_rng(seed)
    n_orders = max(1, _rows("web_sales", scale) // 3)
    date_n = min(_rows("date_dim", scale), SALES_DATE_DAYS)
    return _date_ordered(pa.table({
        "wr_order_number": pa.array(rng.integers(1, n_orders + 1, n)),
        "wr_return_amt": pa.array(np.round(rng.random(n) * 80, 2)),
        "wr_item_sk": pa.array(rng.integers(1, _rows("item", scale) + 1, n)),
        "wr_returning_customer_sk": pa.array(
            rng.integers(1, _rows("customer", scale) + 1, n)),
        "wr_returned_date_sk": pa.array(
            rng.integers(2450815, 2450815 + date_n, n)),
        "wr_reason_sk": pa.array(rng.integers(1, 36, n)),
        "wr_net_loss": pa.array(np.round(rng.random(n) * 50, 2)),
    }), "wr_returned_date_sk")


def gen_customer_demographics(scale: float, seed: int = 20) -> pa.Table:
    n = _rows("customer_demographics", scale)
    rng = np.random.default_rng(seed)
    genders = np.array(["M", "F"])
    edu = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                    "4 yr Degree", "Advanced Degree", "Unknown"])
    return pa.table({
        "cd_demo_sk": pa.array(np.arange(1, n + 1)),
        "cd_gender": pa.array(genders[rng.integers(0, 2, n)]),
        "cd_education_status": pa.array(edu[rng.integers(0, len(edu), n)]),
        "cd_dep_count": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "cd_marital_status": pa.array(
            np.array(["S", "M", "D", "W", "U"])[rng.integers(0, 5, n)]),
    })


def gen_customer_address(scale: float, seed: int = 21) -> pa.Table:
    n = _rows("customer_address", scale)
    rng = np.random.default_rng(seed)
    states = np.array(["TN", "CA", "NY", "TX", "WA", "GA", "IL", "IN",
                       "OH", "NE"])
    counties = np.array([f"county_{i}" for i in range(40)])
    return pa.table({
        "ca_address_sk": pa.array(np.arange(1, n + 1)),
        "ca_state": pa.array(states[rng.integers(0, len(states), n)]),
        "ca_city": pa.array(
            np.array([f"city_{i}" for i in range(60)])[
                rng.integers(0, 60, n)]),
        "ca_county": pa.array(counties[rng.integers(0, len(counties), n)]),
        "ca_country": pa.array(np.array(["United States"]).repeat(n)),
        "ca_zip": pa.array(np.char.zfill(
            rng.integers(0, 100000, n).astype(str), 5)),
        "ca_gmt_offset": pa.array(
            rng.integers(-8, -4, n).astype(np.int32)),
    })


def gen_item(scale: float, seed: int = 16) -> pa.Table:
    n = _rows("item", scale)
    rng = np.random.default_rng(seed)
    cats = np.array(["Books", "Home", "Sports", "Music", "Electronics"])
    brands = np.array([f"brand_{i}" for i in range(50)])
    classes = np.array([f"class_{i}" for i in range(16)])
    brand_ids = rng.integers(1, 51, n)
    return pa.table({
        "i_item_sk": pa.array(np.arange(1, n + 1)),
        "i_item_id": pa.array([f"I{i:09d}" for i in range(1, n + 1)]),
        "i_category": pa.array(cats[rng.integers(0, len(cats), n)]),
        "i_class": pa.array(classes[rng.integers(0, len(classes), n)]),
        "i_brand_id": pa.array(brand_ids.astype(np.int32)),
        "i_brand": pa.array(brands[brand_ids - 1]),
        "i_manager_id": pa.array(rng.integers(1, 100, n).astype(np.int32)),
        "i_manufact_id": pa.array(
            rng.integers(1, 1001, n).astype(np.int32)),
        "i_current_price": pa.array(np.round(rng.random(n) * 100, 2)),
    })


def gen_promotion(scale: float, seed: int = 22) -> pa.Table:
    n = _rows("promotion", scale)
    rng = np.random.default_rng(seed)
    yn = np.array(["Y", "N"])
    return pa.table({
        "p_promo_sk": pa.array(np.arange(1, n + 1)),
        "p_channel_email": pa.array(yn[rng.integers(0, 2, n)]),
        "p_channel_event": pa.array(yn[rng.integers(0, 2, n)]),
    })


def gen_web_clickstreams(scale: float, seed: int = 23) -> pa.Table:
    """Sessions with a LIST column of 0-5 clicked item keys (TPC-DS has
    no list column; gq1 explodes this one)."""
    n = _rows("web_clickstreams", scale)
    rng = np.random.default_rng(seed)
    n_items = _rows("item", scale)
    lengths = rng.integers(0, 6, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    values = rng.integers(1, n_items + 1, int(offsets[-1]))
    pages = pa.ListArray.from_arrays(pa.array(offsets, type=pa.int32()),
                                     pa.array(values, type=pa.int64()))
    return pa.table({
        "wc_session_sk": pa.array(np.arange(1, n + 1)),
        "wc_clicked_items": pages,
    })


def gen_inventory(scale: float, seed: int = 29) -> pa.Table:
    """Weekly on-hand snapshots (TPC-DS inventory): one row per
    (week, item-sample, warehouse); dsdgen emits them in date order."""
    n = _rows("inventory", scale)
    rng = np.random.default_rng(seed)
    week_starts = np.arange(0, SALES_DATE_DAYS, 7)
    return _date_ordered(pa.table({
        "inv_date_sk": pa.array(
            2450815 + week_starts[rng.integers(0, len(week_starts), n)]),
        "inv_item_sk": pa.array(
            rng.integers(1, _rows("item", scale) + 1, n)),
        "inv_warehouse_sk": pa.array(
            rng.integers(1, _rows("warehouse", scale) + 1, n)),
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1000, n).astype(np.int32)),
    }), "inv_date_sk")


def gen_warehouse(scale: float, seed: int = 27) -> pa.Table:
    n = _rows("warehouse", scale)
    return pa.table({
        "w_warehouse_sk": pa.array(np.arange(1, n + 1)),
        "w_warehouse_name": pa.array([f"warehouse_{i}"
                                      for i in range(1, n + 1)]),
        "w_state": pa.array(np.array(["TN", "CA", "NY", "TX", "WA"])
                            [np.arange(n) % 5]),
    })


def gen_household_demographics(scale: float, seed: int = 24) -> pa.Table:
    n = _rows("household_demographics", scale)
    rng = np.random.default_rng(seed)
    pot = np.array([">10000", "5001-10000", "1001-5000", "501-1000",
                    "0-500", "Unknown"])
    return pa.table({
        "hd_demo_sk": pa.array(np.arange(1, n + 1)),
        "hd_dep_count": pa.array(rng.integers(0, 10, n).astype(np.int32)),
        "hd_vehicle_count": pa.array(
            rng.integers(-1, 5, n).astype(np.int32)),
        "hd_buy_potential": pa.array(pot[rng.integers(0, len(pot), n)]),
    })


def gen_time_dim(scale: float, seed: int = 25) -> pa.Table:
    n = _rows("time_dim", scale)
    t = np.arange(n)
    return pa.table({
        "t_time_sk": pa.array(t),
        "t_hour": pa.array((t // 3600).astype(np.int32)),
        "t_minute": pa.array(((t % 3600) // 60).astype(np.int32)),
    })


def gen_reason(scale: float, seed: int = 26) -> pa.Table:
    n = _rows("reason", scale)
    return pa.table({
        "r_reason_sk": pa.array(np.arange(1, n + 1)),
        "r_reason_desc": pa.array([f"reason {i}" for i in range(1, n + 1)]),
    })


def write_parquet_splits(tables, out_dir: str, partitions: int,
                         row_group_size: int = 1 << 16):
    """Fact tables split into `partitions` files, one scan file group per
    partition; dimension tables (10,000 rows or fewer) stay single-file.
    The files are written in parallel threads (pyarrow releases the GIL);
    each holds the rows it would hold written alone.  Returns {name:
    [[file], [file], ...]} in the parquet_scan IR shape."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import pyarrow.parquet as pq
    paths, parts = {}, []
    for name, t in tables.items():
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        nparts = partitions if t.num_rows > 10_000 else 1
        per = -(-t.num_rows // nparts)
        groups = []
        for i in range(nparts):
            p = os.path.join(d, f"part-{i:05d}.parquet")
            parts.append((t.slice(i * per, per), p))
            groups.append([p])
        paths[name] = groups
    if parts:
        with ThreadPoolExecutor(min(len(parts), os.cpu_count() or 1)) as pool:
            for f in [pool.submit(pq.write_table, t, p,
                                  row_group_size=row_group_size)
                      for t, p in parts]:
                f.result()
    return paths


def make_tables(scale: float, names) -> dict:
    """The named tables at `scale` from their generators' seeds."""
    return {n: globals()["gen_" + n](scale) for n in names}


def write_splits(tables, out_dir: str, n_files: int) -> dict:
    """The fact tables (FACTS) in `n_files` parquet files each, every
    other table in one (write_parquet_splits' layout)."""
    facts = {k: t for k, t in tables.items() if k in FACTS}
    dims = {k: t for k, t in tables.items() if k not in FACTS}
    paths = write_parquet_splits(facts, out_dir, n_files)
    paths.update(write_parquet_splits(dims, out_dir, 1))
    return paths
