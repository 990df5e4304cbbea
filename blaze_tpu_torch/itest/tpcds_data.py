"""Synthetic TPC-DS-shaped tables for the q01 path (a copy of
`gen_store_returns` and `gen_date_dim` of blaze_tpu/itest/tpcds_data.py,
with the helpers they use).  The same seed gives the same values as the
JAX package's generator: same columns, types and key relationships as
TPC-DS, scaled by `scale` (1.0 ~ SF1 row counts).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

SF1_ROWS = {
    "store_returns": 287_514,
    "store": 12,
    "customer": 100_000,
    "date_dim": 73_049,
    "item": 18_000,
}

SALES_DATE_DAYS = 1826  # TPC-DS facts span ~5 years (1998-2002)


def _date_ordered(tbl: pa.Table, date_col: str) -> pa.Table:
    """Fact tables come out of dsdgen in date order, so real TPC-DS parquet
    loads carry strong date-key clustering; sort to match."""
    return tbl.sort_by([(date_col, "ascending")])


def _rows(name: str, scale: float) -> int:
    base = SF1_ROWS[name]
    if name in ("store", "date_dim"):
        return base  # dimension tables do not scale
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
