"""TPC-DS q17 and q18 (BASELINE config #3: multi-join + rollup aggregate,
shuffle-heavy) through the port's stage DAG (plan/stages.py): their
tables, the counters a run is checked by, q18's plan over all five
grouping sets, and q17 on a linked input.

q18 joins catalog_sales (1998) by broadcast to the female, "Unknown"
education demographics, by a shuffled hash join to customer, by
broadcast to the addresses IN ('TX', 'OH', 'IL') and to item, then
averages four measures over ROLLUP(i_item_id, ca_country, ca_state,
ca_county): an Expand writes each joined row five times, with null utf8
keys where the set rolls a column up and the grouping id `g_id` (0, 1,
3, 7, 15).  q17 joins store_sales to store_returns on (ticket, item) and
that join's output, exchanged again, to catalog_sales on (customer,
item): two shuffled hash joins on two-column keys; then item and store
by broadcast, counts and averages by (i_item_id, s_state).

The fact tables (store_sales, store_returns, catalog_sales) are split
into `n_files` files, every dimension stays one file (itest/tpcds_data.py
`write_splits`).

Two properties of the reference's generator and query, kept as they are:
  * q17 finds no row: `sr_ticket_number` is `arange(1, n + 1)`, drawn
    independently of store_sales, so ss ⨝ sr on (ticket, item) matches
    about one row.  `q17_linked` makes a copy of the tables in which the
    joins find rows;
  * q18's top 100 (sorted by g_id first) all have g_id 0, so no rolled-up
    row reaches the compared output.  `q18_all_sets` is q18's plan cut
    above the sort, compared with every grouping set.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.itest import queries as Q

#: every table q17 or q18 reads
TABLES = ("store_sales", "store_returns", "catalog_sales", "store", "item",
          "customer_demographics", "customer", "customer_address")

#: operator counters a q17/q18 run is checked by (itest/q01_dag.py
#: stage_counters sums them per stage)
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                  "fused_batches", "dict_device_batches",
                  "dict_device_fallback", "stage_loop_tasks",
                  "stage_loop_fallback", "partial_skipped",
                  "passthrough_rows", "sort_device_runs", "io_bytes")

#: the grouping ids of q18's five grouping sets
Q18_GIDS = (0, 1, 3, 7, 15)


def q18_all_sets(paths: Dict, tables: Dict, partitions: int):
    """(plan, oracle): q18's plan cut at its final aggregation under the
    exchange to one partition (no sort, no limit), and a pandas frame of
    all five grouping sets (queries.q18_sets)."""
    plan, _ = Q.q18(paths, tables, partitions)
    single = plan["input"]["input"]
    assert single["kind"] == "local_exchange", single["kind"]
    return single, lambda: Q.q18_sets(tables)


def q17_linked(tables: Dict[str, pa.Table], seed: int
               ) -> Tuple[Dict[str, pa.Table], int]:
    """A copy of `tables` in which q17's joins find rows, and the number
    k of linked rows.  With numpy.random.default_rng(seed): k is 1% of
    the store_returns rows in SR_CS_WINDOW; k of them and k store_sales
    rows in SS_WINDOW are drawn, and each drawn return takes the ticket,
    item and customer of its sale; then k catalog_sales rows in
    SR_CS_WINDOW take the drawn returns' (customer, item) as
    (cs_bill_customer_sk, cs_item_sk).  Nothing else changes."""
    rng = np.random.default_rng(seed)
    ss, sr, cs = (tables["store_sales"], tables["store_returns"],
                  tables["catalog_sales"])

    def window(t, col, lo_hi):
        d = t.column(col).to_numpy()
        return np.flatnonzero((d >= lo_hi[0]) & (d <= lo_hi[1]))

    sr_in = window(sr, "sr_returned_date_sk", Q.SR_CS_WINDOW)
    ss_in = window(ss, "ss_sold_date_sk", Q.SS_WINDOW)
    cs_in = window(cs, "cs_sold_date_sk", Q.SR_CS_WINDOW)
    k = max(1, len(sr_in) // 100)
    k = min(k, len(ss_in), len(cs_in))
    pick_sr = rng.choice(sr_in, k, replace=False)
    pick_ss = rng.choice(ss_in, k, replace=False)
    pick_cs = rng.choice(cs_in, k, replace=False)

    def put(t, col, rows, values):
        arr = t.column(col).combine_chunks()
        vals = arr.fill_null(0).to_numpy().copy()
        nulls = arr.is_null().to_numpy(zero_copy_only=False).copy()
        vals[rows], nulls[rows] = values, False
        return t.set_column(t.schema.get_field_index(col), col,
                            pa.array(vals, type=arr.type, mask=nulls))

    def values(t, col, rows):
        return t.column(col).to_numpy()[rows]

    cust = values(ss, "ss_customer_sk", pick_ss)
    item = values(ss, "ss_item_sk", pick_ss)
    sr = put(sr, "sr_ticket_number", pick_sr,
             values(ss, "ss_ticket_number", pick_ss))
    sr = put(sr, "sr_item_sk", pick_sr, item)
    sr = put(sr, "sr_customer_sk", pick_sr, cust)
    cs = put(cs, "cs_bill_customer_sk", pick_cs, cust)
    cs = put(cs, "cs_item_sk", pick_cs, item)
    out = dict(tables)
    out["store_returns"], out["catalog_sales"] = sr, cs
    return out, k
