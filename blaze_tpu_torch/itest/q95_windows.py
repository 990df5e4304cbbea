"""TPC-DS q95 (BASELINE config #4: EXISTS and NOT EXISTS over a wide
exchange) and the window queries q12, q20, q98, q51 and q67 through the
port's stage DAG (plan/stages.py): their tables, the counters a run is
checked by, q95's row count after each of its joins, and each oracle's
frame in the plan's row order.

q95 keeps the web orders shipped from more than one warehouse and never
returned: web_sales in a 61-day ship window from web sites 1-2 joins the
Illinois addresses by broadcast (`ws1`); a shuffled hash join on the order
number against all of web_sales (`ws_all`, every row hashed into the
exchange) keeps a `ws1` row when some row of its order left another
warehouse (EXISTS: a left semi join whose filter `!=` reads both sides);
a second one against web_returns drops the returned orders (NOT EXISTS:
a left anti join); then a per-order sum and one global row.

The window queries run `WindowExec` (ops/window.py) over a sort in a
single partition: q12, q20 and q98 divide each item's revenue by its
class total (a whole-partition sum), q51 takes running sums of daily web
and store revenue per item and joins them by a full outer sort-merge
join, q67 ranks ROLLUP(category, class) totals within their category.

The fact tables (store_sales, catalog_sales, web_sales, web_returns) are
split into `n_files` files, every dimension stays one file
(itest/tpcds_data.py `write_splits`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import pandas as pd

from blaze_tpu_torch.bridge.metrics import MetricNode

#: every table q95 or a window query reads
TABLES = ("web_sales", "web_returns", "customer_address", "store_sales",
          "catalog_sales", "item", "date_dim")

#: the queries of this module
QUERIES = ("q95", "q12", "q20", "q98", "q51", "q67")

#: each query's stage count in the reference's split
STAGES = {"q95": 5, "q12": 3, "q20": 3, "q98": 3, "q51": 5, "q67": 3}

#: operator counters a run is checked by (itest/q01_dag.py
#: stage_counters sums them per stage)
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                  "fused_batches", "dict_device_batches",
                  "stage_loop_tasks", "stage_loop_fallback",
                  "sort_device_runs", "output_rows", "io_bytes")


def _nodes_named(node: MetricNode, name: str) -> List[MetricNode]:
    """The nodes named `name` under `node`, parents before children."""
    out = [node] if node.name == name else []
    for c in node.children:
        out.extend(_nodes_named(c, name))
    return out


def q95_join_rows(sched) -> Dict[str, int]:
    """q95's rows after each join, summed over tasks: `ws1` (the web
    sales in the window after the Illinois broadcast), `exists` (after
    the semi join) and `not_exists` (after the anti join, which probes
    with the semi join's output in the same stage)."""
    bcast, shj = [], []
    for tree in sched.stage_metrics.values():
        bcast += _nodes_named(tree, "BroadcastJoinExec")
        shj += _nodes_named(tree, "ShuffledHashJoinExec")
    if len(bcast) != 1 or len(shj) != 2:
        raise ValueError(f"q95: {len(bcast)} broadcast and {len(shj)} "
                         f"shuffled hash joins, expected 1 and 2")
    anti, semi = shj  # the anti join is the semi join's parent
    return {"ws1": bcast[0].values.get("output_rows", 0),
            "exists": semi.values.get("output_rows", 0),
            "not_exists": anti.values.get("output_rows", 0)}


def joins_cut(rows: Dict[str, int]) -> bool:
    """Whether the semi and the anti join each removed rows and kept
    some."""
    return (0 < rows["exists"] < rows["ws1"]
            and 0 < rows["not_exists"] < rows["exists"])


#: q51's output columns as its plan names them: each side's window
#: (item_sk, date_sk, rev, cume), web then store
Q51_COLUMNS = ["item_sk", "date_sk", "rev", "cume"] * 2


def in_plan_order(name: str, got: pd.DataFrame, want: pd.DataFrame
                  ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """(got, want) ready for runner.same_order: the oracle's rows in the
    order the plan defines, under the plan's column names.  q12, q20 and
    q98 leave their window sorted by (i_class, i_item_id), which the
    oracle does not sort by; q67's sort puts the null category first,
    the oracle's last; q51's oracle names the two sides' columns apart
    (`Q51_COLUMNS` are the plan's names)."""
    if name in ("q12", "q20", "q98"):
        want = want.sort_values(["i_class", "i_item_id"], kind="stable")
    elif name == "q67":
        want = want.sort_values(["i_category", "rk"], kind="stable",
                                na_position="first")
    elif name == "q51":
        want = want.set_axis(Q51_COLUMNS, axis=1)
    return got, want.reset_index(drop=True)
