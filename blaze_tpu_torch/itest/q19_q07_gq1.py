"""TPC-DS q19, q07 and the Generate-bearing gq1 through the port's stage
DAG (plan/stages.py): their tables, the counters a run is checked by, the
rows after each join and generator, and each oracle's frame under the
plan's column names.

q19 joins store_sales to November 1999 (broadcast) and to item
(broadcast), exchanges the result and customer on the customer key into
a shuffled hash join, then joins the addresses and the stores by
broadcast and sums the revenue by brand, sorted by the sum descending.
q07 joins store_sales by broadcast to the male, college-educated
demographics, to 2000's dates, to the promotions without e-mail and to
item, then averages four measures by item id on the generic engine.
gq1 explodes each web session's list of clicked items with their
positions (posexplode on the host, over the Arrow list offsets), renames
the generated columns, joins item by broadcast and counts clicks by
category.

The fact tables (store_sales, web_clickstreams) are split into `n_files`
files, every dimension stays one file (itest/tpcds_data.py
`write_splits`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import pandas as pd

from blaze_tpu_torch.bridge.metrics import MetricNode

#: every table q19, q07 or gq1 reads
TABLES = ("store_sales", "item", "date_dim", "customer",
          "customer_address", "store", "customer_demographics",
          "promotion", "web_clickstreams")

#: the queries of this module
QUERIES = ("q19", "q07", "gq1")

#: each query's stage count in the reference's split
STAGES = {"q19": 5, "q07": 3, "gq1": 3}

#: operator counters a run is checked by (itest/q01_dag.py
#: stage_counters sums them per stage)
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                  "fused_batches", "dict_device_batches",
                  "stage_loop_tasks", "stage_loop_fallback",
                  "sort_device_runs", "io_bytes")

#: the operators whose `output_rows` `operator_rows` reads
ROW_OPERATORS = ("BroadcastJoinExec", "ShuffledHashJoinExec",
                 "GenerateExec")


def _nodes_named(node: MetricNode, name: str) -> List[MetricNode]:
    """The nodes named `name` under `node`, parents before children."""
    out = [node] if node.name == name else []
    for c in node.children:
        out.extend(_nodes_named(c, name))
    return out


def operator_rows(sched, ops=ROW_OPERATORS) -> Dict[str, List[int]]:
    """Operator (of `ops`) -> the `output_rows` of each of its nodes,
    summed over the tasks of a stage, stage by stage and in a stage
    parents before children (a chain of joins reads from the last join
    down)."""
    out: Dict[str, List[int]] = {}
    for op in ops:
        rows = []
        for _sid, tree in sorted(sched.stage_metrics.items()):
            rows += [n.values.get("output_rows", 0)
                     for n in _nodes_named(tree, op)]
        if rows:
            out[op] = rows
    return out


#: q19's output columns as its plan names them
Q19_COLUMNS = ["brand_id", "brand", "ext_price"]


def in_plan_order(name: str, got: pd.DataFrame, want: pd.DataFrame
                  ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """(got, want) ready for runner.same_order: the oracle's frame under
    the plan's column names (q19's oracle keeps item's)."""
    if name == "q19":
        want = want.set_axis(Q19_COLUMNS, axis=1)
    return got, want.reset_index(drop=True)
