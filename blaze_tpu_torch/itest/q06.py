"""TPC-DS q06 and the brand-revenue queries (q03, q42, q52, q55) through
the port's stage DAG (plan/stages.py): the tables they read, the
counters a run is checked by, and the per-operator counters of a run.

Every one of them groups by a utf8 key somewhere: q06 averages the item
price by `i_category` (the generic AggExec engine: avg is not fused) and
counts store_sales rows by store through a hash join (the fused hash
lane); the brand-revenue queries sum revenue by (d_year, i_brand_id,
i_brand) or (d_year, i_category) on the fused dict-device lane, in the
partial and in the final stage.

store_sales is split into `n_files` files; item and date_dim stay one
file each (itest/tpcds_data.py `write_splits`).  q06 needs item in one
file: its category average is a partial `avg` directly under a final one
with no exchange between them (the reference's plan, itest/queries.py),
so each file of a split item would average on its own.
"""

from __future__ import annotations

from typing import Dict

#: operator counters a q06-family run is checked by (itest/q01_dag.py
#: stage_counters sums them per stage)
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                  "dict_device_batches", "dict_device_doublings",
                  "dict_device_relayouts", "dict_device_fallback",
                  "fused_batches",
                  "stage_loop_tasks", "stage_loop_fallback",
                  "partial_skipped", "passthrough_rows",
                  "sort_device_runs", "io_bytes")

#: the tables q06, q42 and q03 read, and the queries run over them
TABLES = ("store_sales", "item", "date_dim")
QUERY_NAMES = ("q06", "q42", "q03")


def operator_counters(sched, op_name: str, names) -> Dict[int, Dict]:
    """Per stage: the counters `names` summed over the nodes named
    `op_name` of its merged operator metric tree (q06's generic AggExec
    beside the fused aggregation, say)."""
    out = {}
    for sid, tree in sched.stage_metrics.items():
        acc = {k: 0 for k in names}
        todo = [tree]
        while todo:
            node = todo.pop()
            if node.name == op_name:
                for k in names:
                    acc[k] += node.values.get(k, 0)
            todo.extend(node.children)
        out[sid] = acc
    return out
