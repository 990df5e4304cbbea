"""TPC-DS q06 and the brand-revenue queries (q03, q42, q52, q55) through
the port's stage DAG (plan/stages.py): their tables at a scale, the file
splits and the plans with their oracles.

Every one of them groups by a utf8 key somewhere: q06 averages the item
price by `i_category` (the generic AggExec engine: avg is not fused) and
counts store_sales rows by store through a hash join (the fused hash
lane); the brand-revenue queries sum revenue by (d_year, i_brand_id,
i_brand) or (d_year, i_category) on the fused dict-device lane, in the
partial and in the final stage.

store_sales is split into `n_files` files; item and date_dim stay one
file each.  q06 needs item in one file: its category average is a partial
`avg` directly under a final one with no exchange between them (the
reference's plan, itest/queries.py), so each file of a split item would
average on its own.
"""

from __future__ import annotations

from typing import Dict, List

from blaze_tpu_torch.itest import queries as Q

#: operator counters a q06-family run is checked by (itest/q01_dag.py
#: stage_counters sums them per stage)
STAGE_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                  "dict_device_batches", "dict_device_doublings",
                  "dict_device_relayouts", "dict_device_fallback",
                  "fused_batches",
                  "stage_loop_tasks", "stage_loop_fallback",
                  "partial_skipped", "passthrough_rows",
                  "sort_device_runs")

#: the fact table; every other table is a dimension and stays one file
FACT = "store_sales"


def make_tables(scale: float, names: List[str] = ("store_sales", "item",
                                                  "date_dim")) -> Dict:
    """The named tables at `scale` from their generators' seeds."""
    from blaze_tpu_torch.itest import tpcds_data as T
    return {n: getattr(T, "gen_" + n)(scale) for n in names}


def write_splits(tables: Dict, out_dir: str, n_files: int) -> Dict:
    """store_sales in `n_files` parquet files, every other table in one
    (write_parquet_splits' layout)."""
    from blaze_tpu_torch.itest.tpcds_data import write_parquet_splits
    facts = {k: t for k, t in tables.items() if k == FACT}
    dims = {k: t for k, t in tables.items() if k != FACT}
    paths = write_parquet_splits(facts, out_dir, n_files)
    paths.update(write_parquet_splits(dims, out_dir, 1))
    return paths


def plans(paths: Dict, tables: Dict, partitions: int,
          names: List[str] = ("q06", "q42", "q03")) -> Dict:
    """name -> (plan dict, oracle) for each query in `names`."""
    return {n: Q.QUERIES[n][0](paths, tables, partitions) for n in names}


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
