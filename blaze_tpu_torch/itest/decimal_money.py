"""TPC-DS money typed as Spark types it: decimal(7,2) (TPC-DS v3.2.0 §2,
the fact tables' column definitions), with full q01 (BASELINE config #1)
and q12 over it and an exact oracle for each.

  * `money_as_decimal` rewrites the named float money columns of a
    generated table (already rounded to cents by itest/tpcds_data.py) as
    decimal(7,2) from the unscaled cents np.rint(x * 100), vectorised;
  * `q01` and `q12` build the plans of itest/queries.py over those
    tables and retype their literals as Spark's parser types them
    (`spark_literals`): q01's `1.2` is a decimal(2,1) and q12's `100` an
    int, so `ctr_total_return > avg_return * 1.2` compares a decimal(17,2)
    with a decimal(21,7) (precision > 18: exact on the host) and
    `revenueratio` is a decimal division;
  * each oracle is exact and uses no float: q01 in integer cents with
    Spark's decimal(18,6) average (sum x 10^4 / count, HALF_UP), q12 the
    grouped cents and Python Decimal for the ratio.

`python -m blaze_tpu_torch.itest.decimal_money [--scale S] [--device D]`
runs both through the stage DAG and prints each one's wall, stages and
rows and the host rows and seconds of exprs/decimal_arith.py.
"""

from __future__ import annotations

import decimal as pydec
from typing import Dict, List

import numpy as np
import pyarrow as pa

from blaze_tpu_torch.itest import queries as Q

MONEY = pa.decimal128(7, 2)

#: the money columns of each table the two queries read
MONEY_COLUMNS = {
    "store_returns": ["sr_return_amt", "sr_net_loss"],
    "web_sales": ["ws_ext_ship_cost", "ws_net_profit", "ws_ext_sales_price",
                  "ws_sales_price"],
}

#: each query's tables
TABLES = {"q01": ["store_returns", "date_dim", "store", "customer"],
          "q12": ["web_sales", "item"]}

#: each query's stage count in the reference's split
STAGES = {"q01": 6, "q12": 3}


def cents(arr) -> np.ndarray:
    """The unscaled int64 values of a decimal(p <= 18) Arrow array (nulls
    read as 0): the low limb of each int128."""
    from blaze_tpu_torch.kernels.decimal128 import int128_limbs
    return int128_limbs(arr)[1]


def money_as_decimal(table: pa.Table, columns: List[str]) -> pa.Table:
    """`table` with each of `columns` (float64 cents) as decimal(7,2)."""
    from blaze_tpu_torch.batch import decimal_from_unscaled
    for name in columns:
        i = table.schema.get_field_index(name)
        col = table.column(i).combine_chunks()
        valid = np.ones(len(col), dtype=bool) if col.null_count == 0 else \
            np.asarray(col.is_valid())
        unscaled = np.rint(np.asarray(col.fill_null(0.0)) * 100) \
            .astype(np.int64)
        table = table.set_column(i, pa.field(name, MONEY),
                                 decimal_from_unscaled(unscaled, valid,
                                                       MONEY))
    return table


def with_money(tables: Dict[str, pa.Table]) -> Dict[str, pa.Table]:
    """The tables with their money columns as decimal(7,2)."""
    return {n: money_as_decimal(t, MONEY_COLUMNS[n]) if n in MONEY_COLUMNS
            else t for n, t in tables.items()}


def spark_literal(value: float) -> dict:
    """A float literal of itest/queries.py's plans as Spark's parser
    types the SQL text it stands for: an integral value (q12's `100`) an int, any other
    a decimal of its digits (q01's `1.2`: decimal(2,1))."""
    if float(value).is_integer():
        return {"kind": "literal", "value": int(value),
                "type": {"id": "int32"}}
    d = pydec.Decimal(repr(value))
    scale = -d.as_tuple().exponent
    precision = max(len(d.as_tuple().digits), scale)
    return {"kind": "literal", "value": d,
            "type": {"id": "decimal", "precision": precision,
                     "scale": scale}}


def spark_literals(node):
    """The plan dict with every float64 literal retyped by
    `spark_literal` (a new dict; the input is not changed)."""
    if isinstance(node, dict):
        if node.get("kind") == "literal" and \
                node.get("type", {}).get("id") == "float64":
            return spark_literal(node["value"])
        return {k: spark_literals(v) for k, v in node.items()}
    if isinstance(node, list):
        return [spark_literals(v) for v in node]
    return node


def _half_up_div(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """HALF_UP of num / den over int64 arrays (den > 0)."""
    q = (np.abs(num) + den // 2) // den
    return np.where(num < 0, -q, q)


def q01(paths, tables, partitions: int = 2):
    """Full q01 over decimal store_returns: (plan, oracle)."""
    plan, _ = Q.q01(paths, tables, partitions)
    plan = spark_literals(plan)

    def oracle():
        import pandas as pd
        sr, dd = tables["store_returns"], tables["date_dim"].to_pandas()
        m = pd.DataFrame({
            "date": sr.column("sr_returned_date_sk").to_numpy(),
            "cust": sr.column("sr_customer_sk").to_pandas(),
            "store": sr.column("sr_store_sk").to_numpy(),
            "cents": cents(sr.column("sr_return_amt"))})
        m = m[m.date.isin(dd[dd.d_year == 2000].d_date_sk)]
        ctr = m.groupby(["cust", "store"], as_index=False, dropna=False) \
            .cents.sum()
        avg = ctr.groupby("store", as_index=False).cents.agg(["sum", "count"])
        # avg(decimal(17,2)) is decimal(18,6): sum x 10^4 / count, HALF_UP
        avg["avg6"] = _half_up_div(avg["sum"].to_numpy() * 10_000,
                                   avg["count"].to_numpy())
        j = ctr.merge(avg[["store", "avg6"]], on="store")
        # ctr_total_return (scale 2) > avg_return (scale 6) * 1.2 (scale 1)
        j = j[j.cents.to_numpy() * 100_000 > j.avg6.to_numpy() * 12]
        st, cu = tables["store"].to_pandas(), tables["customer"].to_pandas()
        j = j.merge(st[st.s_state == "TN"], left_on="store",
                    right_on="s_store_sk")
        j = j.merge(cu, left_on="cust", right_on="c_customer_sk")
        out = j[["c_customer_id"]].sort_values("c_customer_id")[:100]
        return pa.table({"c_customer_id": pa.array(
            out.c_customer_id.tolist(), pa.utf8())})

    return plan, oracle


def q12(paths, tables, partitions: int = 2):
    """q12's ratio over a window over decimal web_sales: (plan, oracle).
    The oracle gives {(i_item_id, i_class): (item cents, class cents)}."""
    plan, _ = Q.q12(paths, tables, partitions)
    plan = spark_literals(plan)

    def oracle():
        import pandas as pd
        ws, it = tables["web_sales"], tables["item"].to_pandas()
        lo, hi = Q.Q12_WINDOW
        m = pd.DataFrame({
            "date": ws.column("ws_sold_date_sk").to_numpy(),
            "item": ws.column("ws_item_sk").to_numpy(),
            "cents": cents(ws.column("ws_ext_sales_price"))})
        m = m[(m.date >= lo) & (m.date <= hi)]
        m = m.merge(it, left_on="item", right_on="i_item_sk")
        rev = m.groupby(["i_item_id", "i_class"], as_index=False,
                        dropna=False).cents.sum()
        total = rev.groupby("i_class", dropna=False).cents.transform("sum")
        return {(a, b): (int(c), int(t)) for a, b, c, t in
                zip(rev.i_item_id, rev.i_class, rev.cents, total)}

    return plan, oracle


def check_q01(out: pa.Table, want: pa.Table) -> str:
    """'' where q01's result equals its oracle's, row for row."""
    got = out.column(0).to_pylist()
    exp = want.column(0).to_pylist()
    if got != exp:
        return f"q01: {len(got)} rows against the oracle's {len(exp)}"
    return ""


def check_q12(out: pa.Table, want: dict) -> str:
    """'' where q12's result equals its oracle's exactly: itemrevenue the
    item's cents, revenueratio the exact itemrevenue x 100 / classrevenue
    in Python Decimal, HALF_UP at the column's scale, both columns
    decimals."""
    types = [out.schema.field(i).type for i in (2, 3)]
    if not all(pa.types.is_decimal(t) for t in types):
        return f"q12: revenue columns typed {types}"
    quant = pydec.Decimal(1).scaleb(-types[1].scale)
    cols = [out.column(i).to_pylist() for i in range(4)]
    got = {(a, b): (c, d) for a, b, c, d in zip(*cols)}
    if got.keys() != want.keys() or len(got) != out.num_rows:
        return (f"q12: {out.num_rows} rows, {len(got)} groups against the "
                f"oracle's {len(want)}")
    bad = []
    with pydec.localcontext() as ctx:
        ctx.prec = 76
        for k, (item_c, class_c) in want.items():
            item = pydec.Decimal(item_c).scaleb(-2)
            ratio = (item * 100 / pydec.Decimal(class_c).scaleb(-2)) \
                .quantize(quant, rounding=pydec.ROUND_HALF_UP)
            if got[k] != (item, ratio):
                bad.append((k, got[k], (item, ratio)))
    return f"q12: {len(bad)} rows differ, first {bad[:1]}" if bad else ""


def main(argv=None) -> int:
    import argparse
    import os
    import tempfile
    import time

    from blaze_tpu_torch import config
    from blaze_tpu_torch.exprs.decimal_arith import HOST_STATS
    from blaze_tpu_torch.itest import tpcds_data as T
    from blaze_tpu_torch.plan.stages import DagScheduler
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    if args.device:
        config.conf.set(config.TORCH_DEVICE.key, args.device)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    names = sorted({t for ts in TABLES.values() for t in ts})
    tables = with_money(T.make_tables(args.scale, names))
    failed = 0
    with tempfile.TemporaryDirectory() as root:
        paths = T.write_splits(tables, os.path.join(root, "data"), 4)
        for name, build, check in (("q01", q01, check_q01),
                                   ("q12", q12, check_q12)):
            plan, oracle = build(paths, tables, 4)
            before = dict(HOST_STATS)
            sched = DagScheduler()
            t0 = time.perf_counter()
            out = sched.run_collect(plan)
            wall = time.perf_counter() - t0
            err = check(out, oracle())
            failed += bool(err)
            print(f"{name}: {wall:.3f} s, {sched.exec_mode}, "
                  f"{len(sched.stages)} stages, {out.num_rows} rows, "
                  f"decimal_arith host rows "
                  f"{HOST_STATS['rows'] - before['rows']} in "
                  f"{HOST_STATS['seconds'] - before['seconds']:.3f} s: "
                  f"{err or 'equal to the exact oracle'}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
