"""The port's scan predicate, row-group pruning, Hive partition columns
and footer cache (blaze_tpu_torch/ops/pruning.py, ops/scan.py) against
the JAX package's, on the CPU with seeded numpy data in small row
groups:

  * `prune_with_stats`, `split_covered`, `groups_always_match` and
    `split_may_match` keep the same row groups over `<`, `<=`, `=`, `>`,
    `>=` (the literal on either side), `and`, `or`, `in`, `is null` and
    `is not null` on int, float (NaN), date and utf8 columns with nulls
    and an all-null group;
  * a scan with each predicate under a filter gives the JAX rows and
    batches, and its `pruned_row_groups` equals the JAX scan's; with
    `auron.parquet.enable.pageFiltering` off nothing is pruned;
  * a scan with partition columns (projected among the file columns,
    unprojected, and with a file's values missing or short) null-fills
    as the JAX scan does;
  * the footer cache refreshes a file whose mtime moved and evicts down
    to `auron.parquet.metadataCacheSize`;
  * column pruning narrows a scan and keeps its predicate, and leaves a
    scan with partition columns alone, as the JAX pass does.

The JAX package runs its device route
(`blaze_tpu.bridge.placement.host_resident` patched to False)."""

import datetime
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu_torch import config as tconf

ROWS, RG = 400, 50
BATCH = 64


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    for c in (jconf, tconf):
        c.conf.set("auron.batch.size", BATCH)
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset("auron.batch.size")


def _table(seed=4):
    rng = np.random.default_rng(seed)
    i = np.sort(rng.integers(0, 1000, ROWS))
    i_mask = np.zeros(ROWS, bool)
    i_mask[100:150] = True            # one all-null group
    i_mask[rng.random(ROWS) < 0.03] = True
    f = np.sort(rng.random(ROWS)) * 2 - 0.5
    f[rng.random(ROWS) < 0.05] = np.nan
    d = np.sort(rng.integers(10950, 11400, ROWS)).astype(np.int32)
    words = sorted(f"{chr(97 + k % 26)}{k:03d}" for k in range(ROWS))
    return pa.table({
        "i": pa.array(i, mask=i_mask),
        "f": pa.array(f, mask=rng.random(ROWS) < 0.05),
        "d": pa.array(d, type=pa.date32()),
        "s": pa.array(words, mask=rng.random(ROWS) < 0.05),
    })


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("scan_pruning")
    t = _table()
    paths = []
    for k in range(2):
        p = str(root / f"part-{k}.parquet")
        pq.write_table(t.slice(k * ROWS // 2, ROWS // 2), p,
                       row_group_size=RG)
        paths.append(p)
    return t, paths


def col(n):
    return {"kind": "column", "name": n}


def lit(v, tid):
    return {"kind": "literal", "value": v, "type": {"id": tid}}


def cmp(op, name, v, tid, flip=False):
    a, b = col(name), lit(v, tid)
    return {"kind": "binary", "op": op, "l": b if flip else a,
            "r": a if flip else b}


def both(op, x, y):
    return {"kind": "binary", "op": op, "l": x, "r": y}


D = datetime.date
PREDICATES = {
    "int <": cmp("<", "i", 120, "int64"),
    "int <=": cmp("<=", "i", 300, "int64"),
    "int =": cmp("==", "i", 500, "int64"),
    "int >": cmp(">", "i", 800, "int64"),
    "int >=": cmp(">=", "i", 990, "int64"),
    "int literal first": cmp(">", "i", 200, "int64", flip=True),
    "float <": cmp("<", "f", 0.0, "float64"),
    "float >=": cmp(">=", "f", 1.2, "float64"),
    "float =": cmp("==", "f", 0.75, "float64"),
    "date =": cmp("==", "d", D(2000, 3, 1), "date32"),
    "date >": cmp(">", "d", D(2000, 10, 1), "date32"),
    # a day count against date statistics: neither package compares them
    # (TypeError: every group kept)
    "date > days": cmp(">", "d", 11200, "date32"),
    "date <=": cmp("<=", "d", D(2000, 2, 1), "date32"),
    "utf8 <": cmp("<", "s", "c", "utf8"),
    "utf8 =": cmp("==", "s", "m012", "utf8"),
    "utf8 >": cmp(">", "s", "x", "utf8"),
    "and": both("and", cmp(">", "i", 300, "int64"),
                cmp("<", "f", 0.9, "float64")),
    "or": both("or", cmp("<", "i", 50, "int64"),
               cmp(">=", "s", "y", "utf8")),
    "and of or": both("and", both("or", cmp("<", "i", 100, "int64"),
                                  cmp(">", "i", 900, "int64")),
                      {"kind": "is_not_null", "child": col("s")}),
    "in": {"kind": "in_list", "child": col("i"), "values": [4, 653, 2000],
           "negated": False},
    "is null": {"kind": "is_null", "child": col("i")},
    "is not null": {"kind": "is_not_null", "child": col("i")},
    "not (kept whole)": {"kind": "not",
                         "child": cmp("<", "i", 500, "int64")},
}


def _schemas(table):
    from blaze_tpu.schema import Schema as JS
    from blaze_tpu_torch.schema import Schema as TS
    return JS.from_arrow(table.schema), TS.from_arrow(table.schema)


def _exprs(d, table):
    from blaze_tpu.plan.exprs import expr_from_dict as j_expr
    from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
    js, ts = _schemas(table)
    return j_expr(d, js), t_expr(d, ts)


@pytest.mark.parametrize("name", list(PREDICATES))
def test_pruning_equals_the_jax_package(name, data):
    from blaze_tpu.ops import pruning as JP
    from blaze_tpu_torch.ops import pruning as TP
    table, paths = data
    js, ts = _schemas(table)
    je, te = _exprs(PREDICATES[name], table)
    pruned_any = False
    for p in paths:
        md = pq.ParquetFile(p).metadata
        groups = list(range(md.num_row_groups))
        kept = TP.prune_with_stats(md, ts, te, groups)
        assert kept == JP.prune_with_stats(md, js, je, groups)
        assert TP.split_covered(md, ts, te, groups) == \
            JP.split_covered(md, js, je, groups)
        assert TP.groups_always_match(md, ts, te, kept) == \
            JP.groups_always_match(md, js, je, kept)
        pruned_any |= len(kept) < len(groups)
    assert pruned_any == (name not in ("is not null", "not (kept whole)",
                                       "date > days")), name
    for consts in ({"i": 5}, {"i": None}, {"s": "zz"}, {}):
        assert TP.split_may_match(te, ts, consts) == \
            JP.split_may_match(je, js, consts)


def _scan(paths, table, pred=None, **kw):
    from blaze_tpu_torch.plan.types import schema_to_dict
    from blaze_tpu_torch.schema import Schema
    d = {"kind": "parquet_scan",
         "schema": schema_to_dict(Schema.from_arrow(table.schema)),
         "file_groups": [[p] for p in paths], **kw}
    if pred is not None:
        d["predicate"] = pred
    return d


def _run_both(plan):
    """Every partition of `plan` planned by both packages: the batches
    (compacted Arrow) of each, and each tree's summed metric values."""
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    out = []
    for create in (j_create, t_create):
        p = create(plan)
        batches = [[b.compact().to_arrow() for b in p.execute(i)]
                   for i in range(p.num_partitions)]
        metrics = {}

        def add(node):
            for k, v in node.values.items():
                metrics[k] = metrics.get(k, 0) + v
            for c in node.children:
                add(c)
        add(p.collect_metrics())
        out.append((batches, metrics))
    return out


def _same_batches(a, b):
    assert [len(x) for x in a] == [len(x) for x in b]
    for xs, ys in zip(a, b):
        for x, y in zip(xs, ys):
            assert x.num_rows == y.num_rows
            assert x.equals(y) or _nan_equal(x, y)


def _nan_equal(x, y):
    for u, v in zip(x.columns, y.columns):
        if pa.types.is_floating(u.type):
            if not np.array_equal(np.asarray(u.fill_null(-7.0)),
                                  np.asarray(v.fill_null(-7.0)),
                                  equal_nan=True):
                return False
        elif not u.equals(v):
            return False
    return True


@pytest.mark.parametrize("name", ["int <", "float <", "date > days",
                                  "utf8 =", "and", "or", "is null", "in"])
def test_scans_under_a_filter_equal_the_jax_package(name, data):
    table, paths = data
    pred = PREDICATES[name]
    plan = {"kind": "filter", "predicates": [pred],
            "input": _scan(paths, table, pred)}
    (jb, jm), (tb, tm) = _run_both(plan)
    _same_batches(tb, jb)
    assert tm["pruned_row_groups"] == jm["pruned_row_groups"]
    md = [pq.ParquetFile(p).metadata for p in paths]
    assert tm["pruned_row_groups"] < sum(m.num_row_groups for m in md)
    assert (tm["pruned_row_groups"] > 0) == (name != "date > days")
    # with the key off nothing is pruned, and the rows are the same
    for c in (jconf, tconf):
        c.conf.set("auron.parquet.enable.pageFiltering", False)
    try:
        (jb2, jm2), (tb2, tm2) = _run_both(plan)
    finally:
        for c in (jconf, tconf):
            c.conf.unset("auron.parquet.enable.pageFiltering")
    assert tm2["pruned_row_groups"] == jm2["pruned_row_groups"] == 0
    _same_batches(tb2, jb2)
    whole = [pa.Table.from_batches([b for bs in x for b in bs],
                                   schema=table.schema).combine_chunks()
             for x in (tb2, tb)]
    assert whole[0].num_rows > 0 and _nan_equal(*whole)


def test_a_projected_scan_keeps_its_predicate(data):
    table, paths = data
    pred = PREDICATES["int <"]
    plan = _scan(paths, table, pred, projection=["s", "i"])
    (jb, jm), (tb, tm) = _run_both(plan)
    _same_batches(tb, jb)
    assert tm["pruned_row_groups"] == jm["pruned_row_groups"] > 0


PART_SCHEMA = {"fields": [
    {"name": "region", "type": {"id": "utf8"}, "nullable": True},
    {"name": "day", "type": {"id": "date32"}, "nullable": True},
    {"name": "n", "type": {"id": "int32"}, "nullable": True}]}


@pytest.mark.parametrize("case", ["projected", "unprojected", "partial",
                                  "missing group", "with predicate"])
def test_partition_columns_equal_the_jax_package(case, data):
    table, paths = data
    values = [[["eu", D(2024, 1, 2), 7]], [["us", D(2024, 1, 3), None]]]
    kw = {"partition_schema": PART_SCHEMA, "partition_values": values}
    pred = None
    if case == "projected":
        kw["projection"] = ["day", "i", "region", "s"]
    elif case == "partial":
        kw["partition_values"] = [[["eu"]], [[]]]
        kw["projection"] = ["n", "region", "f", "day"]
    elif case == "missing group":
        kw["partition_values"] = [values[0]]
    elif case == "with predicate":
        pred = PREDICATES["int <"]
        kw["projection"] = ["d", "region", "n"]
    plan = _scan(paths, table, pred, **kw)
    (jb, jm), (tb, tm) = _run_both(plan)
    _same_batches(tb, jb)
    assert tm.get("pruned_row_groups", 0) == jm.get("pruned_row_groups", 0)
    got = pa.Table.from_batches([b for bs in tb for b in bs])
    if case == "partial":
        assert got["n"].null_count == got.num_rows
        assert got["region"].null_count == ROWS // 2
    if case == "with predicate":
        assert tm["pruned_row_groups"] > 0


def test_the_footer_cache_refreshes_and_evicts(tmp_path):
    from blaze_tpu_torch.ops import scan as S
    S._META_CACHE.clear()
    paths = []
    for k in range(3):
        p = str(tmp_path / f"f{k}.parquet")
        pq.write_table(pa.table({"x": np.arange(10 + k)}), p)
        paths.append(p)
    md0 = S.parquet_metadata(paths[0])
    assert S.parquet_metadata(paths[0]) is md0 and len(S._META_CACHE) == 1
    # rewritten in place with a later mtime: the entry refreshes
    pq.write_table(pa.table({"x": np.arange(99)}), paths[0])
    st = os.stat(paths[0])
    os.utime(paths[0], (st.st_atime, st.st_mtime + 10))
    md1 = S.parquet_metadata(paths[0])
    assert md1 is not md0 and md1.num_rows == 99
    assert len(S._META_CACHE) == 1
    tconf.conf.set("auron.parquet.metadataCacheSize", 2)
    try:
        for p in paths:
            S.parquet_metadata(p)
        assert len(S._META_CACHE) == 2
        # the least recently used (paths[0]) went first
        assert S._META_CACHE.get(paths[0], os.path.getmtime(paths[0])) \
            is None
        assert S._META_CACHE.get(paths[2], os.path.getmtime(paths[2])) \
            is not None
    finally:
        tconf.conf.unset("auron.parquet.metadataCacheSize")
        S._META_CACHE.clear()


def test_a_remote_path_names_its_item():
    from blaze_tpu_torch.ops.scan import open_source
    assert open_source("/x/y.parquet") == "/x/y.parquet"
    with pytest.raises(NotImplementedError, match="item 16"):
        open_source("hdfs://nn/x.parquet")


@pytest.mark.parametrize("partitioned", [False, True])
def test_column_pruning_keeps_the_predicate(partitioned, data):
    """prune_columns narrows a plain scan to the columns used above it and
    keeps its predicate (the rows pruned stay pruned); a scan with
    partition columns is left as it is; both as the JAX pass."""
    from blaze_tpu.plan.column_pruning import prune_columns as j_prune
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch.plan.column_pruning import prune_columns as t_prune
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    table, paths = data
    pred = PREDICATES["int <"]
    kw = ({"partition_schema": PART_SCHEMA,
           "partition_values": [[["eu", None, 1]], [["us", None, 2]]]}
          if partitioned else {})
    plan = {"kind": "project", "exprs": [col("s")], "names": ["s"],
            "input": {"kind": "filter", "predicates": [pred],
                      "input": _scan(paths, table, pred, **kw)}}
    jp, tp = j_prune(j_create(plan)), t_prune(t_create(plan))
    jscan, tscan = jp.children[0].children[0], tp.children[0].children[0]
    assert [f.name for f in tscan.schema] == [f.name for f in jscan.schema]
    assert (tscan._predicate is None) == (jscan._predicate is None) is False
    assert [f.name for f in tscan.schema] == (
        ["i", "f", "d", "s", "region", "day", "n"] if partitioned
        else ["i", "s"])
    got = [b.compact().to_arrow() for i in range(tp.num_partitions)
           for b in tp.execute(i)]
    want = [b.compact().to_arrow() for i in range(jp.num_partitions)
            for b in jp.execute(i)]
    assert pa.Table.from_batches(got).equals(pa.Table.from_batches(want))
    assert tscan.metrics.values["pruned_row_groups"] == \
        jscan.metrics.values["pruned_row_groups"] > 0
