"""UnionExec and BroadcastNestedLoopJoinExec of the port
(blaze_tpu_torch/ops/basic.py, blaze_tpu_torch/ops/joins/bnlj.py) against
the JAX package's (blaze_tpu/ops/basic.py UnionExec,
blaze_tpu/ops/joins/bnlj.py) on the same numpy-seeded parquet inputs,
each planned from the same plan dict by its package's planner, and their
wire encoding against the JAX `proto_serde`.  The JAX package runs with
`blaze_tpu.bridge.placement.host_resident` patched to False (its device
route).

  * UnionExec over children with unequal partition counts (3, 1 and 2
    file groups): every output partition holds the same rows in the same
    order;
  * the nested-loop join for every join type and build side the
    reference allows (existence only with the build on the right), with
    and without a join filter over the joined schema, at
    `auron.batch.size` values that cut the cross product into many
    chunks, and a build side larger than a batch; the probe side has two
    partitions, so the unmatched build rows come from the last one;
  * the join's condition runs on the batch's device (`cpu_batches` here)
    and `output_rows` counts its rows;
  * the wire: a union node, and the nested-loop join as a keyless
    broadcast join, its inner filter lifted into a filter node; an outer
    one with a filter has no encoding in either package.

Tolerance: exact (rows in order, Arrow equality)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu.plan import create_plan as j_create
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.ops.basic import UnionExec
from blaze_tpu_torch.ops.joins.bnlj import BroadcastNestedLoopJoinExec
from blaze_tpu_torch.plan import create_plan as t_create
from blaze_tpu_torch.plan import proto_serde as TP


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.BATCH_SIZE.key)


def _scan(tmp_path, name, table, n_groups):
    """A parquet_scan dict over `table` cut into `n_groups` files."""
    d = tmp_path / name
    os.makedirs(d, exist_ok=True)
    per = -(-table.num_rows // n_groups)
    groups = []
    for i in range(n_groups):
        p = str(d / f"part-{i}.parquet")
        pq.write_table(table.slice(i * per, per), p)
        groups.append([p])
    types = {pa.int64(): "int64", pa.float64(): "float64",
             pa.string(): "utf8", pa.int32(): "int32"}
    return {"kind": "parquet_scan", "file_groups": groups,
            "schema": {"fields": [{"name": f.name,
                                   "type": {"id": types[f.type]},
                                   "nullable": True}
                                  for f in table.schema]}}


def _collect(plan):
    """Every partition's output, in order: a list of Arrow tables."""
    out = []
    for p in range(plan.num_partitions):
        batches = list(plan.arrow_batches(p))
        out.append(pa.Table.from_batches(batches, schema=batches[0].schema)
                   if batches else None)
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.num_rows == w.num_rows
            assert g.cast(w.schema).equals(w), (g, w)


def _table(rng, n, prefix, null_every=7):
    keys = rng.integers(0, 12, n)
    mask = np.arange(n) % null_every == 3
    return pa.table({
        f"{prefix}_k": pa.array(keys, mask=mask),
        f"{prefix}_x": pa.array(np.round(rng.normal(size=n) * 10, 2)),
        f"{prefix}_s": pa.array([f"{prefix}{v}" for v in
                                 rng.integers(0, 5, n)])})


def test_union_with_unequal_partition_counts(tmp_path):
    rng = np.random.default_rng(1)
    kids = [_scan(tmp_path, f"u{i}", _table(rng, n, "a"), g)
            for i, (n, g) in enumerate(((90, 3), (25, 1), (40, 2)))]
    d = {"kind": "union", "inputs": kids}
    got_plan = t_create(d)
    assert isinstance(got_plan, UnionExec)
    assert got_plan.num_partitions == 3
    got = _collect(got_plan)
    _same(got, _collect(j_create(d)))
    # partition 0 holds each child's first partition, in child order
    assert got[0].num_rows == 30 + 25 + 20
    assert got[2].num_rows == 30


JOIN_TYPES = ["inner", "left", "right", "full", "left_semi", "left_anti",
              "right_semi", "right_anti", "existence"]

#: l_x < r_x over the joined schema (l_k, l_x, l_s, r_k, r_x, r_s), and an
#: equality that nulls never pass
FILTERS = {
    "none": None,
    "lt": {"kind": "binary", "op": "<", "l": {"kind": "column", "index": 1},
           "r": {"kind": "column", "index": 4}},
    "eq": {"kind": "binary", "op": "==", "l": {"kind": "column", "index": 0},
           "r": {"kind": "column", "index": 3}},
}


def _bnlj(tmp_path, jt, build, flt, n_left=70, n_right=9):
    rng = np.random.default_rng(n_left * 13 + n_right)
    left = _scan(tmp_path, f"l{n_left}", _table(rng, n_left, "l"), 2)
    right = _scan(tmp_path, f"r{n_right}", _table(rng, n_right, "r", 4),
                  2 if build == "left" else 1)
    d = {"kind": "broadcast_nested_loop_join", "join_type": jt,
         "build_side": build, "left": left, "right": right}
    if flt is not None:
        d["join_filter"] = flt
    return d


def _cases():
    for jt in JOIN_TYPES:
        for build in ("left", "right"):
            if jt == "existence" and build == "left":
                continue
            for flt in FILTERS:
                yield jt, build, flt


@pytest.mark.parametrize("jt,build,flt", list(_cases()))
def test_nested_loop_join_equals_the_jax_one(tmp_path, jt, build, flt):
    for c in (jconf, tconf):  # 64 pairs a chunk: 7 probe rows of 9
        c.conf.set(c.BATCH_SIZE.key, 64)
    d = _bnlj(tmp_path, jt, build, FILTERS[flt])
    plan = t_create(d)
    assert isinstance(plan, BroadcastNestedLoopJoinExec)
    got = _collect(plan)
    _same(got, _collect(j_create(d)))
    rows = sum(t.num_rows for t in got if t is not None)
    assert plan.metrics.values["output_rows"] == rows
    if flt != "none":  # the condition ran on the batches' device
        assert plan.metrics.values["cpu_batches"] > 0
        assert plan.metrics.values.get("cuda_batches", 0) == 0


@pytest.mark.parametrize("jt", ["inner", "left", "full", "right_anti"])
def test_a_build_side_larger_than_a_batch(tmp_path, jt):
    """100 build rows against a 32-row batch: each probe row meets the
    build side in slices; rows and order as the JAX join's."""
    for c in (jconf, tconf):
        c.conf.set(c.BATCH_SIZE.key, 32)
    d = _bnlj(tmp_path, jt, "right", FILTERS["lt"], n_left=20, n_right=100)
    _same(_collect(t_create(d)), _collect(j_create(d)))


def test_existence_with_the_build_on_the_left_raises(tmp_path):
    d = _bnlj(tmp_path, "existence", "left", None)
    with pytest.raises(ValueError, match="existence"):
        t_create(d)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

def _one_group(d):
    """The dict with every scan carrying one file group (the wire
    carries one a task)."""
    if d.get("kind") == "parquet_scan":
        return dict(d, file_groups=[d["file_groups"][0]])
    out = dict(d)
    for k, v in d.items():
        if isinstance(v, dict):
            out[k] = _one_group(v)
        elif k == "inputs":
            out[k] = [_one_group(x) for x in v]
    return out


def _wire(tmp_path):
    rng = np.random.default_rng(5)
    a = _scan(tmp_path, "wa", _table(rng, 20, "a"), 1)
    b = _scan(tmp_path, "wb", _table(rng, 20, "a"), 1)
    union = {"kind": "union", "inputs": [a, b, a],
             "input_partitions": [0, 0, 0], "num_partitions": 1,
             "cur_partition": 0}
    plain = _bnlj(tmp_path, "inner", "right", None)
    lifted = _bnlj(tmp_path, "inner", "right", FILTERS["lt"])
    lifted["broadcast_id"] = "bnlj-wire-1"
    left = _bnlj(tmp_path, "left_anti", "left", None)
    return {"union": union, "bnlj": plain, "bnlj filter": lifted,
            "bnlj left anti": left}


@pytest.mark.parametrize("case", ["union", "bnlj", "bnlj filter",
                                  "bnlj left anti"])
def test_wire_round_trip(tmp_path, case):
    """The port's bytes are the JAX package's, and both decode them to
    the same dict; that dict plans in the port."""
    d = _one_group(_wire(tmp_path)[case])
    tbytes = TP.plan_to_proto(d).SerializeToString()
    assert tbytes == JP.plan_to_proto(d).SerializeToString()
    got = TP.plan_from_proto(TP.pb.PhysicalPlanNode.FromString(tbytes))
    assert got == JP.plan_from_proto(JP.pb.PhysicalPlanNode.FromString(
        tbytes))
    if case == "bnlj filter":  # the inner join's filter, lifted
        assert got["kind"] == "filter"
        assert got["input"]["kind"] == "broadcast_nested_loop_join"
    plan = t_create(got)
    assert plan.schema.names == j_create(got).schema.names


def test_an_outer_nested_loop_join_with_a_filter_has_no_wire(tmp_path):
    d = _one_group(_bnlj(tmp_path, "left", "right", FILTERS["lt"]))
    for P in (TP, JP):
        with pytest.raises(ValueError, match="no wire encoding"):
            P.plan_to_proto(d)
