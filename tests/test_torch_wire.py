"""The port's plan wire (blaze_tpu_torch/plan/proto_serde.py) against the
JAX package's: the same TaskDefinition dicts encode to the same bytes,
and the same bytes decode to equal dicts in both packages; the port's
copies of the q01 stage functions equal bench.py's.  The stages of q01's
two branches (itest/q01_branches.py: avg aggregations, `*`, sort with
fetch, limit) and a limit with an offset round-trip the same way."""

import pytest

import bench
from blaze_tpu.plan import proto_serde as JP
from blaze_tpu.plan.planner import decode_task_definition as j_decode
from blaze_tpu_torch.itest import q01
from blaze_tpu_torch.itest import q01_branches as QB
from blaze_tpu_torch.plan import proto_serde as TP
from blaze_tpu_torch.plan.planner import decode_task_definition as t_decode

PATHS = [f"/data/store_returns_{i}.parquet" for i in range(4)]


def _tds():
    tds = [q01.stage1_td(PATHS, 2451545, 2451909, m, "/tmp/shuffle", 4, 16)
           for m in range(4)]
    tds += [q01.stage2_td(r, 16) for r in (0, 15)]
    # a project node and a single partitioning, beside q01's own nodes
    tds.append({"stage_id": 3, "partition_id": 0, "plan": {
        "kind": "shuffle_writer", "partitioning": {"kind": "single"},
        "data_file": "/tmp/x.data", "index_file": "/tmp/x.index",
        "input": {"kind": "project",
                  "exprs": [{"kind": "column", "index": 1},
                            {"kind": "binary", "op": "<",
                             "l": {"kind": "column", "index": 0},
                             "r": {"kind": "literal", "value": 2.5,
                                   "type": {"id": "float64"}}}],
                  "names": ["a", "b"],
                  "input": q01.stage2_td(0, 2)["plan"]["input"]}}})
    tds += [QB.ctr_td(1, 16, "/tmp/ctr"), QB.avg_td(2, 16, "/tmp/avg"),
            QB.avg_limit_td(), QB.top_td(3, 16, "/tmp/top"),
            QB.top_limit_td()]
    # a limit with an offset over a sort with nulls last on ASC
    tds.append({"stage_id": 7, "partition_id": 0, "plan": {
        "kind": "limit", "limit": 5, "offset": 3,
        "input": {"kind": "sort", "specs": [
            {"expr": {"kind": "column", "index": 0}, "descending": False,
             "nulls_first": False}],
            "input": q01.stage2_td(0, 2)["plan"]["input"]}}})
    return tds


def test_port_stage_builders_equal_bench():
    for m in range(4):
        assert q01.stage1_td(PATHS, 1, 9, m, "/t", 4, 16) == \
            bench.stage1_td(PATHS, 1, 9, m, "/t", 4, 16)
    assert q01.stage2_td(3, 16) == bench.stage2_td(3, 16)
    assert q01.SR_SCHEMA_D == bench.SR_SCHEMA_D
    assert q01.PARTIAL_SCHEMA_D == bench.PARTIAL_SCHEMA_D


@pytest.mark.parametrize("i", range(13))
def test_same_bytes_decode_to_equal_dicts(i):
    td = _tds()[i]
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    assert t_decode(data) == j_decode(data)
    # and the decoded dict re-encodes to the same bytes
    assert TP.task_definition_to_bytes(t_decode(data)) == data


def test_out_of_slice_nodes_raise():
    """coalesce_batches, out of slice until the plan-kinds slice, encodes
    to the JAX bytes, decodes to the JAX dict and runs as the JAX node
    over the same rows; a kind still unported (rss_shuffle_writer,
    ROADMAP item 16) raises both ways."""
    import pyarrow as pa
    from blaze_tpu.bridge.resource import put_resource as j_put
    from blaze_tpu.plan.planner import create_plan as j_create
    from blaze_tpu_torch import config as tconf
    from blaze_tpu_torch.bridge.resource import put_resource as t_put
    from blaze_tpu_torch.plan.planner import create_plan as t_create
    inp = {"kind": "ffi_reader", "resource_id": "wire-coalesce",
           "schema": q01.PARTIAL_SCHEMA_D, "num_partitions": 1}
    td = {"plan": {"kind": "coalesce_batches", "batch_size": 1024,
                   "input": inp}}
    data = JP.task_definition_to_bytes(td)
    assert TP.task_definition_to_bytes(td) == data
    assert t_decode(data) == j_decode(data)
    batches = [pa.record_batch({
        "ctr_customer_sk": pa.array(range(i, i + n), type=pa.int64()),
        "ctr_store_sk": pa.array([i % 7] * n, type=pa.int64()),
        "ctr_total_return.sum": pa.array([0.5 * i] * n)})
        for i, n in enumerate((300, 400, 900, 5, 2000))]
    j_put("wire-coalesce", batches)
    t_put("wire-coalesce", batches)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    try:
        want = [b.compact().to_arrow()
                for b in j_create(j_decode(data)["plan"]).execute(0)]
        got = [b.compact().to_arrow()
               for b in t_create(t_decode(data)["plan"]).execute(0)]
    finally:
        tconf.conf.unset(tconf.TORCH_DEVICE.key)
    assert [b.num_rows for b in got] == [b.num_rows for b in want] == \
        [1600, 2005]
    assert all(g.equals(w) for g, w in zip(got, want))
    sink = {"plan": {"kind": "rss_shuffle_writer", "rss_resource_id": "rss",
                     "partitioning": {"kind": "single",
                                      "num_partitions": 1},
                     "input": inp}}
    with pytest.raises(NotImplementedError, match="later slice"):
        TP.task_definition_to_bytes(sink)
    with pytest.raises(NotImplementedError, match="later slice"):
        t_decode(JP.task_definition_to_bytes(sink))
