"""Device selection and kernel routing of the port: `auron.torch.device`
picks the device and CUDA without a card raises; CPU tensors take the
plain versions; the kernel wrappers validate their operands and a missing
toolchain raises instead of falling back; bounded keys take the dense lane
as in the JAX package, string keys take the dict-device lane, and what
the port lacks (the scan's dictionary encoder) raises NotImplementedError
instead of rerouting."""

import copy

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu_torch import config
from blaze_tpu_torch.device import resolve
from blaze_tpu_torch.kernels import build, hash_update, lane, radix


@pytest.fixture
def device_key():
    yield lambda v: config.conf.set(config.TORCH_DEVICE.key, v)
    config.conf.unset(config.TORCH_DEVICE.key)


def test_default_device_is_cuda_and_raises_without_a_card(device_key):
    assert config.TORCH_DEVICE.get() == "cuda"
    if torch.cuda.is_available():
        assert resolve().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="auron.torch.device"):
        resolve()
    from blaze_tpu_torch.bridge.runtime import NativeExecutionRuntime
    from blaze_tpu_torch.itest import q01
    with pytest.raises(RuntimeError, match="is_available"):
        NativeExecutionRuntime(q01.stage2_td(0, 1))
    device_key("cpu")
    assert resolve() == torch.device("cpu")
    device_key("meta")
    with pytest.raises(ValueError):
        resolve()


def test_route_by_tensor_device():
    assert lane.route(torch.zeros(1)) == "plain"
    with pytest.raises(ValueError):
        lane.route(torch.zeros(1, device="meta"))


def test_wrappers_reject_bad_operands():
    n, L, S = 8, 3, 16
    i32 = dict(dtype=torch.int32)
    b8 = dict(dtype=torch.bool)
    # place_in_carry's operands: h, limbs, mask, used, tab, probe rounds
    good = [torch.zeros(n, **i32), torch.zeros(L, n, **i32),
            torch.zeros(n, **b8), torch.zeros(S, **b8),
            torch.zeros(L, S, **i32), 16]
    hash_update._check_operands(*good)
    hash_update._check_operands(torch.zeros(n, dtype=torch.int64),
                                *good[1:])
    for i, bad in [(0, torch.zeros(n, dtype=torch.int16)),
                   (1, torch.zeros(L + 1, n, **i32)),
                   (2, torch.zeros(n, **i32)),
                   (4, torch.zeros(S, L, **i32).t()),
                   (3, torch.zeros(S - 1, **b8)),
                   (5, 0)]:
        ops = list(good)
        ops[i] = bad
        if i == 3:
            ops[4] = torch.zeros(L, S - 1, **i32)
        with pytest.raises((TypeError, ValueError)):
            hash_update._check_operands(*ops)
    with pytest.raises(ValueError, match="int32"):
        radix._partition_ranks_cuda(torch.zeros(8, dtype=torch.int64), 4, 8)
    with pytest.raises(ValueError, match="partitions"):
        radix._partition_ranks_cuda(torch.zeros(8, **i32), 0, 8)


def test_missing_toolchain_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("radix")
    assert build._libs == {}
    with pytest.raises(RuntimeError, match="cudaError 2"):
        build.check(2, "probe")


def _agg_plan(tmp_path, customers, keys=("sr_customer_sk", "sr_store_sk")):
    import pyarrow.parquet as pq
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.plan import create_plan
    rng = np.random.default_rng(0)
    n = 1000
    path = str(tmp_path / "sr.parquet")
    pq.write_table(pa.table({
        "sr_returned_date_sk": rng.integers(0, 9, n),
        "sr_customer_sk": rng.integers(1, customers + 1, n),
        "sr_store_sk": rng.integers(1, 13, n),
        "sr_return_amt": rng.random(n),
        "sr_ticket_number": np.arange(n),
        "s_name": [f"s{i % 7}" for i in range(n)]}), path)
    # a copy: the builder shares q01.SR_SCHEMA_D, which is edited below
    td = copy.deepcopy(q01.stage1_td([path], 0, 9, 0, str(tmp_path), 1, 4))
    agg = td["plan"]["input"]
    agg["groupings"] = [{"expr": {"kind": "column", "name": k}, "name": k}
                        for k in keys]
    scan = agg["input"]["input"]
    scan["schema"]["fields"].append(
        {"name": "s_name", "type": {"id": "utf8"}, "nullable": True})
    scan["projection"].append("s_name")
    return create_plan(td["plan"])


def test_lanes_outside_the_slice_raise(tmp_path, device_key):
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec, fuse_plan
    device_key("cpu")
    # 100,000 customers x 13 stores over 1,000 rows: the ranges drop
    plan = fuse_plan(_agg_plan(tmp_path, 100_000))
    assert isinstance(plan.children[0], FusedPartialAggExec)
    assert plan.children[0].fused_mode == "sorted"
    # 50 customers: the dense lane, as the JAX package plans it
    dense = fuse_plan(_agg_plan(tmp_path, 50)).children[0]
    assert isinstance(dense, FusedPartialAggExec)
    assert dense.fused_mode == "dense" and dense._mxu_meta is not None
    # a utf8 key: the dict-device lane, or the generic engine with the
    # lane off
    var = fuse_plan(_agg_plan(tmp_path, 100_000, keys=("s_name",)))
    assert isinstance(var.children[0], FusedPartialAggExec)
    assert var.children[0]._has_var_keys
    config.conf.set(config.FUSED_DICT_DEVICE_ENABLE.key, False)
    try:
        off = fuse_plan(_agg_plan(tmp_path, 100_000, keys=("s_name",)))
        assert type(off.children[0]).__name__ == "AggExec"
    finally:
        config.conf.unset(config.FUSED_DICT_DEVICE_ENABLE.key)
    config.conf.set(config.ENCODING_DICT_ENABLE.key, True)
    try:
        with pytest.raises(NotImplementedError, match="item 13"):
            _agg_plan(tmp_path, 100_000, keys=("s_name",))
    finally:
        config.conf.unset(config.ENCODING_DICT_ENABLE.key)
