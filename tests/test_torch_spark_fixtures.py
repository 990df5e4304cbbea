"""The seven checked-in Spark plans through the port's front door
(`plan/stages.py` `execute_spark_plan_json`: the port's converter, then
its `DagScheduler`) on the CPU, at scale 0.02, the tables written in the
fixtures' own file layout (itest/spark_fixtures.py).

  * each plan equals its oracle (the port's itest/queries.py oracle of
    the query; the captured Spark 3.5 plan's pandas group-by), as a set
    with floats within 1e-6 relative (the JAX package's fixture test's
    rule), once in the single-task local mode (the default at this size)
    and once staged;
  * (tests/test_torch_spark_fixtures_bytes.py: the q01 fixture's and the
    captured plan's map outputs against the JAX package's, byte for
    byte;)
  * the front door runs on the configured device: with CUDA asked for and
    no card it raises before anything runs;
  * `bridge/runtime.py` `execute_plan` runs the captured plan's converted
    dict one task a partition (its exchange in process), and its operator
    tree all partitions at once, both equal to the oracle.
"""

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import spark_fixtures as SF
from blaze_tpu_torch.plan.stages import execute_spark_plan_json

SCALE = 0.02


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spark_fixtures"))
    tables, paths, _secs = SF.make_data(SCALE, root)
    wants = {n: SF.oracle(n, tables, paths) for n in SF.FIXTURES}
    return root, paths, wants


@pytest.mark.parametrize("mode", ["local", "staged"])
@pytest.mark.parametrize("name", SF.FIXTURES)
def test_fixture_equals_its_oracle(name, mode, data):
    root, paths, wants = data
    if mode == "staged":
        tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    r = SF.run_fixture(name, root, paths, wants[name])
    assert r["exec_mode"] == mode
    assert r["error"] is None, f"{name}: {r['error']}"
    root_class = SF.instantiate(name, root, paths)[0]["class"]
    assert r["classes"][0] == root_class.rsplit(".", 1)[-1]
    if name != "q17":  # the generator's q17 is empty, as its oracle
        assert r["rows"] > 0


def test_the_front_door_runs_on_the_configured_device(data, monkeypatch):
    root, paths, _wants = data
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cuda")
    with pytest.raises(RuntimeError, match="auron.torch.device"):
        execute_spark_plan_json(SF.instantiate("q06", root, paths))


def test_execute_plan_runs_a_converted_plan(data):
    import pyarrow as pa
    from blaze_tpu_torch.bridge.runtime import execute_plan
    from blaze_tpu_torch.convert import convert_spark_plan
    from blaze_tpu_torch.itest.runner import compare_frames
    from blaze_tpu_torch.plan import create_plan
    root, paths, wants = data
    plan = convert_spark_plan(SF.instantiate(SF.CAPTURED, root, paths),
                              SF.NUM_PARTITIONS).plan
    n = create_plan(plan).num_partitions
    per_task = [b for p in range(n) for b in execute_plan(
        {"plan": plan, "partition_id": p, "num_partitions": n})]
    for batches in (per_task, execute_plan(create_plan(plan))):
        got = pa.Table.from_batches(batches).to_pandas()
        assert compare_frames(got, wants[SF.CAPTURED]) is None
