"""The q01 fixture and the captured Spark 3.5 plan through both front
doors, staged, on the CPU at scale 0.02 over the fixtures' own file
layout (itest/spark_fixtures.py): every map output's `.data` and `.index`
bytes from the port's `execute_spark_plan_json` equal those of the JAX
package's on the same files.  The JAX package runs on its device route
(`host_resident` patched to False, as tests/test_torch_join.py `confs`
does) with its device exchange off, so it writes shuffle files to compare.
(tests/test_torch_spark_fixtures.py holds all seven plans to their
oracles.)
"""

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import spark_fixtures as SF
from blaze_tpu_torch.plan.stages import DagScheduler, execute_spark_plan_json

SCALE = 0.02


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spark_fixtures_bytes"))
    _tables, paths, _secs = SF.make_data(SCALE, root,
                                         ["q01", SF.CAPTURED])
    return root, paths


def _recording(base):
    """`base` (either package's DagScheduler) keeping the bytes of every
    committed map output, by (stage, map task, file suffix)."""
    class Recording(base):
        def __init__(self, work_dir=None):
            super().__init__(work_dir)
            self.outputs = {}

        def _run_map_task(self, stage, part, m):
            super()._run_map_task(stage, part, m)
            data = self._map_data_path(stage.sid, m)
            for suffix, path in (("data", data),
                                 ("index", data[:-5] + ".index")):
                with open(path, "rb") as f:
                    self.outputs[(stage.sid, m, suffix)] = f.read()
    return Recording


def _jax_front_door(plan_json):
    """The JAX package's execute_spark_plan_json, staged, on its device
    route; returns its table and its map outputs."""
    import blaze_tpu.bridge.placement as P
    import blaze_tpu.plan.stages as JST
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    recording = _recording(JST.DagScheduler)
    made = []

    def make(work_dir=None):
        made.append(recording(work_dir))
        return made[-1]
    saved = P.host_resident, JST.DagScheduler
    P.host_resident = lambda: False
    JST.DagScheduler = make
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    jconf.conf.set(jconf.SHUFFLE_DEVICE.key, "off")
    try:
        out = JST.execute_spark_plan_json(plan_json, SF.NUM_PARTITIONS)
    finally:
        P.host_resident, JST.DagScheduler = saved
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)
        jconf.conf.unset(jconf.SHUFFLE_DEVICE.key)
    return out, made[0].outputs


@pytest.mark.parametrize("name", ["q01", SF.CAPTURED])
def test_map_outputs_are_the_jax_bytes(name, data):
    root, paths = data
    plan_json = SF.instantiate(name, root, paths)
    sched = _recording(DagScheduler)()
    got = execute_spark_plan_json(plan_json, SF.NUM_PARTITIONS,
                                  scheduler=sched)
    jax_out, jax_maps = _jax_front_door(plan_json)
    assert got.num_rows == jax_out.num_rows > 0
    assert sched.outputs and sorted(sched.outputs) == sorted(jax_maps)
    for key in sorted(jax_maps):
        assert sched.outputs[key] == jax_maps[key], key
