"""Full TPC-DS q01 through the port's stage DAG (blaze_tpu_torch/plan/
stages.py DagScheduler) against its pandas oracle and the JAX package's
DagScheduler on the same plan and data (scale 0.2, 2 file splits, 2
exchange partitions), with task retry (bridge/tasks.py) and lineage
recovery.

Both schedulers run with `auron.tpu.dag.singleTaskBytes` = 0: both
would otherwise run so small a query as one local task
(tests/test_torch_local_mode.py holds that mode).

Tolerance: exact.  The 100 c_customer_id of q01 are compared in order,
with the device stage loop off (the staged executor) and forced on."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.itest import q01_dag as QD
from blaze_tpu_torch.itest import queries as TQ
from blaze_tpu_torch.itest.runner import compare_frames, same_order
from blaze_tpu_torch.itest.tpcds_data import make_tables, write_parquet_splits
from blaze_tpu_torch.plan.stages import DagScheduler

SCALE = 0.2
PARTS = 2
LOOP = tconf.STAGE_DEVICE_LOOP_ENABLE.key


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    tconf.conf.set(tconf.TASK_RETRY_BACKOFF_MS.key, 0)
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.TASK_RETRY_BACKOFF_MS, tconf.STAGE_DEVICE_LOOP_ENABLE,
                tconf.STAGE_MAX_RECOVERIES, tconf.TASK_MAX_ATTEMPTS):
        tconf.conf.unset(opt.key)


@pytest.fixture(scope="module")
def q01(tmp_path_factory):
    """The plan, the pandas oracle's frame and the JAX DagScheduler's."""
    tables = make_tables(SCALE, QD.TABLES)
    paths = write_parquet_splits(tables, str(tmp_path_factory.mktemp("q01")),
                                 PARTS)
    plan, oracle = TQ.q01(paths, tables, partitions=PARTS)
    return plan, oracle(), _jax_run(plan)


def _jax_run(plan):
    from blaze_tpu import config as jconf
    from blaze_tpu.memory import MemManager
    from blaze_tpu.plan.stages import DagScheduler as JDag
    MemManager.init(4 << 30)
    jconf.conf.set(jconf.DAG_SINGLE_TASK_BYTES.key, 0)
    try:
        return _frame(JDag().run_collect(plan))
    finally:
        jconf.conf.unset(jconf.DAG_SINGLE_TASK_BYTES.key)


def _frame(t: pa.Table) -> pd.DataFrame:
    return t.to_pandas() if t.num_rows else pd.DataFrame(
        {n: [] for n in t.schema.names})


def _check(got: pd.DataFrame, oracle: pd.DataFrame, jax: pd.DataFrame):
    assert len(got) == 100
    assert compare_frames(got, oracle) is None
    assert same_order(got, oracle.reset_index(drop=True)) is None
    assert same_order(got, jax) is None


@pytest.mark.parametrize("name", ["store_returns", "date_dim", "store",
                                  "customer"])
def test_generators_equal_the_jax_package(name):
    """The same seed gives the same table as the JAX package's generator."""
    from blaze_tpu.itest import tpcds_data as JT
    from blaze_tpu_torch.itest import tpcds_data as TT
    fn = "gen_" + name
    assert getattr(TT, fn)(SCALE).equals(getattr(JT, fn)(SCALE))


def test_write_parquet_splits_equals_the_jax_package(tmp_path):
    from blaze_tpu.itest.tpcds_data import write_parquet_splits as jsplit
    tables = {**make_tables(0.01, ["store"]),
              **make_tables(0.2, ["customer"])}
    got = write_parquet_splits(tables, str(tmp_path / "t"), 3)
    want = jsplit(tables, str(tmp_path / "j"), 3)
    assert [len(got[k]) for k in tables] == [len(want[k]) for k in tables] \
        == [1, 3]
    for k in tables:
        for g, w in zip(got[k], want[k]):
            assert pq.read_table(g[0]).equals(pq.read_table(w[0]))


def test_q01_splits_into_six_stages(q01):
    from blaze_tpu.plan.stages import DagScheduler as JDag
    plan, _, _ = q01
    stages = DagScheduler().split(plan)
    want = JDag().split(plan)
    assert [s.num_tasks for s in stages] == [s.num_tasks for s in want] \
        == [PARTS] * 5 + [1]
    assert [s.deps for s in stages] == [s.deps for s in want] \
        == [[], [0], [], [2], [1, 3], [4]]
    kinds = [None if s.partitioning is None else s.partitioning["kind"]
             for s in stages]
    assert kinds == ["hash"] * 5 + [None]
    assert stages[4].partitioning["num_partitions"] == 1


@pytest.mark.parametrize("loop", ["off", "on"])
def test_q01_equals_the_oracle_and_the_jax_scheduler(q01, loop):
    plan, oracle, jax = q01
    tconf.conf.set(LOOP, loop)
    sched = DagScheduler()
    got = _frame(sched.run_collect(plan))
    _check(got, oracle, jax)
    assert len(sched.stages) == 6
    assert set(sched.stage_walls) == set(range(6))
    assert all(n == 1 for n in sched.task_runs.values())
    assert len(sched.task_runs) == 5 * PARTS
    counters = QD.stage_counters(sched, ("probe_batches",
                                         "stage_loop_tasks"))
    # the map stages probe date_dim, the join stage the stores and the
    # customers
    assert all(counters[s]["probe_batches"] > 0 for s in (0, 2, 4))
    looped = sum(c["stage_loop_tasks"] for c in counters.values())
    assert (looped > 0) == (loop == "on")
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def test_lineage_recovery_reruns_one_map_task(q01):
    """One byte of stage 0's first non-empty map output is corrupted after
    it commits: the ctr stage's read fails its CRC32C, FetchFailedError
    names that map task, and only it runs again."""
    plan, oracle, jax = q01
    sched = QD.CorruptingScheduler(0)
    got = _frame(sched.run_collect(plan))
    _check(got, oracle, jax)
    assert sched.corrupted_at is not None and sched.left == 0
    reran = {k: v for k, v in sched.task_runs.items() if v != 1}
    assert reran == {sched.target: 2}
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


def test_recovery_gives_up_after_max_rounds(q01):
    from blaze_tpu_torch.faults import FetchFailedError
    plan, _, _ = q01
    tconf.conf.set(tconf.STAGE_MAX_RECOVERIES.key, 1)
    sched = QD.CorruptingScheduler(2, 1, times=5)
    with pytest.raises(FetchFailedError, match="gave up after 1") as ei:
        sched.run_collect(plan)
    assert (ei.value.stage_id, ei.value.map_id) == (2, 1)
    assert sched.task_runs[(2, 1)] == 2
    assert sched.leak_report() == {"files": [], "resources": [],
                                   "dirs": []}


# ---------------------------------------------------------------------------
# task retry
# ---------------------------------------------------------------------------

def test_retryable_error_retries_once_under_decline_loop_scope():
    from blaze_tpu_torch.bridge.tasks import run_tasks
    from blaze_tpu_torch.plan.stage_compiler import stage_loop_active
    tconf.conf.set(LOOP, "on")
    seen = []

    def fn(i):
        seen.append((i, stage_loop_active()))
        if i == 1 and len([s for s in seen if s[0] == 1]) == 1:
            raise OSError("transient")
        return i * 10

    assert run_tasks(fn, 3, "retry test") == [0, 10, 20]
    assert seen == [(0, True), (1, True), (1, False), (2, True)]


@pytest.mark.parametrize("error", [ValueError("a plan error"),
                                   "fetch-failed"])
def test_fatal_and_fetch_failures_are_not_retried(error):
    from blaze_tpu_torch.bridge.tasks import run_tasks
    from blaze_tpu_torch.faults import FetchFailedError
    if error == "fetch-failed":
        error = FetchFailedError(3, 1, "bad block")
    calls = []

    def fn(i):
        calls.append(i)
        raise error

    with pytest.raises(type(error)):
        run_tasks(fn, 1, "no retry")
    assert calls == [0]


def test_retries_are_bounded():
    from blaze_tpu_torch.bridge.tasks import run_tasks
    tconf.conf.set(tconf.TASK_MAX_ATTEMPTS.key, 3)
    calls = []

    def fn(i):
        calls.append(i)
        raise EOFError("short read")

    with pytest.raises(EOFError):
        run_tasks(fn, 1, "bounded")
    assert calls == [0, 0, 0]


def test_a_failed_wave_starts_no_later_task():
    from blaze_tpu_torch.bridge.tasks import run_tasks
    from blaze_tpu_torch.faults import FetchFailedError
    calls = []

    def fn(i):
        calls.append(i)
        if i == 1:
            raise FetchFailedError(1, i, "bad")
        return i

    with pytest.raises(FetchFailedError):
        run_tasks(fn, 4, "stops")
    assert calls == [0, 1]


@pytest.mark.parametrize("exc,kind", [
    ("fetch", "fetch-failed"), ("checksum", "retryable"),
    (EOFError(), "retryable"), (OSError(), "retryable"),
    (ValueError(), "fatal"), (MemoryError(), "fatal")])
def test_classify_exception(exc, kind):
    from blaze_tpu_torch.faults import FetchFailedError, classify_exception
    from blaze_tpu_torch.shuffle.ipc import ShuffleChecksumError
    exc = {"fetch": FetchFailedError(1, 2),
           "checksum": ShuffleChecksumError("crc")}.get(exc, exc)
    assert classify_exception(exc) == kind


# ---------------------------------------------------------------------------
# fetch failures from the read side, and what the port does not have
# ---------------------------------------------------------------------------

def _one_map_output(tmp_path):
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.shuffle import HashPartitioning
    from blaze_tpu_torch.shuffle.writer import ShuffleRepartitioner
    import torch
    rep = ShuffleRepartitioner(HashPartitioning([BoundReference(0)], 3))
    rep.insert_batch(ColumnBatch.from_arrow(pa.table({
        "k": np.arange(500), "s": [f"v{i}" for i in range(500)]}),
        device=torch.device("cpu")))
    data, index = str(tmp_path / "m.data"), str(tmp_path / "m.index")
    rep.write(data, index)
    return data, index


def test_a_corrupt_block_raises_fetch_failed_with_its_lineage(tmp_path):
    from blaze_tpu_torch.faults import FetchFailedError
    from blaze_tpu_torch.shuffle import FileSegmentBlock, read_index_file
    from blaze_tpu_torch.shuffle.reader import read_block
    data, index = _one_map_output(tmp_path)
    offs = read_index_file(index, 3, data)
    block = FileSegmentBlock(data, offs[0], offs[1] - offs[0],
                             stage_id=4, map_id=2)
    assert sum(rb.num_rows for rb in read_block(block)) > 0
    QD.corrupt_block(data, index)
    with pytest.raises(FetchFailedError) as ei:
        list(read_block(block))
    assert (ei.value.stage_id, ei.value.map_id) == (4, 2)
    short = FileSegmentBlock(data, offs[0], offs[-1] + 10, stage_id=4,
                             map_id=2)
    with pytest.raises(FetchFailedError):
        list(read_block(short))


def test_a_bad_index_is_a_fetch_failure(tmp_path):
    from blaze_tpu_torch.faults import FetchFailedError
    from blaze_tpu_torch.shuffle import read_index_file
    data, index = _one_map_output(tmp_path)
    with open(index, "r+b") as f:
        f.truncate(12)
    with pytest.raises(FetchFailedError, match="not a whole number"):
        read_index_file(index, 3, data)
    with pytest.raises(FetchFailedError):
        read_index_file(str(tmp_path / "missing.index"))


@pytest.mark.parametrize("key,value", [
    ("auron.tpu.workers.enable", "true"),
    ("auron.tpu.speculation.enable", "true"),
    ("auron.tpu.shuffle.service", "/tmp/rss"),
    ("auron.tpu.aqe.enable", "true"),
    ("auron.tpu.shuffle.device", "on"),
    ("auron.tpu.stats.enable", "true")])
def test_unported_scheduler_branches_raise(q01, key, value):
    plan, _, _ = q01
    tconf.conf.set(key, value)
    try:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            DagScheduler().run_collect(plan)
    finally:
        tconf.conf.unset(key)
