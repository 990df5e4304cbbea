"""The port's IO prefetcher (blaze_tpu_torch/ops/base.py PrefetchIterator),
mirroring tests/test_prefetch.py: order, exceptions in position, close
joining a blocked worker, no leaked threads (also under a LimitExec that
stops early), depth 0, the kill-switch, the default depth, the stats, an
empty source; then the default-on wiring at the IO edges: a parquet scan
and a shuffle round trip give, prefetch on and off, the JAX scan's rows
and q01's map `.data`/`.index` bytes.

Tolerance: exact (items, rows, bytes, counts)."""

import gc
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.ops.base import prefetch

PREFETCH = tconf.IO_PREFETCH_ENABLE.key


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    for opt in (tconf.TORCH_DEVICE, tconf.IO_PREFETCH_ENABLE,
                tconf.IO_PREFETCH_DEPTH, tconf.DAG_SINGLE_TASK_BYTES,
                tconf.STAGE_DEVICE_LOOP_ENABLE):
        tconf.conf.unset(opt.key)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("blaze-prefetch") and t.is_alive()]


def _wait_no_threads(timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        gc.collect()
        if not _prefetch_threads():
            return True
        time.sleep(0.01)
    return False


def test_ordering_preserved():
    items = list(range(200))
    assert list(prefetch(iter(items), depth=3)) == items
    assert _wait_no_threads()


def test_transform_applied_on_worker():
    names = set()

    def xform(x):
        names.add(threading.current_thread().name)
        return x * 2

    out = list(prefetch(iter(range(50)), depth=2, transform=xform,
                        name="xform"))
    assert out == [x * 2 for x in range(50)]
    assert names == {"blaze-prefetch-xform"}
    assert _wait_no_threads()


def test_worker_runs_in_the_consumers_task_context():
    from blaze_tpu_torch.bridge.context import (TaskContext, current_task,
                                                task_scope)
    seen = []
    ctx = TaskContext(stage_id=7, partition_id=3)
    with task_scope(ctx):
        it = prefetch(iter(range(3)), depth=2,
                      transform=lambda x: seen.append(current_task()) or x)
        assert list(it) == [0, 1, 2]
    assert seen == [ctx] * 3


def test_exception_reraised_at_consumer_in_position():
    def gen():
        yield 1
        yield 2
        raise ValueError("decode failed")

    it = prefetch(gen(), depth=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(ValueError, match="decode failed"):
        next(it)
    with pytest.raises(StopIteration):
        next(it)
    assert _wait_no_threads()


def test_transform_exception_propagates():
    def boom(x):
        if x == 3:
            raise RuntimeError("transform blew up")
        return x

    it = prefetch(iter(range(10)), depth=2, transform=boom)
    assert [next(it), next(it), next(it)] == [0, 1, 2]
    with pytest.raises(RuntimeError, match="transform blew up"):
        for _ in it:
            pass
    assert _wait_no_threads()


def test_close_drains_blocked_worker():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetch(gen(), depth=2)
    assert next(it) == 0
    it.close()
    assert not _prefetch_threads(), "close() must join the worker"
    assert len(produced) <= 10  # bounded: the worker never ran away
    with pytest.raises(StopIteration):
        next(it)
    it.close()  # idempotent


def test_dropping_an_unfinished_iterator_joins_its_worker():
    """An iterator dropped early (no close()) stops its worker once it is
    collected: the worker holds the channel, never the iterator."""
    it = prefetch(iter(range(10_000)), depth=2)
    assert next(it) == 0
    del it
    assert _wait_no_threads()


def test_no_leaked_threads_after_full_consumption():
    for _ in range(5):
        assert len(list(prefetch(iter(range(100)), depth=4))) == 100
    assert _wait_no_threads()


def test_depth_zero_is_synchronous():
    base = len(_prefetch_threads())
    it = prefetch(iter(range(10)), depth=0, transform=lambda x: x + 1)
    assert len(_prefetch_threads()) == base, "depth=0 must not spawn"
    assert list(it) == list(range(1, 11))


def test_kill_switch_disables_thread():
    tconf.conf.set(PREFETCH, False)
    base = len(_prefetch_threads())
    it = prefetch(iter(range(5)))
    assert len(_prefetch_threads()) == base
    assert list(it) == list(range(5))


def test_default_depth_from_config():
    assert tconf.IO_PREFETCH_DEPTH.get() == 2
    tconf.conf.set(tconf.IO_PREFETCH_DEPTH.key, 3)
    it = prefetch(iter(range(5)))
    assert it._ch is not None and it._ch.queue.maxsize == 3
    assert list(it) == list(range(5))
    assert _wait_no_threads()


def test_prefetch_stats_counted():
    before = device_stats.snapshot()
    list(prefetch(iter(range(20)), depth=2))
    d = device_stats.delta(before)
    assert d["prefetch_batches"] == 20
    assert d["prefetch_wait_ns"] >= 0


def test_empty_source():
    assert list(prefetch(iter(()), depth=2)) == []
    assert _wait_no_threads()


# -- the IO edges --------------------------------------------------------------

def _parquet(tmp_path, n=3000):
    rng = np.random.default_rng(0)
    t = pa.table({"k": pa.array(rng.integers(0, 9, n)),
                  "v": pa.array(rng.random(n)),
                  "s": pa.array([f"s{i % 7}" for i in range(n)])})
    path = str(tmp_path / "t.parquet")
    pq.write_table(t, path, row_group_size=700)
    return path, t


def _jax_scan_batches(path, t):
    import blaze_tpu.bridge.placement as P
    from blaze_tpu.ops.scan import ParquetScanExec
    from blaze_tpu.schema import Schema
    saved = P.host_resident
    P.host_resident = lambda: False
    try:
        scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                               batch_rows=512)
        return [b.to_arrow() for b in scan.execute(0)]
    finally:
        P.host_resident = saved


@pytest.mark.parametrize("on", [True, False])
def test_parquet_scan_equals_the_jax_scan(tmp_path, on):
    """Batch for batch (count, sizes, order, values) the JAX scan's, with
    prefetch on and off; on, every batch came through the queue."""
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    tconf.conf.set(PREFETCH, on)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=512)
    before = device_stats.snapshot()
    got = [b.to_arrow() for b in scan.execute(0)]
    want = _jax_scan_batches(path, t)
    assert [b.num_rows for b in got] == [b.num_rows for b in want]
    for g, w in zip(got, want):
        assert g.equals(w)
    d = device_stats.delta(before)
    assert d["prefetch_batches"] == (len(got) if on else 0)
    assert scan.metrics.get("output_rows") == t.num_rows
    assert scan.metrics.get("output_batches") == len(got)
    assert _wait_no_threads()


def test_limit_above_a_scan_leaks_no_thread(tmp_path):
    from blaze_tpu_torch.ops.basic import LimitExec
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=128)
    lim = LimitExec(scan, 300)
    rows = sum(b.selected_count() for b in lim.execute(0))
    assert rows == 300
    assert _wait_no_threads()
    # the scan recorded only the batches the limit pulled
    assert scan.metrics.get("output_batches") < -(-t.num_rows // 128)


def test_cancelled_task_stops_the_worker(tmp_path):
    from blaze_tpu_torch.bridge.context import (TaskContext,
                                                TaskKilledError, task_scope)
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    from blaze_tpu_torch.schema import Schema
    path, t = _parquet(tmp_path)
    scan = ParquetScanExec(Schema.from_arrow(t.schema), [[path]],
                           batch_rows=128)
    alive = [True]
    ctx = TaskContext(is_running=lambda: alive[0])
    with task_scope(ctx):
        it = scan.execute(0)
        next(it)
        alive[0] = False
        with pytest.raises(TaskKilledError):
            next(it)
        it.close()
    assert _wait_no_threads()


def test_shuffle_round_trip_under_prefetch():
    """Map-side writes and reduce-side IPC reads: the same rows, per
    reduce partition in order, prefetch on and off."""
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.scan import MemoryScanExec
    from blaze_tpu_torch.shuffle import (HashPartitioning,
                                         LocalShuffleExchange)
    rng = np.random.default_rng(1)
    t = pa.table({"k": pa.array(rng.integers(0, 32, 5000)),
                  "v": pa.array(rng.random(5000))})

    def run():
        scan = MemoryScanExec.from_arrow(t, num_partitions=2,
                                         batch_rows=700)
        ex = LocalShuffleExchange(scan, HashPartitioning([BoundReference(0)], 4))
        try:
            return [[b.to_arrow() for b in ex.execute(p)]
                    for p in range(4)]
        finally:
            ex.cleanup()

    before = device_stats.snapshot()
    on = run()
    assert device_stats.delta(before)["prefetch_batches"] > 0
    tconf.conf.set(PREFETCH, False)
    off = run()
    for a, b in zip(on, off):
        assert [x.num_rows for x in a] == [x.num_rows for x in b]
        assert all(x.equals(y) for x, y in zip(a, b))
    assert _wait_no_threads()


@pytest.fixture(scope="module")
def q01_data(tmp_path_factory):
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest import queries as TQ
    from blaze_tpu_torch.itest.tpcds_data import (make_tables,
                                                  write_parquet_splits)
    tables = make_tables(0.05, QD.TABLES)
    paths = write_parquet_splits(
        tables, str(tmp_path_factory.mktemp("q01")), 2)
    plan, _oracle = TQ.q01(paths, tables, partitions=2)
    return plan


def test_q01_map_bytes_equal_the_jax_ones_prefetch_on_and_off(q01_data):
    from blaze_tpu_torch.plan.stages import DagScheduler
    from test_torch_q17_q18 import _jax_run, _recording
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    _frame, jsched = _jax_run(q01_data)
    for on in (True, False):
        tconf.conf.set(PREFETCH, on)
        sched = _recording(DagScheduler)()
        sched.run_collect(q01_data)
        assert sorted(sched.outputs) == sorted(jsched.outputs)
        for key, raw in sched.outputs.items():
            assert raw == jsched.outputs[key], (on, key)
    assert _wait_no_threads()


def test_concurrent_prefetchers_under_a_short_switch_interval():
    """More consumer threads than cores, each over its own prefetcher,
    with the interpreter switching threads every 10 us: every stream in
    order, and the shared counters lose no update."""
    import os
    import sys
    n_threads = 2 * (os.cpu_count() or 2) + 2
    items = 300
    out = {}

    def consume(i):
        out[i] = list(prefetch(iter(range(items)), depth=2,
                               transform=lambda x: x * 3))

    before = device_stats.snapshot()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=consume, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(saved)
    assert out == {i: [x * 3 for x in range(items)]
                   for i in range(n_threads)}
    assert device_stats.delta(before)["prefetch_batches"] == \
        n_threads * items
    assert _wait_no_threads()
