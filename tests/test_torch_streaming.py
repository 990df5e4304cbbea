"""The port's streaming runtime (blaze_tpu_torch/streaming/ and the
event-time windows of ops/window.py) against the JAX package's on the CPU,
with the tolerance exact: the same records give equal window panes,
snapshots and restores under every late-record policy, equal checkpoint
manifests and equal committed sink tables, end to end through the
StreamExecutor with and without both fault sites, through the query
service, and when a cancel or a deadline lands at an epoch boundary.
Manifests are compared with the sink attempt's path made relative."""

import json
import os
import threading

import pyarrow as pa
import pytest

from blaze_tpu import config as jconf
from blaze_tpu import faults as jfaults
from blaze_tpu.memory import MemManager as JMemManager
from blaze_tpu.ops import kafka as JK
from blaze_tpu.ops import window as JW
from blaze_tpu.serving import context as jctx
from blaze_tpu.serving.service import QueryService as JService
import blaze_tpu.streaming as JS
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import faults as tfaults
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.memory import MemManager
from blaze_tpu_torch.ops import kafka as TK
from blaze_tpu_torch.ops import window as TW
from blaze_tpu_torch.serving import context as tctx
from blaze_tpu_torch.serving.service import QueryService as TService
import blaze_tpu_torch.streaming as TS

SCHEMA = {"fields": [
    {"name": "k", "type": {"id": "utf8"}, "nullable": True},
    {"name": "v", "type": {"id": "int64"}, "nullable": True}]}


@pytest.fixture(autouse=True)
def confs():
    MemManager.init(4 << 30)
    JMemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for opt in (tconf.STREAM_MAX_RECOVERIES, tconf.STREAM_LATE_SIDE_POLICY,
                tconf.STREAM_WATERMARK_LATENESS_MS):
        tconf.conf.unset(opt.key)


#: each package's modules, by name: a body runs once with each
BOTH = (("torch", dict(K=TK, W=TW, S=TS, faults=tfaults, ctx=tctx,
                       Service=TService, conf=tconf)),
        ("jax", dict(K=JK, W=JW, S=JS, faults=jfaults, ctx=jctx,
                     Service=JService, conf=jconf)))


# -- the window state ----------------------------------------------------

SPECS = {"tumbling": (1000, None), "sliding": (1000, 250)}


def _state_ops(W, spec, policy):
    schema = pa.schema([("k", pa.string()), ("v", pa.int64()),
                        ("__event_time", pa.int64())])
    return W.EventTimeWindowState(
        W.EventTimeWindowSpec(*spec), schema, "__event_time", ["k"],
        [("sum", "v"), ("count", None), ("min", "v"), ("max", "v"),
         ("avg", "v")], late_policy=policy), schema


def _batch(schema, rows):
    return pa.RecordBatch.from_arrays(
        [pa.array([r[0] for r in rows], pa.string()),
         pa.array([r[1] for r in rows], pa.int64()),
         pa.array([r[2] for r in rows], pa.int64())], schema=schema)


STEPS = [
    ("add", [("a", 1, 100), ("b", 2, 350), ("a", None, 990),
             ("c", 2 ** 61, 120), ("c", 2 ** 61, 130)], None),
    ("advance", None, 999),
    ("add", [("a", 5, 1100), ("b", -3, 1700), (None, 4, 1250)], 999),
    ("advance", None, 1500),
    ("add", [("a", 7, 400), ("b", 1, 1490), ("d", 9, 2100)], 1500),
    ("snapshot", None, None),
    ("advance", None, 2250),
    ("add", [("a", 11, 100), ("d", 1, 2300)], 2250),
    ("flush", None, None),
]


@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("policy", ["drop", "side", "accept"])
def test_window_state_equals_the_jax_one(spec, policy):
    """Late rows under each policy, integer sums up to 2^62, null values and
    keys: every fired table, late count, side row, snapshot and restored
    state equal."""
    logs = []
    for W in (TW, JW):
        st, schema = _state_ops(W, SPECS[spec], policy)
        log = []
        try:
            for op, rows, wm in STEPS:
                if op == "add":
                    log.append(("late", st.add_batch(_batch(schema, rows),
                                                     watermark=wm)))
                    log.append(("side", st.take_late()))
                elif op == "advance":
                    log.append(("fired", st.advance(wm).to_pylist()))
                elif op == "snapshot":
                    snap = json.loads(json.dumps(st.snapshot()))
                    log.append(("snapshot", snap))
                    log.append(("bytes", st.state_bytes()))
                    again, _ = _state_ops(W, SPECS[spec], policy)
                    again.restore(snap)
                    log.append(("restored", again.snapshot()))
                    again.close()
                else:
                    log.append(("fired", st.flush().to_pylist()))
            log.append(("late_records", st.late_records))
        finally:
            st.close()
        logs.append(log)
    assert logs[0] == logs[1]
    assert any(k == "fired" and v for k, v in logs[0])


@pytest.mark.parametrize("ts", [0, 1, 249, 250, 999, 1000, -1, -1001,
                                1_436_918_400_123])
def test_window_assignment_and_watermark_equal_the_jax_ones(ts):
    for size, slide in [(1000, None), (1000, 250), (10_000, 2_000),
                        (1000, 300)]:
        assert TW.EventTimeWindowSpec(size, slide).assign(ts) == \
            JW.EventTimeWindowSpec(size, slide).assign(ts)
    trackers = [TW.WatermarkTracker(10), JW.WatermarkTracker(10)]
    seen = []
    for tr in trackers:
        out = [tr.watermark()]
        for p, t in ((0, ts), (1, ts + 500), (0, ts + 2000), (2, ts - 50)):
            tr.observe(p, t)
            out.append(tr.watermark())
        out.append(tr.snapshot())
        seen.append(out)
    assert seen[0] == seen[1]
    with pytest.raises(ValueError):
        TW.EventTimeWindowSpec(0)
    with pytest.raises(ValueError):
        TW.EventTimeWindowSpec(10, 0)


# -- checkpoints and the sink ---------------------------------------------

def test_checkpoints_and_sink_equal_the_jax_ones(tmp_path):
    out = {}
    for name, m in BOTH:
        ck = m["S"].CheckpointManager(str(tmp_path / name / "ckpt"))
        assert ck.latest() is None
        assert ck.commit(0, {"offsets": {"0": 5}, "x": "winner"})
        assert not ck.commit(0, {"offsets": {"0": 9}, "x": "loser"})
        assert ck.commit(1, {"offsets": {"0": 7, "1": 2}})
        sink = m["S"].ExactlyOnceParquetSink(str(tmp_path / name / "sink"))
        t = pa.table({"k": ["a", "b"], "v": [1, 2]})
        a0 = sink.write_attempt(0, t)
        a1 = sink.write_attempt(0, t.slice(1))
        promoted = (sink.promote(0, a0), sink.promote(0, a1))
        sink.repair(1, sink.write_attempt(1, t.slice(0, 0)))
        out[name] = (ck.epochs(), ck.latest(), ck.offsets_from(ck.load(1)),
                     [open(ck._path(e), "rb").read() for e in ck.epochs()],
                     promoted, sink.committed_epochs(),
                     sink.committed_table().to_pylist(),
                     sorted(os.listdir(sink.dir)))
    assert out["torch"] == out["jax"]
    with pytest.raises(FileNotFoundError, match="no committed"):
        TS.ExactlyOnceParquetSink(str(tmp_path / "fresh")).committed_table()


# -- the streaming query end to end ----------------------------------------

def _plan(n):
    return {"kind": "kafka_scan", "topic": "orders", "format": "json",
            "operator_id": "stream-parity", "num_partitions": n,
            "schema": SCHEMA}


def _records(K, partition, n, ts0=0, step=100, keys=3):
    return [K.KafkaRecord(value=json.dumps(
        {"k": f"k{(i * 7 + partition) % keys}", "v": i * i - 40}).encode(),
        offset=i, partition=partition, timestamp_ms=ts0 + i * step)
        for i in range(n)]


def _parts(K, late=False):
    parts = [_records(K, 0, 40), _records(K, 1, 30, ts0=50, step=130)]
    if late:
        # a third partition whose second half goes back in time: those
        # records arrive after the watermark passed them
        recs = _records(K, 2, 12, ts0=0, step=500)
        for i, r in enumerate(recs[6:]):
            r.timestamp_ms = 100 * i
        parts.append(recs)
    return parts


def _window(W, S, spec):
    return S.StreamWindowConfig(spec=W.EventTimeWindowSpec(*spec),
                                keys=["k"],
                                aggs=[("sum", "v"), ("count", None),
                                      ("max", "v"), ("avg", "v")])


def _manifests(ckpt_dir, sink_dir):
    out = []
    for name in sorted(os.listdir(ckpt_dir)):
        if not name.endswith(".json"):
            continue
        m = json.loads(open(os.path.join(ckpt_dir, name)).read())
        sink = m.get("sink") or {}
        if sink.get("attempt"):
            sink["attempt"] = os.path.relpath(sink["attempt"], sink_dir)
        out.append(m)
    return out


def _result(ex, summary):
    sink_dir, ckpt_dir = ex.sink.dir, ex._ckpt.dir
    return {"table": ex.sink.committed_table().to_pylist(),
            "epochs": ex.sink.committed_epochs(),
            "manifests": _manifests(ckpt_dir, sink_dir),
            "summary": {k: v for k, v in summary.items()
                        if k not in ("sink_dir", "checkpoint_dir")},
            "late_side": ex.late_side}


def _run_stream(tmp_path, name, m, spec=(1000, None), poll=6,
                fault_rules=(), late=False, policy=None, lateness=None):
    conf = m["conf"]
    if policy is not None:
        conf.conf.set(conf.STREAM_LATE_SIDE_POLICY.key, policy)
    if lateness is not None:
        conf.conf.set(conf.STREAM_WATERMARK_LATENESS_MS.key, lateness)
    try:
        ex = m["S"].StreamExecutor(
            _plan(1), m["S"].MemoryStreamSource(_parts(m["K"], late)),
            _window(m["W"], m["S"], spec),
            sink_dir=str(tmp_path / name / "sink"),
            checkpoint_dir=str(tmp_path / name / "ckpt"),
            max_records_per_poll=poll)
        with m["faults"].scoped(*fault_rules, seed=11):
            summary = ex.run()
            fired = {s: st["fires"]
                     for s, st in m["faults"].stats().items()
                     if s in ("stream-epoch", "checkpoint-commit")}
        return dict(_result(ex, summary), fired=fired)
    finally:
        for opt in (conf.STREAM_LATE_SIDE_POLICY,
                    conf.STREAM_WATERMARK_LATENESS_MS):
            conf.conf.unset(opt.key)


RUNS = {
    "tumbling": dict(),
    "sliding": dict(spec=(1000, 400), poll=9),
    "both faults": dict(fault_rules=(("stream-epoch", dict(at=(3,))),
                                     ("checkpoint-commit", dict(at=(5,))))),
    "late drop": dict(late=True, policy="drop"),
    "late side": dict(late=True, policy="side", lateness=100),
    "late accept": dict(late=True, policy="accept", spec=(1000, 500)),
}


@pytest.mark.parametrize("run", list(RUNS))
def test_stream_executor_equals_the_jax_one(tmp_path, run):
    device_stats.reset()
    out = {name: _run_stream(tmp_path, name, m, **RUNS[run])
           for name, m in BOTH}
    assert out["torch"] == out["jax"]
    got = out["torch"]
    assert got["summary"]["epochs"] > 3 and got["table"]
    st = device_stats.stream_stats()
    assert st["stream_checkpoints"] == st["stream_sink_commits"] == \
        got["summary"]["epochs"]
    if run == "both faults":
        assert got["fired"]["stream-epoch"] == 1
        assert got["fired"]["checkpoint-commit"] == 1
        assert got["summary"]["recoveries"] == st["stream_recoveries"] == 2
        assert got["table"] == _run_stream(tmp_path, "torch-clean",
                                           dict(BOTH)["torch"]
                                           )["table"]
    if run.startswith("late"):
        assert st["stream_late_records"] > 0


def test_recovery_budget_exhaustion_raises_in_both(tmp_path):
    for name, m in BOTH:
        m["conf"].conf.set(m["conf"].STREAM_MAX_RECOVERIES.key, 1)
        try:
            with pytest.raises(m["faults"].InjectedFault):
                _run_stream(tmp_path, name, m, fault_rules=(
                    ("stream-epoch", dict(at=(2, 3))),))
        finally:
            m["conf"].conf.unset(m["conf"].STREAM_MAX_RECOVERIES.key)


def test_executor_partition_checks(tmp_path):
    parts = _parts(TK)
    with pytest.raises(ValueError, match="disagrees"):
        TS.StreamExecutor(_plan(2), TS.MemoryStreamSource(parts[:1]),
                          _window(TW, TS, (1000, None)),
                          sink_dir=str(tmp_path / "s"), num_partitions=2)
    with pytest.raises(ValueError, match="no kafka_scan"):
        TS.StreamExecutor({"kind": "memory_scan", "resource_id": "x"},
                          TS.MemoryStreamSource(parts),
                          _window(TW, TS, (1000, None)),
                          sink_dir=str(tmp_path / "s"))
    src = TS.MemoryStreamSource(parts)
    assert src.poll(0, 38, 5) == parts[0][38:] and src.poll(1, 30, 5) is None
    assert src.lag({0: 10}) == 30 + 30


# -- through the query service, cancel and deadline -----------------------

def _service_run(tmp_path, name, m, plan, hook=None, deadline_ms=None,
                 poll=4):
    holder = {}

    class Source(m["S"].MemoryStreamSource):
        def poll(self, partition, offset, max_records):
            if hook is not None and partition == 0:
                hook(holder, offset)
            return super().poll(partition, offset, max_records)

    def build(plan_ir, ctx):
        ex = m["S"].StreamExecutor(
            plan_ir, Source(_parts(m["K"])), _window(m["W"], m["S"],
                                                     (1000, None)),
            sink_dir=str(tmp_path / name / "sink"),
            checkpoint_dir=str(tmp_path / name / "ckpt"), ctx=ctx,
            max_records_per_poll=poll)
        holder["ex"], holder["ctx"] = ex, ctx
        return ex

    svc = m["Service"](max_concurrent=1,
                       executor=m["S"].streaming_service_executor(build))
    try:
        h = svc.submit(plan, tenant="t", deadline_ms=deadline_ms)
        try:
            summary, error = h.result(timeout=120), None
        except BaseException as e:  # noqa: BLE001 - compared below
            summary, error = None, type(e).__name__
    finally:
        svc.shutdown()
    ex = holder["ex"]
    res = {"error": error, "status": h.status,
           "epochs": ex.sink.committed_epochs(),
           "manifests": _manifests(ex._ckpt.dir, ex.sink.dir)}
    if summary is not None:
        res.update(_result(ex, summary))
    return res


def test_stream_through_the_service_equals_the_jax_one(tmp_path):
    out = {name: _service_run(tmp_path, name, m, _plan(2))
           for name, m in BOTH}
    assert out["torch"] == out["jax"]
    assert out["torch"]["error"] is None
    assert out["torch"]["summary"]["records_consumed"] == 70


def test_cancel_at_an_epoch_boundary_equals_the_jax_one(tmp_path):
    """A cancel raised while epoch 3 polls: the epoch's run checks the
    context before any work and raises, so epochs 0-2 stay committed; the
    same epochs and manifests in both."""
    def hook(holder, offset):
        if offset == 12:
            holder["ctx"].cancel("stop at epoch 3")

    out = {name: _service_run(tmp_path, name, m, _plan(2), hook=hook)
           for name, m in BOTH}
    assert out["torch"] == out["jax"]
    assert out["torch"]["error"] == "QueryCancelled"
    assert out["torch"]["epochs"] == [0, 1, 2]


def test_deadline_at_an_epoch_boundary_equals_the_jax_one(tmp_path):
    """A deadline that passes while epoch 2 polls (the poll waits past
    it): the epoch's run raises DeadlineExceeded before any work, epochs
    0 and 1 stay committed, in both."""
    def hook(holder, offset):
        if offset == 8:
            ctx = holder["ctx"]
            while ctx.remaining_ms() is None or ctx.remaining_ms() > 0:
                threading.Event().wait(0.005)

    out = {name: _service_run(tmp_path, name, m, _plan(2), hook=hook,
                              deadline_ms=400)
           for name, m in BOTH}
    assert out["torch"] == out["jax"]
    assert out["torch"]["error"] == "DeadlineExceeded"
    assert out["torch"]["epochs"] == [0, 1]


def test_memory_quota_on_window_state_kills_in_both(tmp_path):
    """Every record opens a pane that never fires: the state's bytes climb
    the quota ladder to the kill in both packages."""
    levels = []
    for name, m in BOTH:
        parts = [[m["K"].KafkaRecord(
            value=json.dumps({"k": f"u{i}", "v": i}).encode(), offset=i,
            timestamp_ms=10 * i) for i in range(40)]]
        win = m["S"].StreamWindowConfig(
            spec=m["W"].EventTimeWindowSpec(size_ms=10 ** 9), keys=["k"],
            aggs=[("sum", "v")])
        ctx = m["ctx"].QueryContext(f"q-mem-{name}", mem_quota=600)
        ex = m["S"].StreamExecutor(
            _plan(1), m["S"].MemoryStreamSource(parts), win,
            sink_dir=str(tmp_path / name / "sink"),
            checkpoint_dir=str(tmp_path / name / "ckpt"), ctx=ctx,
            max_records_per_poll=2)
        with pytest.raises(m["ctx"].QueryMemoryExceeded):
            ex.run()
        levels.append((ctx.degrade_level, ex.sink.committed_epochs()))
    assert levels[0] == levels[1] and levels[0][0] >= 3


def test_stream_counters_footer_and_exposition(tmp_path):
    device_stats.reset()
    m = dict(BOTH)["torch"]
    got = _run_stream(tmp_path, "torch", m)
    snap = device_stats.snapshot()
    assert snap["stream_epochs"] == got["summary"]["epochs"]
    assert snap["stream_sink_commits"] == snap["stream_epochs"]
    assert snap["stream_records"] == 70
    from blaze_tpu_torch.bridge.profiling import prometheus_text
    prom = prometheus_text()
    assert "blaze_stream_epochs_total" in prom
    assert "blaze_stream_window_state_bytes" in prom
    assert "blaze_stream_window_state_bytes_last" not in prom
    from blaze_tpu_torch.plan.explain import _footers
    text = "\n".join(_footers(snap))
    assert "stream: epochs=" in text and "dup_skips=0" in text
    from blaze_tpu_torch.bridge import tracing
    assert {"stream_epoch", "stream_recovery"} <= set(tracing.SPAN_NAMES)


def test_the_nexmark_itest_holds_both_paths_and_profiles_n2(tmp_path):
    """The port's Nexmark itest at a small scale on the CPU: N1 and N2 hold
    to their pyarrow oracles, and `profile=True` reads the slot thread's
    host time by part."""
    from blaze_tpu_torch.itest import nexmark
    from blaze_tpu_torch.itest import streaming as drive
    stream = nexmark.generate_bids(1 << 13, seed=7)
    n1 = drive.run_n1(stream, str(tmp_path / "n1"))
    n2 = drive.run_n2(stream, str(tmp_path / "n2"), poll=256, profile=True)
    assert n1["failures"] == [] and n2["failures"] == []
    prof = n2["host_profile"]
    assert set(prof["parts"]) == {p[0] for p in drive.PROFILE_PARTS}
    assert prof["profiled_s"] > 0
    assert all(0 <= v <= 1 for v in prof["parts"].values())
    assert prof["parts"]["epoch"] > 0.5
    assert 0 < prof["parts"]["decode"] <= prof["parts"]["plan run"]
    assert len(prof["top_own"]) == 10
