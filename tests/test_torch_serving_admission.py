"""The port's QueryService admission and lifecycle
(blaze_tpu_torch/serving/service.py) against the JAX package's
(blaze_tpu/serving/service.py): the same submission script, over
executors gated by `threading.Event`s (no sleeps), gives the same
rejection kinds in the same places and the same `stats()` counters;
a query cancelled in the queue is shed at the pop with no work done; a
running one stops at its next check; the left-out features raise naming
ROADMAP item 16; the process-wide serving counters and the HTTP routes
(/serving, /serving/cancel, /progress, the tenant histogram) answer with
the reference's keys."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from blaze_tpu import faults as jfaults
from blaze_tpu.serving import service as jservice
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch import faults
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.serving import service as tservice

WAIT = 30  # seconds: every wait's own timeout


@pytest.fixture(autouse=True)
def clean():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


class Gated:
    """An executor whose runs block until `release`, each run setting its
    own `started` event first; `ran` lists the query ids that ran."""

    def __init__(self):
        self.release = threading.Event()
        self.started = {}
        self.ran = []
        self._lock = threading.Lock()

    def started_event(self, n):
        with self._lock:
            return self.started.setdefault(n, threading.Event())

    def __call__(self, plan, ctx, handle):
        with self._lock:
            self.ran.append(ctx.query_id)
            n = len(self.ran)
        self.started_event(n).set()
        while not self.release.wait(0.005):
            ctx.check()
        return plan.get("value", "done")


def _script(mod, steps, **svc_kw):
    """Run one admission script against `mod`'s QueryService; returns the
    outcome of each step and the final stats().  A step is
    ("submit", tenant, plan), ("wait_started", n), ("cancel", i) (the i-th
    admitted handle), ("release",), ("fault", rule) or ("results",)."""
    gate = Gated()
    svc = mod.QueryService(executor=gate, **svc_kw)
    fmod = faults if mod is tservice else jfaults
    handles, out = [], []
    try:
        for step in steps:
            kind = step[0]
            if kind == "submit":
                try:
                    handles.append(svc.submit(step[2], tenant=step[1]))
                    out.append("admitted")
                except mod.QueryRejected as e:
                    out.append(e.kind)
            elif kind == "wait_started":
                assert gate.started_event(step[1]).wait(WAIT)
                out.append("started")
            elif kind == "cancel":
                out.append(handles[step[1]].cancel())
            elif kind == "release":
                gate.release.set()
                out.append("released")
            elif kind == "fault":
                fmod.configure(step[1], seed=1)
                out.append("fault")
            elif kind == "results":
                res = []
                for h in handles:
                    err = h.exception(WAIT)
                    res.append((h.status, None if err is None
                                else type(err).__name__,
                                h.result(0) if err is None else None))
                out.append(res)
    finally:
        gate.release.set()
        svc.shutdown(wait=True)
        fmod.clear()
    stats = svc.stats()
    stats.pop("tenants")
    return out, stats, len(gate.ran)


N = {"kind": "noop"}
SCRIPTS = {
    "queue full": (dict(max_concurrent=1, max_queue=1), [
        ("submit", "a", N), ("wait_started", 1), ("submit", "a", N),
        ("submit", "a", N), ("submit", "b", N), ("release",),
        ("results",)]),
    "tenant quota": (dict(max_concurrent=1, max_queue=16,
                          tenant_max_inflight=2), [
        ("submit", "hog", N), ("submit", "hog", N), ("submit", "hog", N),
        ("submit", "polite", N), ("release",), ("results",)]),
    "tenant quota frees on finish": (dict(max_concurrent=2, max_queue=8,
                                          tenant_max_inflight=1), [
        ("submit", "t", {"kind": "noop", "value": 1}), ("wait_started", 1),
        ("submit", "t", N), ("release",), ("results",),
        ("submit", "t", {"kind": "noop", "value": 2}), ("results",)]),
    "injected": (dict(max_concurrent=2, max_queue=8), [
        ("fault", "admit@2+3"), ("submit", "a", N), ("submit", "a", N),
        ("submit", "b", N), ("submit", "b", N), ("release",),
        ("results",)]),
    "cancel queued and running": (dict(max_concurrent=1, max_queue=4), [
        ("submit", "a", N), ("wait_started", 1), ("submit", "a", N),
        ("cancel", 1), ("cancel", 0), ("results",), ("cancel", 0)]),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_same_script_gives_the_jax_kinds_and_counters(name):
    kw, steps = SCRIPTS[name]
    got = _script(tservice, steps, **kw)
    want = _script(jservice, steps, **kw)
    assert got == want
    assert set(got[1]["counters"]) == set(want[1]["counters"])


def test_a_query_cancelled_in_the_queue_does_no_work():
    out, stats, ran = _script(tservice, SCRIPTS[
        "cancel queued and running"][1], max_concurrent=1, max_queue=4)
    assert ran == 1
    assert out[-2] == [("cancelled", "QueryCancelled", None)] * 2
    assert stats["counters"]["cancelled"] == 2


def test_memory_admission_and_shutdown(tmp_path):
    from test_torch_serving_queries import two_stage_plan
    plan = two_stage_plan(tmp_path, n=2_000)
    svc = tservice.QueryService(admit_mem_bytes=16,
                                executor=lambda p, c, h: "ran")
    try:
        with pytest.raises(tservice.QueryRejected) as e:
            svc.submit(plan)
        assert e.value.kind == "memory"
        # an input that cannot be stat'ed always admits
        assert svc.submit({"kind": "memory_scan"}).result(WAIT) == "ran"
    finally:
        svc.shutdown()
    with pytest.raises(tservice.QueryRejected) as e:
        svc.submit({"kind": "noop"})
    assert e.value.kind == "shutdown"
    assert svc.stats()["counters"]["shed_memory"] == 1


def test_a_failing_query_is_failed_not_cancelled():
    def boom(plan, ctx, handle):
        raise ValueError("bad plan")
    with tservice.QueryService(executor=boom) as svc:
        h = svc.submit({"kind": "noop"})
        assert isinstance(h.exception(WAIT), ValueError)
        assert h.status == "failed"
        assert svc.stats()["counters"]["failed"] == 1
        with pytest.raises(ValueError, match="bad plan"):
            h.result(0)


@pytest.mark.parametrize("key", ["auron.tpu.serving.singleFlight",
                                 "auron.tpu.serving.useWorkerPool",
                                 "auron.tpu.cache.enable",
                                 "auron.tpu.history.enable",
                                 "auron.tpu.flightRecorder.enable"])
def test_left_out_features_raise_naming_item_16(key):
    tconf.conf.set(key, "true")
    try:
        with pytest.raises(NotImplementedError, match="item 16"):
            tservice.QueryService(executor=lambda p, c, h: None)
    finally:
        tconf.conf.unset(key)


def test_the_default_service_needs_the_configured_device():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cuda")
    try:
        import torch
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="auron.torch.device"):
                tservice.QueryService()
    finally:
        tconf.conf.unset(tconf.TORCH_DEVICE.key)


@pytest.mark.parametrize("name,leased", [("cuda", True), ("cpu", False)])
def test_an_injected_executor_takes_the_slot_stream_where_a_card_is(
        monkeypatch, name, leased):
    """Where a card is visible every executor, injected or not, runs
    through the slot's stream lease when the configured device is CUDA
    (the lease itself is stubbed: there is no card here)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    tconf.conf.set(tconf.TORCH_DEVICE.key, name)
    on_stream = []

    def own_stream(self, plan, ctx, handle):
        on_stream.append(self._device.type)
        return self._executor(plan, ctx, handle)

    monkeypatch.setattr(tservice.QueryService, "_on_own_stream", own_stream)
    try:
        with tservice.QueryService(executor=lambda p, c, h: "ran") as svc:
            assert svc.submit({}).result(timeout=WAIT) == "ran"
    finally:
        tconf.conf.unset(tconf.TORCH_DEVICE.key)
    assert on_stream == (["cuda"] if leased else [])


def test_an_injected_executor_runs_bare_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tservice.QueryService(executor=lambda p, c, h: "ran") as svc:
        assert svc._device is None
        assert svc.submit({}).result(timeout=WAIT) == "ran"


def test_the_config_keys_have_the_jax_names_and_defaults():
    from blaze_tpu import config as jconf
    for name in ("SERVING_MAX_CONCURRENT", "SERVING_MAX_QUEUE",
                 "SERVING_TENANT_MAX_INFLIGHT", "SERVING_ADMIT_MEM_BYTES",
                 "QUERY_DEADLINE_MS", "QUERY_MEM_QUOTA", "FAULTS_ENABLE",
                 "FAULTS_SEED", "FAULTS_RULES"):
        mine, ref = getattr(tconf, name), getattr(jconf, name)
        assert (mine.key, mine.default) == (ref.key, ref.default), name
    svc = tservice.QueryService(executor=lambda p, c, h: None)
    try:
        assert (svc.max_concurrent, svc.max_queue,
                svc.tenant_max_inflight, svc.admit_mem_bytes) == (4, 32, 8, 0)
    finally:
        svc.shutdown()


def test_serving_counters_and_the_tenant_histogram():
    from blaze_tpu_torch.bridge import profiling
    from blaze_tpu_torch.memory import MemManager
    MemManager.init(4 << 30)
    before = device_stats.snapshot()
    with tservice.QueryService(executor=lambda p, c, h: "ok",
                               max_queue=4) as svc:
        for t in ("t1", "t2", "t1"):
            assert svc.submit(N, tenant=t).result(WAIT) == "ok"
    delta = device_stats.delta(before)
    assert delta["serving_admitted"] == 3
    assert delta["serving_completed"] == 3
    assert set(device_stats.counter_families()["serving"]) == {
        f"serving_{k}" for k in svc.counters
        if k not in ("coalesced", "cache_hits")}
    body = profiling.prometheus_text()
    assert 'blaze_tenant_query_wall_seconds_count{tenant="t1"}' in body
    assert "blaze_serving_completed_total" in body


# -- HTTP ---------------------------------------------------------------------

@pytest.fixture
def http():
    from blaze_tpu_torch.bridge import profiling
    from blaze_tpu_torch.memory import MemManager
    MemManager.init(4 << 30)
    port = profiling.start_http_service()
    yield port
    profiling.stop_http_service()


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=WAIT) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_serving_stats_and_cancel_have_the_jax_keys(http):
    gate = Gated()
    svc = tservice.QueryService(executor=gate, max_concurrent=1,
                                max_queue=97)  # tells it from the others
    jsvc = jservice.QueryService(executor=lambda p, c, h: None)
    try:
        h = svc.submit(N, tenant="web")
        assert gate.started_event(1).wait(WAIT)
        code, body = _get(http, "/serving")
        assert code == 200
        mine = [s for s in body["services"] if s["max_queue"] == 97]
        assert len(mine) == 1 and mine[0]["running"] == 1
        assert set(mine[0]) == set(jsvc.stats())
        assert set(mine[0]["counters"]) == set(jsvc.stats()["counters"])
        assert _get(http, "/serving/cancel")[0] == 400
        code, body = _get(http, f"/serving/cancel?qid={h.query_id}")
        assert code == 200 and body == {"query_id": h.query_id,
                                        "cancelled": True}
        assert h.exception(WAIT) is not None
        assert _get(http, "/serving/cancel?qid=nope")[1]["cancelled"] is False
    finally:
        gate.release.set()
        svc.shutdown()
        jsvc.shutdown()


def test_http_progress_routes(http):
    from blaze_tpu_torch.serving import progress
    progress.reset()
    code, body = _get(http, "/query/qx/progress")
    assert code == 404 and "auron.tpu.stats.enable" in body["error"]
    progress.note_query_start("qx", "fp", None)
    progress.note_stage_start("qx", 0, 2)
    progress.note_task_done("qx", 0)
    code, body = _get(http, "/query/qx/progress")
    assert code == 200 and body["tasks_done"] == 1
    assert body["eta_source"] == "fraction"
    code, body = _get(http, "/progress")
    assert code == 200 and [r["query_id"] for r in body["running"]] == ["qx"]
    progress.reset()
