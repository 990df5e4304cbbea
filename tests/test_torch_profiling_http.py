"""The port's profiling HTTP service (blaze_tpu_torch/bridge/
profiling.py), as tests/test_profiling_http.py holds the JAX package's:
/status, /metrics, /metrics.prom, /profile and /profile/<qid>,
/query/<qid>/timeline and /bottleneck, /trace/start's validation and a
torch.profiler trace written by /trace/stop, /history* answering 404,
the unknown-path listing and the profile LRU.

Tolerance: exact."""

import json
import os
import urllib.error
import urllib.request

import pytest

from blaze_tpu_torch.bridge import device_stats, profiling, tracing
from blaze_tpu_torch.memory import MemManager


@pytest.fixture(autouse=True)
def service():
    MemManager.init(4 << 30)
    port = profiling.start_http_service()
    yield port
    profiling.stop_http_service()


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _get_error(port, path):
    try:
        _get(port, path)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())
    raise AssertionError(f"{path} unexpectedly succeeded")


def test_status_reports_memory_manager(service):
    code, _ctype, body = _get(service, "/status")
    assert code == 200
    status = json.loads(body)
    assert status["mem_manager"].startswith("MemManager total=")
    assert "device_memory" in status


def test_metrics_serves_recorded_trees(service):
    profiling.record_metrics({"name": "FilterExec",
                              "values": {"output_rows": 42},
                              "children": []})
    code, _ctype, body = _get(service, "/metrics")
    assert code == 200
    assert any(t.get("name") == "FilterExec" and
               t["values"]["output_rows"] == 42 for t in json.loads(body))


def test_metrics_prom_exposition(service):
    device_stats.reset()
    device_stats.note_compile("nvcc:radix", 1500)
    device_stats.note_compile_hit("nvcc:radix")
    device_stats.note_h2d(1024)
    device_stats.note_task_duration(3_000_000)
    profiling.record_metrics({"name": "ScanExec",
                              "values": {"output_rows": 7,
                                         "io_bytes": 123},
                              "children": []})
    code, ctype, body = _get(service, "/metrics.prom")
    assert code == 200 and ctype.startswith("text/plain")
    assert 'blaze_compiles_total{kernel="nvcc:radix"} 1' in body
    assert 'blaze_compile_cache_hits_total{kernel="nvcc:radix"} 1' in body
    assert 'blaze_compile_ns_total{kernel="nvcc:radix"} 1500' in body
    assert "blaze_h2d_bytes_total 1024" in body
    assert "blaze_placement_launches_total" in body
    assert "blaze_mem_peak_used_bytes" in body
    assert 'blaze_operator_output_rows_total{operator="ScanExec"} 7' in body
    assert 'blaze_operator_io_bytes_total{operator="ScanExec"} 123' in body
    assert body.count("# TYPE blaze_h2d_bytes_total counter") == 1
    assert "# TYPE blaze_task_duration_seconds histogram" in body
    assert 'blaze_task_duration_seconds_bucket{le="0.005"} 1' in body
    assert "blaze_task_duration_seconds_count 1" in body
    # two scrapes give the same HELP/TYPE headers
    assert _get(service, "/metrics.prom")[2].count("# TYPE") == \
        body.count("# TYPE")


def test_profile_endpoints(service):
    profiling.record_profile("q-http-1", {
        "query_id": "q-http-1", "wall_ns": 1000,
        "tree": {"name": "AggExec", "values": {"output_rows": 5},
                 "children": []},
        "output_rows": 5})
    code, _ctype, body = _get(service, "/profile")
    assert code == 200
    assert any(p["query_id"] == "q-http-1" and p["output_rows"] == 5
               for p in json.loads(body))
    code, _ctype, body = _get(service, "/profile/q-http-1")
    assert code == 200 and json.loads(body)["tree"]["name"] == "AggExec"
    code, err = _get_error(service, "/profile/nope")
    assert code == 404 and "q-http-1" in err["known"]


def test_profile_store_is_an_lru(service, monkeypatch):
    monkeypatch.setattr(profiling, "_MAX_PROFILES", 4)
    for i in range(6):
        profiling.record_profile(f"ring-{i}", {"wall_ns": i})
    profiling.get_profile("ring-2")  # touched: kept over ring-3
    profiling.record_profile("ring-6", {"wall_ns": 6})
    known = [p["query_id"] for p in profiling.list_profiles()]
    assert known == ["ring-4", "ring-5", "ring-2", "ring-6"]


def test_query_timeline_and_bottleneck(service):
    tracing.start_tracing()
    try:
        with tracing.execution_context(query="q-http-tl"):
            with tracing.span("task_attempt", task=0, attempt=1,
                              what="http-tl"):
                with tracing.span("stage_loop_chunk", chunk=0):
                    pass
            tracing.instant("mem_spill", consumer="sort", bytes=64)
            tracing.instant("kernel_build", kernel="radix", ns=2_000_000)
        code, _ctype, body = _get(service, "/query/q-http-tl/timeline")
        assert code == 200
        tl = json.loads(body)
        assert tl["query_id"] == "q-http-tl"
        names = {e["name"]: e for e in tl["traceEvents"] if "ts" in e}
        assert names["task_attempt"]["ph"] == "X"
        assert names["mem_spill"]["ph"] == "i"
        att = tl["attribution"]
        assert att["span_count"] == 4 and att["spill_bytes"] == 64
        assert att["device_dispatches"] == 1
        assert att["compile_seconds"] == pytest.approx(0.002)
        code, _ctype, body = _get(service, "/query/q-http-tl/bottleneck")
        assert code == 200 and json.loads(body)["span_count"] == 4
        for path in ("/query/never/timeline", "/query/never/bottleneck"):
            code, err = _get_error(service, path)
            assert code == 404 and "never" in err["error"]
    finally:
        tracing.stop_tracing()
        with tracing._lock:
            tracing._spans.clear()
        tracing.reset_conf_probe()


def test_trace_start_validates_and_stop_writes_a_trace(service, tmp_path):
    code, err = _get_error(service, "/trace/start?/tmp/x")
    assert code == 400 and "expected ?dir=" in err["error"]
    code, err = _get_error(service, "/trace/start?dir=relative/path")
    assert code == 400 and "absolute" in err["error"]
    code, err = _get_error(service, "/trace/stop")
    assert code == 409
    out = str(tmp_path / "trace")
    code, _ctype, body = _get(service, f"/trace/start?dir={out}")
    assert code == 200 and json.loads(body)["tracing"]
    code, err = _get_error(service, f"/trace/start?dir={out}")
    assert code == 409
    code, _ctype, body = _get(service, "/trace/stop")
    assert code == 200
    assert os.path.getsize(json.loads(body)["trace"]) > 0


@pytest.mark.parametrize("path", ["/history", "/history/q1",
                                  "/history/rollup"])
def test_history_routes_name_the_later_item(service, path):
    code, err = _get_error(service, path)
    assert code == 404 and "item 16" in err["error"]


def test_unknown_path_404_lists_routes(service):
    code, err = _get_error(service, "/nope")
    assert code == 404
    assert "/metrics.prom" in err["paths"]
    assert "/profile/<qid>" in err["paths"]
    assert "/query/<qid>/timeline" in err["paths"]
