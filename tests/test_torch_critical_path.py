"""The port's critical-path attribution (blaze_tpu_torch/bridge/
critical_path.py) against the JAX package's on the same synthetic span
traces: `attribute`, `critical_path` and `bottleneck_report` give equal
dicts; the port's compile instants (`kernel_build`, `graph_capture`)
count in `device_compute` as the reference's `xla_compile` does; the
categories sum to the extent.

Tolerance: exact dict equality; the category sum to the extent within
1e-9 relative."""

import copy

import numpy as np
import pytest

from blaze_tpu.bridge import critical_path as J
from blaze_tpu_torch.bridge import critical_path as T

_MS = 1_000_000


def _span(name, t0_ms, dur_ms, sid, parent=None, **attrs):
    t0, dur = int(t0_ms * _MS), int(dur_ms * _MS)
    r = {"name": name, "t0_ns": t0, "t1_ns": t0 + dur, "dur_ns": dur,
         "sid": sid, "thread": "t", "attrs": dict(attrs)}
    if parent is not None:
        r["parent"] = parent
    return r


SHARED = ("task", "task_attempt", "shuffle_exchange", "stage_recovery",
          "stage_loop_chunk", "backoff_wait", "explain_analyze",
          "operator:ParquetScanExec", "operator:SortExec",
          "operator:BroadcastJoinExec", "task_retry", "mem_spill",
          "admission_wait", "device_exchange")


def _random_trace(seed, n=60):
    rng = np.random.default_rng(seed)
    spans = [_span("explain_analyze", 0, 1000, 1, stage=0)]
    for sid in range(2, n):
        parent = int(rng.integers(1, sid))
        spans.append(_span(
            SHARED[int(rng.integers(len(SHARED)))],
            float(rng.uniform(0, 900)), float(rng.uniform(0, 120)), sid,
            parent=parent if rng.random() < 0.8 else None,
            stage=int(rng.integers(0, 5))))
    return spans


TRACES = {
    "sum to wall": [
        _span("admission_wait", 0, 50, 1),
        _span("task", 50, 300, 2),
        _span("shuffle_exchange", 100, 80, 3, parent=2),
        _span("stage_loop_chunk", 200, 60, 4, parent=2),
        _span("operator:ParquetScanExec", 260, 30, 5, parent=2),
        _span("device_exchange", 400, 100, 6)],
    "gap": [_span("task", 0, 100, 1), _span("task", 200, 100, 2)],
    "malformed": [None, 42, {"name": 7}, {"name": "task", "t0_ns": "x"},
                  _span("task", 0, 10, 1)],
    "empty": [],
    **{f"random {s}": _random_trace(s) for s in range(4)},
}


def _as_jax(spans):
    """The same trace with the port's compile instants under the
    reference's name."""
    out = copy.deepcopy(spans)
    for r in out:
        if isinstance(r, dict) and r.get("name") in ("kernel_build",
                                                    "graph_capture"):
            r["name"] = "xla_compile"
    return out


@pytest.mark.parametrize("case", sorted(TRACES))
def test_attribution_equals_the_jax_one(case):
    spans = TRACES[case]
    assert T.attribute(spans) == J.attribute(spans)
    assert T.critical_path(spans) == J.critical_path(spans)
    assert T.bottleneck_report(spans, 1.5) == J.bottleneck_report(spans, 1.5)
    att = T.attribute(spans)
    total = sum(att[c] for c in T.CATEGORIES)
    assert total == pytest.approx(att["wall_s"], rel=1e-9, abs=1e-12)
    assert T.CATEGORIES == J.CATEGORIES


@pytest.mark.parametrize("name", ["kernel_build", "graph_capture"])
def test_compile_instants_count_as_device_compute(name):
    spans = [{"name": name, "t0_ns": 0, "t1_ns": 0, "dur_ns": 0, "sid": 1,
              "attrs": {"kernel": "k", "ns": 100 * _MS}},
             _span("task", 100, 100, 2),
             _span("shuffle_exchange", 120, 50, 3, parent=2)]
    got = T.attribute(spans)
    assert got["device_compute"] == pytest.approx(0.100)
    assert got == J.attribute(_as_jax(spans))
    assert T.bottleneck_report(spans) == \
        J.bottleneck_report(_as_jax(spans))
