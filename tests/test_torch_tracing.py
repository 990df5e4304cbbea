"""The port's span tracer (blaze_tpu_torch/bridge/tracing.py): the name
registry, disabled tracing a no-op, the lazily probed
`auron.tpu.trace.enable`, unregistered names rejected, spans nesting
under their parents with the execution context, and every registered
name emitted by some port path on the CPU, except `graph_capture`, which
only a CUDA graph capture on the card emits (chip_smoke.py's staging and
accounting phase reads it there).

Tolerance: exact."""

import os
import sys

import pytest

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import tracing

#: emitted on the card only (a stage-loop graph capture)
CARD_ONLY = {"graph_capture"}


def _drop():
    tracing.stop_tracing()
    with tracing._lock:
        tracing._spans.clear()
    tracing.reset_conf_probe()


@pytest.fixture(autouse=True)
def clean():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    _drop()
    yield
    _drop()
    for opt in (tconf.TORCH_DEVICE, tconf.TRACE_ENABLE,
                tconf.DAG_SINGLE_TASK_BYTES, tconf.STAGE_DEVICE_LOOP_ENABLE,
                tconf.ON_DEVICE_AGG_CAPACITY, tconf.TASK_RETRY_BACKOFF_MS):
        tconf.conf.unset(opt.key)


def test_disabled_tracing_records_nothing():
    assert not tracing.enabled()
    with tracing.span("task", mode="sync"):
        tracing.instant("task_retry", task=0)
        tracing.emit_span("operator:X", 5)
        # unregistered names are not even checked while disabled
        with tracing.span("not-a-span"):
            pass
    assert tracing.spans() == []


def test_conf_knob_is_probed_lazily():
    tconf.conf.set(tconf.TRACE_ENABLE.key, True)
    assert tracing.enabled()  # first read probes the key
    with tracing.execution_context(query="knob"):
        tracing.instant("task_retry", task=1)
    assert [s["name"] for s in tracing.spans_for_query("knob")] == \
        ["task_retry"]
    tconf.conf.set(tconf.TRACE_ENABLE.key, False)
    assert tracing.enabled()  # probed once
    tracing.reset_conf_probe()
    assert not tracing.enabled()


def test_unregistered_names_are_rejected():
    tracing.start_tracing()
    with pytest.raises(ValueError, match="unregistered span name"):
        tracing.instant("made_up")
    with pytest.raises(ValueError):
        with tracing.span("also_made_up"):
            pass
    tracing.emit_span("operator:AnyExec", 10)  # a prefix family
    tracing.register_span("extra_site", "an out-of-tree emitter")
    try:
        tracing.instant("extra_site")
    finally:
        del tracing.SPAN_NAMES["extra_site"]


def test_spans_nest_and_carry_their_context(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tracing.start_tracing(path)
    with tracing.execution_context(query="n", stage=2):
        with tracing.span("task", mode="sync"):
            with tracing.execution_context(partition=5):
                tracing.instant("task_retry", task=5)
    spans = tracing.stop_tracing()
    outer, inner = ([s for s in spans if s["name"] == n][0]
                    for n in ("task", "task_retry"))
    assert inner["parent"] == outer["sid"]
    assert inner["ctx"] == {"query": "n", "stage": 2, "partition": 5}
    assert outer["ctx"] == {"query": "n", "stage": 2}
    assert outer["dur_ns"] > 0 and inner["dur_ns"] == 0
    with open(path) as f:
        assert len(f.readlines()) == 2


def _q01(root):
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest import queries as TQ
    from blaze_tpu_torch.itest.tpcds_data import (make_tables,
                                                  write_parquet_splits)
    tables = make_tables(0.02, QD.TABLES)
    paths = write_parquet_splits(tables, str(root), 2)
    return TQ.q01(paths, tables, partitions=2)[0]


class _Consumer:
    """A memory consumer that releases everything it holds."""

    def __init__(self, name, query=None):
        from blaze_tpu_torch.memory.manager import MemConsumer

        class C(MemConsumer):
            def spill(self):
                released, self._mem_used = self._mem_used, 0
                return released
        self.c = C(name)
        self.c.query = query


class _Query:
    query_id = "quota-q"
    mem_quota = 1000
    rung = 0

    def degrade(self):
        self.rung += 1
        return self.rung


def _fake_nvcc(tmp_path):
    """An `nvcc` that writes its -o file: the build path without CUDA."""
    script = tmp_path / "nvcc"
    script.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    os.chmod(script, 0o755)
    return str(script)


def test_every_registered_name_is_emitted_by_a_port_path(tmp_path,
                                                         monkeypatch):
    from blaze_tpu_torch.bridge.tasks import run_tasks
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.kernels import build
    from blaze_tpu_torch.memory import MemManager
    from blaze_tpu_torch.plan.explain import explain_analyze
    tconf.conf.set(tconf.DAG_SINGLE_TASK_BYTES.key, 0)
    tconf.conf.set(tconf.TASK_RETRY_BACKOFF_MS.key, 0)
    plan = _q01(tmp_path / "q01")
    tracing.start_tracing()
    # task, task_attempt, shuffle_exchange, operator:*, explain_analyze,
    # and with the loop on (eager on the CPU) stage_loop_chunk
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_ENABLE.key, "on")
    explain_analyze(plan, record=False)
    # a partial table of 16 slots overflows: stage_loop_fallback
    tconf.conf.set(tconf.ON_DEVICE_AGG_CAPACITY.key, 16)
    explain_analyze(plan, record=False)
    tconf.conf.unset(tconf.ON_DEVICE_AGG_CAPACITY.key)
    # a corrupt block: stage_recovery
    QD.CorruptingScheduler(0).run_collect(plan)
    # a retryable failure: task_retry, backoff_wait
    first = []

    def flaky(i):
        if not first:
            first.append(i)
            raise OSError("transient")
        return i
    assert run_tasks(flaky, 1, "flaky") == [0]
    # pressure and a quota: mem_spill, quota_breach
    mm = MemManager.init(1 << 20)
    try:
        big = _Consumer("big").c
        big.set_spillable(mm)
        big.update_mem_used(4 << 20)
        q = _Query()
        held = _Consumer("held", q).c
        held.set_spillable(mm)
        held.update_mem_used(2000)
        assert q.rung == 1
    finally:
        MemManager.init(4 << 30)
    # an nvcc build: kernel_build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path))
    assert "crc32c" in build.build_all(["crc32c"])
    emitted = {s["name"] for s in tracing.stop_tracing()}
    families = {n for n in emitted if ":" in n}
    assert "operator:ParquetScanExec" in families
    names = (emitted - families) | {n.split(":")[0] + ":*"
                                    for n in families}
    assert names | CARD_ONLY == set(tracing.SPAN_NAMES)
    assert not names & CARD_ONLY
