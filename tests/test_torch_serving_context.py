"""The port's per-query context (blaze_tpu_torch/serving/context.py) and
the degradation hooks it drives, against the JAX package's
(blaze_tpu/serving/context.py): the same call sequences give the same
states (first cancel wins, a deadline, the rungs then the kill), and the
same ladder gives the same coalesce target (`effective_batch_size`) and
stage-loop chunk width (`loop_chunk_batches`).  The bridge's
`query_scope` binds a query to its thread, a TaskContext's probe raises
its cancellation, and the task wave stops at a cancelled query and cuts
its retry backoff short.  Deadlines here are set in the past, never
raced."""

import threading
import time

import pytest

from blaze_tpu.bridge import context as jbridge
from blaze_tpu.ops.base import effective_batch_size as jeffective
from blaze_tpu.runtime import loop as jloop
from blaze_tpu.serving import context as jctx
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import context as tbridge
from blaze_tpu_torch.ops.base import effective_batch_size
from blaze_tpu_torch.runtime import loop as tloop
from blaze_tpu_torch.serving import context as tctx

#: call sequences: (method, args) applied to a fresh context of each
SEQUENCES = {
    "cancel then deadline": [("cancel", ("stop it",)),
                             ("cancel", ("too late", "deadline"))],
    "deadline then cancel": [("cancel", ("", "deadline")),
                             ("cancel", ("late",))],
    "mem kill wins": [("degrade", ()), ("degrade", ()), ("degrade", ()),
                      ("cancel", ("after the kill",))],
    "rungs": [("degrade", ()), ("degrade", ())],
    "five rungs": [("degrade", ())] * 5,
    "cancel then rungs": [("cancel", ("first",)), ("degrade", ()),
                          ("degrade", ()), ("degrade", ())],
    "nothing": [],
}


def _state(mod, ctx):
    """Everything observable of a context, the raised exception's type
    name and message included."""
    try:
        ctx.check()
        raised = None
    except mod.QueryCancelled as e:
        raised = (type(e).__name__, str(e), e.reason)
    return {"cancelled": ctx.cancelled, "kind": ctx._cancel_kind,
            "level": ctx.degrade_level,
            "passthrough": ctx.force_agg_passthrough,
            "shrink": ctx.capacity_shrink, "raised": raised,
            "waited": ctx.wait_cancelled(0)}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_call_sequences_give_the_jax_states(seq):
    got, want = [], []
    for mod, out in ((tctx, got), (jctx, want)):
        ctx = mod.QueryContext("q7", tenant="t", mem_quota=123)
        for name, args in SEQUENCES[seq]:
            out.append(getattr(ctx, name)(*args))
        out.append(_state(mod, ctx))
    assert got == want


def test_a_past_deadline_cancels_at_check():
    for mod in (tctx, jctx):
        ctx = mod.QueryContext("qd", deadline_ms=50)
        ctx.deadline = time.monotonic() - 1.0  # passed, not raced
        assert ctx.remaining_ms() < 0
        with pytest.raises(mod.DeadlineExceeded, match="50ms"):
            ctx.check()
        assert ctx._cancel_kind == "deadline" and ctx.cancelled


def test_no_deadline_and_ids():
    ctx = tctx.QueryContext()
    assert ctx.remaining_ms() is None and ctx.query_id.startswith("q")
    assert tctx.DEGRADE_LADDER == jctx.DEGRADE_LADDER
    assert issubclass(tctx.DeadlineExceeded, tctx.QueryCancelled)
    assert issubclass(tctx.QueryMemoryExceeded, tctx.QueryCancelled)


def test_is_cancellation():
    assert tctx.is_cancellation(tctx.QueryCancelled("q"))
    assert tctx.is_cancellation(tbridge.TaskKilledError("x"))
    assert not tctx.is_cancellation(RuntimeError("x"))


@pytest.mark.parametrize("rungs", [0, 1, 2, 3, 6])
@pytest.mark.parametrize("base", [8192, 300, 32768])
def test_effective_batch_size_equals_the_jax_ladder(rungs, base):
    got = []
    for mod, bridge, fn in ((tctx, tbridge, effective_batch_size),
                            (jctx, jbridge, jeffective)):
        ctx = mod.QueryContext()
        for _ in range(rungs):
            ctx.degrade()
        with bridge.query_scope(ctx):
            got.append(fn(base))
        assert fn(base) == base  # no query bound: no shrink
    assert got[0] == got[1]


@pytest.mark.parametrize("chunk", [8, 3, 1])
@pytest.mark.parametrize("rungs", [0, 2, 3, 5])
def test_loop_chunk_shrink_equals_the_jax_loop(chunk, rungs):
    from blaze_tpu import config as jconf
    tconf.conf.set(tconf.STAGE_DEVICE_LOOP_CHUNK.key, chunk)
    jconf.conf.set(jconf.STAGE_DEVICE_LOOP_CHUNK.key, chunk)
    try:
        got = []
        for mod, bridge, lp in ((tctx, tbridge, tloop),
                                (jctx, jbridge, jloop)):
            ctx = mod.QueryContext()
            for _ in range(rungs):
                ctx.degrade()
            with bridge.query_scope(ctx):
                got.append(lp.loop_chunk_batches())
        assert got[0] == got[1]
    finally:
        tconf.conf.unset(tconf.STAGE_DEVICE_LOOP_CHUNK.key)
        jconf.conf.unset(jconf.STAGE_DEVICE_LOOP_CHUNK.key)


def test_query_scope_binds_the_thread_and_the_task_probe():
    ctx = tctx.QueryContext("qs")
    assert tbridge.current_query() is None
    with tbridge.query_scope(ctx):
        assert tbridge.current_query() is ctx
        assert tbridge.active_query() is ctx
        seen = []
        t = threading.Thread(target=lambda: seen.append(
            tbridge.current_query()))
        t.start()
        t.join(10)
        assert seen == [None]  # another thread sees no binding
        task = tbridge.TaskContext()
        task.check_running()
        ctx.cancel("stop")
        with pytest.raises(tctx.QueryCancelled, match="stop"):
            task.check_running()
    assert tbridge.current_query() is None
    with tbridge.query_scope(None):
        assert tbridge.current_query() is None
    # a task context carrying the query raises on another thread too
    carried = tbridge.TaskContext(query=ctx)
    errs = []

    def probe():
        with tbridge.task_scope(carried):
            try:
                tbridge.current_task().check_running()
            except tctx.QueryCancelled as e:
                errs.append(e)
    t = threading.Thread(target=probe)
    t.start()
    t.join(10)
    assert len(errs) == 1


def test_query_scopes_nest_and_each_thread_keeps_its_own():
    outer, inner = tctx.QueryContext("qo"), tctx.QueryContext("qi")
    seen = {}

    def other():
        seen["other"] = tbridge.current_query()
        with tbridge.query_scope(inner):
            seen["other inside"] = tbridge.active_query()
    with tbridge.query_scope(outer):
        with tbridge.query_scope(None):
            assert tbridge.current_query() is None
        with tbridge.query_scope(inner):
            t = threading.Thread(target=other)
            t.start()
            t.join(10)
            assert tbridge.active_query() is inner
        assert tbridge.current_query() is outer
        # a task's own query wins over the thread's binding
        with tbridge.task_scope(tbridge.TaskContext(query=inner)):
            assert tbridge.active_query() is inner
        assert tbridge.active_query() is outer
    assert tbridge.current_query() is None
    assert seen == {"other": None, "other inside": inner}


def test_the_wave_stops_at_a_cancelled_query():
    from blaze_tpu_torch.bridge.tasks import run_tasks
    ctx = tctx.QueryContext("qw")
    ran = []

    def fn(i):
        ran.append(i)
        if i == 1:
            ctx.cancel("mid-wave")
        return i
    with tbridge.query_scope(ctx):
        with pytest.raises(tctx.QueryCancelled, match="mid-wave"):
            run_tasks(fn, 5, "wave")
    assert ran == [0, 1]
    # an already cancelled query starts no task, passed explicitly too
    with pytest.raises(tctx.QueryCancelled):
        run_tasks(lambda i: ran.append(i), 3, "none", query=ctx)
    assert ran == [0, 1]


def test_the_retry_backoff_is_cut_short_by_a_cancel():
    """A 30 s backoff after a retryable failure ends as soon as another
    thread cancels the query (the JAX package's
    test_retry_backoff_interruptible_by_cancel, without its sleep)."""
    from blaze_tpu_torch.bridge.tasks import run_tasks
    tconf.conf.set(tconf.TASK_RETRY_BACKOFF_MS.key, 30_000)
    ctx = tctx.QueryContext("qb")
    failed = threading.Event()

    def fn(i):
        failed.set()
        raise OSError("transient")
    errs = []

    def wave():
        try:
            run_tasks(fn, 1, "backoff", query=ctx)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)
    t = threading.Thread(target=wave)
    try:
        t0 = time.monotonic()
        t.start()
        assert failed.wait(10)
        ctx.cancel("stop the backoff")
        t.join(10)
        assert not t.is_alive()
        assert time.monotonic() - t0 < 10
        assert isinstance(errs[0], tctx.QueryCancelled)
    finally:
        tconf.conf.unset(tconf.TASK_RETRY_BACKOFF_MS.key)


def test_rung_one_declines_the_stage_loop():
    ctx = tctx.QueryContext()
    ctx.degrade()
    with tbridge.query_scope(ctx):
        with pytest.raises(tloop.StageLoopFallback, match="pass-through"):
            with tloop._folded(None, 0):
                pass
