"""Task waves with per-task retry (port of `run_tasks` and
`_run_with_retries`, blaze_tpu/bridge/tasks.py).

Each task gets bounded attempts (`auron.tpu.task.maxAttempts`) with
exponential backoff and a deterministic jitter for RETRYABLE failures
(faults.classify_exception: transient IO, a corrupt frame, an injected
fault), the spark.task.maxFailures analog.  Fatal errors and
FetchFailedError reach the caller after ONE attempt: a bad plan does not
improve on retry, and a fetch failure needs the scheduler's lineage
recovery, not a re-read of the same poisoned block.  A retry runs under
`decline_loop_scope`: it takes the staged per-batch executor, the most
conservative path, in case the device stage loop was what failed.

The serving query that governs the wave (`query`, by default the
thread's `bridge.context.current_query()`) is checked before every
attempt and before every task of the wave, so a cancel, a deadline or a
quota kill stops the wave at the next task boundary; the retry backoff
waits on the query's token, so a cancel interrupts it.  The `task-start`
fault site (faults.py) is evaluated before each attempt.

The tasks of a wave run one at a time, in order, on the caller's thread
(a query service slot runs its query's waves on its own thread and CUDA
stream): the first terminal failure stops the wave.  The JAX package's
thread pool, its wave timeout, the worker-process pool and speculative
attempts belong to ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import binascii
import logging
import random
import time
from typing import Any, Callable, List

from blaze_tpu_torch import faults
from blaze_tpu_torch.faults import classify_exception

log = logging.getLogger("blaze_tpu_torch.tasks")

_BACKOFF_CAP_S = 10.0


def _backoff_jitter(what: str, task: int, attempt: int) -> float:
    """Deterministic jitter in [0, 1): a pure function of the faults seed
    and (what, task, attempt), the crc32-keyed construction of
    faults.FaultInjector, so seeded chaos runs replay with identical
    retry timing while distinct tasks still decorrelate."""
    from blaze_tpu_torch import config
    seed = config.FAULTS_SEED.get()
    key = f"{seed}|backoff|{what}|{task}|{attempt}".encode()
    return random.Random(binascii.crc32(key)).random()


def _run_with_retries(fn: Callable[[int], Any], i: int, what: str,
                      query=None) -> Any:
    """Bounded attempts around `fn(i)`, each under a `task_attempt` span
    and inside `query_scope(query)`; the terminal state counts in
    bridge/device_stats.py (attempts, backoff, failure, a successful
    attempt's duration)."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.bridge import device_stats, tracing
    from blaze_tpu_torch.bridge.context import query_scope
    from blaze_tpu_torch.plan.stage_compiler import decline_loop_scope
    max_attempts = max(1, config.TASK_MAX_ATTEMPTS.get())
    base_s = max(0, config.TASK_RETRY_BACKOFF_MS.get()) / 1e3
    attempt = 1
    wait_ns = 0
    t0 = time.monotonic()
    with query_scope(query), tracing.execution_context(
            query=getattr(query, "query_id", None), task=i, what=what):
        while True:
            try:
                if query is not None:
                    query.check()
                faults.maybe_fail("task-start", task=i, attempt=attempt,
                                  what=what)
                with tracing.span("task_attempt", task=i, attempt=attempt,
                                  what=what):
                    if attempt == 1:
                        out = fn(i)
                    else:
                        # a retry declines the device stage loop, an
                        # optimization that was live during the attempt
                        # that failed
                        with decline_loop_scope():
                            out = fn(i)
                device_stats.note_task_attempts(attempt, wait_ns)
                device_stats.note_task_duration(
                    int((time.monotonic() - t0) * 1e9))
                return out
            except BaseException as e:
                if classify_exception(e) != "retryable" \
                        or attempt >= max_attempts:
                    device_stats.note_task_attempts(attempt, wait_ns,
                                                    failed=True)
                    raise
                delay = min(base_s * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
                delay *= 1.0 + 0.25 * _backoff_jitter(what, i, attempt)
                log.warning("%s: task %d attempt %d/%d failed (%s: %s); "
                            "retrying in %.2fs", what, i, attempt,
                            max_attempts, type(e).__name__, e, delay)
                tracing.instant("task_retry", task=i, attempt=attempt,
                                error=type(e).__name__, what=what)
                w0 = time.perf_counter_ns()
                with tracing.span("backoff_wait", task=i, attempt=attempt,
                                  what=what, delay_s=round(delay, 4)):
                    if query is not None:
                        # a cancel during the backoff ends it at once
                        if query.wait_cancelled(delay):
                            query.check()
                    else:
                        time.sleep(delay)
                wait_ns += time.perf_counter_ns() - w0
                attempt += 1


def run_tasks(fn: Callable[[int], Any], n: int, what: str,
              query=None) -> List[Any]:
    """`fn(i)` for every i < n in order, each with bounded retries, on the
    caller's thread; results in task order.  `query` (by default the
    thread's current query) is checked before each task, so a cancelled
    query starts no further task; the first terminal failure is raised
    and no later task starts, so nothing of a failed wave runs on behind
    the caller.  The wave's wall counts in bridge/device_stats.py."""
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.bridge.context import current_query
    if query is None:
        query = current_query()
    t0 = time.monotonic()
    out = []
    for i in range(n):
        if query is not None and query.cancelled:
            query.check()
        out.append(_run_with_retries(fn, i, what, query))
    device_stats.note_wave_wall(int((time.monotonic() - t0) * 1e9))
    return out
