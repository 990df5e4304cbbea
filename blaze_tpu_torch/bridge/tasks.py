"""Task waves with per-task retry (port of `run_tasks` and
`_run_with_retries`, blaze_tpu/bridge/tasks.py).

Each task gets bounded attempts (`auron.tpu.task.maxAttempts`) with
exponential backoff and a deterministic jitter for RETRYABLE failures
(faults.classify_exception: transient IO, a corrupt frame), the
spark.task.maxFailures analog.  Fatal errors and FetchFailedError reach
the caller after ONE attempt: a bad plan does not improve on retry, and a
fetch failure needs the scheduler's lineage recovery, not a re-read of
the same poisoned block.  A retry runs under `decline_loop_scope`: it
takes the staged per-batch executor, the most conservative path, in case
the device stage loop was what failed.

The tasks of a wave run one at a time, in order, on the caller's thread:
they share one card, one stream and the kernels' per-stream scratch, and
the first terminal failure stops the wave.  The JAX package's thread
pool, its wave timeout (a wedged task thread abandoned as a
TimeoutError), the worker-process pool, speculative attempts and query
deadlines belong to ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import hashlib
import logging
import random
import time
from typing import Any, Callable, List

from blaze_tpu_torch.faults import classify_exception

log = logging.getLogger("blaze_tpu_torch.tasks")

_BACKOFF_CAP_S = 10.0


def _backoff_jitter(what: str, task: int, attempt: int) -> float:
    """Deterministic jitter in [0, 1): a pure function of (what, task,
    attempt), so runs replay with identical retry timing while distinct
    tasks still decorrelate.  The JAX package also keys it by its
    fault-injection seed, which comes with fault injection (item 16)."""
    key = f"backoff|{what}|{task}|{attempt}".encode()
    return random.Random(hashlib.sha256(key).digest()).random()


def _run_with_retries(fn: Callable[[int], Any], i: int, what: str) -> Any:
    """Bounded attempts around `fn(i)`."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.plan.stage_compiler import decline_loop_scope
    max_attempts = max(1, config.TASK_MAX_ATTEMPTS.get())
    base_s = max(0, config.TASK_RETRY_BACKOFF_MS.get()) / 1e3
    attempt = 1
    while True:
        try:
            if attempt == 1:
                return fn(i)
            # a retry declines the device stage loop, an optimization
            # that was live during the attempt that failed
            with decline_loop_scope():
                return fn(i)
        except BaseException as e:
            if classify_exception(e) != "retryable" \
                    or attempt >= max_attempts:
                raise
            delay = min(base_s * (2 ** (attempt - 1)), _BACKOFF_CAP_S)
            delay *= 1.0 + 0.25 * _backoff_jitter(what, i, attempt)
            log.warning("%s: task %d attempt %d/%d failed (%s: %s); "
                        "retrying in %.2fs", what, i, attempt, max_attempts,
                        type(e).__name__, e, delay)
            time.sleep(delay)
            attempt += 1


def run_tasks(fn: Callable[[int], Any], n: int, what: str) -> List[Any]:
    """`fn(i)` for every i < n in order, each with bounded retries, on the
    caller's thread; results in task order.  The first terminal failure
    is raised and no later task starts, so nothing of a failed wave runs
    on behind the caller."""
    return [_run_with_retries(fn, i, what) for i in range(n)]
