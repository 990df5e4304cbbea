"""Failure classification for task retry and lineage recovery (the port's
copy of `FetchFailedError` and `classify_exception`,
blaze_tpu/faults.py).

  * `FetchFailedError`: a shuffle block could not be read back intact.  It
    names the producer stage and map task that wrote the block, so the
    stage scheduler (plan/stages.py) re-runs only that map task.
  * `classify_exception`: 'retryable' (transient IO, a corrupt frame, a
    leaked stage-loop fallback), 'fetch-failed' (lineage recovery, never a
    retry in place) or 'fatal' (plan, serde and logic errors: fail fast).

Fault injection, worker crashes and task deadlines belong to the
host-subsystem slice of the port (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations


class FetchFailedError(RuntimeError):
    """A shuffle block could not be read back intact (Spark's
    FetchFailedException).  Carries the producer stage id and map task id
    that wrote the block."""

    def __init__(self, stage_id: int = -1, map_id: int = -1,
                 reason: str = ""):
        self.stage_id = int(stage_id)
        self.map_id = int(map_id)
        self.reason = reason
        super().__init__(
            f"shuffle fetch failed (stage={stage_id} map={map_id})"
            + (f": {reason}" if reason else ""))


def classify_exception(e: BaseException) -> str:
    """'retryable' | 'fetch-failed' | 'fatal'.

    A fetch failure goes to the scheduler's lineage recovery: re-running
    the reading task would re-read the same poisoned block."""
    from blaze_tpu_torch.shuffle.ipc import ShuffleChecksumError
    if isinstance(e, FetchFailedError):
        return "fetch-failed"
    if isinstance(e, (ShuffleChecksumError, EOFError, ConnectionError,
                      BrokenPipeError, InterruptedError)):
        return "retryable"
    if isinstance(e, (MemoryError, KeyboardInterrupt, SystemExit)):
        return "fatal"
    if isinstance(e, OSError):
        return "retryable"  # transient filesystem trouble
    if type(e).__name__ == "StageLoopFallback":
        # every stage-loop caller handles the fallback in place; one that
        # leaks is retried with the loop declined (bridge/tasks.py)
        return "retryable"
    return "fatal"
