"""Shuffle index reading (port of `read_index_file`,
blaze_tpu/shuffle/exchange.py).  The in-process LocalShuffleExchange
belongs to a later slice (ROADMAP Queue 1 item 8); the stage scheduler
(plan/stages.py) and itest/q01.py register reduce-side blocks themselves
(`FileSegmentBlock` per map output)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from blaze_tpu_torch.faults import FetchFailedError


class ShuffleIndexError(FetchFailedError):
    """A `.index` file that is missing, truncated or inconsistent with its
    `.data`: a fetch failure, which the stage scheduler re-raises with the
    producer's stage and map id."""

    def __init__(self, reason: str):
        super().__init__(reason=reason)


def read_index_file(path: str, expected_partitions: Optional[int] = None,
                    data_file: Optional[str] = None) -> List[int]:
    """Cumulative offsets of one map output.  Validates the shape up front
    (length a multiple of 8, `expected_partitions` + 1 entries when given,
    monotone offsets from 0, last offset within the `.data` file) and
    raises ShuffleIndexError instead of slicing garbage."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise ShuffleIndexError(f"bad shuffle index {path}: {e}") from e
    if len(data) == 0 or len(data) % 8:
        raise ShuffleIndexError(f"bad shuffle index {path}: {len(data)} "
                                f"bytes is not a whole number of offsets")
    offsets = np.frombuffer(data, dtype="<i8")
    if expected_partitions is not None \
            and len(offsets) != expected_partitions + 1:
        raise ShuffleIndexError(
            f"bad shuffle index {path}: {len(offsets)} offsets, want "
            f"{expected_partitions + 1}")
    if offsets[0] != 0 or bool(np.any(np.diff(offsets) < 0)):
        raise ShuffleIndexError(f"bad shuffle index {path}: offsets do not "
                                f"start at 0 or are not monotone")
    if data_file is not None and (not os.path.exists(data_file) or int(
            offsets[-1]) > os.path.getsize(data_file)):
        raise ShuffleIndexError(f"bad shuffle index {path}: last offset "
                                f"exceeds the size of {data_file}")
    return offsets.tolist()
