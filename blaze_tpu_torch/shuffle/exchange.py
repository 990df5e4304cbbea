"""Shuffle index reading (port of `read_index_file`,
blaze_tpu/shuffle/exchange.py).  The in-process LocalShuffleExchange
belongs to a later slice; callers register reduce-side blocks themselves
(`FileSegmentBlock` per map output, see itest/q01.py)."""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np


class ShuffleIndexError(IOError):
    """A `.index` file that is truncated or inconsistent with its `.data`."""


def read_index_file(path: str, expected_partitions: Optional[int] = None,
                    data_file: Optional[str] = None) -> List[int]:
    """Cumulative offsets of one map output.  Validates the shape up front
    (length a multiple of 8, `expected_partitions` + 1 entries when given,
    monotone offsets from 0, last offset within the `.data` file) and
    raises ShuffleIndexError instead of slicing garbage."""
    with open(path, "rb") as f:
        data = f.read()
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
    if data_file is not None and int(offsets[-1]) > os.path.getsize(data_file):
        raise ShuffleIndexError(f"bad shuffle index {path}: last offset "
                                f"exceeds the size of {data_file}")
    return offsets.tolist()
