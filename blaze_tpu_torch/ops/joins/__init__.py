"""Joins of the PyTorch port: broadcast, shuffled-hash and sort-merge
equi-joins over the device probe (kernels/join.py)."""

from blaze_tpu_torch.ops.joins.exec import (BaseJoinExec, BroadcastJoinExec,
                                            BuildHashMapExec, JoinMap,
                                            JoinType, ShuffledHashJoinExec,
                                            SortMergeJoinExec,
                                            build_join_map)

__all__ = ["BaseJoinExec", "BroadcastJoinExec", "BuildHashMapExec",
           "JoinMap", "JoinType", "ShuffledHashJoinExec",
           "SortMergeJoinExec", "build_join_map"]
