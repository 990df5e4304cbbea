"""Joins of the PyTorch port: broadcast, shuffled-hash and sort-merge
equi-joins over the device probe (kernels/join.py), and the broadcast
nested-loop join (bnlj.py)."""

from blaze_tpu_torch.ops.joins.exec import (BaseJoinExec, BroadcastJoinExec,
                                            BuildHashMapExec, JoinMap,
                                            JoinType, ShuffledHashJoinExec,
                                            SortMergeJoinExec,
                                            build_join_map)
from blaze_tpu_torch.ops.joins.bnlj import BroadcastNestedLoopJoinExec

__all__ = ["BaseJoinExec", "BroadcastJoinExec",
           "BroadcastNestedLoopJoinExec", "BuildHashMapExec", "JoinMap",
           "JoinType", "ShuffledHashJoinExec", "SortMergeJoinExec",
           "build_join_map"]
