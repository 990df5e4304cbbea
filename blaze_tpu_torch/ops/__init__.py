"""Operators of the PyTorch port."""

from blaze_tpu_torch.ops.window import (LeadLagFunc, NthValueFunc, RankFunc,
                                        WindowAggFunc, WindowExec,
                                        WindowFunc, WindowRankType)

__all__ = ["LeadLagFunc", "NthValueFunc", "RankFunc", "WindowAggFunc",
           "WindowExec", "WindowFunc", "WindowRankType"]
