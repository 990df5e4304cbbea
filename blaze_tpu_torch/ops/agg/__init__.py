"""Aggregation plan node and functions of the PyTorch port."""

from blaze_tpu_torch.ops.agg.exec import AggExec, AggExecMode, AggMode
from blaze_tpu_torch.ops.agg.functions import (AggFunction, AvgAgg,
                                               CountAgg, MinMaxAgg, SumAgg,
                                               make_agg)

__all__ = ["AggExec", "AggExecMode", "AggFunction", "AggMode", "AvgAgg",
           "CountAgg", "MinMaxAgg", "SumAgg", "make_agg"]
