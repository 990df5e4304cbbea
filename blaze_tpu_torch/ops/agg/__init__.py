"""Aggregation plan node and functions of the PyTorch port."""

from blaze_tpu_torch.ops.agg.exec import AggExec, AggExecMode, AggMode
from blaze_tpu_torch.ops.agg.functions import (AggFunction, CountAgg,
                                               MinMaxAgg, SumAgg, make_agg)

__all__ = ["AggExec", "AggExecMode", "AggFunction", "AggMode", "CountAgg",
           "MinMaxAgg", "SumAgg", "make_agg"]
