"""L6 plan-translation layer of the PyTorch port (a copy of
blaze_tpu/convert/: the AuronConvertStrategy + AuronConverters +
NativeConverters analog), and the Flink front end (convert/flink.py,
convert/flink_runtime.py)."""

from blaze_tpu_torch.convert.spark import (ConversionError, ConversionResult,
                                           convert_spark_plan)

__all__ = ["ConversionError", "ConversionResult", "convert_spark_plan"]
