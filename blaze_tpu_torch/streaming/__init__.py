"""The streaming runtime: continuous micro-batch execution with
checkpointed state, event-time watermarks and an exactly-once sink (port
of blaze_tpu/streaming/; ref auron-flink-extension/)."""

from blaze_tpu_torch.streaming.checkpoint import CheckpointManager
from blaze_tpu_torch.streaming.executor import (MemoryStreamSource,
                                                StreamExecutor,
                                                StreamWindowConfig,
                                                streaming_service_executor)
from blaze_tpu_torch.streaming.sink import ExactlyOnceParquetSink

__all__ = ["CheckpointManager", "ExactlyOnceParquetSink",
           "MemoryStreamSource", "StreamExecutor", "StreamWindowConfig",
           "streaming_service_executor"]
