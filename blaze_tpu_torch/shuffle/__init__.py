"""Shuffle of the PyTorch port: the hash, round-robin, single and range
partitionings, the framed IPC format, the map-side writer, the
reduce-side reader, the in-process exchange, the Arrow import node
(`FFIReaderExec`) and the collect path's writer (`IpcWriterExec`)."""

from blaze_tpu_torch.shuffle.exchange import (LocalShuffleExchange,
                                              read_index_file)
from blaze_tpu_torch.shuffle.partitioning import (HashPartitioning,
                                                  Partitioning,
                                                  RangePartitioning,
                                                  RoundRobinPartitioning,
                                                  SinglePartitioning,
                                                  sample_range_bounds)
from blaze_tpu_torch.shuffle.reader import (FFIReaderExec, FileSegmentBlock,
                                            IpcReaderExec, IpcWriterExec)
from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec

__all__ = ["FFIReaderExec", "FileSegmentBlock", "HashPartitioning",
           "IpcReaderExec", "IpcWriterExec", "LocalShuffleExchange",
           "Partitioning", "RangePartitioning", "RoundRobinPartitioning",
           "ShuffleWriterExec", "SinglePartitioning", "read_index_file",
           "sample_range_bounds"]
