"""Shuffle of the PyTorch port: hash partitioning, the framed IPC format,
the map-side writer, the reduce-side reader and the in-process
exchange."""

from blaze_tpu_torch.shuffle.exchange import (LocalShuffleExchange,
                                              read_index_file)
from blaze_tpu_torch.shuffle.partitioning import (HashPartitioning,
                                                  Partitioning,
                                                  SinglePartitioning)
from blaze_tpu_torch.shuffle.reader import FileSegmentBlock, IpcReaderExec
from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec

__all__ = ["FileSegmentBlock", "HashPartitioning", "IpcReaderExec",
           "LocalShuffleExchange", "Partitioning", "ShuffleWriterExec", "SinglePartitioning",
           "read_index_file"]
