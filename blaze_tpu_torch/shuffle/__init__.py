"""Shuffle of the PyTorch port: hash partitioning, the framed IPC format,
the map-side writer and the reduce-side reader."""

from blaze_tpu_torch.shuffle.exchange import read_index_file
from blaze_tpu_torch.shuffle.partitioning import (HashPartitioning,
                                                  Partitioning,
                                                  SinglePartitioning)
from blaze_tpu_torch.shuffle.reader import FileSegmentBlock, IpcReaderExec
from blaze_tpu_torch.shuffle.writer import ShuffleWriterExec

__all__ = ["FileSegmentBlock", "HashPartitioning", "IpcReaderExec",
           "Partitioning", "ShuffleWriterExec", "SinglePartitioning",
           "read_index_file"]
