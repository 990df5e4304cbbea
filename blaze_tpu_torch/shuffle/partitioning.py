"""Partitioning schemes (port of the hash and single partitionings of
blaze_tpu/shuffle/partitioning.py).

The partition id is Spark's `pmod(murmur3(keys, seed=42), n)`, bit-exact
with Spark's HashPartitioning, computed on the batch's device by the
port's hashing (kernels/hashing.py); a utf8 key's bytes cross to the
device as a padded byte matrix.  Round-robin and range partitioning
belong to a later slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.kernels import hashing as H


class Partitioning:
    num_partitions: int = 1

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        """int32 partition id per row, on the batch's device; the batch
        must be compact."""
        raise NotImplementedError


class SinglePartitioning(Partitioning):
    num_partitions = 1

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        return torch.zeros(batch.num_rows, dtype=torch.int32,
                           device=batch.device)


class HashPartitioning(Partitioning):
    def __init__(self, exprs: Sequence[PhysicalExpr], num_partitions: int):
        self.exprs = list(exprs)
        self.num_partitions = num_partitions

    def partition_ids(self, batch: ColumnBatch) -> torch.Tensor:
        n = batch.num_rows
        if self.num_partitions == 1:
            # pmod(h, 1) == 0 for every row: skip the hash chain
            return torch.zeros(n, dtype=torch.int32, device=batch.device)
        flat_cols, tids = [], []
        for e in self.exprs:
            v = e.evaluate(batch)
            if v.is_device:
                flat_cols.append((v.data[:n], v.validity[:n]))
            else:
                # utf8: the byte matrix crosses to the batch's device
                (mat, lens), valid = H.padded_string_key(
                    v.to_host(n), n, batch.device)
                flat_cols.append(((mat, lens), valid))
            tids.append(v.dtype.id.value)
        return H.spark_partition_ids(flat_cols, tids, self.num_partitions)
