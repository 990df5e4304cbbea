"""Radix (counting) partition of a pid column (port of
blaze_tpu/kernels/radix.py).

`partition_ranks` computes, for a pid column over P partitions: per-row
(dest_part, dest_slot), the partition-contiguous `order` (equal to a
stable argsort of the pids over the real rows) and the per-partition
`counts`.  Pids are clamped to [0, P]; P is parked and never enters
`order`; a rank at or above `capacity` parks the row as well.

Two implementations of one function, chosen by the tensor's device
(kernels/lane.py):
  * CUDA: csrc/radix.cu, per-tile shared-memory histograms, one scan
    block, and a warp-per-tile rank pass with __match_any_sync (see the
    note at the top of that file);
  * CPU: `partition_ranks_plain`, a stable argsort plus bincount, cumsum
    and rank.

`partition_order` is the shuffle writer's entry point: it pads the pid
column to a power-of-two bucket with parked rows, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from blaze_tpu_torch.kernels import lane

#: launches of the CUDA partition kernel (one per `partition_ranks` call on
#: a CUDA device)
partition_launches = 0

#: shared-memory histogram/cursor limit of the CUDA kernel (48 KB of int32)
MAX_PARTITIONS = 12288


def partition_ranks_plain(pid: torch.Tensor, num_partitions: int,
                          capacity: int):
    """Stable-argsort formulation of `partition_ranks` on any device."""
    P = int(num_partitions)
    n = pid.shape[0]
    dev = pid.device
    p = pid.clamp(0, P).to(torch.int64)
    order_all = torch.argsort(p, stable=True)
    counts_all = torch.bincount(p, minlength=P + 1)
    starts_all = torch.cumsum(counts_all, 0) - counts_all
    rows = torch.arange(n, dtype=torch.int64, device=dev)
    rank = torch.empty(n, dtype=torch.int64, device=dev)
    rank[order_all] = rows - starts_all[p[order_all]]
    ok = (p < P) & (rank < capacity)
    part = torch.where(ok, p, P)
    slot = torch.where(ok, rank, capacity)
    counts = counts_all[:P]
    order = torch.where(rows < counts.sum(), order_all, n)
    return (part.to(torch.int32), slot.to(torch.int32),
            order.to(torch.int32), counts.to(torch.int32))


def _partition_ranks_cuda(pid: torch.Tensor, P: int, capacity: int):
    global partition_launches
    from blaze_tpu_torch.kernels import build
    if pid.dtype != torch.int32 or pid.dim() != 1 or not pid.is_contiguous():
        raise ValueError("partition_ranks: pid must be a contiguous 1-D "
                         f"int32 tensor, got {pid.dtype} {tuple(pid.shape)}")
    if not 1 <= P <= MAX_PARTITIONS:
        raise ValueError(f"partition_ranks: {P} partitions outside the "
                         f"kernel's range [1, {MAX_PARTITIONS}]")
    n = pid.shape[0]
    if n >= (1 << 31) - 1 or capacity >= (1 << 31) - 1:
        raise ValueError("partition_ranks: sizes exceed int32 indexing")
    tile = build.bound("radix", "blaze_radix_tile_rows")()
    fn = build.bound("radix", "blaze_radix_partition")
    dev = pid.device
    part = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    starts = torch.empty(P, dtype=torch.int32, device=dev)
    mat = torch.empty(P * (-(-n // tile)), dtype=torch.int32, device=dev)
    stream = build.stream_of(dev)
    rc = fn(pid.data_ptr(), part.data_ptr(), slot.data_ptr(),
            order.data_ptr(), counts.data_ptr(), starts.data_ptr(),
            mat.data_ptr(), n, P, int(capacity), stream)
    build.check(rc, "radix partition kernel")
    partition_launches += 1
    return part, slot, order, counts


def partition_ranks(pid: torch.Tensor, num_partitions: int, capacity: int):
    """Per-row (dest_part, dest_slot), the contiguous `order`, and the
    per-partition `counts`, all int32, for one pid column."""
    if pid.shape[0] == 0:
        z = torch.empty(0, dtype=torch.int32, device=pid.device)
        return (z, z.clone(), z.clone(),
                torch.zeros(int(num_partitions), dtype=torch.int32,
                            device=pid.device))
    if lane.route(pid) == "cuda":
        return _partition_ranks_cuda(pid, int(num_partitions), int(capacity))
    return partition_ranks_plain(pid, num_partitions, capacity)


def partition_order(pids: torch.Tensor, n_parts: int):
    """Shuffle-writer grouping of a pid column: (order, starts, ends) with
    `order` an int64 tensor on the pids' device, equal to a stable argsort
    of the pids, and starts/ends int64 numpy offsets per partition.

    The column is padded up to a power-of-two bucket (at least 1024) with
    parked rows (pid == n_parts), which never enter `order`."""
    n = int(pids.shape[0])
    if n == 0:
        z = np.zeros(n_parts, np.int64)
        return torch.zeros(0, dtype=torch.int64, device=pids.device), z, z
    bucket = max(1024, 1 << int(n - 1).bit_length())
    padded = torch.full((bucket,), n_parts, dtype=torch.int32,
                        device=pids.device)
    padded[:n] = pids.to(torch.int32)
    _part, _slot, order, counts = partition_ranks(padded, int(n_parts),
                                                  bucket)
    counts = counts.cpu().numpy().astype(np.int64)
    ends = np.cumsum(counts)
    starts = ends - counts
    return order[:n].to(torch.int64), starts, ends
