"""Radix (counting) partition of a pid column (port of
blaze_tpu/kernels/radix.py).

`partition_ranks` computes, for a pid column over P partitions: per-row
(dest_part, dest_slot), the partition-contiguous `order` (equal to a
stable argsort of the pids over the real rows) and the per-partition
`counts`.  Pids are clamped to [0, P]; P is parked and never enters
`order`; a rank at or above `capacity` parks the row as well.

Two implementations of one function, chosen by the tensor's device
(kernels/lane.py):
  * CUDA: csrc/radix.cu, 4096-row tiles of 8-16 warps: an upsweep of tile
    histograms (skipped for a column of one tile) and a downsweep that
    sums the earlier tiles' counts and ranks rows stably per warp (see the
    note at the top of that file), so at most two launches a call;
  * CPU: `partition_ranks_plain`, a stable argsort plus bincount, cumsum
    and rank.

`partition_order` is the shuffle writer's entry point.  It hands the
kernel the unpadded pid column and asks for `order` and `counts` alone
(no part/slot stores); both come back to the host in one copy with one
sync.  The JAX package pads the column to a power-of-two bucket with
parked rows so that XLA compiles once per rung; eager CUDA compiles
nothing per shape, so only the bucket's value is kept: it is the sentinel
that a parked row leaves in `order`, as in the padded call.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from blaze_tpu_torch.kernels import lane

#: calls that launched the CUDA partition kernel (one per `partition_ranks`
#: or `partition_order` call on a CUDA device)
partition_launches = 0

#: device kernels those calls launched, by name: the upsweep runs only
#: for columns of more than one tile
kernel_launches = {"upsweep": 0, "downsweep": 0}

#: shared-memory limit of the CUDA kernel's per-warp bin counts
MAX_PARTITIONS = 12288


def _bucket(n: int) -> int:
    """The JAX package's pad length for n rows: a power of two, >= 1024."""
    return max(1024, 1 << int(n - 1).bit_length())


def partition_ranks_plain(pid: torch.Tensor, num_partitions: int,
                          capacity: int, sentinel=None):
    """Stable-argsort formulation of `partition_ranks` on any device;
    `order` holds `sentinel` (default n) past the last real row."""
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
    order = torch.where(rows < counts.sum(), order_all,
                        n if sentinel is None else int(sentinel))
    return (part.to(torch.int32), slot.to(torch.int32),
            order.to(torch.int32), counts.to(torch.int32))


class _Scratch:
    """The kernel's scratch for one stream of one device: `state` (the two
    totals buffers, zeroed once and kept across calls) and `agg` (the
    per-tile counts, rewritten by every call), with the parity that lets
    the kernel clear nothing between calls (csrc/radix.cu, "Scratch")."""

    def __init__(self, device):
        from blaze_tpu_torch.kernels import build
        cells = build.bound("radix", "blaze_radix_state_cells")()
        self.state = torch.zeros(cells, dtype=torch.int32, device=device)
        self.agg = torch.empty(0, dtype=torch.int32, device=device)
        self.parity = 0

    def take(self, tiles: int, bins: int):
        """(agg, parity) for a call of `tiles` tiles over `bins` bins, the
        parity flipped past it."""
        if tiles == 1:  # one launch: no scratch touched
            return self.agg, 0
        if tiles * bins > self.agg.numel():
            self.agg = torch.empty(tiles * bins, dtype=torch.int32,
                                   device=self.state.device)
        parity = self.parity
        self.parity ^= 1
        return self.agg, parity


#: (device index, stream handle) -> _Scratch.  A call's kernels run in
#: order on its stream, and `_lock` makes the calls that share a scratch
#: launch in the order they took its parity
_scratch: dict = {}
_lock = threading.Lock()


def _check_operands(pid: torch.Tensor, P: int, capacity: int,
                    what: str) -> None:
    if pid.dtype != torch.int32 or pid.dim() != 1 or not pid.is_contiguous():
        raise ValueError(f"{what}: pid must be a contiguous 1-D "
                         f"int32 tensor, got {pid.dtype} {tuple(pid.shape)}")
    if not 1 <= P <= MAX_PARTITIONS:
        raise ValueError(f"{what}: {P} partitions outside the "
                         f"kernel's range [1, {MAX_PARTITIONS}]")
    if pid.shape[0] >= (1 << 31) - 1 or capacity >= (1 << 31) - 1:
        raise ValueError(f"{what}: sizes exceed int32 indexing")


def _launch(pid, P: int, capacity: int, sentinel: int, part, slot, order,
            counts) -> None:
    """One call of the CUDA kernel: `order` and `counts` written, and
    `part`/`slot` unless both are None."""
    global partition_launches
    from blaze_tpu_torch.kernels import build
    n = pid.shape[0]
    dev = pid.device
    tiles = -(-n // build.bound("radix", "blaze_radix_tile_rows")())
    stream = build.stream_of(dev)
    key = (dev.index, stream)
    with _lock:
        sc = _scratch.get(key)
        if sc is None:
            sc = _scratch[key] = _Scratch(dev)
        agg, parity = sc.take(tiles, P + 1)
        rc = build.bound("radix", "blaze_radix_partition")(
            pid.data_ptr(), None if part is None else part.data_ptr(),
            None if slot is None else slot.data_ptr(), order.data_ptr(),
            counts.data_ptr(), sc.state.data_ptr(), agg.data_ptr(), n, P,
            capacity, sentinel, parity, stream)
        if rc != 0:
            # the parity no longer matches what ran: start afresh
            _scratch.pop(key, None)
    build.check(rc, "radix partition kernel")
    partition_launches += 1
    kernel_launches["downsweep"] += 1
    if tiles > 1:
        kernel_launches["upsweep"] += 1


def _partition_ranks_cuda(pid: torch.Tensor, P: int, capacity: int):
    _check_operands(pid, P, capacity, "partition_ranks")
    n = pid.shape[0]
    dev = pid.device
    part = torch.empty(n, dtype=torch.int32, device=dev)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(P, dtype=torch.int32, device=dev)
    _launch(pid, P, int(capacity), n, part, slot, order, counts)
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


def _order_cuda(pid: torch.Tensor, P: int, sentinel: int):
    """The order-only kernel entry: (order, counts) as int32 numpy arrays
    on the host, from one device-to-host copy into pinned memory."""
    _check_operands(pid, P, sentinel, "partition_order")
    n = pid.shape[0]
    dev = pid.device
    out = torch.empty(P + n, dtype=torch.int32, device=dev)
    _launch(pid, P, sentinel, sentinel, None, None, out[P:], out[:P])
    # the call's own buffer (PyTorch's host allocator pools pinned memory)
    host = torch.empty(P + n, dtype=torch.int32, pin_memory=True)
    host.copy_(out)  # a blocking copy: the call's one sync
    h = host.numpy()
    return h[P:], h[:P]


def _grouping(order: np.ndarray, counts: np.ndarray):
    """(order int64, starts, ends) from int32 order and counts."""
    counts = counts.astype(np.int64)
    ends = np.cumsum(counts)
    return order.astype(np.int64), ends - counts, ends


def _empty_grouping(n_parts: int):
    z = np.zeros(n_parts, np.int64)
    return np.zeros(0, np.int64), z, z.copy()


def partition_order_plain(pids: torch.Tensor, n_parts: int):
    """`partition_order` by the plain version, on any device."""
    n = int(pids.shape[0])
    if n == 0:
        return _empty_grouping(n_parts)
    _part, _slot, order, counts = partition_ranks_plain(
        pids.to(torch.int32), int(n_parts), n, sentinel=_bucket(n))
    return _grouping(order.cpu().numpy(), counts.cpu().numpy())


def partition_order(pids: torch.Tensor, n_parts: int):
    """Shuffle-writer grouping of an int32 pid column: numpy (order,
    starts, ends), `order` int64 and equal to a stable argsort of the
    pids, starts/ends int64 offsets per partition; as the JAX
    `partition_order`, a pid at or above n_parts is parked and leaves the
    bucket (the power of two >= max(n, 1024)) in `order`, and a negative
    pid counts as partition 0."""
    n = int(pids.shape[0])
    if n == 0:
        return _empty_grouping(n_parts)
    if lane.route(pids) == "cuda":
        pid = pids.to(torch.int32).contiguous()  # no copy for the writer's
        return _grouping(*_order_cuda(pid, int(n_parts), _bucket(n)))
    return partition_order_plain(pids, n_parts)
