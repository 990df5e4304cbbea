"""Join-probe kernels: build runs, match counting and bounded pair
expansion (port of blaze_tpu/kernels/join.py).

The build side of a hash join is a HASH-SORTED table: xxhash64 of the
join keys sorted ascending, with a run-length index over the unique
hashes.  A probe batch runs two steps on the device of its tensors:

  1. `probe_counts`: a binary search of every probe hash into the unique
     build hashes gives each probe row its (start, count) run;
  2. `expand_pairs`: an exclusive scan of the counts gives each probe row
     its output offset; a scatter-max of the row ids at their offsets and
     a running max assign every output slot its probe row, which fills
     (probe_idx, sorted_pos) pair arrays of a power-of-two size `cap`.

`probe_expand_device` runs both with ONE scalar sync (the total) and ONE
device-to-host copy (the pairs).  The pair arrays are int32 below 2^31
slots; the total is int64, since the true pair count can exceed `cap`.
The caller verifies every candidate pair against the real key columns, so
a hash collision never makes a wrong row.

These are torch ops, as the JAX package's are plain `jnp` with no Pallas
kernel behind them: `searchsorted` and gathers, a cumsum, a
`scatter_reduce` into one extra slot that takes the offsets past `cap`
(the JAX `mode="drop"`), and `torch.cummax` for the associative max-scan.
On a CUDA device every step runs on the card; nothing falls back to numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: probe_expand_device calls by device type of their tensors ("cuda",
#: "cpu"); a run reads the count to show that its probes ran on the card
probe_calls = {"cuda": 0, "cpu": 0}


def _index_dtype(n: int) -> torch.dtype:
    return torch.int32 if n < (1 << 31) else torch.int64


def build_runs(sorted_hashes: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(unique_hashes, run_start, run_count) of an ascending hash tensor,
    on its device; positions are int32 below 2^31 build rows."""
    idt = _index_dtype(sorted_hashes.shape[0])
    uh, count = torch.unique_consecutive(sorted_hashes, return_counts=True)
    start = torch.cumsum(count, 0) - count
    return uh, start.to(idt), count.to(idt)


def probe_counts(unique_hashes: torch.Tensor, run_start: torch.Tensor,
                 run_count: torch.Tensor, probe_hashes: torch.Tensor,
                 probe_null: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-probe-row (start, count) into the sorted build table; a probe
    row with a null key counts 0 (SQL equi-join semantics)."""
    pos = torch.searchsorted(unique_hashes, probe_hashes)
    n_unique = unique_hashes.shape[0]
    pos_c = pos.clamp(0, max(n_unique - 1, 0))
    hit = (pos < n_unique) & (unique_hashes[pos_c] == probe_hashes)
    hit = hit & ~probe_null
    zero = torch.zeros((), dtype=run_start.dtype, device=run_start.device)
    start = torch.where(hit, run_start[pos_c], zero)
    count = torch.where(hit, run_count[pos_c], zero)
    return start, count


def expand_pairs(start: torch.Tensor, count: torch.Tensor, cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """Bounded expansion of (start, count) runs into pair arrays.

    Returns (probe_idx[cap], sorted_pos[cap], valid[cap], total): slot j
    below min(total, cap) pairs probe row probe_idx[j] with the build row
    at sorted position sorted_pos[j]; pairs at offsets >= cap are dropped
    (the caller grows `cap` and calls again when total > cap)."""
    n = start.shape[0]
    dev = start.device
    idt = _index_dtype(cap)
    count64 = count.to(torch.int64)
    offsets = torch.cumsum(count64, 0) - count64
    total = (offsets[-1] + count64[-1] if n
             else torch.zeros((), dtype=torch.int64, device=dev))
    # probe-row boundaries scattered into the output domain; slot `cap`
    # takes every offset past the end and is cut off
    at = torch.where((count64 > 0) & (offsets < cap), offsets,
                     torch.full_like(offsets, cap))
    slot_probe = torch.zeros(cap + 1, dtype=idt, device=dev)
    slot_probe.scatter_reduce_(0, at, torch.arange(n, dtype=idt, device=dev),
                               reduce="amax")
    slot_probe = torch.cummax(slot_probe[:cap], 0).values
    out_pos = torch.arange(cap, dtype=idt, device=dev)
    valid = out_pos < torch.clamp(total, max=cap).to(idt)
    p = slot_probe.clamp(0, max(n - 1, 0))
    within = out_pos - offsets.to(idt)[p]
    sorted_pos = start.to(idt)[p] + within
    return p, sorted_pos, valid, total


def _pow2_at_least(n: int) -> int:
    return max(1024, 1 << int(max(n, 1) - 1).bit_length())


def probe_expand_device(unique_hashes: torch.Tensor,
                        run_start: torch.Tensor, run_count: torch.Tensor,
                        sorted_idx: torch.Tensor, probe_hashes: torch.Tensor,
                        probe_null: torch.Tensor
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The whole probe on the tensors' device: counts, expansion, the map
    through the build permutation `sorted_idx`; one scalar sync for the
    total, one copy of the pairs to the host.  Returns (probe_idx,
    build_idx) int64 numpy arrays."""
    probe_calls[probe_hashes.device.type] += 1
    start, count = probe_counts(unique_hashes, run_start, run_count,
                                probe_hashes, probe_null)
    total = int(count.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    cap = _pow2_at_least(total)
    p, sorted_pos, _valid, _total = expand_pairs(start, count, cap)
    want = _index_dtype(cap)
    assert p.dtype == want and sorted_pos.dtype == want, (
        f"join pair arrays widened: {p.dtype}/{sorted_pos.dtype}, expected "
        f"{want} at cap={cap}")
    b = sorted_idx[sorted_pos[:total].to(torch.int64)]
    pairs = torch.stack([p[:total].to(torch.int64), b.to(torch.int64)])
    pairs = pairs.cpu().numpy()
    return pairs[0], pairs[1]
