"""Open-addressing placement for hash_agg_step (port of
blaze_tpu/kernels/hash_update.py).

`placement` computes, for one batch, where each pending row lands in the
group table: round r probes slot (h + r) & (S - 1); the lowest row index
claims a contested empty slot; after the claims, a pending row whose key
limbs equal the slot's limbs is placed.  It returns `placed` (slot per
row, S = never placed) and `wslot` (slot a row claimed as new, S = none).
The kernel is placement-only: parallel/stage.py replays the key scatters
through `wslot` and the accumulation through `placed`, the same tail the
JAX package runs on every lane, so the carry is bit-identical.

Two implementations of one function, chosen by the tensors' device
(kernels/lane.py):
  * CUDA: csrc/hash_update.cu, round-synchronous claim/commit/match passes
    (see the note at the top of that file);
  * CPU: `placement_plain`, the scatter formulation over limbs with
    `scatter_reduce_(..., "amin")` for the claims.

Keys are matched on int32 limbs of the already-normalized key bits: data
limbs are zeroed where the key is NULL and each column adds its validity
bit as one more limb, so equality over all limbs is SQL grouping equality.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import lane

#: launches of the CUDA placement kernel (one per `placement` call on a
#: CUDA device)
placement_launches = 0


# ---------------------------------------------------------------------------
# limb encoding
# ---------------------------------------------------------------------------

def limbs_per_column(dtype: torch.dtype) -> int:
    """int32 limbs for one key column: its data limbs + 1 validity limb."""
    return (2 if dtype.itemsize == 8 else 1) + 1


def _data_limbs(data: torch.Tensor):
    if data.dtype.itemsize == 8:
        halves = data.contiguous().view(torch.int32).reshape(-1, 2)
        return [halves[:, 0], halves[:, 1]]
    if data.dtype.itemsize == 4:
        return [data.contiguous().view(torch.int32)]
    return [data.to(torch.int32)]  # sub-32-bit ints and bool


def encode_limbs(key_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> torch.Tensor:
    """(L, n) int32 limb matrix for rows or table slots."""
    rows = []
    for data, valid in key_cols:
        for limb in _data_limbs(data):
            rows.append(torch.where(valid, limb, torch.zeros_like(limb)))
        rows.append(valid.to(torch.int32))
    return torch.stack(rows, dim=0).contiguous()


# ---------------------------------------------------------------------------
# placement: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def placement_plain(h, limbs, pend0, npend, used0, tab0, probe_rounds: int):
    """Scatter formulation of the placement on any device.  Same operands
    and results as `placement`."""
    n = h.shape[0]
    L, S = tab0.shape
    dev = h.device
    npend = int(npend)
    pending = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    pending[pend0[:npend].long()] = True
    pending = pending[:n]
    row = torch.arange(n, dtype=torch.int64, device=dev)
    hl = h.to(torch.int64)
    # one spare trailing slot takes the writes of rows that do not win
    used = torch.cat([used0.to(torch.int32),
                      torch.zeros(1, dtype=torch.int32, device=dev)])
    tab = torch.cat([tab0, torch.zeros(L, 1, dtype=torch.int32, device=dev)],
                    dim=1)
    placed = torch.full((n,), S, dtype=torch.int64, device=dev)
    wslot = torch.full((n,), S, dtype=torch.int64, device=dev)
    for r in range(probe_rounds):
        if not bool(pending.any()):
            break
        slot = (hl + r) & (S - 1)
        can_claim = pending & (used[slot] == 0)
        claim = torch.full((S + 1,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(can_claim, slot, S), row,
                              "amin", include_self=True)
        winner = can_claim & (claim[slot] == row)
        ws = torch.where(winner, slot, S)
        used[ws] = 1
        tab[:, ws] = limbs
        wslot = torch.where(winner, slot, wslot)
        # match after the claims, so same-key rows of this round unify
        eq = (used[slot] == 1) & (tab[:, slot] == limbs).all(dim=0)
        ok = pending & eq
        placed = torch.where(ok, slot, placed)
        pending = pending & ~ok
    return placed.to(torch.int32), wslot.to(torch.int32)


def _check_operands(h, limbs, pend0, npend, used0, tab0):
    n = h.shape[0]
    L, S = tab0.shape
    for name, t, shape in (("h", h, (n,)), ("limbs", limbs, (L, n)),
                           ("pend0", pend0, (n,)), ("npend", npend, (1,)),
                           ("used0", used0, (S,)), ("tab0", tab0, (L, S))):
        if t.dtype != torch.int32:
            raise TypeError(f"placement: {name} must be int32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"placement: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if t.device != h.device:
            raise ValueError(f"placement: {name} is on {t.device}, "
                             f"h on {h.device}")
        if not t.is_contiguous():
            raise ValueError(f"placement: {name} must be contiguous")
    if S < 1 or S & (S - 1):
        raise ValueError(f"placement: table size {S} is not a power of two")
    if n >= (1 << 31) - 1 or L * S >= (1 << 31):
        raise ValueError("placement: operands exceed int32 indexing")


def _placement_cuda(h, limbs, pend0, npend, used0, tab0, probe_rounds: int):
    global placement_launches
    from blaze_tpu_torch.kernels import build
    _check_operands(h, limbs, pend0, npend, used0, tab0)
    n = h.shape[0]
    L, S = tab0.shape
    lib = build.load("hash_update")
    fn = lib.blaze_hash_placement
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    dev = h.device
    used = torch.empty(S, dtype=torch.int32, device=dev)
    tab = torch.empty(L, S, dtype=torch.int32, device=dev)
    claim = torch.empty(S, dtype=torch.int32, device=dev)
    cnt = torch.empty(probe_rounds + 1, dtype=torch.int32, device=dev)
    placed = torch.empty(n, dtype=torch.int32, device=dev)
    wslot = torch.empty(n, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(h.data_ptr(), limbs.data_ptr(), pend0.data_ptr(),
            npend.data_ptr(), used0.data_ptr(), tab0.data_ptr(),
            used.data_ptr(), tab.data_ptr(), claim.data_ptr(),
            cnt.data_ptr(), placed.data_ptr(), wslot.data_ptr(),
            n, S, L, probe_rounds, stream)
    build.check(rc, "hash placement kernel")
    placement_launches += 1
    return placed, wslot


def placement(h, limbs, pend0, npend, used0, tab0, probe_rounds: int):
    """Run the placement.  All operands int32 on one device: h (n,)
    pre-masked to [0, S); limbs (L, n); pend0 (n,) pending rows in row
    order, padded with n; npend (1,) their count; used0 (S,) 0/1; tab0
    (L, S) stored-key limbs.  Returns (placed (n,), wslot (n,)) int32 with
    sentinel S."""
    if h.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=h.device)
        return empty, empty.clone()
    if lane.route(h) == "cuda":
        return _placement_cuda(h, limbs, pend0, npend, used0, tab0,
                               probe_rounds)
    return placement_plain(h, limbs, pend0, npend, used0, tab0, probe_rounds)


# ---------------------------------------------------------------------------
# hash_agg_step integration
# ---------------------------------------------------------------------------

def placement_inputs(h, key_cols, mask, carry):
    """The operands of `placement` for one hash_agg_step batch:
    (h, limbs, pend0, npend, used0, tab0).  `h` already masked to [0, S);
    key_cols already normalized."""
    n = mask.shape[0]
    dev = mask.device
    limbs = encode_limbs(key_cols)
    tab0 = encode_limbs(list(zip(carry.keys, carry.key_valid)))
    used0 = carry.used.to(torch.int32)
    # pending list = masked row indices in row order (the claim rule gives
    # contested slots to the lowest row index)
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    pend = torch.full((n + 1,), n, dtype=torch.int32, device=dev)
    pend.scatter_(0, torch.where(mask, pos, n), idx)
    pend0 = pend[:n].contiguous()
    npend = mask.sum().to(torch.int32).reshape(1)
    return (h.to(torch.int32).contiguous(), limbs, pend0, npend,
            used0.contiguous(), tab0)


def place_rows(h, key_cols, mask, carry, probe_rounds: int):
    """Placement for one hash_agg_step batch.  Returns (placed, wslot)
    int32 with sentinel S."""
    return placement(*placement_inputs(h, key_cols, mask, carry),
                     probe_rounds)
