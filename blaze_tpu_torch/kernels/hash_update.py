"""Open-addressing placement for hash_agg_step (port of
blaze_tpu/kernels/hash_update.py).

`place_in_carry` computes, for one batch, where each masked row lands in
the group table: round r probes slot (h + r) & (S - 1); the lowest row
index claims a contested empty slot; after the claims, a pending row whose
key limbs equal the slot's limbs is placed.  It returns `placed` (slot per
row, S = never placed), `wslot` (slot a row claimed as new, S = none) and
the count of masked rows left unplaced, and it writes the claims into the
`used` flags and the (L, S) limb table it is handed (parallel/stage.py
keeps that table in the carry and hands in copies).  The kernel is
placement-only: parallel/stage.py replays the key scatters through `wslot`
and the accumulation through `placed`, the same tail the JAX package runs
on every lane, so the carry is bit-identical.  With `rollback`, a call
that leaves a masked row unplaced takes its claims back and reports every
row unplaced, so a table updated in place stays as it was (the device
stage loop's fold step, parallel/stage.py `fold_step`).

Two implementations of one function, chosen by the tensors' device
(kernels/lane.py):
  * CUDA: csrc/hash_update.cu, one cooperative launch whose grid barriers
    separate the round-synchronous claim/commit/match phases (see the note
    at the top of that file);
  * CPU: `place_in_carry_plain`, the scatter formulation over limbs with
    `scatter_reduce_(..., "amin")` for the claims.

`placement_plain` takes the JAX package's operands (a pending row list,
int32 `used`, a table it does not write), so the tests can hold the plain
version to the Pallas kernel's contract; it runs `place_in_carry_plain`
on copies.

Keys are matched on int32 limbs of the already-normalized key bits: data
limbs are zeroed where the key is NULL and each column adds its validity
bit as one more limb, so equality over all limbs is SQL grouping equality.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import lane

#: launches of the CUDA placement kernel: one per eager `place_in_carry`
#: call on a CUDA device; a call captured into a CUDA graph counts in
#: `captured_launches` instead, and each replay of the graph adds its
#: placement nodes here (runtime/loop.py)
placement_launches = 0
#: placement launches recorded into CUDA graphs while they were captured
captured_launches = 0


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
# placement into the carry's table: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def place_in_carry_plain(h, limbs, mask, used, tab, probe_rounds: int,
                         rollback: bool = False):
    """Scatter formulation of `place_in_carry` on any device: same
    operands, same results, `used` and `tab` claimed into in place (and
    taken back on overflow with `rollback`)."""
    n = h.shape[0]
    S = tab.shape[1]
    dev = h.device
    pending = mask.clone()
    row = torch.arange(n, dtype=torch.int64, device=dev)
    hl = h.to(torch.int64)
    placed = torch.full((n,), S, dtype=torch.int64, device=dev)
    wslot = torch.full((n,), S, dtype=torch.int64, device=dev)
    for r in range(probe_rounds):
        if not bool(pending.any()):
            break
        slot = (hl + r) & (S - 1)
        can_claim = pending & ~used[slot]
        claim = torch.full((S + 1,), n, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(can_claim, slot, S), row,
                              "amin", include_self=True)
        winner = can_claim & (claim[slot] == row)
        won = slot[winner]  # one winner per slot
        used[won] = True
        tab[:, won] = limbs[:, winner]
        wslot = torch.where(winner, slot, wslot)
        # match after the claims, so same-key rows of this round unify
        eq = used[slot] & (tab[:, slot] == limbs).all(dim=0)
        ok = pending & eq
        placed = torch.where(ok, slot, placed)
        pending = pending & ~ok
    if rollback and bool(pending.any()):
        # the call's claims go: an unused slot holds zero limbs
        won = wslot[wslot < S]
        used[won] = False
        tab[:, won] = 0
        placed.fill_(S)
        wslot.fill_(S)
    return (placed.to(torch.int32), wslot.to(torch.int32),
            pending.sum().to(torch.int32).reshape(1))


def _check_operands(h, limbs, mask, used, tab, probe_rounds):
    n = h.shape[0]
    L, S = tab.shape
    dev = h.get_device()
    for t, dtypes, shape in ((h, (torch.int32, torch.int64), (n,)),
                             (limbs, (torch.int32,), (L, n)),
                             (mask, (torch.bool,), (n,)),
                             (used, (torch.bool,), (S,)),
                             (tab, (torch.int32,), (L, S))):
        if (t.dtype not in dtypes or t.shape != shape
                or t.get_device() != dev or not t.is_contiguous()):
            raise ValueError(
                f"place_in_carry: expected contiguous {shape} "
                f"{'/'.join(map(str, dtypes))} on {h.device}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if S < 1 or S & (S - 1):
        raise ValueError(f"place_in_carry: table size {S} is not a power "
                         f"of two")
    if probe_rounds < 1:
        raise ValueError("place_in_carry: probe_rounds must be at least 1")
    if 5 * S + probe_rounds + 257 >= (1 << 31) or L * S >= (1 << 31):
        raise ValueError("place_in_carry: operands exceed int32 indexing")


class Scratch:
    """The placement kernel's scratch: its claim and stamp arrays for
    tables of up to `slots` slots and the device word holding the next
    call's round tag (csrc/hash_update.cu: every value a call leaves there
    is tagged below the next call's rounds, so nothing is cleared between
    calls, whatever their tables).  The kernel advances the word itself,
    so calls launched eagerly and calls replayed from a CUDA graph draw
    their tags from it alike; the host only counts the tags it has let
    launches take (`reserve`), and zeroes the scratch before they would
    run out.  Each CUDA graph of the device stage loop owns one; eager
    calls share one per (device, stream)."""

    #: tags are 32-bit; the scratch is zeroed again before they run out
    TAG_LIMIT = (1 << 32) - 1

    def __init__(self, device, slots: int, rounds: int = 16):
        from blaze_tpu_torch.kernels import build
        self.slots, self.rounds = slots, max(rounds, 16)
        cells = build.bound("hash_update", "blaze_place_scratch_cells")(
            slots, self.rounds)
        self.buf = torch.zeros(cells, dtype=torch.int32, device=device)
        self.buf[0] = 1
        self.next = 1  # the most the tag word can hold now

    def reserve(self, tags: int) -> None:
        """Before launches (or a graph replay) that take up to `tags` round
        tags: zero the scratch and restart the word at 1 where they would
        reach the limit.  Stream-ordered with the launches."""
        if self.next + tags >= self.TAG_LIMIT:
            self.buf.zero_()
            self.buf[0] = 1
            self.next = 1
        self.next += tags


#: (device index, stream handle) -> the eager calls' Scratch on that
#: stream, sized for the largest table placed there.  A stream's calls run
#: in order, so they may share its scratch; `_lock` makes the host side of
#: a call (the scratch's tag count, a larger replacement, the launch) one
#: step, so two threads on one stream cannot interleave there, and calls
#: on two streams (two queries of the query service) never share claim
#: and stamp arrays.  A scratch replaced by a larger one is freed on its
#: own stream, after the launches that used it.
_scratch: dict = {}
_lock = threading.Lock()


def _scratch_for(device, stream: int, S: int, rounds: int) -> Scratch:
    """The eager scratch of (device, stream); the caller holds `_lock`."""
    key = (device.index, stream)
    sc = _scratch.get(key)
    if sc is None or sc.slots < S or sc.rounds < rounds:
        sc = _scratch[key] = Scratch(
            device, max(S, sc.slots if sc else 0), rounds)
    return sc


def add_replayed(nodes: int) -> None:
    """Count the placement launches of one graph replay holding `nodes`
    captured calls (runtime/loop.py)."""
    global placement_launches
    with _lock:
        placement_launches += nodes


def _place_cuda(h, limbs, mask, used, tab, probe_rounds: int,
                rollback: bool, scratch):
    """One launch.  Under CUDA graph capture the launch is recorded, not
    run: it takes the caller's `scratch` (which reserves the replay's tags)
    and counts in `captured_launches`."""
    global placement_launches, captured_launches
    from blaze_tpu_torch.kernels import build
    _check_operands(h, limbs, mask, used, tab, probe_rounds)
    n = h.shape[0]
    L, S = tab.shape
    capturing = torch.cuda.is_current_stream_capturing()
    if capturing and scratch is None:
        raise RuntimeError("place_in_carry: a captured launch needs the "
                           "graph's own scratch")
    out = torch.empty(2 * n + 1, dtype=torch.int32, device=h.device)
    stream = build.stream_of(h.device)
    with _lock:
        sc = scratch if scratch is not None else _scratch_for(
            h.device, stream, S, probe_rounds)
        if sc.slots < S or sc.rounds < probe_rounds:
            raise ValueError(f"place_in_carry: scratch for {sc.slots} slots "
                             f"and {sc.rounds} rounds, table {S} and "
                             f"{probe_rounds}")
        if not capturing:
            sc.reserve(probe_rounds + 1)
        rc = build.bound("hash_update", "blaze_place_in_carry")(
            h.data_ptr(), limbs.data_ptr(), mask.data_ptr(),
            used.data_ptr(), tab.data_ptr(), out.data_ptr(),
            sc.buf.data_ptr(), sc.slots, n, S, L, probe_rounds,
            int(h.dtype == torch.int64), int(rollback), stream)
        if rc == 0:
            if capturing:
                captured_launches += 1
            else:
                placement_launches += 1
    build.check(rc, "hash placement kernel")
    return out[:n], out[n:2 * n], out[2 * n:]


def place_in_carry(h, limbs, mask, used, tab, probe_rounds: int,
                   rollback: bool = False, scratch: Scratch = None):
    """Place one batch's rows into a table, claiming in place.  h (n,)
    int32 or int64 slot hashes (bits above log2(S) ignored); limbs (L, n)
    int32 row key limbs; mask (n,) bool rows to place; used (S,) bool and
    tab (L, S) int32 stored-key limbs, both written where rows claim a
    slot.  Returns (placed (n,), wslot (n,), unplaced (1,)) int32: slots
    with sentinel S, and the masked rows left unplaced.  `rollback` takes
    an overflowing call's claims back (every row then reads as unplaced);
    `scratch` is the kernel's scratch on a CUDA device (the device's
    shared one when None; a CUDA graph capture must pass its own)."""
    if h.shape[0] == 0:
        empty = torch.empty(0, dtype=torch.int32, device=h.device)
        return empty, empty.clone(), torch.zeros(1, dtype=torch.int32,
                                                 device=h.device)
    if lane.route(h, "hash") == "cuda":
        return _place_cuda(h, limbs, mask, used, tab, probe_rounds,
                           rollback, scratch)
    return place_in_carry_plain(h, limbs, mask, used, tab, probe_rounds,
                                rollback)


# ---------------------------------------------------------------------------
# the JAX package's operands: a pending list and an int32 `used`
# ---------------------------------------------------------------------------

def _carry_operands(pend0, npend, used0, tab0):
    """(mask, used, tab) for `place_in_carry` from the JAX package's
    operands: the first npend entries of pend0 as a row mask, and copies
    of used0 (as bool) and tab0."""
    n = pend0.shape[0]
    first = torch.arange(n, device=pend0.device) < npend.reshape(())
    mask = torch.zeros(n + 1, dtype=torch.bool, device=pend0.device)
    mask[torch.where(first, pend0.long(), n)] = True
    return mask[:n], used0 != 0, tab0.clone()


def placement_plain(h, limbs, pend0, npend, used0, tab0, probe_rounds: int):
    """The placement with the JAX package's operands (its Pallas kernel's
    contract), on any device: h (n,) pre-masked to [0, S); limbs (L, n);
    pend0 (n,) pending rows in row order; npend (1,) their count; used0
    (S,) 0/1; tab0 (L, S) stored-key limbs, neither written; all int32.
    Returns (placed (n,), wslot (n,)) int32 with sentinel S."""
    placed, wslot, _ = place_in_carry_plain(
        h, limbs, *_carry_operands(pend0, npend, used0, tab0), probe_rounds)
    return placed, wslot
