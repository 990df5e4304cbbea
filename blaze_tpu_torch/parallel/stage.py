"""Device group tables (port of the aggregation core of
blaze_tpu/parallel/stage.py: `HashAggCarry` .. `_identity`, the dense
group ids `pack_dense_keys[_i32]` / `unpack_dense_keys` and a batch's own
dense table `dense_partial_agg`, with the dense scatter carry of
blaze_tpu/plan/fused.py `_init_carry` / `_scatter_into_carry`).

`hash_agg_step` inserts one batch: keys hash with xxhash64 (seed 42) to a
slot, `kernels/hash_update.place_in_carry` places rows by linear probing,
claiming slots in the carry's `used` flags and its key-limb table, and the
shared tail replays the key scatters through the claimed slots and
accumulates through the placed slots.  The step is atomic: when any row
fails to place within `probe_rounds`, the original carry comes back
unchanged with the overflow count, so the caller can grow (exact modes) or
degrade to pass-through (partial mode) losslessly.

The port keeps the JAX package's functional contract: a step never writes
into the carry it was given (the new carry holds fresh tensors: `used`
and `limbs` are copied once, before the placement claims into them), so
a caller may retry a batch against the old carry.

`fold_step` is the device stage loop's step (runtime/loop.py): the same
insert, in place into the carry it is given, with static shapes and no
host sync, so a CUDA graph can capture it.  Its overflow is atomic all the
same: the placement takes its claims back (`rollback`), every row then
reads as unplaced, and the tail leaves every bit of the carry as it was.
Its final carry equals `hash_agg_step`'s bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.schema import dtype_of


class HashAggCarry(NamedTuple):
    """The group table: S slots (a power of two)."""

    keys: Tuple[torch.Tensor, ...]        # stored key data, each (S,)
    key_valid: Tuple[torch.Tensor, ...]
    accs: Tuple[torch.Tensor, ...]
    acc_valid: Tuple[torch.Tensor, ...]
    used: torch.Tensor                    # (S,) bool
    #: (L, S) int32 key limbs of the stored keys
    #: (kernels/hash_update.encode_limbs), zero where `used` is false
    limbs: torch.Tensor


def _identity(dtype: torch.dtype, minimum: bool):
    """Identity of max (minimum=True) or min (minimum=False) over dtype."""
    if dtype.is_floating_point:
        return float("-inf") if minimum else float("inf")
    info = torch.iinfo(dtype)
    return info.min if minimum else info.max


def _acc_init(kind: str, dtype: torch.dtype):
    """(initial value, initial validity) of one accumulator kind."""
    if kind == "count":
        return 0, True
    if kind == "min":
        return _identity(dtype, False), False
    if kind == "max":
        return _identity(dtype, True), False
    return 0, False


def init_accumulators(kinds: Sequence[str], acc_dtypes: Sequence,
                      num_slots: int, device: torch.device):
    """Identity-initialized accumulator columns."""
    accs, avalid = [], []
    for kind, dt in zip(kinds, acc_dtypes):
        dt = torch.int64 if kind == "count" else dt
        value, valid = _acc_init(kind, dt)
        accs.append(torch.full((num_slots,), value, dtype=dt, device=device))
        avalid.append(torch.full((num_slots,), valid, dtype=torch.bool,
                                 device=device))
    return tuple(accs), tuple(avalid)


def init_hash_carry(key_dtypes: Sequence, acc_kinds: Sequence[str],
                    acc_dtypes: Sequence, num_slots: int,
                    device: torch.device) -> HashAggCarry:
    from blaze_tpu_torch.kernels.hash_update import limbs_per_column
    keys = tuple(torch.zeros(num_slots, dtype=dt, device=device)
                 for dt in key_dtypes)
    kvalid = tuple(torch.zeros(num_slots, dtype=torch.bool, device=device)
                   for _ in key_dtypes)
    accs, avalid = init_accumulators(acc_kinds, acc_dtypes, num_slots,
                                     device)
    n_limbs = sum(limbs_per_column(dt) for dt in key_dtypes)
    return HashAggCarry(keys, kvalid, accs, avalid,
                        torch.zeros(num_slots, dtype=torch.bool,
                                    device=device),
                        torch.zeros(n_limbs, num_slots, dtype=torch.int32,
                                    device=device))


def reset_hash_carry(carry: HashAggCarry, kinds: Sequence[str]) -> None:
    """Put a carry back to `init_hash_carry`'s state, in place."""
    for t in (*carry.keys, *carry.key_valid, carry.used, carry.limbs):
        t.zero_()
    for kind, a, av in zip(kinds, carry.accs, carry.acc_valid):
        value, valid = _acc_init(kind, a.dtype)
        a.fill_(value)
        av.fill_(valid)


def _norm_float(d: torch.Tensor) -> torch.Tensor:
    """-0.0 -> 0.0 and every NaN -> one canonical bit pattern, before
    hashing (Spark's NormalizeFloatingNumbers), so equal keys hash alike
    and compare equal bit for bit."""
    d = torch.where(d == 0, d.abs(), d)
    return torch.where(torch.isnan(d), torch.full_like(d, float("nan")), d)


def hash_agg_step(carry: HashAggCarry,
                  key_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  agg_specs: Sequence[Tuple[str, Optional[torch.Tensor],
                                            Optional[torch.Tensor]]],
                  mask: torch.Tensor, probe_rounds: int = 16):
    """Insert one batch into the table.  Returns (new_carry, overflow,
    num_groups): overflow is a host int (the unplaced masked rows; > 0
    returns the original carry); num_groups a 0-d tensor."""
    from blaze_tpu_torch.kernels import hash_update as HU
    S = carry.used.shape[0]
    key_cols, h = _slot_hashes(key_cols, S)
    used = carry.used.clone()
    limbs = carry.limbs.clone()
    placed, wslot, unplaced = HU.place_in_carry(
        h, HU.encode_limbs(key_cols), mask, used, limbs, probe_rounds)
    overflow = int(unplaced)
    if overflow:
        return carry, overflow, carry.used.sum()
    new = _hash_step_tail(carry, key_cols, agg_specs, mask, placed, wslot,
                          used, limbs)
    return new, 0, new.used.sum()


def _slot_hashes(key_cols, S: int):
    """Normalized key columns and their slot hashes into a table of S."""
    from blaze_tpu_torch.kernels.hashing import hash_columns
    key_cols = [(_norm_float(d), v) if d.is_floating_point() else (d, v)
                for d, v in key_cols]
    cols = [(d, v, dtype_of(d).id.value) for d, v in key_cols]
    return key_cols, hash_columns(cols, seed=42, algo="xxhash64") & (S - 1)


_SAME_WIDTH_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's storage as integers of its width (a view)."""
    return t.view(_SAME_WIDTH_INT[t.element_size()])


def fold_step(carry: HashAggCarry,
              key_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
              agg_specs: Sequence[Tuple[str, Optional[torch.Tensor],
                                        Optional[torch.Tensor]]],
              live: torch.Tensor, probe_rounds: int = 16, scratch=None):
    """Insert one batch's `live` rows into `carry` in place.  Returns a
    (1,) bool tensor on the carry's device: the batch overflowed, and the
    carry is unchanged.  No host sync, no data-dependent shape: the step
    a CUDA graph captures (`scratch`: the graph's placement scratch)."""
    from blaze_tpu_torch.kernels import hash_update as HU
    S = carry.used.shape[0]
    key_cols, h = _slot_hashes(key_cols, S)
    placed, wslot, unplaced = HU.place_in_carry(
        h, HU.encode_limbs(key_cols), live, carry.used, carry.limbs,
        probe_rounds, rollback=True, scratch=scratch)
    # a claimed slot was empty, so its key and validity are zero: adding a
    # key's bits writes them; a row that claimed nothing adds zero to a
    # slot of its own (spread, so the atomics do not pile onto one slot)
    claimed = wslot < S
    idx = torch.where(claimed, wslot.long(), _spread(live.shape[0], S,
                                                     live.device))
    for tk, tv, (kd, kv) in zip(carry.keys, carry.key_valid, key_cols):
        kb = _bits(kd.to(tk.dtype))
        _bits(tk).index_add_(0, idx, torch.where(claimed, kb,
                                                 torch.zeros_like(kb)))
        _bits(tv).index_add_(0, idx, (kv & claimed).to(torch.uint8))
    scatter_accumulate(placed, agg_specs, live, carry.accs, carry.acc_valid,
                       inplace=True)
    return unplaced > 0


def _spread(n: int, S: int, device) -> torch.Tensor:
    """Row i's slot for an update that changes nothing: i & (S - 1), in
    [0, S) for any S (i mod S where S is a power of two)."""
    return torch.arange(n, device=device) & (S - 1)


def _hash_step_tail(carry, key_cols, agg_specs, mask, placed, wslot, used,
                    limbs):
    """Key scatters through the newly claimed slots, then the accumulation
    through the placed slots: one code path behind every placement.
    `used` and `limbs` are the new carry's, already claimed into by the
    placement."""
    S = carry.used.shape[0]
    claimed = torch.nonzero(wslot < S).squeeze(1)
    slots = wslot.index_select(0, claimed).long()
    tkeys, tkvalid = [], []
    for tk, tv, (kd, kv) in zip(carry.keys, carry.key_valid, key_cols):
        tk = tk.clone()
        tv = tv.clone()
        tk[slots] = kd.index_select(0, claimed)
        tv[slots] = kv.index_select(0, claimed)
        tkeys.append(tk)
        tkvalid.append(tv)
    accs, avalid = scatter_accumulate(placed, agg_specs, mask, carry.accs,
                                      carry.acc_valid)
    return HashAggCarry(tuple(tkeys), tuple(tkvalid), tuple(accs),
                        tuple(avalid), used, limbs)


def scatter_accumulate(g: torch.Tensor,
                       agg_specs: Sequence[Tuple[str, Optional[torch.Tensor],
                                                 Optional[torch.Tensor]]],
                       mask: torch.Tensor, accs: Sequence[torch.Tensor],
                       avalid: Sequence[torch.Tensor], inplace: bool = False):
    """Rows scatter into slot `g`; out-of-range slots (the sentinel S) drop.
    Row i, dropped, is routed to slot i & (S - 1) (spread, so that on a CUDA
    device the atomics of the dropped rows do not all contend for one
    slot) with the operation's identity (0 for integer sums and counts,
    -0.0 for float sums, the max/min identity for min/max), which leaves
    every accumulator bit unchanged.  `inplace` updates `accs` and
    `avalid` themselves (the fold step) instead of new tensors."""
    new_accs, new_avalid = [], []
    spread = None
    for (kind, vd, vv), a, av in zip(agg_specs, accs, avalid):
        S = a.shape[0]
        live = g < S
        if spread is None:
            spread = _spread(g.shape[0], S, g.device)
        gi = torch.where(live, g.long(), spread)
        cv = (vv if vv is not None else torch.ones_like(mask)) & mask & live
        if not inplace:
            a = a.clone()
        if kind == "count":
            new_accs.append(a.index_add_(0, gi, cv.to(a.dtype)))
            new_avalid.append(av)
            continue
        if kind == "sum":
            zero = -0.0 if a.dtype.is_floating_point else 0
            upd = torch.where(cv, vd.to(a.dtype), torch.full_like(a[:1], zero))
            a.index_add_(0, gi, upd)
        elif kind in ("min", "max"):
            ident = _identity(a.dtype, kind == "max")
            upd = torch.where(cv, vd.to(a.dtype),
                              torch.full_like(a[:1], ident))
            a.scatter_reduce_(0, gi, upd, "amin" if kind == "min" else "amax",
                              include_self=True)
        else:
            raise ValueError(f"unsupported agg kind {kind}")
        hit = torch.zeros(S, dtype=torch.int32, device=a.device)
        hit.index_add_(0, gi, cv.to(torch.int32))
        new_accs.append(a)
        new_avalid.append(av.logical_or_(hit > 0) if inplace
                          else av | (hit > 0))
    return new_accs, new_avalid


# ---------------------------------------------------------------------------
# dense group ids (bounded integer keys) and the dense scatter carry
# ---------------------------------------------------------------------------

def _strides(ranges: Sequence[Tuple[int, int]]):
    total, strides = 1, []
    for lo, hi in ranges:
        strides.append(total)
        total *= (hi - lo + 2)  # +1 for the null slot
    return strides, total


def pack_dense_keys(key_cols: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    ranges: Sequence[Tuple[int, int]]):
    """Bounded-range keys packed into one dense int64 group id (row-major
    strides; each key's NULL takes the extra slot hi - lo + 1).  Returns
    (gid, total_slots)."""
    strides, total = _strides(ranges)
    gid = None
    for (data, valid), (lo, hi), stride in zip(key_cols, ranges, strides):
        k = (data.to(torch.int64) - lo).clamp(0, hi - lo)
        k = torch.where(valid, k, torch.full_like(k, hi - lo + 1))
        gid = k * stride if gid is None else gid + k * stride
    return gid, total


def pack_dense_keys_i32(key_cols: Sequence[Tuple[torch.Tensor,
                                                 torch.Tensor]],
                        ranges: Sequence[Tuple[int, int]]):
    """pack_dense_keys in int32: the same stride layout; only the `data -
    lo` shift runs in the key's own dtype, int32 for int8 and int16 keys
    (whose span may exceed their own range)."""
    strides, total = _strides(ranges)
    if total >= (1 << 31):
        raise ValueError("dense table exceeds the int32 id range")
    gid = None
    for (data, valid), (lo, hi), stride in zip(key_cols, ranges, strides):
        span = hi - lo
        if data.dtype.itemsize < 4:
            data = data.to(torch.int32)
        k = (data - lo).clamp(0, span).to(torch.int32)
        k = torch.where(valid, k, torch.full_like(k, span + 1))
        gid = k * stride if gid is None else gid + k * stride
    return gid, total


def unpack_dense_keys(slots, ranges: Sequence[Tuple[int, int]]):
    """Inverse of pack_dense_keys: slot ids -> [(key, validity)] per key.
    Takes a torch tensor (decoded on its device) or a numpy array."""
    if isinstance(slots, np.ndarray):
        rem, where = slots.astype(np.int64), np.where
    else:
        rem, where = slots.to(torch.int64), torch.where
    out = []
    for lo, hi in ranges:
        size = hi - lo + 2
        k = rem % size
        rem = rem // size
        valid = k < (hi - lo + 1)
        out.append((where(valid, k + lo, 0), valid))
    return out


def dense_partial_agg(gid: torch.Tensor, num_slots: int,
                      agg_specs: Sequence[Tuple[str, Optional[torch.Tensor],
                                                Optional[torch.Tensor]]],
                      valid_mask: torch.Tensor):
    """One batch's own dense table: one segmented reduction per
    accumulator, keyed by a precomputed dense group id; masked rows go to
    the sentinel slot `num_slots`, which is cut off.  Empty slots hold 0.
    Returns (accs, acc_valid, slot_occupied)."""
    g = torch.where(valid_mask, gid.to(torch.int64),
                    torch.full_like(gid, num_slots, dtype=torch.int64))

    def seg(init, index, values, reduce=None):
        out = torch.full((num_slots + 1,), init, dtype=values.dtype,
                         device=values.device)
        if reduce is None:
            out.index_add_(0, index, values)
        else:
            out.scatter_reduce_(0, index, values, reduce, include_self=True)
        return out[:num_slots]

    occupied = seg(0, g, valid_mask.to(torch.int32)) > 0
    accs, avalid = [], []
    for kind, values, vvalid in agg_specs:
        vv = (vvalid if vvalid is not None
              else torch.ones_like(valid_mask)) & valid_mask
        if kind == "count":
            accs.append(seg(0, g, vv.to(torch.int64)))
            avalid.append(torch.ones(num_slots, dtype=torch.bool,
                                     device=g.device))
            continue
        if kind == "sum":
            dt = (torch.float64 if values.dtype.is_floating_point
                  else torch.int64)
            v = values.to(dt)
            acc = seg(0, g, torch.where(vv, v, torch.zeros_like(v)))
        elif kind in ("min", "max"):
            ident = _identity(values.dtype, kind == "max")
            gm = torch.where(vv, g, torch.full_like(g, num_slots))
            acc = seg(ident, gm, torch.where(
                vv, values, torch.full_like(values, ident)),
                "amin" if kind == "min" else "amax")
        else:
            raise ValueError(f"unsupported dense agg kind {kind}")
        has = seg(0, g, vv.to(torch.int32)) > 0
        accs.append(torch.where(has, acc, torch.zeros_like(acc)))
        avalid.append(has)
    return accs, avalid, occupied


def init_dense_carry(kinds: Sequence[str], acc_dtypes: Sequence,
                     num_slots: int, device: torch.device):
    """(accs, acc_valid, occupied) of the scatter dense lane."""
    accs, avalid = init_accumulators(kinds, acc_dtypes, num_slots, device)
    return accs, avalid, torch.zeros(num_slots, dtype=torch.bool,
                                     device=device)


def scatter_into_dense_carry(carry, gid: torch.Tensor, kinds: Sequence[str],
                             agg_data, agg_valid, mask: torch.Tensor):
    """One batch into the dense carry: masked rows scatter to their group
    id, the rest to the sentinel num_slots, which drops."""
    accs, avalid, occupied = carry
    num_slots = occupied.shape[0]
    g = torch.where(mask, gid, torch.full_like(gid, num_slots))
    hit = torch.zeros(num_slots + 1, dtype=torch.bool, device=g.device)
    hit[g] = True
    specs = list(zip(kinds, agg_data, agg_valid))
    new_a, new_v = scatter_accumulate(g, specs, mask, accs, avalid)
    return tuple(new_a), tuple(new_v), occupied | hit[:num_slots]


def rehash_carry(old: HashAggCarry, kinds: Sequence[str], new_slots: int,
                 probe_rounds: int = 16):
    """Re-insert an existing table into a larger one (the grow path).
    `kinds` are the original accumulator kinds; stored accumulators merge
    with merge semantics (count -> sum of counts)."""
    key_dtypes = [k.dtype for k in old.keys]
    acc_dtypes = [a.dtype for a in old.accs]
    fresh = init_hash_carry(key_dtypes, kinds, acc_dtypes, new_slots,
                            old.used.device)
    specs = [("sum" if k == "count" else k, a, av)
             for k, a, av in zip(kinds, old.accs, old.acc_valid)]
    return hash_agg_step(fresh, list(zip(old.keys, old.key_valid)), specs,
                         old.used, probe_rounds)
