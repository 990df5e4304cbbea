"""Device group tables (port of the aggregation core of
blaze_tpu/parallel/stage.py: `HashAggCarry` .. `_identity`, and the dense
group ids `pack_dense_keys[_i32]` / `unpack_dense_keys`, with the dense
scatter carry of blaze_tpu/plan/fused.py `_init_carry` /
`_scatter_into_carry`).

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


def init_accumulators(kinds: Sequence[str], acc_dtypes: Sequence,
                      num_slots: int, device: torch.device):
    """Identity-initialized accumulator columns."""
    accs, avalid = [], []
    for kind, dt in zip(kinds, acc_dtypes):
        if kind == "count":
            accs.append(torch.zeros(num_slots, dtype=torch.int64,
                                    device=device))
            avalid.append(torch.ones(num_slots, dtype=torch.bool,
                                     device=device))
            continue
        if kind == "min":
            accs.append(torch.full((num_slots,), _identity(dt, False),
                                   dtype=dt, device=device))
        elif kind == "max":
            accs.append(torch.full((num_slots,), _identity(dt, True),
                                   dtype=dt, device=device))
        else:
            accs.append(torch.zeros(num_slots, dtype=dt, device=device))
        avalid.append(torch.zeros(num_slots, dtype=torch.bool,
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
    from blaze_tpu_torch.kernels.hashing import hash_columns
    S = carry.used.shape[0]
    key_cols = [(_norm_float(d), v) if d.is_floating_point() else (d, v)
                for d, v in key_cols]
    cols = [(d, v, dtype_of(d).id.value) for d, v in key_cols]
    h = hash_columns(cols, seed=42, algo="xxhash64") & (S - 1)
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
                       avalid: Sequence[torch.Tensor]):
    """Rows scatter into slot `g`; out-of-range slots (the sentinel S) drop.
    Dropped rows are routed to slot 0 with the operation's identity (0 for
    sums and counts, the max/min identity for min/max), which leaves every
    accumulator bit unchanged."""
    new_accs, new_avalid = [], []
    for (kind, vd, vv), a, av in zip(agg_specs, accs, avalid):
        S = a.shape[0]
        live = g < S
        gi = torch.where(live, g, 0).long()
        cv = (vv if vv is not None else torch.ones_like(mask)) & mask & live
        if kind == "count":
            a = a.clone().index_add_(0, gi, cv.to(a.dtype))
            new_accs.append(a)
            new_avalid.append(av)
            continue
        if kind == "sum":
            upd = torch.where(cv, vd.to(a.dtype), torch.zeros_like(a[:1]))
            a = a.clone().index_add_(0, gi, upd)
        elif kind in ("min", "max"):
            ident = _identity(a.dtype, kind == "max")
            upd = torch.where(cv, vd.to(a.dtype),
                              torch.full_like(a[:1], ident))
            a = a.clone().scatter_reduce_(0, gi, upd,
                                          "amin" if kind == "min" else "amax",
                                          include_self=True)
        else:
            raise ValueError(f"unsupported agg kind {kind}")
        hit = torch.zeros(S, dtype=torch.int32, device=a.device)
        hit.index_add_(0, gi, cv.to(torch.int32))
        new_accs.append(a)
        new_avalid.append(av | (hit > 0))
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
