"""Exact grouped-aggregation table for one window of rows (counterpart of
blaze_tpu/kernels/mxu_agg.py, whose Pallas kernel `_pallas_window_table`
computes the same table on the TPU's matrix unit as bf16 one-hot matmuls).

A row with group id `gid` adds, into the int32 table of its slot, one to
the optional presence block and every 8-bit limb of every value array to
that limb's block.  The table is `(sh, sl * n_blocks)`, block-major: cell
`table[hi, b * sl + lo]` holds block b of slot `hi * sl + lo`; blocks are
[presence?] + every limb of every array, little-endian.  Rows with `gid >=
sh * sl` (the sentinel) drop.  Values are non-negative int32 below
`2 ** (8 * limbs[i])`; all arithmetic is integer, so the table is exact
and independent of the order rows are added in, while
`255 * rows <= 2 ** 31 - 1`: the caller drains it into int64 at least every
`MAX_ROWS_PER_TABLE` rows.

`window_table_plain` is the table from ready group ids and value arrays:
the scatter formulation of the JAX package's `_window_table_ref`, one
`index_add_` into an (S + 1)-slot table whose extra slot takes the
sentinel rows.  The lane runs it inside `window_step`: one batch of the
window-table lane of plan/fused.py (the loop body of the JAX package's
`_mxu_fold_factory`): dense group ids, each aggregate's limb-domain
values and their fixed-point verify, the table update and the min/max
accumulators.  Two implementations, chosen by the tensors' device
(kernels/lane.py): CUDA, one launch of csrc/window_table.cu
`blaze_window_step` (an integer histogram with warp-aggregated int32
atomics, see the note at the top of that file); CPU, `window_step_plain`,
the same arithmetic in eager PyTorch.

`plan_layout`, `split_blocks` and `limb_bits_for` are the JAX module's
host-side planning and recombination; `MxuSpec` and `MxuMeta` describe a
planned lane (plan/fused.py `_plan_mxu_meta` makes them).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import lane

#: 255 * MAX_ROWS_PER_TABLE must stay below 2^31 (int32 table exactness);
#: read at call time, so tests can patch it
MAX_ROWS_PER_TABLE = 8_000_000
_LIMB_BITS = 8
_LIMB_MASK = (1 << _LIMB_BITS) - 1
#: most grouping keys `window_step` takes on the card: a planned layout
#: has at most 512 * 256 = 2 ** 17 slots and every key takes a factor of at
#: least 2 of them, so every plan fits
MAX_KEYS = 17
#: most aggregates it takes (and value arrays: sl * n_blocks <= 2048 and
#: sl >= 128 bound them by 16); `_plan_mxu_meta` plans no more
MAX_SPECS = 16

#: identity of the lane's int32 min (True) / max (False) accumulators
MM_IDENT = {True: (1 << 31) - 1, False: -(1 << 31)}

#: launches of the CUDA step kernel (one per `window_step` call on a CUDA
#: device)
window_step_launches = 0


class WindowTableLayout(NamedTuple):
    """The table's shape: `limbs[i]` is the limb count of value array i."""

    sh: int                  # hi-digit extent (multiple of 8)
    sl: int                  # lo-digit extent (128 or 256)
    limbs: Tuple[int, ...]   # limb count per value array
    presence: bool = True    # a leading count block

    @property
    def num_slots(self) -> int:
        return self.sh * self.sl

    @property
    def n_blocks(self) -> int:
        return (1 if self.presence else 0) + sum(self.limbs)


class MxuSpec(NamedTuple):
    """One aggregate of the window-table lane."""

    kind: str          # count_star | count | sum | min | max
    arr_valid: int     # value-array index of the validity block (-1)
    arr_cents: int     # value-array index of the cents blocks (-1)
    scatter_idx: int   # min/max accumulator index (-1)
    off: int           # integer offset subtracted into the limb domain
    scale: int         # 1 for ints; fixed-point scale for floats
    is_float: bool


class MxuMeta(NamedTuple):
    """A planned window-table lane: its table layout, its aggregates, the
    table's value arrays and the min/max accumulators."""

    layout: WindowTableLayout
    specs: Tuple[MxuSpec, ...]
    arrays: Tuple[Tuple[str, int], ...]   # ("valid"|"cents", spec_index)
    scatter: Tuple[Tuple[bool, int], ...]  # (is_min, spec_index)


def plan_layout(num_slots: int, value_bits: Sequence[int],
                presence: bool = True) -> Optional[WindowTableLayout]:
    """(sh, sl) digits and limb counts for `num_slots` groups, or None
    outside the JAX kernel's envelope (sh <= 512, sl * n_blocks <= 2048,
    at most 4 limbs per array), so both packages admit the same plans."""
    limbs = tuple(max(1, -(-int(b) // _LIMB_BITS)) for b in value_bits)
    nb = (1 if presence else 0) + sum(limbs)
    sl = 128 if num_slots <= (1 << 14) else 256
    sh = -(-num_slots // sl)
    sh += (-sh) % 8
    if sh > 512 or sl * nb > 2048 or any(n > 4 for n in limbs):
        return None
    return WindowTableLayout(sh, sl, limbs, presence)


def limb_bits_for(lo: int, hi: int) -> int:
    """Bits needed for the shifted non-negative value range [0, hi - lo]."""
    span = max(0, int(hi) - int(lo))
    return max(1, span.bit_length())


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------

def window_table_plain(gid: torch.Tensor, arrays: Sequence[torch.Tensor],
                       layout: WindowTableLayout) -> torch.Tensor:
    """One window's table on any device.  gid: (n,) int32 group ids, the
    sentinel `layout.num_slots` for rows to drop; arrays: one (n,) int32
    per `layout.limbs` entry, zeroed where the value is NULL.  Returns a
    fresh (sh, sl * n_blocks) int32 table."""
    S = layout.num_slots
    nb = layout.n_blocks
    dev = gid.device
    g = gid.to(torch.int64)
    g = torch.where((g >= 0) & (g < S), g, torch.full_like(g, S))
    weights = []
    if layout.presence:
        weights.append(torch.ones_like(g))
    for a, nl in zip(arrays, layout.limbs):
        # logical shift: limbs of the value's 32 bits as unsigned
        u = a.to(torch.int64) & 0xFFFFFFFF
        for li in range(nl):
            weights.append((u >> (_LIMB_BITS * li)) & _LIMB_MASK)
    flat = torch.zeros(nb * (S + 1), dtype=torch.int32, device=dev)
    if g.shape[0]:
        idx = torch.cat([g + b * (S + 1) for b in range(nb)])
        flat.index_add_(0, idx, torch.cat(weights).to(torch.int32))
    tab = flat.reshape(nb, S + 1)[:, :S].reshape(nb, layout.sh, layout.sl)
    return tab.permute(1, 0, 2).reshape(layout.sh, layout.sl * nb)


# ---------------------------------------------------------------------------
# one batch of the lane: plain version and CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=256)
def _checked_layout(layout: WindowTableLayout) -> None:
    """Validate a layout for the kernel once."""
    if len(layout.limbs) > MAX_SPECS:
        raise ValueError(f"window_step: at most {MAX_SPECS} value arrays")
    if layout.sl & (layout.sl - 1) or not 0 < layout.sl <= 1024:
        raise ValueError(f"window_step: sl={layout.sl} is not a power of "
                         f"two up to 1024")
    if any(not 1 <= n <= 4 for n in layout.limbs):
        raise ValueError(f"window_step: limbs {layout.limbs} outside 1..4")
    if layout.sh * layout.sl * layout.n_blocks >= (1 << 31):
        raise ValueError("window_step: the table exceeds int32 indexing")


def window_step_plain(meta: MxuMeta, ranges, kd, kv, ad, av,
                      m: torch.Tensor, carry):
    """`window_step` in eager PyTorch on any device: int32 group ids, the
    fixed-point limb domain and its verify, the table update and the
    min/max scatters (blaze_tpu/plan/fused.py _mxu_fold_factory's loop
    body).  The table and the min/max accumulators are updated in place;
    returns (table, mm_accs, ok)."""
    from blaze_tpu_torch.parallel.stage import pack_dense_keys_i32
    table, mm_accs, ok = carry
    gid, _total = pack_dense_keys_i32(list(zip(kd, kv)), ranges)
    gid = torch.where(m, gid, torch.full_like(gid, meta.layout.num_slots))
    valids, cents = {}, {}
    for si, sp in enumerate(meta.specs):
        if sp.kind == "count_star":
            continue
        valids[si] = av[si] if av[si] is not None else torch.ones_like(m)
        if sp.kind == "count":
            continue
        data = ad[si]
        if sp.is_float:
            scale = float(sp.scale)
            c = torch.round(data * scale)  # half to even, as jnp.rint
            # fixed-point verify without division: a genuine scaled value
            # lies within two roundings of its integer
            exact = (data * scale - c).abs() <= (c.abs() + 1.0) * 1e-12
            ok = ok & (exact | ~valids[si] | ~m).all()
            cents[si] = (c - sp.off).to(torch.int32)
        else:
            cents[si] = (data.to(torch.int64) - sp.off).to(torch.int32)
    arrays = []
    for akind, si in meta.arrays:
        if akind == "valid":
            arrays.append((valids[si] & m).to(torch.int32))
        else:
            arrays.append(torch.where(valids[si], cents[si],
                                      torch.zeros_like(cents[si])))
    table.add_(window_table_plain(gid, arrays, meta.layout))
    gl = gid.to(torch.int64)
    new_mm = []
    for (is_min, si), acc in zip(meta.scatter, mm_accs):
        val = torch.where(valids[si] & m, cents[si],
                          torch.full_like(cents[si], MM_IDENT[is_min]))
        new_mm.append(acc.scatter_reduce_(
            0, gl, val, "amin" if is_min else "amax", include_self=True))
    return table, new_mm, ok


class _StepKey(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("lo", ctypes.c_int64), ("span", ctypes.c_int64),
                ("stride", ctypes.c_int64), ("bytes", ctypes.c_int64)]


class _StepSpec(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("valid", ctypes.c_void_p),
                ("off", ctypes.c_int64), ("scale", ctypes.c_double),
                ("dtype", ctypes.c_int64)]


class _StepArray(ctypes.Structure):
    _fields_ = [("spec", ctypes.c_int64), ("is_valid", ctypes.c_int64),
                ("limbs", ctypes.c_int64)]


class _StepMinMax(ctypes.Structure):
    _fields_ = [("acc", ctypes.c_void_p), ("spec", ctypes.c_int64),
                ("is_min", ctypes.c_int64)]


class _StepParams(ctypes.Structure):
    """Mirror of `StepParams` in csrc/window_table.cu: every field is 8
    bytes, so the two layouts agree without padding rules."""
    _fields_ = [("mask", ctypes.c_void_p), ("table", ctypes.c_void_p),
                ("ok", ctypes.c_void_p)] + \
        [(f, ctypes.c_int64) for f in
         ("n", "sh", "lo_bits", "nb", "presence", "sentinel", "n_keys",
          "n_specs", "n_arrays", "n_mm")] + \
        [("keys", _StepKey * MAX_KEYS), ("specs", _StepSpec * MAX_SPECS),
         ("arrays", _StepArray * MAX_SPECS), ("mm", _StepMinMax * MAX_SPECS)]


#: the kernel's dtype code of a key (ints only) or aggregate column
_DTYPE_CODE = {torch.int8: 1, torch.int16: 2, torch.int32: 4,
               torch.int64: 8, torch.float64: 9}


class _StepPlan(NamedTuple):
    """A plan's kernel parameters, validated once: the parameter block
    with everything but the pointers and the row count filled in, the
    block's word index of each pointer, and the input columns' dtypes it
    was built for."""

    meta: MxuMeta
    ranges: Sequence            # the caller's object, checked by identity
    template: ctypes.Array      # the StepParams block as 64-bit words
    in_dtypes: tuple            # mask, keys' (data, valid), aggregates'
    in_slots: tuple             # word index per input, in that order
    spec_inputs: tuple          # (spec index, has data) per aggregate
    mm_slots: tuple             # word index per min/max accumulator


_WORDS = ctypes.sizeof(_StepParams) // 8
#: (id(meta), id(ranges)) -> their _StepPlan (the plan holds both, so
#: the ids stay theirs); cleared past MAX_PLANS
_step_plans: dict = {}
MAX_PLANS = 256


def _word(field_offset: int) -> int:
    return field_offset // 8


def _spec_inputs(meta: MxuMeta) -> tuple:
    """(spec index, has data) of each aggregate that reads its argument."""
    return tuple((si, sp.kind != "count") for si, sp in enumerate(meta.specs)
                 if sp.kind != "count_star")


def _step_inputs(spec_inputs, kd, kv, ad, av, m) -> list:
    """The step's input columns in the parameter block's order: the mask,
    each key's data and validity, each aggregate's validity and data."""
    ins = [m]
    for d, v in zip(kd, kv):
        ins += (d, v)
    for si, has_data in spec_inputs:
        ins.append(av[si])
        if has_data:
            ins.append(ad[si])
    return ins


def _step_plan(meta: MxuMeta, ranges, ins) -> _StepPlan:
    """Build, validate and cache the kernel parameters of a plan for input
    columns of these dtypes (`ins` in `_step_inputs` order)."""
    layout = meta.layout
    _checked_layout(layout)
    if any(t is None for t in ins):
        raise ValueError("window_step: every aggregate but count(*) needs "
                         "its argument's data and validity")
    if not 1 <= len(ranges) <= MAX_KEYS:
        raise ValueError(f"window_step: {len(ranges)} keys; the kernel "
                         f"takes 1 to {MAX_KEYS}")
    if len(meta.specs) > MAX_SPECS:
        raise ValueError(f"window_step: at most {MAX_SPECS} aggregates")
    p = _StepParams()
    p.sh, p.nb, p.presence = layout.sh, layout.n_blocks, int(layout.presence)
    p.lo_bits = layout.sl.bit_length() - 1
    p.sentinel = layout.num_slots
    p.n_keys, p.n_specs = len(ranges), len(meta.specs)
    p.n_arrays, p.n_mm = len(meta.arrays), len(meta.scatter)
    keys_at, specs_at, mm_at = (_StepParams.keys.offset,
                                _StepParams.specs.offset,
                                _StepParams.mm.offset)
    kz, sz, mz = (ctypes.sizeof(_StepKey), ctypes.sizeof(_StepSpec),
                  ctypes.sizeof(_StepMinMax))
    dtypes = [torch.bool]
    slots = [_word(_StepParams.mask.offset)]
    stride = 1
    for k, (lo, hi) in enumerate(ranges):
        dt = ins[1 + 2 * k].dtype
        if _DTYPE_CODE.get(dt, 9) == 9:
            raise ValueError(f"window_step: key {k} is {dt}; the kernel "
                             f"takes int8, int16, int32 or int64 keys")
        key = p.keys[k]
        key.lo, key.span, key.stride = lo, hi - lo, stride
        key.bytes = _DTYPE_CODE[dt]
        stride *= hi - lo + 2
        dtypes += [dt, torch.bool]
        slots += [_word(keys_at + k * kz + _StepKey.data.offset),
                  _word(keys_at + k * kz + _StepKey.valid.offset)]
    if stride >= (1 << 31):
        raise ValueError("dense table exceeds the int32 id range")
    at = 1 + 2 * len(ranges)
    for si, sp in enumerate(meta.specs):
        spec = p.specs[si]
        spec.off, spec.scale = sp.off, float(sp.scale)
        if sp.kind == "count_star":
            continue
        has_data = sp.kind != "count"
        dtypes.append(torch.bool)
        slots.append(_word(specs_at + si * sz + _StepSpec.valid.offset))
        at += 1
        if not has_data:
            continue
        if sp.kind not in ("sum", "min", "max"):
            raise ValueError(f"window_step: aggregate {sp.kind}")
        dt = ins[at].dtype
        if dt not in _DTYPE_CODE or (dt == torch.float64) != sp.is_float:
            raise ValueError(f"window_step: a {sp.kind} over {dt} "
                             f"(is_float={sp.is_float})")
        spec.dtype = _DTYPE_CODE[dt]
        dtypes.append(dt)
        slots.append(_word(specs_at + si * sz + _StepSpec.data.offset))
        at += 1
    if any(t.dtype != dt for t, dt in zip(ins, dtypes)):
        raise ValueError("window_step: the mask and every validity must be "
                         "bool")
    for a, ((akind, si), nl) in enumerate(zip(meta.arrays, layout.limbs)):
        arr = p.arrays[a]
        arr.spec, arr.is_valid, arr.limbs = si, int(akind == "valid"), nl
    for j, (is_min, si) in enumerate(meta.scatter):
        p.mm[j].spec, p.mm[j].is_min = si, int(is_min)
    plan = _StepPlan(
        meta, ranges, (ctypes.c_uint64 * _WORDS).from_buffer_copy(p),
        tuple(dtypes), tuple(slots), _spec_inputs(meta),
        tuple(_word(mm_at + j * mz + _StepMinMax.acc.offset)
              for j in range(len(meta.scatter))))
    if len(_step_plans) >= MAX_PLANS:
        _step_plans.clear()
    _step_plans[(id(meta), id(ranges))] = plan
    return plan


def _window_step_cuda(meta, ranges, kd, kv, ad, av, m, carry):
    global window_step_launches
    from blaze_tpu_torch.kernels import build
    table, mm_accs, ok = carry
    n = m.shape[0]
    plan = _step_plans.get((id(meta), id(ranges)))
    if plan is None or plan.meta is not meta or plan.ranges is not ranges:
        plan = None
    ins = _step_inputs(plan.spec_inputs if plan else _spec_inputs(meta),
                       kd, kv, ad, av, m)
    if plan is None or any(t is None or t.dtype != dt
                           for t, dt in zip(ins, plan.in_dtypes)):
        plan = _step_plan(meta, ranges, ins)  # new plan or column types
    lay = meta.layout
    shape, S1 = (lay.sh, lay.sl * lay.n_blocks), (lay.num_slots + 1,)
    for t in ins:
        if t.shape != (n,) or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"window_step: every column must be a "
                             f"contiguous ({n},) tensor on the card, got "
                             f"{tuple(t.shape)} on {t.device}")
    if (table.dtype != torch.int32 or table.shape != shape
            or not table.is_cuda or not table.is_contiguous()
            or ok.dtype != torch.bool or not ok.is_cuda
            or len(mm_accs) != len(plan.mm_slots)
            or any(a.dtype != torch.int32 or a.shape != S1 or not a.is_cuda
                   or not a.is_contiguous() for a in mm_accs)):
        raise ValueError("window_step: the carry must be an int32 table of "
                         f"{shape}, int32 {S1} min/max accumulators and a "
                         "bool ok flag, all on the card")
    words = plan.template.__class__.from_buffer_copy(plan.template)
    for i, t in zip(plan.in_slots, ins):
        words[i] = t.data_ptr()
    for i, a in zip(plan.mm_slots, mm_accs):
        words[i] = a.data_ptr()
    words[_TABLE], words[_OK], words[_N] = table.data_ptr(), ok.data_ptr(), n
    rc = build.bound("window_table", "blaze_window_step")(
        words, build.stream_of(m.device))
    build.check(rc, "window-step kernel")
    window_step_launches += 1
    return table, mm_accs, ok


_TABLE, _OK, _N = (_word(_StepParams.table.offset),
                   _word(_StepParams.ok.offset), _word(_StepParams.n.offset))


def window_step(meta: MxuMeta, ranges, kd, kv, ad, av, m: torch.Tensor,
                carry):
    """One batch into the lane's carry (table, mm_accs, ok).  kd/kv: the
    grouping keys' data and validity, packed with `ranges` as
    `pack_dense_keys_i32`; ad/av: per aggregate of `meta.specs` its
    argument's data and validity (None for count(*)); m: the batch's bool
    row mask.  The table and the (S + 1,) int32 min/max accumulators are
    updated in place; `ok` turns false once a float64 value fails the
    fixed-point verify.  Returns the carry."""
    if lane.route(m) == "cuda":
        return _window_step_cuda(meta, ranges, kd, kv, ad, av, m, carry)
    return window_step_plain(meta, ranges, kd, kv, ad, av, m, carry)


# ---------------------------------------------------------------------------
# recombination
# ---------------------------------------------------------------------------

def split_blocks(table: torch.Tensor, layout: WindowTableLayout
                 ) -> Tuple[Optional[torch.Tensor], List[torch.Tensor]]:
    """(presence (S,) int64 or None, per value array its recombined (S,)
    int64 sums), on the table's device."""
    sh, sl, nb = layout.sh, layout.sl, layout.n_blocks
    t = table.reshape(sh, nb, sl).to(torch.int64)
    b = 0
    presence = None
    if layout.presence:
        presence = t[:, 0, :].reshape(-1)
        b = 1
    out = []
    for nl in layout.limbs:
        acc = torch.zeros(sh * sl, dtype=torch.int64, device=t.device)
        for li in range(nl):
            acc += t[:, b, :].reshape(-1) << (_LIMB_BITS * li)
            b += 1
        out.append(acc)
    return presence, out
