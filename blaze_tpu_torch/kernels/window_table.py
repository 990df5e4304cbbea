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

Two implementations of one function, chosen by the tensors' device
(kernels/lane.py):
  * CUDA: csrc/window_table.cu, an integer histogram, one thread per row
    adding its blocks with int32 atomics (see the note at the top of that
    file);
  * CPU: `window_table_plain`, the scatter formulation of the JAX
    package's `_window_table_ref`, one `index_add_` into an (S + 1)-slot
    table whose extra slot takes the sentinel rows.

`plan_layout`, `split_blocks` and `limb_bits_for` are the JAX module's
host-side planning and recombination.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import lane

#: 255 * MAX_ROWS_PER_TABLE must stay below 2^31 (int32 table exactness);
#: read at call time, so tests can patch it
MAX_ROWS_PER_TABLE = 8_000_000
_LIMB_BITS = 8
_LIMB_MASK = (1 << _LIMB_BITS) - 1
#: most value arrays the CUDA entry point takes (sl * n_blocks <= 2048 and
#: sl >= 128 bound n_blocks by 16)
MAX_ARRAYS = 16

#: launches of the CUDA window-table kernel (one per `window_table` call on
#: a CUDA device)
window_table_launches = 0


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
# the table: plain version and CUDA kernel
# ---------------------------------------------------------------------------

def window_table_plain(gid: torch.Tensor, arrays: Sequence[torch.Tensor],
                       layout: WindowTableLayout) -> torch.Tensor:
    """Scatter formulation of `window_table` on any device."""
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


def _check_operands(gid, arrays, layout, out):
    if len(arrays) != len(layout.limbs):
        raise ValueError(f"window_table: {len(arrays)} value arrays for "
                         f"{len(layout.limbs)} limb counts")
    if len(arrays) > MAX_ARRAYS:
        raise ValueError(f"window_table: at most {MAX_ARRAYS} value arrays")
    if layout.sl & (layout.sl - 1) or not 0 < layout.sl <= 1024:
        raise ValueError(f"window_table: sl={layout.sl} is not a power of "
                         f"two up to 1024")
    if any(not 1 <= n <= 4 for n in layout.limbs):
        raise ValueError(f"window_table: limbs {layout.limbs} outside 1..4")
    n = gid.shape[0]
    for name, t in [("gid", gid)] + [(f"arrays[{i}]", a)
                                     for i, a in enumerate(arrays)]:
        if t.dtype != torch.int32:
            raise TypeError(f"window_table: {name} must be int32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"window_table: {name} has shape "
                             f"{tuple(t.shape)}, expected ({n},)")
        if t.device != gid.device or not t.is_contiguous():
            raise ValueError(f"window_table: {name} must be contiguous on "
                             f"{gid.device}")
    shape = (layout.sh, layout.sl * layout.n_blocks)
    if (out.dtype != torch.int32 or tuple(out.shape) != shape
            or out.device != gid.device or not out.is_contiguous()):
        raise ValueError(f"window_table: out must be a contiguous int32 "
                         f"{shape} table on {gid.device}")
    if out.numel() >= (1 << 31) or n >= (1 << 31):
        raise ValueError("window_table: operands exceed int32 indexing")


def _window_table_cuda(gid, arrays, layout, out):
    global window_table_launches
    from blaze_tpu_torch.kernels import build
    _check_operands(gid, arrays, layout, out)
    k = len(arrays)
    lib = build.load("window_table")
    fn = lib.blaze_window_table
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    ptrs = (ctypes.c_void_p * MAX_ARRAYS)(*[a.data_ptr() for a in arrays])
    limbs = (ctypes.c_int * MAX_ARRAYS)(*layout.limbs)
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    rc = fn(gid.data_ptr(), ptrs, limbs, k, out.data_ptr(), gid.shape[0],
            layout.sh, layout.sl, layout.n_blocks, int(layout.presence),
            stream)
    build.check(rc, "window-table kernel")
    window_table_launches += 1
    return out


def window_table(gid: torch.Tensor, arrays: Sequence[torch.Tensor],
                 layout: WindowTableLayout,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One window's table.  gid: (n,) int32 group ids, the sentinel
    `layout.num_slots` for rows to drop; arrays: one (n,) int32 per
    `layout.limbs` entry, zeroed where the value is NULL.  With `out`
    (an int32 table of the layout's shape), the window is added into it in
    place and `out` is returned; else a fresh table."""
    shape = (layout.sh, layout.sl * layout.n_blocks)
    if lane.route(gid) == "cuda":
        if out is None:
            out = torch.zeros(shape, dtype=torch.int32, device=gid.device)
        if gid.shape[0] == 0:
            return out
        return _window_table_cuda(gid, list(arrays), layout, out)
    tab = window_table_plain(gid, arrays, layout)
    return tab if out is None else out.add_(tab)


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
