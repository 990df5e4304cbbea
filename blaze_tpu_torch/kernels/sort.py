"""Device sort and segmented reductions (port of blaze_tpu/kernels/sort.py).

The JAX package builds these from `lax.sort` and `jax.ops.segment_*`;
here they are PyTorch operations on the batch's device:

  * `segment_sum`/`segment_count` are one `index_add_` into a buffer one
    slot longer than the segments: rows whose group id is out of range
    (padding and masked rows carry `capacity - 1`, which is past the
    groups) land in the extra slot, as XLA's scatter drops them.  A float
    sum on a CUDA tensor runs csrc/segment_sum.cu instead (below);
  * `segment_min`/`segment_max` are `scatter_reduce` over an identity
    fill.  NaN propagates as in `jax.ops.segment_min`: NaN values enter
    the reduction as the identity and a segment that held one becomes
    NaN afterwards, so the result does not depend on how a backend's
    atomics treat NaN.  An empty segment holds the JAX identity (the
    type's extreme, or -inf/inf).

Float sums add in row order on both devices.  On the CPU `index_add_`
adds each segment's rows sequentially from +0.0, as the JAX package does
there.  On the card `index_add_` adds with atomics in a run-dependent
order, so a float sum on a CUDA tensor goes to the hand kernel
csrc/segment_sum.cu, one warp per segment adding its rows in row order,
which gives the CPU's bits; integer sums stay on `index_add_`, exact in
any order.  There is no fallback: a CUDA float tensor the kernel does not
take (float16, bfloat16) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import compare, lane
from blaze_tpu_torch.schema import DataType

#: launches of the CUDA row-order sum (csrc/segment_sum.cu): one per
#: `segment_sum` call on a CUDA float tensor with rows and segments (two
#: kernels each)
segment_sum_launches = 0


def sort_indices(columns: Sequence[Tuple[torch.Tensor,
                                         Optional[torch.Tensor], DataType]],
                 descending: Sequence[bool], nulls_first: Sequence[bool],
                 valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable row permutation sorting by the key columns; masked-out rows
    sink to the end."""
    keys = compare.order_keys(columns, descending, nulls_first)
    return compare.lexsort_indices(keys, valid_mask)


def group_ids_from_sorted(keys: Sequence[torch.Tensor],
                          valid_mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense int64 group ids of rows already sorted by `keys`, and the
    group count as a device scalar.  Masked rows get `capacity - 1`, past
    every group (callers cut at the group count)."""
    n = keys[0].shape[0]
    boundary = compare.rows_differ_from_prev(keys) & valid_mask
    # the first valid row opens a group even if it equals a masked row 0
    # (CUDA's argmax takes no bool)
    first_valid = torch.argmax(valid_mask.to(torch.int32))
    idx = torch.arange(n, device=valid_mask.device)
    boundary = boundary | ((idx == first_valid) & valid_mask)
    b = boundary.to(torch.int64)
    gids = torch.cumsum(b, 0) - 1
    num_groups = b.sum()
    gids = torch.where(valid_mask, gids, n - 1)
    return gids, num_groups


def _slot(gids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Group ids with every out-of-range id sent to slot num_segments."""
    ok = (gids >= 0) & (gids < num_segments)
    return torch.where(ok, gids, num_segments).to(torch.int64)


def segment_sum(values: torch.Tensor, gids: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor] = None,
                contiguous: bool = False) -> torch.Tensor:
    """Per-segment sums in the values' type (integers wrap as in JAX);
    floats add in row order.  `contiguous` says the rows of each segment
    are adjacent (out-of-range rows aside), as the generic engine's are
    after its lexsort; the card's kernel then walks them where they lie,
    else it sorts the ids stably first.  Either way the sums are the
    same."""
    if values.dtype.is_floating_point and lane.route(values) == "cuda":
        return _segment_sum_cuda(values, gids, num_segments, valid,
                                 contiguous)
    return segment_sum_plain(values, gids, num_segments, valid)


def segment_sum_plain(values: torch.Tensor, gids: torch.Tensor,
                      num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`segment_sum` as one `index_add_` (row order on the CPU)."""
    v = values if valid is None else torch.where(
        valid, values, torch.zeros_like(values))
    out = torch.zeros(num_segments + 1, dtype=v.dtype, device=v.device)
    out.index_add_(0, _slot(gids, num_segments), v)
    return out[:num_segments]


def _segment_sum_cuda(values, gids, num_segments, valid, contiguous):
    """One call of csrc/segment_sum.cu: float32/float64 sums in row
    order."""
    global segment_sum_launches
    from blaze_tpu_torch.kernels import build
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_sum: no row-order kernel for "
                        f"{values.dtype} on the card")
    n = values.shape[0]
    if values.dim() != 1 or gids.shape != values.shape or (
            valid is not None and valid.shape != values.shape):
        raise ValueError(f"segment_sum: values {tuple(values.shape)}, gids "
                         f"{tuple(gids.shape)} and valid must be equal 1-D")
    dev = values.device
    if n == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=values.dtype, device=dev)
    slots = _slot(gids, num_segments)
    v = values.contiguous()
    ok = None if valid is None else valid.to(torch.bool).contiguous()
    if not contiguous:
        order = torch.sort(slots, stable=True).indices
        slots = slots.index_select(0, order)
        v = v.index_select(0, order)
        ok = None if ok is None else ok.index_select(0, order)
    out = torch.empty(num_segments, dtype=v.dtype, device=dev)
    first = torch.empty(num_segments, dtype=torch.int64, device=dev)
    last = torch.empty(num_segments, dtype=torch.int64, device=dev)
    rc = build.bound("segment_sum", "blaze_segment_sum")(
        slots.data_ptr(), v.data_ptr(), None if ok is None else ok.data_ptr(),
        out.data_ptr(), first.data_ptr(), last.data_ptr(), n, num_segments,
        int(v.dtype == torch.float64), build.stream_of(dev))
    build.check(rc, "segment_sum kernel")
    segment_sum_launches += 1
    return out


def segment_count(valid: torch.Tensor, gids: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    return segment_sum(valid.to(torch.int64), gids, num_segments)


def _identity_for(dtype: torch.dtype, minimum: bool):
    """The reference's fill for masked rows: the smallest value when
    `minimum`, else the largest (bool: True either way, as the reference
    computes it)."""
    if dtype.is_floating_point:
        return float("-inf") if minimum else float("inf")
    if dtype == torch.bool:
        return True
    info = torch.iinfo(dtype)
    return info.min if minimum else info.max


def _segment_extreme(values, gids, num_segments, valid, minimum):
    dtype = values.dtype
    work = values.to(torch.uint8) if dtype == torch.bool else values
    if valid is not None:
        fill = _identity_for(dtype, minimum=not minimum)
        work = torch.where(valid, work, torch.full_like(work, fill))
    slots = _slot(gids, num_segments)
    empty = _identity_for(work.dtype, minimum=not minimum)
    nan = None
    if work.dtype.is_floating_point:
        nan = torch.isnan(work)
        work = torch.where(nan, torch.full_like(work, empty), work)
    out = torch.full((num_segments + 1,), empty, dtype=work.dtype,
                     device=work.device)
    out = out.scatter_reduce(0, slots, work,
                             "amin" if minimum else "amax",
                             include_self=True)[:num_segments]
    if nan is not None:
        has_nan = segment_count(nan, gids, num_segments) > 0
        out = torch.where(has_nan, torch.full_like(out, float("nan")), out)
    return out.to(dtype)


def segment_min(values: torch.Tensor, gids: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _segment_extreme(values, gids, num_segments, valid, True)


def segment_max(values: torch.Tensor, gids: torch.Tensor, num_segments: int,
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    return _segment_extreme(values, gids, num_segments, valid, False)


def _first_position(pos: torch.Tensor, gids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Smallest `pos` per segment, or len(pos) for an empty segment."""
    n = pos.shape[0]
    out = torch.full((num_segments + 1,), n, dtype=torch.int64,
                     device=pos.device)
    return out.scatter_reduce(0, _slot(gids, num_segments), pos, "amin",
                              include_self=True)[:num_segments]


def segment_first(values: torch.Tensor, valid: torch.Tensor,
                  gids: torch.Tensor, num_segments: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First row's value per segment, null or not (Spark
    first(ignoreNulls=false)); an empty segment comes back invalid."""
    n = values.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=values.device)
    first = _first_position(pos, gids, num_segments)
    idx = first.clamp(0, max(n - 1, 0))
    return (values.index_select(0, idx),
            valid.index_select(0, idx) & (first < n))


def segment_first_ignores_null(values: torch.Tensor, valid: torch.Tensor,
                               gids: torch.Tensor, num_segments: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First non-null value per segment (Spark first(ignoreNulls=true))."""
    n = values.shape[0]
    pos = torch.where(valid, torch.arange(n, dtype=torch.int64,
                                          device=values.device), n)
    first = _first_position(pos, gids, num_segments)
    idx = first.clamp(0, max(n - 1, 0))
    return values.index_select(0, idx), first < n


def segment_boundaries_to_offsets(gids: torch.Tensor, num_groups,
                                  capacity: int) -> torch.Tensor:
    """Per-group start offsets (capacity + 1 of them) from dense sorted
    group ids."""
    counts = torch.bincount(torch.where(gids < capacity, gids, capacity),
                            minlength=capacity + 1)[:capacity]
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
