"""Device sort and segmented reductions (port of blaze_tpu/kernels/sort.py).

The JAX package builds these from `lax.sort` and `jax.ops.segment_*`;
here they are PyTorch operations on the batch's device:

  * `segment_sum`/`segment_count` are one `index_add_` into a buffer one
    slot longer than the segments: rows whose group id is out of range
    (padding and masked rows carry `capacity - 1`, which is past the
    groups) land in the extra slot, as XLA's scatter drops them;
  * `segment_min`/`segment_max` are `scatter_reduce` over an identity
    fill.  NaN propagates as in `jax.ops.segment_min`: NaN values enter
    the reduction as the identity and a segment that held one becomes
    NaN afterwards, so the result does not depend on how a backend's
    atomics treat NaN.  An empty segment holds the JAX identity (the
    type's extreme, or -inf/inf).

On CUDA the float sums add with atomics in a run-dependent order; on the
CPU `index_add_` adds in row order, as the JAX package does there.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.kernels import compare
from blaze_tpu_torch.schema import DataType


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
                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-segment sums in the values' type (integers wrap as in JAX)."""
    v = values if valid is None else torch.where(
        valid, values, torch.zeros_like(values))
    out = torch.zeros(num_segments + 1, dtype=v.dtype, device=v.device)
    out.index_add_(0, _slot(gids, num_segments), v)
    return out[:num_segments]


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
