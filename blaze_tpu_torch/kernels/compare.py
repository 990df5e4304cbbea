"""Null-aware comparison and order-key encoding (port of
blaze_tpu/kernels/compare.py).

Each sort key column maps to a pair of operands, a small bucket and a
value key, whose joint lexicographic `<` equals the column's SQL order
(asc/desc, nulls first/last, NaN largest as in Spark).  A multi-key sort
sorts the operands of every column in turn.

Two differences from the JAX package, both forced by PyTorch and neither
changing a permutation:

  * integer keys stay int64.  The JAX package sign-biases them into
    uint64 and flips descending keys with `~`; PyTorch's uint64 has
    neither `sort` nor `^` on CUDA.  The natural int64 order equals the
    biased uint64 order, and `~v` reverses int64 exactly, so the key here
    is the JAX key with the bias taken off (`(k ^ 2^63)` viewed as int64);
    a NULL row's key is int64's minimum, the JAX package's 0.
  * PyTorch has no multi-operand sort: `lexsort_indices` sorts stably by
    one operand at a time, from the least significant to the most,
    gathering the permutation between passes (a radix-style LSD
    lexsort), with the row mask and the leading bucket folded into one
    small operand.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from blaze_tpu_torch.schema import DataType, TypeId

INT64_MIN = -(1 << 63)


def order_key(data: torch.Tensor, validity: Optional[torch.Tensor],
              dtype: DataType, descending: bool = False,
              nulls_first: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bucket uint8, value key) of one column.  Buckets: 0/4 null
    (first/last), 2 ordinary value, 1/3 NaN (after values on ASC, before
    them on DESC).  NaN keys are zeroed and -0.0 becomes +0.0, so the same
    operands serve as grouping keys (NaN == NaN, -0.0 == 0.0, null ==
    null)."""
    tid = dtype.id
    n = data.shape[0]
    if tid in (TypeId.FLOAT32, TypeId.FLOAT64):
        is_nan = torch.isnan(data)
        key = torch.where(is_nan, torch.zeros_like(data), data)
        if descending:
            key = -key
        key = key + 0.0  # -0.0 + 0.0 == +0.0
        bucket = torch.where(is_nan, 1 if descending else 3, 2).to(
            torch.uint8)
        null_key = 0.0
    elif tid == TypeId.BOOL:
        key = data.to(torch.uint8)
        if descending:
            key = 1 - key
        bucket = torch.full((n,), 2, dtype=torch.uint8, device=data.device)
        null_key = 0
    else:
        key = data.to(torch.int64)
        if descending:
            key = ~key
        bucket = torch.full((n,), 2, dtype=torch.uint8, device=data.device)
        null_key = INT64_MIN
    if validity is not None:
        bucket = torch.where(validity, bucket,
                             0 if nulls_first else 4).to(torch.uint8)
        key = torch.where(validity, key, torch.full_like(key, null_key))
    return bucket, key


def order_keys(columns: Sequence[Tuple[torch.Tensor, Optional[torch.Tensor],
                                       DataType]],
               descending: Sequence[bool], nulls_first: Sequence[bool]
               ) -> Tuple[torch.Tensor, ...]:
    """Flattened (bucket, key) operand list for lexsort_indices."""
    out = []
    for (d, v, t), desc, nf in zip(columns, descending, nulls_first):
        bucket, key = order_key(d, v, t, desc, nf)
        out.append(bucket)
        out.append(key)
    return tuple(out)


def lexsort_indices(keys: Sequence[torch.Tensor],
                    valid_mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Stable lexicographic sort permutation (int64) over equal-length
    operands, the first the most significant.  Masked-out rows sort to
    the very end whatever their keys."""
    ops = list(keys)
    n = ops[0].shape[0]
    if valid_mask is not None:
        # (masked, first operand) as one operand; every operand but a
        # bucket is wider than 3 bits, so fold only a uint8 bucket
        head = (~valid_mask).to(torch.int32)
        if ops[0].dtype == torch.uint8:
            ops[0] = head * 256 + ops[0].to(torch.int32)
        else:
            ops.insert(0, head)
    perm = torch.arange(n, dtype=torch.int64, device=ops[0].device)
    for k in reversed(ops):
        if k.dtype in (torch.uint8, torch.bool):
            k = k.to(torch.int32)
        _, order = torch.sort(k.index_select(0, perm), stable=True)
        perm = perm.index_select(0, order)
    return perm


def null_aware_eq(a_data: torch.Tensor, a_valid: Optional[torch.Tensor],
                  b_data: torch.Tensor, b_valid: Optional[torch.Tensor],
                  nan_equal: bool = True) -> torch.Tensor:
    """SQL <=> / grouping equality: null == null, NaN == NaN."""
    eq = a_data == b_data
    if a_data.dtype.is_floating_point and nan_equal:
        eq = eq | (torch.isnan(a_data) & torch.isnan(b_data))
    av = torch.ones_like(eq) if a_valid is None else a_valid
    bv = torch.ones_like(eq) if b_valid is None else b_valid
    return torch.where(av & bv, eq, av == bv)


def rows_differ_from_prev(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Boundary mask over sorted rows: True where row i differs from row
    i-1 on any key; row 0 is always a boundary."""
    n = keys[0].shape[0]
    diff = torch.zeros(n, dtype=torch.bool, device=keys[0].device)
    if n:
        diff[0] = True
    for k in keys:
        diff[1:] |= k[1:] != k[:-1]
    return diff
