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
adds each segment's rows sequentially (from +0.0, or into a carry), and
`torch.cumsum` along a row is sequential from +0.0, as the JAX package's
CPU sums are.  On the card `index_add_` adds with atomics in a
run-dependent order and `torch.cumsum` in a tree, so every float sum of a
CUDA tensor goes to the hand kernel csrc/segment_sum.cu, in one of three
forms: `segment_sum` (per segment, from +0.0), `segment_sum_into` (per
slot, into a carry: the hash lane's accumulators) and
`segmented_running_sum` (every prefix of each run: the window's running
sums).  Each keeps one chain of adds per segment in row order, which gives
the CPU's bits.  Integer sums stay on `index_add_` and `torch.cumsum`,
exact in any order.  There is no fallback: a CUDA float tensor the kernel
does not take (float16, bfloat16) raises.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import threading

import numpy as np
import torch

from blaze_tpu_torch.kernels import compare, lane
from blaze_tpu_torch.schema import DataType

#: segments of at most this many rows are summed by one thread of
#: csrc/segment_sum.cu; a longer one gets a block of its own.  Chosen from
#: `chip_smoke.py --short-max-sweep` (PERF.md §6): below 64, partitions of
#: 64 rows take the block path and run 1.6-2x slower; 64 and 128 lie
#: within each other's spread.  The sums are the same bits at any value
SHORT_MAX = 64

_FORMS = {"sum": 0, "into": 1, "running": 2}
#: launches of csrc/segment_sum.cu (two kernels each), by form: one per
#: call of `segment_sum` ("sum"), `segment_sum_into` ("into") and
#: `segmented_running_sum` ("running") on a CUDA float tensor with rows;
#: a call captured into a CUDA graph counts in `captured_launches`
#: instead, and each replay of the graph adds its nodes here
#: (`add_replayed`, runtime/loop.py)
form_launches = dict.fromkeys(_FORMS, 0)
#: launches recorded into CUDA graphs while they were captured, by form
captured_launches = dict.fromkeys(_FORMS, 0)
#: the counts' lock: query threads of the query service launch at once
_count_lock = threading.Lock()


def add_replayed(nodes: dict) -> None:
    """Count the launches of one graph replay holding `nodes` captured
    launches by form."""
    with _count_lock:
        for form, count in nodes.items():
            form_launches[form] += count


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
    floats add in row order.  `contiguous` says each segment's rows are
    one run of consecutive rows, with no row of another id, in range or
    not, among them (the generic engine's, after its lexsort or, with no
    keys, its sort of the masked rows to the end); the card's kernel then
    takes them where they lie, else it sorts the ids stably first.  The
    card cannot check the claim: a segment that comes in two runs gets
    one run's sum."""
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


def segment_sum_into(acc: torch.Tensor, values: torch.Tensor,
                     gids: torch.Tensor,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float sums into a carry, in place: acc[s] = ((acc[s] + x1) + x2)
    + ... over the rows whose id is s, in row order, x a row's value or
    +0.0 where `valid` is False.  A row whose id is outside [0, S) adds
    nowhere; a slot with no rows keeps its bits.  Returns `acc`."""
    if not acc.dtype.is_floating_point:
        raise TypeError(f"segment_sum_into: {acc.dtype} is not a float")
    if lane.route(acc) == "cuda":
        return _segment_sum_into_cuda(acc, values, gids, valid)
    return segment_sum_into_plain(acc, values, gids, valid)


def segment_sum_into_plain(acc, values, gids, valid=None):
    """`segment_sum_into` as one `index_add_` (row order on the CPU): a
    row out of range adds -0.0, which changes no bit, to slot 0."""
    S = acc.shape[0]
    live = (gids >= 0) & (gids < S)
    x = values.to(acc.dtype)
    if valid is not None:
        x = torch.where(valid, x, torch.zeros_like(x))
    x = torch.where(live, x, torch.full_like(x, -0.0))
    return acc.index_add_(0, torch.where(live, gids.long(), 0), x)


def segmented_running_sum(values: torch.Tensor,
                          seg_ids: torch.Tensor) -> torch.Tensor:
    """For every row, the float sum from +0.0 of its run's values up to
    and including it, in row order.  A run is a maximal stretch of equal
    `seg_ids` (the window passes each row's partition start)."""
    if not values.dtype.is_floating_point:
        raise TypeError(f"segmented_running_sum: {values.dtype} is not a "
                        f"float")
    if lane.route(values) == "cuda":
        return _running_sum_cuda(values, seg_ids)
    return segmented_running_sum_plain(values, seg_ids)


def segmented_running_sum_plain(values: torch.Tensor,
                                seg_ids: torch.Tensor) -> torch.Tensor:
    """`segmented_running_sum` by rows of a matrix: the runs, grouped by
    the power of two above their length, are laid out as the rows of one
    zero-padded (runs x (longest + 1)) matrix per group, each row led by
    a +0.0, and summed along the rows: `torch.cumsum(dim=1)` for float64
    (sequential from +0.0 on the CPU, where its accumulator is a double),
    numpy's `add.accumulate` on the host for float32 (sequential in
    float32; the CPU's float32 cumsum accumulates in double).  The
    padding trails every run, so it never enters a prefix; the matrices
    hold at most about twice the rows."""
    n = values.shape[0]
    out = torch.empty_like(values)
    if n == 0:
        return out
    dev = values.device
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = seg_ids[1:] != seg_ids[:-1]
    starts = torch.nonzero(head).squeeze(1)
    lens = torch.diff(starts, append=torch.tensor([n], device=dev))
    run = torch.cumsum(head.to(torch.int64), 0) - 1
    pos = torch.arange(n, device=dev) - starts[run] + 1
    group = torch.ceil(torch.log2(lens.to(torch.float64))).to(torch.int64)
    # the runs and the rows of each group, as slices of two sorts
    run_order = torch.sort(group, stable=True).indices
    row_order = torch.sort(group[run], stable=True).indices
    runs_in = torch.bincount(group).tolist()
    rows_in = torch.bincount(group, weights=lens.to(torch.float64)).tolist()
    slot = torch.empty_like(lens)
    r0 = w0 = 0
    for n_runs, n_rows in zip(runs_in, rows_in):
        if not n_runs:
            continue
        runs = run_order[r0:r0 + n_runs]
        rows = row_order[w0:w0 + int(n_rows)]
        r0, w0 = r0 + n_runs, w0 + int(n_rows)
        width = int(lens[runs].max()) + 1
        slot[runs] = torch.arange(n_runs, device=dev)
        cell = slot[run[rows]] * width + pos[rows]
        m = torch.zeros(n_runs * width, dtype=values.dtype, device=dev)
        m.index_copy_(0, cell, values.index_select(0, rows))
        m = m.view(n_runs, width)
        if values.dtype == torch.float64:
            m = torch.cumsum(m, 1)
        else:
            m = torch.from_numpy(np.add.accumulate(m.cpu().numpy(),
                                                   axis=1)).to(dev)
        out.index_copy_(0, rows, m.reshape(-1).index_select(0, cell))
    return out


def _check_float(what, values):
    if values.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: no row-order kernel for {values.dtype} "
                        f"on the card")


def _check_rows(what, values, ids, valid):
    if values.dim() != 1 or ids.shape != values.shape or (
            valid is not None and valid.shape != values.shape):
        raise ValueError(f"{what}: values {tuple(values.shape)}, ids "
                         f"{tuple(ids.shape)} and valid must be equal 1-D")
    if values.shape[0] >= 1 << 31:
        raise ValueError(f"{what}: {values.shape[0]} rows; the kernel "
                         f"takes fewer than 2^31")
    for t in (ids, valid):
        if t is not None and t.device != values.device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{values.device}")


def _grouped(gids: torch.Tensor):
    """Ids sorted stably and the sorted positions' rows: each slot's rows
    become one run in row order; out-of-range ids (negative, or S and
    above) sort to the ends, where the kernel skips them."""
    return torch.sort(_ids(gids), stable=True)


def _ids(t: torch.Tensor) -> torch.Tensor:
    if t.dtype not in (torch.int32, torch.int64):
        t = t.to(torch.int64)
    return t.contiguous()


def _launch(form, ids, order, values, valid, out, S):
    """One call of csrc/segment_sum.cu on the current stream."""
    from blaze_tpu_torch.kernels import build
    n = values.shape[0]
    scratch = torch.empty(2 + n // (SHORT_MAX + 1), dtype=torch.int32,
                          device=values.device)
    rc = build.bound("segment_sum", "blaze_segment_sum")(
        _FORMS[form], ids.data_ptr(), int(ids.dtype == torch.int64),
        None if order is None else order.data_ptr(), values.data_ptr(),
        None if valid is None else valid.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), n, S, SHORT_MAX,
        int(values.dtype == torch.float64), build.stream_of(values.device))
    build.check(rc, f"segment_sum kernel ({form})")
    with _count_lock:
        if torch.cuda.is_current_stream_capturing():
            captured_launches[form] += 1
        else:
            form_launches[form] += 1


def _valid_bytes(valid):
    return None if valid is None else valid.to(torch.bool).contiguous()


def _segment_sum_cuda(values, gids, num_segments, valid, contiguous):
    """Form 0 of csrc/segment_sum.cu: float32/float64 sums from +0.0 in
    row order."""
    _check_float("segment_sum", values)
    _check_rows("segment_sum", values, gids, valid)
    n = values.shape[0]
    if n == 0 or num_segments == 0:
        return torch.zeros(num_segments, dtype=values.dtype,
                           device=values.device)
    if contiguous:
        ids, order = _ids(gids), None
    else:
        ids, order = _grouped(gids)
    out = torch.empty(num_segments, dtype=values.dtype, device=values.device)
    _launch("sum", ids, order, values.contiguous(), _valid_bytes(valid), out,
            num_segments)
    return out


def _segment_sum_into_cuda(acc, values, gids, valid):
    """Form 1 of csrc/segment_sum.cu: into the carry `acc`, in place.
    Capturable: a stable sort and one kernel call, no host sync."""
    _check_float("segment_sum_into", acc)
    _check_rows("segment_sum_into", values, gids, valid)
    if acc.dim() != 1 or not acc.is_contiguous() or \
            values.dtype != acc.dtype or acc.device != values.device:
        raise ValueError(f"segment_sum_into: the carry must be a contiguous "
                         f"1-D {values.dtype} on {values.device}")
    if values.shape[0] == 0:
        return acc
    ids, order = _grouped(gids)
    _launch("into", ids, order, values.contiguous(), _valid_bytes(valid),
            acc, acc.shape[0])
    return acc


def _running_sum_cuda(values, seg_ids):
    """Form 2 of csrc/segment_sum.cu: every prefix of each run."""
    _check_float("segmented_running_sum", values)
    _check_rows("segmented_running_sum", values, seg_ids, None)
    out = torch.empty_like(values, memory_format=torch.contiguous_format)
    if values.shape[0]:
        _launch("running", _ids(seg_ids), None, values.contiguous(), None,
                out, 1)
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
