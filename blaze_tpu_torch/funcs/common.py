"""Helpers shared by the scalar functions (port of
blaze_tpu/funcs/common.py): arguments on the host, per-row values, a
constant argument, and arguments on the batch's device."""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch.exprs.base import ColVal


def host(args, batch) -> List[pa.Array]:
    return [a.to_host(batch.num_rows) for a in args]


def per_row(arr: pa.Array) -> List[Any]:
    """Per-row Python values of an argument, literal or column."""
    return arr.to_pylist()


def const_arg(val: ColVal, batch, fname: str,
              arr: Optional[pa.Array] = None) -> Optional[Any]:
    """The value of an argument that must be constant over the batch.

    A Literal's value is marked `literal` and read from row 0.  A column
    whose rows are all equal (a plan that projected a literal early) is
    accepted; a column that varies raises NotImplementedError instead of
    applying row 0's value to every row."""
    if arr is None:
        arr = val.to_host(batch.num_rows)
    if val.literal or len(arr) == 0:
        return arr[0].as_py() if len(arr) and arr[0].is_valid else None
    if arr.null_count == len(arr):
        return None
    if arr.null_count == 0 and pc.count_distinct(arr).as_py() <= 1:
        return arr[0].as_py()
    raise NotImplementedError(
        f"{fname}: non-literal (column-valued) argument is not supported")


def dev(args, batch) -> List[ColVal]:
    """Every argument in the device form, on the batch's device."""
    return [a.to_device(batch.capacity, batch.device) for a in args]


def selected_mask(batch, n: Optional[int] = None) -> np.ndarray:
    """Host bool mask over the first `n` rows (default num_rows): True
    where a row survives the batch's selection (a raise must skip rows a
    filter deselected)."""
    n = batch.num_rows if n is None else n
    if batch.selection is None:
        return np.ones(n, dtype=bool)
    return batch.row_mask()[:n].cpu().numpy()
