"""State handed across between the JAX package and the port as numpy.

For a query engine the state is the data and the aggregation table.  The
tests start both packages from the same arrays: a `HashAggCarry` as a dict
of numpy leaves (the JAX carry's fields after `np.asarray`), a
`ColumnBatch` as its columns' (data, validity) arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from blaze_tpu_torch.batch import (ColumnBatch, DeviceColumn, to_device,
                                   to_host)
from blaze_tpu_torch.parallel.stage import HashAggCarry
from blaze_tpu_torch.schema import Schema

#: the carry's leaves that both packages hold (the port's `limbs` is
#: derived from `keys` and `key_valid`)
CARRY_FIELDS = ("keys", "key_valid", "accs", "acc_valid", "used")


def carry_from_numpy(leaves: Dict[str, object],
                     device: torch.device) -> HashAggCarry:
    """{"keys": [..], "key_valid": [..], "accs": [..], "acc_valid": [..],
    "used": array} of numpy arrays -> the port's carry (copies).  The
    carry's key-limb table, which the JAX carry does not hold, is encoded
    from the stored keys (zero where a slot is unused)."""
    from blaze_tpu_torch.kernels.hash_update import encode_limbs

    def dev(a):
        return to_device(np.asarray(a), device)
    keys = tuple(dev(a) for a in leaves["keys"])
    key_valid = tuple(dev(a) for a in leaves["key_valid"])
    used = dev(leaves["used"])
    limbs = encode_limbs(list(zip(keys, key_valid)))
    return HashAggCarry(keys, key_valid,
                        tuple(dev(a) for a in leaves["accs"]),
                        tuple(dev(a) for a in leaves["acc_valid"]),
                        used, limbs * used.to(torch.int32))


def carry_to_numpy(carry: HashAggCarry) -> Dict[str, object]:
    """The inverse of `carry_from_numpy`."""
    return {"keys": [to_host(a) for a in carry.keys],
            "key_valid": [to_host(a) for a in carry.key_valid],
            "accs": [to_host(a) for a in carry.accs],
            "acc_valid": [to_host(a) for a in carry.acc_valid],
            "used": to_host(carry.used)}


def batch_from_numpy(schema: Schema,
                     columns: Sequence[Tuple[np.ndarray, np.ndarray]],
                     num_rows: int, device: torch.device,
                     selection: Optional[np.ndarray] = None
                     ) -> ColumnBatch:
    """Fixed-width columns given as padded (data, validity) arrays of one
    capacity -> a ColumnBatch on `device`."""
    cols = [DeviceColumn(f.data_type, to_device(np.asarray(d), device),
                         to_device(np.asarray(v, dtype=bool), device))
            for f, (d, v) in zip(schema, columns)]
    sel = (to_device(np.asarray(selection, dtype=bool), device)
           if selection is not None else None)
    return ColumnBatch(schema, cols, num_rows, sel)


def batch_to_numpy(batch: ColumnBatch) -> Dict[str, object]:
    """{"columns": [(data, validity)], "num_rows", "selection"} with the
    padded device buffers copied to the host."""
    cols: List[Tuple[np.ndarray, np.ndarray]] = [
        (to_host(c.data), to_host(c.validity)) for c in batch.columns]
    return {"columns": cols, "num_rows": batch.num_rows,
            "selection": (to_host(batch.selection)
                          if batch.selection is not None else None)}
