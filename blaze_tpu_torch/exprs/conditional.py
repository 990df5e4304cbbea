"""Null tests, NOT, IF, CASE WHEN, COALESCE and IN-list (port of
blaze_tpu/exprs/conditional.py).

Fixed-width values evaluate in the device form, as torch ops on the
batch's device; utf8 values stay Arrow on the host, as in the JAX
package.  SQL null semantics throughout:

  * IS NULL / IS NOT NULL are never null (a padding row reads as null;
    callers mask rows);
  * NOT NULL is NULL; IF and CASE WHEN treat a null condition as false;
    a CASE row that no branch takes and that has no ELSE is NULL;
  * `x IN (...)`: a match is TRUE; no match is NULL when a member is
    null (the null could have matched), else FALSE; a null probe stays
    NULL; NOT IN negates the value and keeps the validity.

A dictionary-encoded probe (the JAX package's `DictColumn` code lane)
raises: the port has no dictionary column yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import torch

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.schema import BOOL, DataType


def _all_valid(like: torch.Tensor) -> torch.Tensor:
    return torch.ones(like.shape[0], dtype=torch.bool, device=like.device)


@dataclass(frozen=True, repr=False)
class IsNull(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        v = self.child.evaluate(batch)
        if v.is_device:
            return ColVal(BOOL, ~v.validity, _all_valid(v.validity))
        return ColVal(BOOL, array=pc.is_null(v.to_host(batch.num_rows)))


@dataclass(frozen=True, repr=False)
class IsNotNull(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        v = self.child.evaluate(batch)
        if v.is_device:
            return ColVal(BOOL, v.validity.clone(), _all_valid(v.validity))
        return ColVal(BOOL, array=pc.is_valid(v.to_host(batch.num_rows)))


@dataclass(frozen=True, repr=False)
class Not(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        v = self.child.evaluate(batch)
        if v.is_device:
            return ColVal(BOOL, ~v.data.to(torch.bool) & v.validity,
                          v.validity)
        return ColVal(BOOL, array=pc.invert(v.to_host(batch.num_rows)))


@dataclass(frozen=True, repr=False)
class CaseWhen(PhysicalExpr):
    """CASE WHEN p1 THEN v1 ... ELSE e END: the first branch whose
    predicate is true (null counts as false) gives the row's value."""

    branches: Tuple[Tuple[PhysicalExpr, PhysicalExpr], ...]
    otherwise: Optional[PhysicalExpr] = None

    def children(self):
        cs = [e for pair in self.branches for e in pair]
        if self.otherwise is not None:
            cs.append(self.otherwise)
        return tuple(cs)

    def data_type(self, schema):
        return self.branches[0][1].data_type(schema)

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        dtype = self.data_type(batch.schema)
        if not dtype.is_fixed_width:
            return self._evaluate_host(batch, dtype)
        cap, dev, dt = batch.capacity, batch.device, dtype.torch_dtype()
        if self.otherwise is not None:
            acc = self.otherwise.evaluate(batch).to_device(cap)
            data, valid = acc.data.to(dt), acc.validity
        else:
            data = torch.zeros(cap, dtype=dt, device=dev)
            valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        taken = torch.zeros(cap, dtype=torch.bool, device=dev)
        for pred_e, val_e in self.branches:
            hit = pred_e.evaluate(batch).as_mask(batch) & ~taken
            val = val_e.evaluate(batch).to_device(cap)
            data = torch.where(hit, val.data.to(dt), data)
            valid = torch.where(hit, val.validity, valid)
            taken = taken | hit
        return ColVal(dtype, data, valid)

    def _evaluate_host(self, batch: ColumnBatch, dtype: DataType) -> ColVal:
        """Each row takes its value from the chosen branch's array (or the
        ELSE, or null): one gather over the candidates laid end to end."""
        n = batch.num_rows
        k = len(self.branches)
        chosen = np.full(n, k, dtype=np.int64)
        for bi, (pred_e, _) in enumerate(self.branches):
            mask = pred_e.evaluate(batch).as_mask(batch)[:n].cpu().numpy()
            chosen = np.where((chosen == k) & mask, bi, chosen)
        at = dtype.to_arrow()
        cands = [e.evaluate(batch).to_host(n).cast(at)
                 for _, e in self.branches]
        cands.append(self.otherwise.evaluate(batch).to_host(n).cast(at)
                     if self.otherwise is not None else pa.nulls(n, at))
        flat = pa.concat_arrays(cands)
        return ColVal(dtype, array=flat.take(
            pa.array(chosen * n + np.arange(n, dtype=np.int64))))


@dataclass(frozen=True, repr=False)
class If(PhysicalExpr):
    """IF(cond, then, else): a null condition takes ELSE (Spark If)."""

    cond: PhysicalExpr
    then: PhysicalExpr
    otherwise: PhysicalExpr

    def children(self):
        return (self.cond, self.then, self.otherwise)

    def data_type(self, schema):
        return self.then.data_type(schema)

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        return CaseWhen(((self.cond, self.then),),
                        self.otherwise).evaluate(batch)


@dataclass(frozen=True, repr=False)
class Coalesce(PhysicalExpr):
    """The first non-null argument of each row."""

    args: Tuple[PhysicalExpr, ...]

    def children(self):
        return self.args

    def data_type(self, schema):
        return self.args[0].data_type(schema)

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        dtype = self.data_type(batch.schema)
        if not dtype.is_fixed_width:
            n = batch.num_rows
            out = self.args[0].evaluate(batch).to_host(n)
            for e in self.args[1:]:
                out = pc.coalesce(out, e.evaluate(batch).to_host(n))
            return ColVal(dtype, array=out)
        cap, dt = batch.capacity, dtype.torch_dtype()
        acc = self.args[0].evaluate(batch).to_device(cap)
        data, valid = acc.data.to(dt), acc.validity
        for e in self.args[1:]:
            v = e.evaluate(batch).to_device(cap)
            data = torch.where(~valid & v.validity, v.data.to(dt), data)
            valid = valid | v.validity
        return ColVal(dtype, data, valid)


@dataclass(frozen=True, repr=False)
class InList(PhysicalExpr):
    """`child IN (values...)` with SQL null semantics (proto
    PhysicalInListNode): device lane for a fixed-width probe, Arrow's
    `is_in` for a host utf8 probe."""

    child: PhysicalExpr
    values: Tuple[object, ...]
    negated: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL

    def evaluate(self, batch: ColumnBatch) -> ColVal:
        v = self.child.evaluate(batch)
        has_null_member = any(x is None for x in self.values)
        members = [x for x in self.values if x is not None]
        if v.is_device:
            if members:
                hit = torch.isin(v.data, torch.tensor(
                    members, dtype=v.data.dtype, device=v.data.device))
            else:
                hit = torch.zeros_like(v.validity)
            valid = (v.validity & hit) if has_null_member else v.validity
            data = ~hit if self.negated else hit
            return ColVal(BOOL, data & valid, valid)
        arr = v.to_host(batch.num_rows)
        if pa.types.is_dictionary(arr.type):
            raise NotImplementedError(
                "IN over a dictionary-encoded probe rides the dictionary "
                "column's codes, which belong to the strings slice of the "
                "PyTorch port (ROADMAP Queue 1 item 13)")
        hit = pc.is_in(arr, value_set=pa.array(members, type=arr.type))
        if has_null_member:
            hit = pc.if_else(hit, hit, pa.nulls(len(arr), pa.bool_()))
        out = pc.invert(hit) if self.negated else hit
        out = pc.if_else(pc.is_valid(arr), out,
                         pa.nulls(len(arr), pa.bool_()))
        return ColVal(BOOL, array=out)
