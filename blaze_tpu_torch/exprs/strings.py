"""String predicates and pattern matches on the host over Arrow arrays
(port of blaze_tpu/exprs/strings.py): `StringPredicate` (starts_with,
ends_with, contains with a literal needle), `Like` (SQL LIKE with % and
_, an escape character, optionally case-insensitive) and `RLike`
(Java-regex find() semantics).  Each returns host bools, which a filter
pads onto the device (`ColVal.as_mask`) and a projection uploads
(`ColVal.to_column`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import pyarrow as pa
import pyarrow.compute as pc

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.schema import BOOL


@dataclass(frozen=True, repr=False)
class StringPredicate(PhysicalExpr):
    """starts_with / ends_with / contains with a literal needle."""

    kind: str  # "starts_with" | "ends_with" | "contains"
    child: PhysicalExpr
    needle: str

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL


    def evaluate(self, batch: ColumnBatch) -> ColVal:
        arr = self.child.evaluate(batch).to_host(batch.num_rows)
        if self.kind == "starts_with":
            out = pc.starts_with(arr, pattern=self.needle)
        elif self.kind == "ends_with":
            out = pc.ends_with(arr, pattern=self.needle)
        else:
            out = pc.match_substring(arr, pattern=self.needle)
        return ColVal.host(BOOL, out)


def starts_with(child: PhysicalExpr, needle: str) -> StringPredicate:
    return StringPredicate("starts_with", child, needle)


def ends_with(child: PhysicalExpr, needle: str) -> StringPredicate:
    return StringPredicate("ends_with", child, needle)


def contains(child: PhysicalExpr, needle: str) -> StringPredicate:
    return StringPredicate("contains", child, needle)


def _like_to_regex(pattern: str, escape: str = "\\") -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


@dataclass(frozen=True, repr=False)
class Like(PhysicalExpr):
    """SQL LIKE with %/_ wildcards (Spark Like; proto LikeExprNode)."""

    child: PhysicalExpr
    pattern: str
    negated: bool = False
    case_insensitive: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL


    def evaluate(self, batch: ColumnBatch) -> ColVal:
        arr = self.child.evaluate(batch).to_host(batch.num_rows)
        regex = _like_to_regex(self.pattern)
        flags = re.DOTALL | (re.IGNORECASE if self.case_insensitive else 0)
        prog = re.compile(regex, flags)
        py = [None if not x.is_valid else bool(prog.match(x.as_py()))
              for x in arr]
        out = pa.array(py, type=pa.bool_())
        if self.negated:
            out = pc.invert(out)
        return ColVal.host(BOOL, out)


@dataclass(frozen=True, repr=False)
class RLike(PhysicalExpr):
    """Java-regex find() semantics (Spark RLike; ref spark_strings.rs)."""

    child: PhysicalExpr
    pattern: str
    case_insensitive: bool = False

    def children(self):
        return (self.child,)

    def data_type(self, schema):
        return BOOL


    def evaluate(self, batch: ColumnBatch) -> ColVal:
        arr = self.child.evaluate(batch).to_host(batch.num_rows)
        prog = re.compile(self.pattern,
                          re.IGNORECASE if self.case_insensitive else 0)
        py = [None if not x.is_valid else bool(prog.search(x.as_py()))
              for x in arr]
        return ColVal.host(BOOL, pa.array(py, type=pa.bool_()))
