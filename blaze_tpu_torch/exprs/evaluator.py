"""The eager expression evaluator with a per-batch cache of common
subexpressions (port of blaze_tpu/exprs/evaluator.py).

Filter and project share one evaluator, so an expression that appears
twice (a projection repeated, a filter conjunct projected again) is
evaluated once per batch: the cache is keyed by `cache_key`, at the level
of each whole filter or projection, as in the JAX package.  A filter's
AND tree is always split into its conjuncts, and each conjunct narrows
the selection before the next one runs (the masks are ANDed into the
selection; nothing compacts, so the bits equal one AND of the whole
tree's mask: the JAX package's `auron.forceShortCircuitAndOr` is not
carried over).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs.base import ColVal, PhysicalExpr
from blaze_tpu_torch.exprs.binary import BinaryExpr


def split_conjuncts(pred: PhysicalExpr) -> List[PhysicalExpr]:
    if isinstance(pred, BinaryExpr) and pred.op == "and":
        return split_conjuncts(pred.left) + split_conjuncts(pred.right)
    return [pred]


class CachedExprsEvaluator:
    """Evaluates filters, then projections, with per-batch memoization."""

    def __init__(self, filters: Sequence[PhysicalExpr] = (),
                 projections: Sequence[PhysicalExpr] = ()):
        self.filters: List[PhysicalExpr] = []
        for f in filters:
            self.filters.extend(split_conjuncts(f))
        self.projections = list(projections)
        self._cache: Dict[object, ColVal] = {}

    def _eval(self, expr: PhysicalExpr, batch: ColumnBatch) -> ColVal:
        key = expr.cache_key()
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = expr.evaluate(batch)
        return hit

    def filter(self, batch: ColumnBatch) -> ColumnBatch:
        """AND every conjunct's mask (NULL counts as False) into the
        selection, one conjunct after another."""
        self._cache.clear()
        out = batch
        for f in self.filters:
            out = out.with_selection(self._eval(f, out).as_mask(out))
        return out

    def project(self, batch: ColumnBatch, out_schema,
                reuse_cache: bool = False) -> ColumnBatch:
        # the cache is per batch: its keys do not name the batch, so a
        # stale entry would replay an earlier batch's columns
        if not reuse_cache:
            self._cache.clear()
        cap, dev = batch.capacity, batch.device
        cols = [self._eval(e, batch).to_column(cap, dev)
                for e in self.projections]
        return ColumnBatch(out_schema, cols, batch.num_rows, batch.selection)

    def filter_project(self, batch: ColumnBatch, out_schema) -> ColumnBatch:
        out = self.project(self.filter(batch), out_schema, reuse_cache=True)
        self._cache.clear()
        return out
