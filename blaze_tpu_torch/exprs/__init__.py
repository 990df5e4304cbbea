"""Expressions of the PyTorch port (this slice: column, literal, the
comparisons and AND)."""

from blaze_tpu_torch.exprs.base import (BoundReference, ColVal, Literal,
                                        PhysicalExpr)
from blaze_tpu_torch.exprs.binary import BinaryExpr

__all__ = ["BinaryExpr", "BoundReference", "ColVal", "Literal",
           "PhysicalExpr"]
