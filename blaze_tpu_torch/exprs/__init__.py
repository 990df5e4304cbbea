"""Expressions of the PyTorch port: column, literal, and the binary
comparisons, AND/OR and arithmetic over fixed-width types."""

from blaze_tpu_torch.exprs.base import (BoundReference, ColVal, Literal,
                                        PhysicalExpr)
from blaze_tpu_torch.exprs.binary import BinaryExpr

__all__ = ["BinaryExpr", "BoundReference", "ColVal", "Literal",
           "PhysicalExpr"]
