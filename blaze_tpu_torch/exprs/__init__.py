"""Expressions of the PyTorch port: column, literal, and the binary
comparisons, AND/OR and arithmetic over fixed-width types; utf8 columns
and literals evaluate on the host, where `==` and `!=` compare them."""

from blaze_tpu_torch.exprs.base import (BoundReference, ColVal, Literal,
                                        PhysicalExpr)
from blaze_tpu_torch.exprs.binary import BinaryExpr

__all__ = ["BinaryExpr", "BoundReference", "ColVal", "Literal",
           "PhysicalExpr"]
