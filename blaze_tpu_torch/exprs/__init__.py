"""Expressions of the PyTorch port: column, literal, the binary
comparisons, AND/OR and arithmetic over fixed-width types, and the
conditional expressions (null tests, NOT, IF, CASE WHEN, COALESCE,
IN-list) and Cast/TryCast; utf8 columns and literals evaluate on the
host, where `==`, `!=` and IN compare them and string casts parse or
format them."""

from blaze_tpu_torch.exprs.base import (BoundReference, ColVal, Literal,
                                        PhysicalExpr)
from blaze_tpu_torch.exprs.binary import BinaryExpr
from blaze_tpu_torch.exprs.cast import Cast, TryCast
from blaze_tpu_torch.exprs.conditional import (CaseWhen, Coalesce, If,
                                               InList, IsNotNull, IsNull,
                                               Not)

__all__ = ["BinaryExpr", "BoundReference", "CaseWhen", "Cast", "Coalesce",
           "ColVal", "If", "InList", "IsNotNull", "IsNull", "Literal", "Not",
           "PhysicalExpr", "TryCast"]
