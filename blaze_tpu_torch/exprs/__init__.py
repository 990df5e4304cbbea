"""Expressions of the PyTorch port: column, literal, the binary
operators, the conditional expressions (null tests, NOT, IF, CASE WHEN,
COALESCE, IN-list), Cast/TryCast, the string predicates (LIKE, RLIKE,
starts/ends with, contains), Spark's special expressions (ids, rand,
nested access, named_struct, scalar subqueries, the bloom-filter probe),
the eager evaluator with its per-batch cache (evaluator.py), constant
folding (fold.py) and the fused expression programs (program.py).  Fixed-width values
evaluate as torch ops on the batch's device; variable-width values stay
Arrow arrays on the host.  The scalar functions are in
`blaze_tpu_torch.funcs`."""

from blaze_tpu_torch.exprs.base import (BoundReference, ColVal, Literal,
                                        PhysicalExpr)
from blaze_tpu_torch.exprs.binary import BinaryExpr
from blaze_tpu_torch.exprs.cast import Cast, TryCast
from blaze_tpu_torch.exprs.conditional import (CaseWhen, Coalesce, If,
                                               InList, IsNotNull, IsNull,
                                               Not)
from blaze_tpu_torch.exprs.evaluator import (CachedExprsEvaluator,
                                             split_conjuncts)
from blaze_tpu_torch.exprs.fold import fold_constants, fold_node
from blaze_tpu_torch.exprs.program import (FusedExprsEvaluator,
                                           fused_filter, is_traceable)
from blaze_tpu_torch.exprs.special import (BloomFilterMightContain,
                                           GetIndexedField, GetMapValue,
                                           MonotonicallyIncreasingId,
                                           NamedStruct, Rand, RowNum,
                                           ScalarSubqueryWrapper,
                                           SparkPartitionId)
from blaze_tpu_torch.exprs.strings import Like, RLike, StringPredicate

__all__ = ["BinaryExpr", "BloomFilterMightContain", "BoundReference",
           "CachedExprsEvaluator", "CaseWhen", "Cast", "Coalesce", "ColVal",
           "FusedExprsEvaluator", "GetIndexedField", "GetMapValue", "If",
           "InList", "IsNotNull", "IsNull", "Like", "Literal",
           "MonotonicallyIncreasingId", "NamedStruct", "Not",
           "PhysicalExpr", "RLike", "Rand", "RowNum",
           "ScalarSubqueryWrapper", "SparkPartitionId", "StringPredicate",
           "TryCast", "fold_constants", "fold_node", "fused_filter",
           "is_traceable", "split_conjuncts"]
