"""Conversion strategy: per-node convertibility tagging + island removal
(the PyTorch port's copy of blaze_tpu/convert/strategy.py, over the port's
converter; the same tags and reasons).

Parity: AuronConvertStrategy (AuronConvertStrategy.scala:49 `apply` tags
every plan node with convertibleTag/convertStrategyTag/
neverConvertReasonTag before AuronConverters rewrites the tree, and
`removeInefficientConverts` (:205) un-converts native islands whose
row<->columnar boundary cost exceeds their benefit).

The executable path (`convert_spark_plan`) still requires a fully
convertible tree — this engine has no Spark to hand the remainder back
to.  What this module provides is the decision layer in front of it:
which subtrees WOULD convert, why the others won't (the neverConvertReason
surfaced in the reference's UI fallback tab), and which convertible nodes
should stay un-converted because they'd be isolated islands.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from blaze_tpu_torch.convert.spark import (ConversionError, _cls,
                                           _convert_node, _tree)


@dataclass
class NodeTag:
    """convertibleTag + neverConvertReasonTag for one plan node."""

    node_class: str
    convertible: bool
    reason: str = ""                      # neverConvertReason
    children: List["NodeTag"] = field(default_factory=list)

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


# nodes that are pure plumbing — never counted as islands and never
# demoted (the reference's AlwaysConvert set: scans and exchanges keep
# their native form regardless of neighbors)
_ALWAYS_CONVERT = {
    "FileSourceScanExec", "ShuffleExchangeExec", "BroadcastExchangeExec",
}
_TRANSPARENT = {
    "InputAdapter", "WholeStageCodegenExec", "AQEShuffleReadExec",
    "ShuffleQueryStageExec", "ColumnarToRowExec", "RowToColumnarExec",
    "AdaptiveSparkPlanExec",
}


def tag_plan(plan_json, num_partitions: int = 1) -> NodeTag:
    """AuronConvertStrategy.apply: bottom-up per-node convertibility.

    A node whose child subtree fails is still tagged on ITS OWN merits
    when the child exposes output attributes: the child is substituted
    with a synthetic scan over those attributes (the ConvertToNative
    boundary the reference inserts at non-native leaves).  Children
    without discoverable output fall back to whole-subtree testing."""
    root = _tree(plan_json)
    return _tag(root, num_partitions)


def _placeholder_for(node: dict) -> Optional[dict]:
    """A convertible stand-in exposing the same output attributes."""
    out = node.get("output")
    if not out:
        return None
    ph = {"class": "org.apache.spark.sql.execution.FileSourceScanExec",
          "num-children": 0, "output": out,
          "files": [["placeholder://convert-to-native"]],
          "__children": []}
    return ph


def _tag(node: dict, parts: int) -> NodeTag:
    c = _cls(node)
    children = node["__children"]
    child_tags = [_tag(ch, parts) for ch in children]
    # test THIS node with children replaced by placeholders wherever the
    # child's output attrs are known — islands become visible AND each
    # per-node test stops re-converting whole subtrees (without this,
    # tagging is O(n^2) in plan size)
    test_node = node
    subs = []
    changed = False
    for ch, t in zip(children, child_tags):
        ph = _placeholder_for(ch)
        if ph is not None:
            subs.append(ph)
            changed = True
        elif t.convertible:
            subs.append(ch)
        else:
            return NodeTag(c, False,
                           f"child not convertible: {t.reason}",
                           child_tags)
    if changed:
        test_node = dict(node)
        test_node["__children"] = subs
    try:
        _convert_node(test_node, parts, [])
        ok, reason = True, ""
    except ConversionError as e:
        ok, reason = False, f"{e.node_class}: {e.reason}"
    except Exception as e:  # malformed JSON etc.
        ok, reason = False, f"{c}: {e}"
    return NodeTag(c, ok, reason, child_tags)


def remove_inefficient_converts(tag: NodeTag,
                                parent_convertible: Optional[bool] = None
                                ) -> NodeTag:
    """removeInefficientConverts (AuronConvertStrategy.scala:205): a
    convertible node surrounded by unconvertible neighbors is an island —
    each boundary pays a row<->columnar transition, so isolated islands
    convert at a loss and are demoted (unless always-convert)."""
    out = tag
    if tag.convertible and tag.node_class not in _ALWAYS_CONVERT \
            and tag.node_class not in _TRANSPARENT:
        parent_native = bool(parent_convertible)
        children_native = any(c.convertible for c in tag.children)
        has_children = bool(tag.children)
        if not parent_native and has_children and not children_native:
            out = NodeTag(tag.node_class, False,
                          "inefficient isolated conversion "
                          "(removeInefficientConverts)", tag.children)
    # rebuild rather than mutating the caller's tree in place — this
    # function returns new nodes, so it must be pure all the way down
    return NodeTag(out.node_class, out.convertible, out.reason,
                   [remove_inefficient_converts(c, out.convertible)
                    for c in out.children])


def explain(tag: NodeTag) -> str:
    """The fallback report (what the reference's Auron UI tab shows)."""
    lines = []

    def rec(t: NodeTag, depth: int):
        mark = "native" if t.convertible else f"FALLBACK [{t.reason}]"
        lines.append("  " * depth + f"{t.node_class}: {mark}")
        for ch in t.children:
            rec(ch, depth + 1)

    rec(tag, 0)
    return "\n".join(lines)
