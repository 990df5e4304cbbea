"""Metric tree mirroring the operator tree.

Copy of blaze_tpu/bridge/metrics.py.  Parity: auron-core MetricNode (ref: auron-core/.../metric/MetricNode.java:27 —
a tree of named counters the native side pushes into on finalize,
native-engine/auron/src/metrics.rs:22 update_metric_node) surfaced to Spark
SQLMetrics (SparkMetricNode.scala).  Operators own a MetricNode; the runtime
collects the tree after execution.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# Standard metric vocabulary every operator reports (the port of
# auron-core's baseline_metrics convention: each ExecutionPlan emits
# these regardless of operator-specific extras).  `elapsed_compute_ns`
# is INCLUSIVE of child pull time; renderers derive self-time as
# node - sum(children).
BASELINE_METRICS = (
    "output_rows",
    "output_batches",
    "elapsed_compute_ns",
    "spilled_bytes",
    "mem_used",
    "io_bytes",
)


@dataclass
class MetricNode:
    name: str = ""
    values: Dict[str, int] = field(default_factory=dict)
    children: List["MetricNode"] = field(default_factory=list)

    def add(self, metric: str, value: int = 1) -> None:
        self.values[metric] = self.values.get(metric, 0) + int(value)

    def set(self, metric: str, value: int) -> None:
        self.values[metric] = int(value)

    def set_max(self, metric: str, value: int) -> None:
        """Record a high-water mark (peak memory style)."""
        if int(value) > self.values.get(metric, 0):
            self.values[metric] = int(value)

    def get(self, metric: str) -> int:
        return self.values.get(metric, 0)

    def child(self, i: int, name: str = "") -> "MetricNode":
        while len(self.children) <= i:
            self.children.append(MetricNode())
        node = self.children[i]
        if name and not node.name:
            node.name = name
        return node

    @contextmanager
    def timer(self, metric: str):
        """Accumulate elapsed nanoseconds (ref common/timer_helper.rs)."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add(metric, time.perf_counter_ns() - t0)

    def to_dict(self) -> dict:
        return {"name": self.name, "values": dict(self.values),
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def from_dict(cls, d: dict) -> "MetricNode":
        return cls(name=d.get("name", ""),
                   values={k: int(v) for k, v in d.get("values", {}).items()},
                   children=[cls.from_dict(c) for c in d.get("children", ())])

    def merge_from(self, other: "MetricNode") -> None:
        """Accumulate another tree (per-partition trees merging into the
        query-level profile).  Child names propagate: merging used to
        produce unnamed operator nodes when `self` was a bare skeleton."""
        if other.name and not self.name:
            self.name = other.name
        for k, v in other.values.items():
            if k == "mem_used":
                self.set_max(k, v)  # peaks don't sum across partitions
            else:
                self.add(k, v)
        for i, c in enumerate(other.children):
            self.child(i, name=c.name).merge_from(c)

    def snapshot(self) -> "MetricNode":
        """Deep copy of the current counter state."""
        return MetricNode(name=self.name, values=dict(self.values),
                          children=[c.snapshot() for c in self.children])

    def diff(self, before: "MetricNode") -> "MetricNode":
        """Per-partition delta: current counters minus a snapshot()."""
        out = MetricNode(name=self.name)
        for k, v in self.values.items():
            d = v - before.values.get(k, 0)
            if d or k in self.values:
                out.values[k] = d
        for i, c in enumerate(self.children):
            prev = (before.children[i] if i < len(before.children)
                    else MetricNode())
            out.children.append(c.diff(prev))
        return out
