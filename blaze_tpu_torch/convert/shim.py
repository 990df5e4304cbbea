"""PySpark-side shim: executed plan -> toJSON + file listing -> engine
(the PyTorch port's copy of blaze_tpu/convert/shim.py, pointed at the
port's converter, `DagScheduler` and bridge/resource.py).

Parity role: the thin end of the L7 Spark integration
(AuronSparkSessionExtension + NativeConverters feed the native engine a
serialized plan; here the serialization is the plan's own toJSON).  This
module is the piece that runs INSIDE a PySpark driver when one exists:

    from blaze_tpu_torch.convert.shim import execute_dataframe
    result_table = execute_dataframe(df)   # pyarrow.Table

It extracts `df.queryExecution.executedPlan.toJSON`, attaches the scan
file listings (HadoopFsRelation does not serialize — the one side channel
convert/spark.py documents), converts via the L6 converter, and executes
through the stage-DAG scheduler over the protobuf wire.

No JVM ships in this environment, so this module is exercised only when
pyspark is importable (tests skip otherwise); the converter itself is
covered by the checked-in toJSON fixtures either way.  The remaining L7
surface of the reference (AuronShuffleManager as a drop-in Spark shuffle
manager, the bytecode injectors, the UI tab) requires the Scala
extension, which is out of scope for a JVM-less build — see
docs/spark_integration.md for the deployment story.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional


def extract_plan_json(df) -> list:
    """`df._jdf.queryExecution().executedPlan().toJSON()` as parsed JSON,
    with per-scan file listings attached under the "files" key."""
    qe = df._jdf.queryExecution()
    plan = qe.executedPlan()
    nodes = json.loads(plan.toJSON())

    # collect the file listing of every FileSourceScanExec in tree order
    # (toJSON pre-order matches collectLeaves order for scans)
    listings = _scan_listings(plan)
    it = iter(listings)
    for node in nodes:
        if node.get("class", "").endswith("FileSourceScanExec"):
            try:
                node["files"] = next(it)
            except StopIteration:
                raise RuntimeError(
                    "scan count mismatch between toJSON and the plan")
    return nodes


def _scan_listings(plan) -> List[List[List[str]]]:
    """File groups per FileSourceScanExec, via selectedPartitions."""
    out = []
    stack = [plan]
    order = []
    while stack:
        p = stack.pop()
        order.append(p)
        children = p.children()
        for i in range(children.size() - 1, -1, -1):
            stack.append(children.apply(i))
    for p in order:
        if p.getClass().getSimpleName() == "FileSourceScanExec":
            files = []
            parts = p.selectedPartitions()
            for i in range(len(parts)):
                for f in parts[i].files():
                    files.append(f.getPath().toString()
                                 .replace("file:", ""))
            out.append([files])  # one group: the engine re-splits
    return out


def execute_dataframe(df, num_partitions: Optional[int] = None,
                      work_dir: Optional[str] = None,
                      udf_evaluators: Optional[dict] = None):
    """Convert + execute a PySpark DataFrame's physical plan on this
    engine; returns a pyarrow.Table.

    `udf_evaluators` maps wrapped-expression names (or bare Catalyst
    class names like "ScalaUDF") to host callables — the
    SparkAuronUDFWrapperContext registration step.  Wrapped expressions
    without an evaluator fail HERE with the full list, not deep inside a
    task with a missing-resource error."""
    from blaze_tpu_torch.bridge.resource import put_resource
    from blaze_tpu_torch.convert.spark import convert_spark_plan
    from blaze_tpu_torch.plan.stages import DagScheduler

    parts = num_partitions or df.rdd.getNumPartitions() or 2
    plan_json = extract_plan_json(df)
    res = convert_spark_plan(plan_json, num_partitions=parts)
    evaluators = udf_evaluators or {}
    missing = []
    for w in res.wrapped_udfs:
        fn = evaluators.get(w["name"]) or evaluators.get(w["class"])
        if fn is None:
            missing.append(w["name"])
        else:
            put_resource(f"udf://{w['name']}", fn)
    if missing:
        raise RuntimeError(
            "plan contains fallback-wrapped expressions with no host "
            f"evaluator registered: {missing}; pass udf_evaluators= or "
            "disable auron.udf.fallback.enable to reject at conversion")
    return DagScheduler(work_dir=work_dir).run_collect(res.plan)
