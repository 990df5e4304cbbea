"""The port stands alone: importing every module of blaze_tpu_torch in a
fresh interpreter loads neither jax nor anything of blaze_tpu, and builds
or launches nothing.  chip_smoke.py imports neither either."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import blaze_tpu_torch
names = [m.name for m in pkgutil.walk_packages(blaze_tpu_torch.__path__,
                                               "blaze_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from blaze_tpu_torch.kernels import build
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "blaze_tpu."))
             or m == "blaze_tpu")
print(json.dumps({"n": len(names), "bad": bad, "libs": sorted(build._libs)}))
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 30
    assert res["bad"] == [] and res["libs"] == []


def test_sources_name_no_jax_import():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, fs in os.walk(os.path.join(ROOT, "blaze_tpu_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    for path in files:
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "blaze_tpu", "bench"), \
                    f"{path} imports {m}"


def test_the_query_service_and_the_fault_engine_are_walked():
    """The import probe above reaches the query service, its context and
    progress registry, the fault engine and itest/serving.py."""
    import pkgutil

    import blaze_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(blaze_tpu_torch.__path__,
                                                   "blaze_tpu_torch.")}
    assert {"blaze_tpu_torch.serving", "blaze_tpu_torch.serving.context",
            "blaze_tpu_torch.serving.progress",
            "blaze_tpu_torch.serving.service", "blaze_tpu_torch.faults",
            "blaze_tpu_torch.itest.serving"} <= names


def test_the_streaming_modules_are_walked():
    """The import probe above reaches the Flink front door, the Kafka scan,
    the sinks, the streaming runtime and the Nexmark paths."""
    import pkgutil

    import blaze_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(blaze_tpu_torch.__path__,
                                                   "blaze_tpu_torch.")}
    assert {"blaze_tpu_torch.convert.flink",
            "blaze_tpu_torch.convert.flink_runtime",
            "blaze_tpu_torch.ops.kafka", "blaze_tpu_torch.ops.sink",
            "blaze_tpu_torch.streaming",
            "blaze_tpu_torch.streaming.checkpoint",
            "blaze_tpu_torch.streaming.executor",
            "blaze_tpu_torch.streaming.sink",
            "blaze_tpu_torch.itest.nexmark",
            "blaze_tpu_torch.itest.streaming"} <= names
