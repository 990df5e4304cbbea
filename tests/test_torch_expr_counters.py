"""The expression-program counters of the port
(blaze_tpu_torch/bridge/device_stats.py, fed by exprs/program.py)
against the JAX package's (blaze_tpu/bridge/xla_stats.py), both program
caches cleared first: one build then one cache hit for a chain evaluated
by two evaluators, evictions at `auron.tpu.expr.cache.size` 2,
`host_evictions_*` by the dtype that sent a chain to the host, a
literal-only chain and ANSI mode staying eager, and the explain footer.

Tolerance: exact (counter deltas)."""

import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.bridge import xla_stats
from blaze_tpu.exprs import program as JPROG
from blaze_tpu.plan.exprs import expr_from_dict as j_expr
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.exprs import program as TPROG
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema

from test_torch_expr_program import (SCHEMA, D, S, X, batches, bin_, col,
                                     lit)

CPU = torch.device("cpu")
COUNTERS = ("expr_programs_built", "expr_program_cache_hits",
            "expr_program_evictions", "expr_fused_batches",
            "expr_eager_batches", "host_evictions_string",
            "host_evictions_decimal", "host_evictions_other")


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    import blaze_tpu.bridge.placement as P
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    JPROG.clear_program_cache()
    TPROG.clear_program_cache()
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        for opt in (c.EXPR_CACHE_SIZE, c.ANSI_ENABLED, c.EXPR_FUSE):
            c.conf.unset(opt.key)
    JPROG.clear_program_cache()
    TPROG.clear_program_cache()


def _run_both(chains, rbs, decimal_schema=None):
    """Each (filters, projections) chain through a fresh evaluator of
    each package over `rbs`; the two counter deltas."""
    out = {}
    for pkg in ("torch", "jax"):
        if pkg == "jax":
            stats, prog, decode = xla_stats, JPROG, j_expr
            schema = JSchema.from_arrow(decimal_schema or SCHEMA)
            to_batch = JBatch.from_arrow
        else:
            stats, prog, decode = device_stats, TPROG, t_expr
            schema = TSchema.from_arrow(decimal_schema or SCHEMA)

            def to_batch(rb):
                return TBatch.from_arrow(rb, device=CPU)
        before = stats.snapshot()
        for filters, projections in chains:
            fs = [decode(f, schema) for f in filters]
            ps = [decode(p, schema) for p in projections]
            out_schema = type(schema)([
                type(schema[0])(f"c{i}", p.data_type(schema))
                for i, p in enumerate(ps)])
            ev = prog.FusedExprsEvaluator(filters=fs, projections=ps,
                                          in_schema=schema)
            for rb in rbs:
                b = to_batch(rb)
                if fs and ps:
                    ev.filter_project(b, out_schema)
                elif fs:
                    ev.filter(b)
                else:
                    ev.project(b, out_schema)
        d = stats.delta(before)
        out[pkg] = {k: d.get(k, 0) for k in COUNTERS}
    return out["torch"], out["jax"]


DATE = [bin_(">=", col(D), lit(2451000, "date32"))]
ARITH = [bin_("*", col(X), lit(3.0, "float64"))]


def test_one_build_then_one_hit():
    rbs = batches(1, 2, 300)
    got, want = _run_both([(DATE, ARITH), (DATE, ARITH)], rbs)
    assert got == want
    assert got["expr_programs_built"] == 1
    assert got["expr_program_cache_hits"] == 1
    assert got["expr_fused_batches"] == 4
    assert TPROG.program_cache_info()["size"] == 1


def test_evictions_at_cache_size_two():
    for c in (jconf, tconf):
        c.conf.set(c.EXPR_CACHE_SIZE.key, 2)
    rbs = batches(2, 1, 200)
    chains = [(DATE, []), ([], ARITH), (DATE, ARITH), (DATE, [])]
    got, want = _run_both(chains, rbs)
    assert got == want
    # the fourth chain was the first, evicted by the third
    assert got["expr_programs_built"] == 4
    assert got["expr_program_evictions"] == 2
    assert TPROG.program_cache_info()["size"] == 2


def test_host_evictions_by_reason():
    dec = pa.schema([("m", pa.decimal128(7, 2)), ("x", pa.float64())])
    rbs_dec = [pa.record_batch({
        "m": pa.array([1, 2, None], type=pa.decimal128(7, 2)),
        "x": pa.array([1.0, None, 2.0])}, schema=dec)]
    # a utf8 reference: string
    got, want = _run_both(
        [([bin_("==", col(S), lit("v1", "utf8"))], [])], batches(3, 1, 100))
    assert got == want and got["host_evictions_string"] == 1
    # a decimal reference (decimal encoding off): decimal
    dm = {"kind": "literal", "value": 1, "type": {
        "id": "decimal", "precision": 7, "scale": 2}}
    got, want = _run_both([([bin_(">", col(0), dm)], [])], rbs_dec,
                          decimal_schema=dec)
    assert got == want and got["host_evictions_decimal"] == 1
    # an untraceable expression over a float column: other
    got, want = _run_both(
        [([], [{"kind": "scalar_function", "name": "sqrt",
                "args": [col(X)], "return_type": {"id": "float64"}}])],
        batches(4, 1, 100))
    assert got == want and got["host_evictions_other"] == 1
    assert got["expr_eager_batches"] == 1


def test_a_literal_only_chain_and_ansi_stay_eager():
    rbs = batches(5, 2, 100)
    got, want = _run_both([([lit(True, "bool")], [lit(7, "int64")])], rbs)
    assert got == want
    assert got["expr_eager_batches"] == 2 and got["expr_programs_built"] == 0
    for c in (jconf, tconf):
        c.conf.set(c.ANSI_ENABLED.key, True)
    got, want = _run_both([(DATE, ARITH)], rbs)
    assert got == want
    assert got["expr_eager_batches"] == 2 and got["expr_programs_built"] == 0


def test_the_explain_footer_renders_the_programs():
    from blaze_tpu_torch.plan.explain import _footers
    lines = _footers({"expr_programs_built": 2, "expr_program_cache_hits": 6,
                      "expr_fused_batches": 40, "expr_eager_batches": 3,
                      "expr_program_evictions": 1})
    assert ("expr programs: built=2 cache_hits=6 (hit_rate=0.75) "
            "fused_batches=40 eager_batches=3 evictions=1") in lines
    assert not any(x.startswith("expr programs")
                   for x in _footers({"bucket_batches": 1}))
    stats = device_stats.expr_stats()
    assert "expr_cache_hit_rate" in stats
    assert "expr_cache_hit_rate" not in device_stats.snapshot()
