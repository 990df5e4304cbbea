"""The port's SortExec (blaze_tpu_torch/ops/sort.py) and LimitExec
(ops/basic.py) against the JAX package's (blaze_tpu/ops/sort.py,
ops/basic.py) on the same numpy-seeded batches: with and without
`fetch`, at 1023 staged rows (the host lexsort) and 1024 (the device
sort), multi-key with many ties, NULLs first and last, NaN and -0.0 keys,
ascending and descending, over several input batches with rows masked by
a filter; LimitExec with and without an offset, across batch boundaries.

Tolerance: exact.  The same rows in the same order, bit for bit."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import BinaryExpr as JBinary
from blaze_tpu.exprs import BoundReference as JRef
from blaze_tpu.exprs import Literal as JLit
from blaze_tpu.ops.basic import FilterExec as JFilter
from blaze_tpu.ops.basic import LimitExec as JLimit
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.ops.sort import SortExec as JSort
from blaze_tpu.schema import BOOL as JBOOL
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import BinaryExpr as TBinary
from blaze_tpu_torch.exprs import BoundReference as TRef
from blaze_tpu_torch.exprs import Literal as TLit
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import FilterExec as TFilter
from blaze_tpu_torch.ops.basic import LimitExec as TLimit
from blaze_tpu_torch.ops.sort import DEVICE_SORT_MIN_ROWS
from blaze_tpu_torch.ops.sort import SortExec as TSort
from blaze_tpu_torch.schema import BOOL as TBOOL
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")


class _Source(ExecutionPlan):
    """Fixed Arrow batches as port batches on the CPU (one partition)."""

    def __init__(self, batches, schema):
        super().__init__()
        self._batches = list(batches)
        self._schema = TSchema.from_arrow(schema)

    @property
    def schema(self):
        return self._schema

    def execute(self, partition):
        for rb in self._batches:
            yield TBatch.from_arrow(rb, device=CPU)


@pytest.fixture(autouse=True)
def _cpu():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _batches(rng, sizes, distinct=5):
    """(a int64 with NULLs, b float64 with NaN/-0.0/NULL, c int16, d date32,
    id int64 row number, m bool filter column), few distinct keys so rows
    tie."""
    out, base = [], 0
    for n in sizes:
        b = (rng.integers(0, distinct, n) - 2).astype(np.float64) / 2
        b[rng.random(n) < 0.1] = np.nan
        b[rng.random(n) < 0.1] = -0.0
        out.append(pa.record_batch({
            "a": pa.array(rng.integers(0, distinct, n),
                          mask=rng.random(n) < 0.1),
            "b": pa.array(b, mask=rng.random(n) < 0.05),
            "c": pa.array(rng.integers(-3, 3, n).astype(np.int16)),
            "d": pa.array(rng.integers(0, distinct, n).astype(np.int32),
                          pa.date32()),
            "id": pa.array(np.arange(base, base + n)),
            "m": pa.array(rng.random(n) < 0.9)}))
        base += n
    return out


def _source(pkg, batches, filtered):
    schema = batches[0].schema
    if pkg == "jax":
        src = MemoryScanExec(JSchema.from_arrow(schema),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        if filtered:
            src = JFilter(src, [JBinary("==", JRef(5), JLit(True, JBOOL))])
        return src
    src = _Source(batches, schema)
    if filtered:
        src = TFilter(src, [TBinary("==", TRef(5), TLit(True, TBOOL))])
    return src


def _collect(op):
    out = [b.to_arrow() for b in op.execute(0)]
    return pa.Table.from_batches(out).combine_chunks() if out else None


#: (column, descending, nulls_first) sort specs
SPECS = {
    "one": [(0, False, True)],
    "two": [(1, True, False), (0, False, True)],
    "four": [(2, False, False), (3, True, True), (1, False, True),
             (0, True, False)],
}


def _sort(pkg, batches, specs, fetch, filtered):
    src = _source(pkg, batches, filtered)
    ref, Sort = (JRef, JSort) if pkg == "jax" else (TRef, TSort)
    op = Sort(src, [(ref(c), d, nf) for c, d, nf in specs], fetch=fetch)
    return _collect(op), op


def _assert_same(t, j):
    assert t.schema.names == j.schema.names
    assert t.num_rows == j.num_rows
    for name in j.schema.names:
        assert t[name].type == j[name].type
        a = np.asarray(t[name].is_null())
        assert np.array_equal(a, np.asarray(j[name].is_null())), name
        if pa.types.is_floating(j[name].type):
            x = t[name].fill_null(0.0).to_numpy()
            y = j[name].fill_null(0.0).to_numpy()
            assert np.array_equal(x.view(np.uint64), y.view(np.uint64)), name
        else:
            assert t[name].equals(j[name]), name


@pytest.mark.parametrize("rows", [DEVICE_SORT_MIN_ROWS - 1,
                                  DEVICE_SORT_MIN_ROWS])
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("fetch", [None, 100])
def test_sort_matches_jax_on_both_routes(rows, spec, fetch):
    rng = np.random.default_rng(rows + len(SPECS[spec]))
    sizes = [rows // 3, rows // 3, rows - 2 * (rows // 3)]
    batches = _batches(rng, sizes)
    t, op = _sort("torch", batches, SPECS[spec], fetch, False)
    j, _ = _sort("jax", batches, SPECS[spec], fetch, False)
    _assert_same(t, j)
    assert t.num_rows == (rows if fetch is None else fetch)
    assert op.metrics.get("sort_device_runs") == int(
        rows >= DEVICE_SORT_MIN_ROWS)
    # ties keep their input order (ids ascend within equal keys)
    if spec == "one":
        a = t["a"].fill_null(-1).to_numpy()
        ids = t["id"].to_numpy()
        same = a[1:] == a[:-1]
        assert (ids[1:][same] > ids[:-1][same]).all()


@pytest.mark.parametrize("spec", ["two", "four"])
def test_sort_of_filtered_batches_matches_jax(spec):
    rng = np.random.default_rng(21)
    batches = _batches(rng, [900, 700, 600])
    for fetch in (None, 37):
        t, op = _sort("torch", batches, SPECS[spec], fetch, True)
        j, _ = _sort("jax", batches, SPECS[spec], fetch, True)
        _assert_same(t, j)
        assert op.metrics.get("sort_device_runs") == 1


def test_sort_of_one_batch_larger_than_batch_size_matches_jax():
    confs = {"auron.batch.size": 256}
    for c in (jconf, tconf):
        for k, v in confs.items():
            c.conf.set(k, v)
    try:
        rng = np.random.default_rng(4)
        batches = _batches(rng, [1500])
        t, _ = _sort("torch", batches, SPECS["two"], None, False)
        j, _ = _sort("jax", batches, SPECS["two"], None, False)
    finally:
        for c in (jconf, tconf):
            for k in confs:
                c.conf.unset(k)
    _assert_same(t, j)


@pytest.mark.parametrize("limit,offset", [(10, 0), (150, 0), (150, 95),
                                          (1000, 0), (40, 260), (5, 400),
                                          (0, 0)])
@pytest.mark.parametrize("filtered", [False, True])
def test_limit_matches_jax(limit, offset, filtered):
    rng = np.random.default_rng(limit + offset)
    batches = _batches(rng, [100, 130, 120])
    out = {}
    for pkg, Limit in (("jax", JLimit), ("torch", TLimit)):
        op = Limit(_source(pkg, batches, filtered), limit, offset=offset)
        out[pkg] = _collect(op)
    if out["jax"] is None:
        assert out["torch"] is None
        return
    _assert_same(out["torch"], out["jax"])
    assert out["torch"].num_rows <= limit
