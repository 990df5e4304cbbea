"""The parquet scan's post-decode filter (blaze_tpu_torch/ops/scan.py
`_post_decode_filter` over exprs/program.py `fused_filter`) against the
JAX scan's (blaze_tpu/ops/scan.py), the JAX package on its device route:
an unprojected scan with a traceable predicate gives each decoded batch
the JAX batch's selection (prefetch on and off); a projected scan and a
predicate over a string column leave the batches unselected, as the JAX
scan does; the fused batches are counted.

Tolerance: exact (row counts and selection masks)."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from blaze_tpu import config as jconf
from blaze_tpu.ops.scan import ParquetScanExec as JScan
from blaze_tpu.plan.exprs import expr_from_dict as j_expr
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.bridge import device_stats
from blaze_tpu_torch.ops.scan import ParquetScanExec as TScan
from blaze_tpu_torch.plan.exprs import expr_from_dict as t_expr
from blaze_tpu_torch.schema import Schema as TSchema

from test_torch_expr_program import bin_, col, lit

SCHEMA = pa.schema([("d", pa.int32()), ("k", pa.int64()),
                    ("s", pa.string())])
RANGE = bin_("and", bin_(">=", col(0), lit(2451000, "int32")),
             bin_("<=", col(0), lit(2451090, "int32")))


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    for c in (jconf, tconf):
        c.conf.unset(c.IO_PREFETCH_ENABLE.key)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    rng = np.random.default_rng(21)
    n = 5000
    t = pa.table({
        "d": pa.array(rng.integers(2450800, 2451300, n).astype(np.int32),
                      mask=rng.random(n) < 0.05),
        "k": pa.array(rng.integers(0, 100, n)),
        "s": pa.array([f"s{v}" for v in rng.integers(0, 5, n)])},
        schema=SCHEMA)
    p = str(tmp_path_factory.mktemp("scan") / "t.parquet")
    pq.write_table(t, p, row_group_size=1200)
    return p


def _selections(pkg, path, pred, projection=None):
    if pkg == "jax":
        schema = JSchema.from_arrow(SCHEMA)
        scan = JScan(schema, [[path]], projection=projection,
                     predicate=j_expr(pred, schema), batch_rows=700)
    else:
        schema = TSchema.from_arrow(SCHEMA)
        scan = TScan(schema, [[path]], projection=projection,
                     predicate=t_expr(pred, schema), batch_rows=700)
    out = []
    for b in scan.execute(0):
        sel = (None if b.selection is None
               else np.asarray(b.selection)[:b.num_rows].astype(bool))
        out.append((b.num_rows, sel))
    return out


def _same(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            assert (g == w).all()


@pytest.mark.parametrize("prefetch", [True, False])
def test_the_post_decode_selection_equals_jax(path, prefetch):
    for c in (jconf, tconf):
        c.conf.set(c.IO_PREFETCH_ENABLE.key, prefetch)
    before = device_stats.snapshot()
    got = _selections("torch", path, RANGE)
    fused = device_stats.delta(before)["expr_fused_batches"]
    _same(got, _selections("jax", path, RANGE))
    assert all(sel is not None for _, sel in got)
    kept = sum(int(sel.sum()) for _, sel in got)
    assert 0 < kept < sum(n for n, _ in got)
    assert fused == len(got)


def test_projected_or_untraceable_scans_keep_every_row(path):
    for pred, projection in ((RANGE, ["d", "k"]),
                             (bin_("==", col(2), lit("s1", "utf8")), None)):
        got = _selections("torch", path, pred, projection)
        _same(got, _selections("jax", path, pred, projection))
        assert all(sel is None for _, sel in got)
