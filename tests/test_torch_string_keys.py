"""utf8 group keys in the port (blaze_tpu_torch/ops/agg/exec.py and the
dict-device lane of blaze_tpu_torch/plan/fused.py) against the JAX
package's (blaze_tpu/ops/agg/exec.py, blaze_tpu/plan/fused.py
`_execute_dict_device`) on the same numpy-seeded batches, with
`blaze_tpu.bridge.placement.host_resident` patched to False: the route
the JAX package takes on a device (on JAX-CPU it would otherwise take its
host Arrow lane, which the port does not have).

  * `incremental_dict_codes`: codes, validity, dictionary and growth flag
    bit-identical (utf8 with NULLs, empty and multi-byte strings, float64
    with -0.0 and NaN, growth across batches, an empty and an all-NULL
    batch);
  * the generic AggExec over utf8 keys in the partial, complete,
    partial_merge and final modes and on the pass-through lane after the
    skip probe, with count over a utf8 column, unfiltered and under a
    filter;
  * FusedPartialAggExec's dict lane in partial and final mode, a growth
    case that re-lays the table out, a selective filter whose deselected
    rows do not grow the dictionary, `_relayout_dict_table` alone, and the
    `maxSlots` fallback (the port's generic engine against the JAX
    package's host Arrow lane, compared as sets).

Tolerance: keys, integer accumulators and row order exact; float sums and
averages within 1e-9 relative (the JAX step and the port's add each
batch's table into the carry in the same order); NULLs where NULLs.  The
fallback runs are compared as sets with `compare_frames` (cells within
1e-6), since the JAX package's host lane orders its groups its own way."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu import config as jconf
from blaze_tpu.batch import ColumnBatch as JBatch
from blaze_tpu.exprs import BinaryExpr as JBinary
from blaze_tpu.exprs import BoundReference as JRef
from blaze_tpu.exprs import Literal as JLit
from blaze_tpu.ops.agg import exec as JA
from blaze_tpu.ops.agg.functions import make_agg as j_make_agg
from blaze_tpu.ops.basic import FilterExec as JFilter
from blaze_tpu.ops.scan import MemoryScanExec
from blaze_tpu.plan import fused as JF
from blaze_tpu.schema import Schema as JSchema
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.exprs import BinaryExpr as TBinary
from blaze_tpu_torch.exprs import BoundReference as TRef
from blaze_tpu_torch.exprs import Literal as TLit
from blaze_tpu_torch.itest.runner import compare_frames
from blaze_tpu_torch.ops.agg import exec as TA
from blaze_tpu_torch.ops.agg.functions import make_agg as t_make_agg
from blaze_tpu_torch.ops.base import ExecutionPlan
from blaze_tpu_torch.ops.basic import FilterExec as TFilter
from blaze_tpu_torch.plan import fused as TF
from blaze_tpu_torch.schema import Schema as TSchema

CPU = torch.device("cpu")
SCHEMA = pa.schema([("s", pa.string()), ("k", pa.int64()),
                    ("x", pa.float64()), ("i", pa.int32()),
                    ("t", pa.string()), ("m", pa.bool_())])
S, K, X, I, T, M = range(6)


@pytest.fixture(autouse=True)
def confs(monkeypatch):
    from blaze_tpu.memory import MemManager
    import blaze_tpu.bridge.placement as P
    MemManager.init(4 << 30)
    monkeypatch.setattr(P, "host_resident", lambda: False)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _set_both(confs):
    for c in (jconf, tconf):
        for k, v in confs.items():
            c.conf.set(k, v)


def _unset_both(confs):
    for c in (jconf, tconf):
        for k in confs:
            c.conf.unset(k)


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


def _words(rng, n, distinct, prefix="w"):
    pool = np.array([f"{prefix}{i}" for i in range(distinct)]
                    + ["", "ß€😀", "a\x00b"], dtype=object)
    return pool[rng.integers(0, len(pool), n)]


def _batches(rng, n_batches, rows, distinct=6, grow=0):
    """(s utf8 with NULLs, k int64 with NULLs, x float64 with NULL/NaN/
    -0.0, i int32 with NULLs, t utf8 with NULLs, m bool filter column).
    With `grow`, batch b draws s from `distinct + b * grow` words, so the
    dictionary grows from batch to batch."""
    out = []
    for b in range(n_batches):
        d = distinct + b * grow
        x = np.round(rng.normal(size=rows) * 100, 2)
        x[rng.random(rows) < 0.03] = np.nan
        x[rng.random(rows) < 0.05] = -0.0
        out.append(pa.record_batch({
            "s": pa.array(_words(rng, rows, d), type=pa.string(),
                          mask=rng.random(rows) < 0.08),
            "k": pa.array(rng.integers(0, 4, rows),
                          mask=rng.random(rows) < 0.08),
            "x": pa.array(x, mask=rng.random(rows) < 0.1),
            "i": pa.array(rng.integers(-1000, 1000, rows).astype(np.int32),
                          mask=rng.random(rows) < 0.1),
            "t": pa.array(_words(rng, rows, 5, "t"), type=pa.string(),
                          mask=rng.random(rows) < 0.2),
            "m": pa.array(rng.random(rows) < 0.8)}))
    return out


def _assert_same_table(t, j, rtol=1e-9):
    """Same names, types, NULLs and rows in the same order; integers and
    strings exact, floats within `rtol`."""
    assert t.schema.names == j.schema.names
    assert t.num_rows == j.num_rows
    for name in j.schema.names:
        a, b = t[name], j[name]
        assert a.type == b.type, name
        assert np.array_equal(np.asarray(a.is_null()),
                              np.asarray(b.is_null())), name
        if pa.types.is_floating(b.type):
            x = np.asarray(a.fill_null(0.0))
            y = np.asarray(b.fill_null(0.0))
            assert np.array_equal(np.isnan(x), np.isnan(y)), name
            ok = ~np.isnan(y)
            np.testing.assert_allclose(x[ok], y[ok], rtol=rtol, atol=0,
                                       err_msg=name)
        else:
            assert a.equals(b), name


# ---------------------------------------------------------------------------
# incremental_dict_codes
# ---------------------------------------------------------------------------

def _code_batches(kind, rng):
    if kind == "utf8":
        return [pa.array(_words(rng, 40, 4 + 6 * b), type=pa.string(),
                         mask=rng.random(40) < 0.2) for b in range(4)]
    if kind == "float64":
        pool = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf,
                         float.fromhex("0x1.8p1")])
        out = []
        for b in range(4):
            v = pool[rng.integers(0, 3 + b, 30)]
            # a NaN with another payload normalizes to the canonical one
            v = v.copy()
            v.view(np.uint64)[rng.random(30) < 0.1] = 0x7FF0000000000BAD
            out.append(pa.array(v, mask=rng.random(30) < 0.15))
        return out
    if kind == "int32":
        return [pa.array(rng.integers(-3, 3 + 4 * b, 50).astype(np.int32),
                         mask=rng.random(50) < 0.1) for b in range(3)]
    if kind == "empty_and_null":
        return [pa.array([], type=pa.string()),
                pa.nulls(7, type=pa.string()),
                pa.array(["b", None, "a", "b"], type=pa.string()),
                pa.nulls(3, type=pa.string()),
                pa.array(["c", "a"], type=pa.string())]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["utf8", "float64", "int32",
                                  "empty_and_null"])
def test_incremental_dict_codes_bit_identical(kind):
    rng = np.random.default_rng(len(kind))
    jd = td = None
    grew_any = False
    for arr in _code_batches(kind, rng):
        cap = max(128, len(arr))
        jc, jv, jd, jg = JA.incremental_dict_codes(arr, jd, cap)
        tc, tv, td, tg = TA.incremental_dict_codes(arr, td, cap)
        assert tc.dtype == jc.dtype == np.int64
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tv, jv)
        assert tg == jg and td.type == jd.type
        if pa.types.is_floating(td.type):
            # bit for bit (Arrow's equals holds NaN unequal to itself)
            assert td.null_count == jd.null_count == 0
            np.testing.assert_array_equal(np.asarray(td).view(np.uint64),
                                          np.asarray(jd).view(np.uint64))
        else:
            assert td.equals(jd)
        grew_any |= tg
    assert grew_any
    if kind == "float64":
        vals = np.asarray(td)
        # one 0.0 (no -0.0), one canonical NaN
        assert np.signbit(vals[vals == 0]).sum() == 0
        assert np.isnan(vals).sum() == 1


# ---------------------------------------------------------------------------
# the generic AggExec
# ---------------------------------------------------------------------------

RAW_FNS = [("sum", [X]), ("count", [S]), ("count", [T]), ("count", []),
           ("avg", [X]), ("min", [I]), ("max", [I]), ("sum", [I])]


def _agg_op(pkg, batches, schema, keys, fns, mode, filtered=False,
            fuse=False):
    if pkg == "jax":
        src = MemoryScanExec(JSchema.from_arrow(schema),
                             [[JBatch.from_arrow(rb) for rb in batches]])
        ref, lit, binary, make, Filter, Agg, Mode, fuse_plan = (
            JRef, JLit, JBinary, j_make_agg, JFilter, JA.AggExec,
            JA.AggMode, JF.fuse_plan)
        from blaze_tpu.schema import BOOL
    else:
        src = _Source(batches, schema)
        ref, lit, binary, make, Filter, Agg, Mode, fuse_plan = (
            TRef, TLit, TBinary, t_make_agg, TFilter, TA.AggExec,
            TA.AggMode, TF.fuse_plan)
        from blaze_tpu_torch.schema import BOOL
    if filtered:
        src = Filter(src, [binary("==", ref(M), lit(True, BOOL))])
    groups = [(ref(k), f"g{k}") for k in keys]
    aggs = [(make(fn, [ref(a) for a in args]), Mode(mode), f"a{j}")
            for j, (fn, args) in enumerate(fns)]
    op = Agg(src, groups, aggs)
    return fuse_plan(op) if fuse else op


def _collect(op):
    out = [b.to_arrow() for b in op.execute(0)]
    tbl = (pa.Table.from_batches(out) if out else
           op.schema.to_arrow().empty_table())
    return tbl.combine_chunks()


def _both(batches, keys, fns, mode, filtered=False, fuse=False,
          schema=SCHEMA):
    t_op = _agg_op("torch", batches, schema, keys, fns, mode, filtered,
                   fuse)
    j_op = _agg_op("jax", batches, schema, keys, fns, mode, filtered, fuse)
    t, j = _collect(t_op), _collect(j_op)
    return t, j, t_op, j_op


@pytest.mark.parametrize("mode", ["partial", "complete"])
@pytest.mark.parametrize("keys", [[S], [S, K], [K, S, T]])
@pytest.mark.parametrize("filtered", [False, True])
def test_generic_engine_raw_modes_match_jax(mode, keys, filtered):
    rng = np.random.default_rng(len(keys) * 10 + filtered)
    batches = _batches(rng, 4, 300)
    t, j, t_op, _ = _both(batches, keys, RAW_FNS, mode, filtered)
    _assert_same_table(t, j)
    assert t.num_rows > 0
    # a filter coalesces the surviving rows of the 4 batches into 1
    assert t_op.metrics.get("cpu_batches") == (1 if filtered else 4)
    assert pa.types.is_string(t.schema.field(f"g{S}").type)


def _partials(rng, keys, chunks=3):
    """The JAX package's partial outputs of several chunks of raw batches,
    concatenated: accumulator batches whose utf8 groups repeat."""
    outs = []
    for c in range(chunks):
        batches = _batches(rng, 2, 250, grow=3 * c)
        outs.append(_collect(_agg_op("jax", batches, SCHEMA, keys, RAW_FNS,
                                     "partial")))
    tbl = pa.concat_tables(outs)
    return tbl.to_batches(max_chunksize=200), tbl.schema


def _merge_fns(keys):
    out, pos = [], len(keys)
    for fn, _args in RAW_FNS:
        nacc = 2 if fn == "avg" else 1
        out.append((fn, list(range(pos, pos + nacc))))
        pos += nacc
    return out


@pytest.mark.parametrize("mode", ["partial_merge", "final"])
@pytest.mark.parametrize("keys", [[S], [S, K]])
def test_generic_engine_merge_modes_match_jax(mode, keys):
    rng = np.random.default_rng(40 + len(keys))
    batches, schema = _partials(rng, keys)
    mk = list(range(len(keys)))
    t, j, _, _ = _both(batches, mk, _merge_fns(keys), mode, schema=schema)
    _assert_same_table(t, j)
    assert t.num_rows < sum(b.num_rows for b in batches)


@pytest.mark.parametrize("distinct,skips", [(100_000, True), (5, False)])
def test_generic_engine_passthrough_after_the_skip_probe(distinct, skips):
    confs = {"auron.tpu.partialAgg.skipping.minRows": 500,
             "auron.tpu.partialAgg.skipping.ratio": 0.5}
    _set_both(confs)
    try:
        rng = np.random.default_rng(distinct)
        batches = _batches(rng, 6, 200, distinct=distinct)
        t, j, t_op, j_op = _both(batches, [S, K], RAW_FNS, "partial")
    finally:
        _unset_both(confs)
    _assert_same_table(t, j)
    tm, jm = t_op.metrics, j_op.metrics
    assert tm.get("partial_skipped") == jm.get("partial_skipped") == int(
        skips)
    assert tm.get("passthrough_rows") == jm.get("passthrough_rows")
    assert (tm.get("passthrough_rows") > 0) == skips


def test_generic_engine_host_accumulators_still_raise():
    with pytest.raises(NotImplementedError, match="item 13"):
        _collect(_agg_op("torch", _batches(np.random.default_rng(1), 1, 10),
                         SCHEMA, [K], [("max", [S])], "partial"))


# ---------------------------------------------------------------------------
# the fused dict-device lane
# ---------------------------------------------------------------------------

DICT_FNS = [("sum", [X]), ("count", [X]), ("count", []), ("min", [I]),
            ("max", [I]), ("sum", [I])]


def _dict_both(batches, keys, fns, mode, filtered=False, schema=SCHEMA):
    t, j, t_op, j_op = _both(batches, keys, fns, mode, filtered, fuse=True,
                             schema=schema)
    assert isinstance(t_op, TF.FusedPartialAggExec)
    assert isinstance(j_op, JF.FusedPartialAggExec)
    return t, j, t_op.metrics, j_op.metrics


@pytest.mark.parametrize("keys", [[S], [S, K], [K, S, T]])
@pytest.mark.parametrize("filtered", [False, True])
def test_dict_lane_partial_matches_jax(keys, filtered):
    rng = np.random.default_rng(100 + len(keys) * 10 + filtered)
    batches = _batches(rng, 4, 300)
    t, j, tm, jm = _dict_both(batches, keys, DICT_FNS, "partial", filtered)
    _assert_same_table(t, j)
    assert tm.get("dict_device_batches") == jm.get("dict_device_batches") \
        == (1 if filtered else 4)
    assert tm.values.get("dict_device_fallback", 0) == 0


@pytest.mark.parametrize("keys", [[S], [S, K]])
def test_dict_lane_final_matches_jax(keys):
    rng = np.random.default_rng(200 + len(keys))
    fns = [("sum", [X]), ("count", [X]), ("min", [I]), ("max", [I])]
    outs = []
    for c in range(3):
        b = _batches(rng, 2, 250, grow=4 * c)
        outs.append(_collect(_agg_op("jax", b, SCHEMA, keys, fns,
                                     "partial")))
    tbl = pa.concat_tables(outs)
    batches = tbl.to_batches(max_chunksize=200)
    mk = list(range(len(keys)))
    merge = [(fn, [len(keys) + q]) for q, (fn, _a) in enumerate(fns)]
    t, j, tm, jm = _dict_both(batches, mk, merge, "final",
                              schema=tbl.schema)
    _assert_same_table(t, j)
    assert t.num_rows < tbl.num_rows
    assert tm.get("dict_device_batches") == jm.get("dict_device_batches") \
        > 0


def test_dict_lane_growth_relays_the_table_out():
    """s draws from 6 words in the first batch and 40 more in each next
    one: the key's capacity doubles 16 -> 32 -> 64 -> 128 -> 256 with a
    carry in place, so the table is re-laid out each time."""
    rng = np.random.default_rng(7)
    batches = _batches(rng, 5, 400, distinct=6, grow=40)
    t, j, tm, _jm = _dict_both(batches, [S, K], DICT_FNS, "partial")
    _assert_same_table(t, j)
    assert tm.get("dict_device_relayouts") >= 3
    assert t.num_rows > 100


def test_dict_lane_deselected_rows_do_not_grow_the_dictionary():
    """Deselected rows hold 200 words of their own; only 5 words survive
    the filter.  Nulled before encoding, they neither grow the dictionary
    nor the table: no relayout, and `maxSlots` 100 (the table of 16 codes
    plus NULL holds 17 slots for s) is never passed.  `auron.batch.size`
    512 and 70% of the rows kept: the filter passes each batch on with
    its selection mask (a sparser or smaller batch would be compacted)."""
    rng = np.random.default_rng(8)
    batches = []
    for _ in range(3):
        n = 400
        keep = rng.random(n) < 0.7
        s = np.where(keep, _words(rng, n, 5, "keep"),
                     _words(rng, n, 200, "drop"))
        rb = _batches(rng, 1, n)[0]
        batches.append(rb.set_column(S, "s", pa.array(s, type=pa.string()))
                       .set_column(M, "m", pa.array(keep)))
    confs = {tconf.FUSED_DICT_DEVICE_MAX_SLOTS.key: 100,
             "auron.batch.size": 512}
    _set_both(confs)
    try:
        src = TFilter(_Source(batches, SCHEMA),
                      [TBinary("==", TRef(M), TLit(True, _bool()))])
        assert all(b.selection is not None and
                   b.selected_count() < b.num_rows for b in src.execute(0))
        t, j, tm, jm = _dict_both(batches, [S], DICT_FNS, "partial",
                                  filtered=True)
    finally:
        _unset_both(confs)
    assert tm.get("dict_device_batches") == 3
    _assert_same_table(t, j)
    assert tm.values.get("dict_device_relayouts", 0) == 0
    assert tm.values.get("dict_device_fallback", 0) == 0 == \
        jm.values.get("dict_device_fallback", 0)
    assert set(t["gs" if "gs" in t.schema.names else f"g{S}"]
               .to_pylist()) <= {f"keep{i}" for i in range(5)} | {
                   "", "ß€😀", "a\x00b", None}


def _bool():
    from blaze_tpu_torch.schema import BOOL
    return BOOL


def test_global_dict_codes_null_deselected_rows_as_jax():
    rng = np.random.default_rng(9)
    jd = td = None
    for b in range(3):
        arr = pa.array(_words(rng, 200, 10 + 30 * b), type=pa.string(),
                       mask=rng.random(200) < 0.1)
        sel = rng.random(200) < 0.5
        jc, jv, jd = JF._global_dict_codes(arr, jd, 256, sel)
        tc, tv, td = TF._global_dict_codes(arr, td, 256, sel)
        assert tc.dtype == jc.dtype == np.int32
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tv, jv)
        assert td.equals(jd)
        assert not tv[:200][~sel].any()
    assert set(td.to_pylist()) < set(_words(rng, 5000, 70))


def test_relayout_dict_table_equals_jax():
    rng = np.random.default_rng(11)
    old_caps, new_caps = [16, 4], [64, 8]
    kinds = ("sum", "count", "min", "max")
    dts = (torch.float64, torch.int64, torch.int32, torch.int32)
    total = 17 * 5
    occ = rng.random(total) < 0.4
    accs = (rng.normal(size=total), rng.integers(0, 9, total),
            rng.integers(-50, 50, total).astype(np.int32),
            rng.integers(-50, 50, total).astype(np.int32))
    avalid = tuple(occ & (rng.random(total) < 0.8) for _ in kinds)
    import jax.numpy as jnp
    jcarry = (tuple(jnp.asarray(a) for a in accs),
              tuple(jnp.asarray(v) for v in avalid), jnp.asarray(occ))
    jd = [jnp.float64, jnp.int64, jnp.int32, jnp.int32]
    j_accs, j_av, j_occ = JF._relayout_dict_table(jcarry, kinds, jd,
                                                  old_caps, new_caps)
    tcarry = (tuple(torch.from_numpy(a) for a in accs),
              tuple(torch.from_numpy(v) for v in avalid),
              torch.from_numpy(occ))
    t_accs, t_av, t_occ = TF._relayout_dict_table(tcarry, kinds, dts,
                                                  old_caps, new_caps)
    np.testing.assert_array_equal(t_occ.numpy(), np.asarray(j_occ))
    for a, b in zip(t_accs + t_av, j_accs + j_av):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_dict_lane_max_slots_falls_back_to_the_generic_engine():
    """`maxSlots` 64: two keys of 16 codes each already need 17 x 17
    slots, so the lane gives up before its first fold; the port re-runs
    the partition through AggExec, the JAX package through its host Arrow
    lane.  Same groups, compared as sets."""
    rng = np.random.default_rng(12)
    batches = _batches(rng, 3, 300)
    confs = {tconf.FUSED_DICT_DEVICE_MAX_SLOTS.key: 64}
    _set_both(confs)
    try:
        t, j, tm, jm = _dict_both(batches, [S, T], DICT_FNS, "partial")
    finally:
        _unset_both(confs)
    assert tm.get("dict_device_fallback") == jm.get(
        "dict_device_fallback") == 1
    assert tm.values.get("dict_device_batches", 0) == 0
    # the lane's first batch, then the generic engine's 3
    assert tm.get("cpu_batches") == 4
    assert compare_frames(t.to_pandas(), j.to_pandas()) is None
    assert t.num_rows > 20


def test_dict_lane_admission():
    """min/max over a float argument stays with the generic engine, as
    with the lane switched off; the port runs the generic engine there."""
    rng = np.random.default_rng(13)
    batches = _batches(rng, 2, 100)
    op = _agg_op("torch", batches, SCHEMA, [S], [("max", [X])], "partial",
                 fuse=True)
    assert isinstance(op, TA.AggExec)
    t, j, _, _ = _both(batches, [S], [("max", [X])], "partial", fuse=True)
    _assert_same_table(t, j)
    tconf.conf.set(tconf.FUSED_DICT_DEVICE_ENABLE.key, False)
    try:
        op = _agg_op("torch", batches, SCHEMA, [S], DICT_FNS, "partial",
                     fuse=True)
        assert isinstance(op, TA.AggExec)
    finally:
        tconf.conf.unset(tconf.FUSED_DICT_DEVICE_ENABLE.key)
