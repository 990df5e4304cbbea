"""The port's spill tiers (blaze_tpu_torch/memory/spill.py) and its k-way
merge (blaze_tpu_torch/ops/sort.py `merge_sorted_batches`) against the
JAX package's.

  * Both tiers round-trip their batches, and a run's stored bytes (the
    RAM tier's buffer, the file tier's file) are the JAX package's for
    the same batches, under each codec.
  * `try_new_spill` picks the RAM tier while the live RAM-tier bytes stay
    under `auron.onHeapSpill.memoryFraction` of the budget and a file past
    it, as the JAX function does step for step; a host factory goes
    first, `HostSpillUnavailable` hands over to the local tiers and any
    other exception of the factory propagates.
  * `merge_sorted_batches` equals the JAX function batch for batch over
    sorted runs of ints, floats with NaN and -0.0, utf8 with a trailing
    NUL byte among them, NULLs, and mixed descending and nulls-first
    keys, also with a merge memory target small enough to cut chunks.

Inputs are made from seeds with numpy.  Tolerance: exact (bytes and
Arrow equality)."""

import numpy as np
import pyarrow as pa
import pytest

import blaze_tpu.memory.spill as JS
import blaze_tpu_torch.memory.spill as TS
from blaze_tpu import config as jconf
from blaze_tpu.memory import MemManager as JManager
from blaze_tpu.ops import sort as JSort
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.memory import MemManager as TManager
from blaze_tpu_torch.ops import sort as TSort


@pytest.fixture(autouse=True)
def restore():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    JManager.init(4 << 30)
    TManager.init(4 << 30)
    for c in (tconf.conf, jconf.conf):
        for k in ("io.compression.codec", "auron.onHeapSpill.memoryFraction",
                  "auron.batch.size",
                  "auron.suggested.batch.memSize.multiwayMerging"):
            c.unset(k)
    tconf.conf.unset(tconf.TORCH_DEVICE.key)
    TS.set_host_spill_factory(None)
    JS.set_host_spill_factory(None)


def _rows(t) -> list:
    """A table's or batch's rows with NaN as a marker, so that equal
    NaNs compare equal."""
    def fix(v):
        return "NaN" if isinstance(v, float) and v != v else v
    return [tuple(fix(v) for v in r.values())
            for r in pa.Table.from_batches([t] if isinstance(
                t, pa.RecordBatch) else t.to_batches()).to_pylist()]


def _batches(seed, n_batches=3, rows=700):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        k = rng.integers(-50, 50, rows)
        f = rng.normal(size=rows)
        f[rng.random(rows) < 0.05] = np.nan
        s = [None if rng.random() < 0.05 else f"s{int(x)}é"
             for x in rng.integers(0, 300, rows)]
        out.append(pa.RecordBatch.from_arrays(
            [pa.array(k, mask=rng.random(rows) < 0.1), pa.array(f),
             pa.array(s)], names=["k", "f", "s"]))
    return out


@pytest.mark.parametrize("codec", ["lz4", "zstd", "raw"])
@pytest.mark.parametrize("tier", ["ram", "file"])
def test_tiers_round_trip_with_the_jax_bytes(codec, tier):
    batches = _batches(1)
    for c in (tconf.conf, jconf.conf):
        c.set("io.compression.codec", codec)
    t = TS.HostMemSpill() if tier == "ram" else TS.FileSpill()
    j = JS.HostMemSpill() if tier == "ram" else JS.FileSpill()
    ram0 = TS.SPILL_TIERS[tier]
    try:
        assert t.write_batches(iter(batches)) == j.write_batches(
            iter(batches)) == sum(b.nbytes for b in batches)
        assert TS.SPILL_TIERS[tier] == ram0 + 1
        assert t.stored_bytes == j.stored_bytes > 0
        if tier == "ram":
            assert t._buf == j._buf
        else:
            with open(t.path, "rb") as a, open(j.path, "rb") as b:
                assert a.read() == b.read()
        got = list(t.read_batches())
        assert _rows(pa.Table.from_batches(got)) == _rows(
            pa.Table.from_batches(batches))
    finally:
        t.release()
        j.release()
    assert t.stored_bytes == 0


def test_ram_tier_account_is_released():
    before = TS._host_spill_bytes
    s = TS.HostMemSpill()
    s.write_batches(iter(_batches(2, 1)))
    assert TS._host_spill_bytes == before + s.stored_bytes
    s.release()
    assert TS._host_spill_bytes == before


def test_try_new_spill_chooses_the_tier_at_the_cap_as_jax_does():
    """Budget 100,000 and fraction 0.5: the RAM tier until the live
    RAM-tier bytes reach 50,000, then files; a release reopens it."""
    JManager.init(100_000)
    TManager.init(100_000)
    for c in (tconf.conf, jconf.conf):
        c.set("auron.onHeapSpill.memoryFraction", 0.5)
    rng = np.random.default_rng(3)
    kept = {"t": [], "j": []}
    kinds = []
    try:
        for step in range(12):
            if step == 8:  # release every run held so far
                for side in kept.values():
                    for s in side:
                        s.release()
                    side.clear()
            rb = pa.RecordBatch.from_arrays(
                [pa.array(rng.integers(0, 1 << 40, 2000))], names=["x"])
            pair = []
            for mod, side in ((TS, "t"), (JS, "j")):
                s = mod.try_new_spill()
                s.write_batches(iter([rb]))
                kept[side].append(s)
                pair.append(type(s).__name__)
            kinds.append(tuple(pair))
        assert all(a == b for a, b in kinds)
        names = [a for a, _ in kinds]
        assert "HostMemSpill" in names[:8] and "FileSpill" in names[:8]
        assert names[8] == "HostMemSpill"
        assert type(TS.try_new_spill(prefer_host=False)) is TS.FileSpill
        assert type(TS.try_new_spill(host_mem_available=True)) \
            is TS.HostMemSpill
    finally:
        for side in kept.values():
            for s in side:
                s.release()


def test_host_factory_goes_first_and_may_decline():
    made = []

    class Mine(TS.Spill):
        pass

    def factory():
        made.append(1)
        if len(made) == 2:
            raise TS.HostSpillUnavailable("no room")
        if len(made) == 3:
            raise ValueError("a real fault")
        return Mine()

    TManager.init(1 << 30)
    TS.set_host_spill_factory(factory)
    assert isinstance(TS.try_new_spill(), Mine)
    assert isinstance(TS.try_new_spill(), (TS.HostMemSpill, TS.FileSpill))
    with pytest.raises(ValueError):
        TS.try_new_spill()
    # prefer_host=False never asks the factory
    assert type(TS.try_new_spill(prefer_host=False)) is TS.FileSpill
    assert len(made) == 3


# -- merge_sorted_batches ------------------------------------------------------

def _run_table(rng, n, nul):
    k = rng.integers(-20, 20, n)
    f = rng.choice([-1.5, -0.0, 0.0, 0.5, 2.0, np.nan, np.inf], n)
    words = ["", "a", "a\x00", "ab", "b", "é", "été"] + \
        (["a\x00\x00", "z\x00"] if nul else [])
    s = [None if rng.random() < 0.1 else words[i]
         for i in rng.integers(0, len(words), n)]
    return pa.RecordBatch.from_arrays(
        [pa.array(k, mask=rng.random(n) < 0.1),
         pa.array(f, mask=rng.random(n) < 0.05), pa.array(s),
         pa.array(np.arange(n))], names=["k", "f", "s", "id"])


SPECS = {
    "int asc": ([0], [False], [True]),
    "float desc nulls last": ([1], [True], [False]),
    "utf8 asc": ([2], [False], [True]),
    "utf8 desc nulls first": ([2], [True], [True]),
    "int desc, utf8 asc, float asc nulls last": (
        [0, 2, 1], [True, False, False], [False, True, False]),
}


def _sorted_runs(seed, spec, n_runs, nul=True):
    """n_runs runs, each sorted by the spec (stably) and cut into random
    batch lengths."""
    cols, desc, nf = spec
    rng = np.random.default_rng(seed)
    runs = []
    for _ in range(n_runs):
        rb = _run_table(rng, int(rng.integers(1, 900)), nul)
        perm = TSort.lexsort_host(TSort.host_sort_keys(rb, cols, desc, nf))
        rb = rb.take(pa.array(perm, type=pa.int64()))
        cuts = np.sort(rng.choice(np.arange(1, max(2, rb.num_rows)),
                                  size=min(4, max(0, rb.num_rows - 1)),
                                  replace=False)) if rb.num_rows > 1 else []
        edges = [0, *[int(c) for c in cuts], rb.num_rows]
        runs.append([rb.slice(a, b - a) for a, b in zip(edges, edges[1:])
                     if b > a])
    return runs


@pytest.mark.parametrize("mem_target", [None, 2048])
@pytest.mark.parametrize("spec", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 1])
def test_merge_sorted_batches_equals_the_jax_merge(seed, spec, mem_target):
    cols, desc, nf = SPECS[spec]
    if mem_target is not None:
        for c in (tconf.conf, jconf.conf):
            c.set("auron.suggested.batch.memSize.multiwayMerging",
                  mem_target)
            c.set("auron.batch.size", 300)
    runs = _sorted_runs(seed * 7 + len(spec), SPECS[spec], 4)
    got = list(TSort.merge_sorted_batches([iter(r) for r in runs], cols,
                                          desc, nf))
    want = list(JSort.merge_sorted_batches([iter(r) for r in runs], cols,
                                           desc, nf))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.schema.equals(w.schema) and _rows(g) == _rows(w)
    merged = pa.Table.from_batches(got)
    assert merged.num_rows == sum(b.num_rows for r in runs for b in r)
    # sorted: a stable sort of the merged rows leaves them where they are
    one = merged.combine_chunks().to_batches()[0]
    perm = TSort.lexsort_host(TSort.host_sort_keys(one, cols, desc, nf))
    assert np.array_equal(perm, np.arange(one.num_rows))
    if mem_target is not None:
        assert max(b.num_rows for b in got) <= 300


def test_compare_scalar_keeps_trailing_nul_bytes():
    keys = np.empty(3, dtype=object)
    keys[:] = [b"a", b"a\x00", b"b"]
    t = TSort.compare_scalar(keys, b"a\x00")
    assert list(keys == t) == [False, True, False]
    assert TSort._count_leq([keys], (b"a\x00",)) == 2
    assert TSort.compare_scalar(np.arange(3), 5) == 5
