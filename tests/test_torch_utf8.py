"""The port's utf8 pieces against the JAX package on the same
numpy-seeded strings:

  * murmur3 (seed 42) and xxhash64 over utf8 (blaze_tpu_torch/kernels/
    hashing.py `murmur3_hash_bytes`, `xxhash64_bytes`) against the JAX
    package's numpy kernels and Spark's own vectors: empty, multibyte,
    NUL, NULL and long (> 32 bytes, xxhash64's stripes) strings, alone
    and chained after an int64 key; Spark partition ids over a utf8 key
    through HashPartitioning;
  * a utf8 literal and `==`/`!=` between a utf8 column and it
    (exprs/binary.py's host branch), in a filter, with NULLs;
  * the host order keys of a utf8 sort key (ops/sort.py
    `_host_order_key`) in every direction and null placement, and
    SortExec with fetch over a utf8 key;
  * host (utf8) columns through ColumnBatch.compact and concat.

Tolerance: exact (hashes bit for bit, rows in the same order)."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

from blaze_tpu.kernels import hashing as JH
from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch as TBatch
from blaze_tpu_torch.kernels import hashing as TH

CPU = torch.device("cpu")

HOSTILE = ["", "a", "hello", "天地", "😁", "x\x00y", "\x00", "ab\x00\x00",
           "b" * 31, "c" * 32, "d" * 33, "ü" * 40, "x" * 64 + "tail", None]


@pytest.fixture(autouse=True)
def cpu_device():
    from blaze_tpu.memory import MemManager
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


def _strings(seed, n=300):
    rng = np.random.default_rng(seed)
    pool = np.array(HOSTILE, dtype=object)
    vals = pool[rng.integers(0, len(pool), n)].tolist()
    return pa.array(vals, type=pa.string())


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_cols(arr, ints=None):
    (mat, lens), valid = TH.string_column_to_padded_bytes(arr)
    cols = [((_t(mat), _t(lens)), _t(valid), "utf8")]
    if ints is not None:
        cols.insert(0, (_t(ints), None, "int64"))
    return cols


def _jax_cols(arr, ints=None):
    (mat, lens), valid = JH.string_column_to_padded_bytes(arr)
    cols = [((mat, lens), valid, "utf8")]
    if ints is not None:
        cols.insert(0, (ints, None, "int64"))
    return cols


def test_padded_bytes_equal_the_jax_package():
    arr = _strings(1)
    (gm, gl), gv = TH.string_column_to_padded_bytes(arr)
    (wm, wl), wv = JH.string_column_to_padded_bytes(arr)
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(gl, wl)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("algo", ["murmur3", "xxhash64"])
@pytest.mark.parametrize("chained", [False, True])
@pytest.mark.parametrize("seed", [1, 2])
def test_utf8_hash_bit_exact(algo, chained, seed):
    arr = _strings(seed)
    ints = (np.random.default_rng(seed).integers(-5, 5, len(arr))
            if chained else None)
    got = TH.hash_columns(_port_cols(arr, ints), algo=algo).numpy()
    want = np.asarray(JH.hash_columns(_jax_cols(arr, ints), xp=np,
                                      algo=algo))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("algo,expected", [
    ("murmur3", np.array([3286402344, 2486176763, 142593372, 885025535,
                          2395000894], dtype=np.uint32).view(np.int32)),
    ("xxhash64", np.array([-4367754540140381902, -1798770879548125814,
                           -7444071767201028348, -6337236088984028203,
                           -235771157374669727], dtype=np.int64))])
def test_utf8_hash_spark_vectors(algo, expected):
    """Spark's own vectors (tests/test_hashing.py)."""
    arr = pa.array(["hello", "bar", "", "😁", "天地"])
    got = TH.hash_columns(_port_cols(arr), algo=algo).numpy()
    np.testing.assert_array_equal(got, expected)


def test_null_utf8_keeps_the_seed():
    arr = pa.array([None, "a"], type=pa.string())
    got = TH.hash_columns(_port_cols(arr)).numpy()
    assert got[0] == 42


def test_partition_ids_over_a_utf8_key():
    """HashPartitioning over (utf8, int64) keys equals the JAX package's
    pmod(murmur3) partition ids."""
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.shuffle import HashPartitioning
    arr = _strings(3, 500)
    ints = np.arange(len(arr), dtype=np.int64) % 7
    cb = TBatch.from_arrow(pa.table({"s": arr, "i": ints}), device=CPU)
    got = HashPartitioning([BoundReference(0), BoundReference(1)],
                           13).partition_ids(cb).numpy()
    (mat, lens), valid = JH.string_column_to_padded_bytes(arr)
    want = np.asarray(JH.spark_partition_ids(
        [((mat, lens), valid), (ints, np.ones(len(ints), bool))],
        ["utf8", "int64"], 13, xp=np))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# a utf8 literal and == / !=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["==", "!="])
@pytest.mark.parametrize("literal", ["TN", "", "天地", None])
def test_utf8_compare_with_a_literal(op, literal):
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.exprs import BinaryExpr as JBin
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.exprs import Literal as JLit
    from blaze_tpu.schema import UTF8 as JUTF8
    from blaze_tpu_torch.exprs import BinaryExpr, BoundReference, Literal
    from blaze_tpu_torch.schema import UTF8
    rng = np.random.default_rng(5)
    states = np.array(["TN", "CA", "", "天地", "TN\x00"], dtype=object)
    arr = pa.array(states[rng.integers(0, len(states), 400)].tolist(),
                   mask=rng.random(400) < 0.1, type=pa.string())
    tbl = pa.table({"s": arr, "v": np.arange(400)})
    got_v = BinaryExpr(op, BoundReference(0), Literal(literal, UTF8)) \
        .evaluate(TBatch.from_arrow(tbl, device=CPU))
    jb = JBatch.from_arrow(tbl)
    want_v = JBin(op, JRef(0), JLit(literal, JUTF8)).evaluate(jb)
    assert got_v.to_host(400).equals(want_v.to_host(400))
    tb = TBatch.from_arrow(tbl, device=CPU)
    mask = got_v.as_mask(tb).numpy()[:400]
    np.testing.assert_array_equal(mask, np.asarray(want_v.as_mask(jb))[:400])


def test_utf8_filter_then_compact_and_concat():
    """A filter on s != 'a' over batches with a utf8 column (NULLs
    dropped); the compacted batches concatenate with their strings in
    order."""
    from blaze_tpu_torch.exprs import BinaryExpr, BoundReference, Literal
    from blaze_tpu_torch.ops.basic import apply_filter
    from blaze_tpu_torch.schema import UTF8
    arr = _strings(7, 1000)
    tbl = pa.table({"s": arr, "v": np.arange(1000)})
    pred = BinaryExpr("!=", BoundReference(0), Literal("a", UTF8))
    parts = [apply_filter(TBatch.from_arrow(tbl.slice(o, 250), device=CPU),
                          [pred]).compact() for o in range(0, 1000, 250)]
    out = TBatch.concat(parts).to_arrow()
    want = tbl.filter(pc.not_equal(tbl["s"], "a"))
    assert out.num_rows == want.num_rows
    assert out.column(0).to_pylist() == want["s"].to_pylist()
    assert out.column(1).to_pylist() == want["v"].to_pylist()


# ---------------------------------------------------------------------------
# sort keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("nulls_first", [False, True])
def test_utf8_host_order_key_equals_the_jax_package(descending, nulls_first):
    from blaze_tpu.ops.sort import _host_order_key as jkey
    from blaze_tpu_torch.ops.sort import _host_order_key as tkey
    arr = _strings(9, 500)
    got = tkey(arr, descending, nulls_first)
    want = jkey(arr, descending, nulls_first)
    assert len(got) == len(want) == 2
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1]) == list(want[1])


@pytest.mark.parametrize("descending", [False, True])
def test_sort_by_utf8_with_fetch(descending):
    """SortExec over a utf8 key (with ties and NULLs) and an int tie
    breaker, fetch 100: the same rows in the same order as the JAX
    package's SortExec."""
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.exprs import BoundReference as JRef
    from blaze_tpu.ops.scan import MemoryScanExec
    from blaze_tpu.ops.sort import SortExec as JSort
    from blaze_tpu.schema import Schema as JSchema
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.base import ExecutionPlan
    from blaze_tpu_torch.ops.sort import SortExec
    from blaze_tpu_torch.schema import Schema
    arr = _strings(11, 1500)
    tbl = pa.table({"s": arr, "v": np.arange(1500) % 50})
    batches = tbl.to_batches(max_chunksize=400)

    class Source(ExecutionPlan):
        @property
        def schema(self):
            return Schema.from_arrow(tbl.schema)

        def execute(self, partition):
            for rb in batches:
                yield TBatch.from_arrow(rb, device=CPU)

    specs = [(0, descending, not descending), (1, False, True)]
    got = [b.to_arrow() for b in SortExec(
        Source(), [(BoundReference(i), d, nf) for i, d, nf in specs],
        fetch=100).execute(0)]
    jsrc = MemoryScanExec(JSchema.from_arrow(tbl.schema),
                          [[JBatch.from_arrow(rb) for rb in batches]])
    want = [b.compact().to_arrow() for b in JSort(
        jsrc, [(JRef(i), d, nf) for i, d, nf in specs],
        fetch=100).execute(0)]
    g = pa.Table.from_batches(got)
    w = pa.Table.from_batches([b for b in want if b.num_rows])
    assert g.num_rows == 100
    assert g.column("s").to_pylist() == w.column("s").to_pylist()
    assert g.column("v").to_pylist() == w.column("v").to_pylist()
