"""One batched copy each way (blaze_tpu_torch/batch.py `_stage_columns`,
`ColumnBatch.from_arrow`, `ColumnBatch.to_arrow`): the tensors of the
batched placement equal the JAX package's placed arrays and the old
per-column padding (values, validity, dtypes; decimals as unscaled int64,
bools as bool), for ints, floats, bools, dates, timestamps, decimals,
nulls and utf8 beside them; every column is a view of the batch's one
buffer; the H2D and D2H bytes equal the JAX package's `note_h2d` and
`note_d2h` for the same batch (its device route: `host_resident` patched
to False).

Tolerance: exact."""

import datetime as dt
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from blaze_tpu_torch import config as tconf
from blaze_tpu_torch.batch import ColumnBatch, DeviceColumn
from blaze_tpu_torch.bridge import device_stats


@pytest.fixture(autouse=True)
def confs():
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


@pytest.fixture
def jax_device_route():
    import blaze_tpu.bridge.placement as P
    saved = P.host_resident
    P.host_resident = lambda: False
    yield
    P.host_resident = saved


def _batch(n, seed, nulls):
    rng = np.random.default_rng(seed)

    def mask():
        return (rng.random(n) < 0.2) if nulls else None

    days = rng.integers(-800, 20000, n).astype("int32")
    return pa.record_batch({
        "i8": pa.array(rng.integers(-128, 127, n).astype("int8"),
                       mask=mask()),
        "i16": pa.array(rng.integers(-999, 999, n).astype("int16")),
        "i32": pa.array(rng.integers(-2**31, 2**31 - 1, n).astype("int32"),
                        mask=mask()),
        "i64": pa.array(rng.integers(-2**62, 2**62, n), mask=mask()),
        "f32": pa.array(rng.random(n).astype("float32")),
        "f64": pa.array(rng.standard_normal(n), mask=mask()),
        "b": pa.array(rng.random(n) < 0.5, mask=mask()),
        "d": pa.array(days, pa.date32()),
        "ts": pa.array(rng.integers(0, 2**40, n), pa.timestamp("us")),
        "dec": pa.array([None if nulls and i % 5 == 0 else
                         decimal.Decimal(int(v)).scaleb(-2)
                         for i, v in enumerate(rng.integers(-10**8, 10**8,
                                                            n))],
                        pa.decimal128(9, 2)),
        "s": pa.array([None if nulls and i % 3 == 0 else f"s{i}"
                       for i in range(n)]),
    })


def _old_column(arr, dtype, cap):
    """The pre-batched placement of one column: values and validity
    padded to `cap` one at a time."""
    from blaze_tpu_torch.batch import (_arrow_fixed_values, _decimal_store,
                                       _unpack_validity)
    from blaze_tpu_torch.schema import TypeId
    values = _arrow_fixed_values(arr, dtype)
    if dtype.id == TypeId.DECIMAL:
        values = values.astype(_decimal_store(dtype), copy=False)
    data = np.zeros(cap, dtype=dtype.np_dtype())
    data[:len(values)] = values
    v = np.zeros(cap, dtype=bool)
    v[:len(values)] = _unpack_validity(arr)
    return data, v


CASES = [(1, 0, False), (100, 1, True), (129, 2, False), (3000, 3, True)]


@pytest.mark.parametrize("n,seed,nulls", CASES)
def test_batched_put_equals_per_column_and_the_jax_arrays(
        jax_device_route, n, seed, nulls):
    from blaze_tpu.batch import ColumnBatch as JBatch
    rb = _batch(n, seed, nulls)
    got = ColumnBatch.from_arrow(rb)
    want = JBatch.from_arrow(rb)
    assert got.num_rows == want.num_rows == n
    assert got.capacity == want.capacity
    bases = set()
    for i, (g, w, f) in enumerate(zip(got.columns, want.columns,
                                      got.schema)):
        if not f.data_type.is_fixed_width:
            assert g.array.equals(w.array)
            continue
        assert isinstance(g, DeviceColumn)
        gd, gv = g.data.numpy(), g.validity.numpy()
        wd, wv = np.asarray(w.data), np.asarray(w.validity)
        assert gd.dtype == wd.dtype, f.name
        assert gv.dtype == wv.dtype == np.bool_
        assert np.array_equal(gd, wd) and np.array_equal(gv, wv), f.name
        od, ov = _old_column(rb.column(i), f.data_type, got.capacity)
        assert gd.dtype == od.dtype and np.array_equal(gd, od), f.name
        assert np.array_equal(gv, ov), f.name
        bases.add(g.data.untyped_storage().data_ptr())
        bases.add(g.validity.untyped_storage().data_ptr())
    assert len(bases) == 1, "every column is a view of one buffer"
    assert got.columns[6].data.dtype == torch.bool
    assert got.columns[9].data.dtype == torch.int64  # unscaled decimal
    assert got.to_arrow().equals(rb)


@pytest.mark.parametrize("n,seed,nulls", CASES)
def test_transfer_bytes_equal_the_jax_counters(jax_device_route, n, seed,
                                               nulls):
    from blaze_tpu.batch import ColumnBatch as JBatch
    from blaze_tpu.bridge import xla_stats
    rb = _batch(n, seed, nulls)
    sel = np.random.default_rng(seed).random(n) < 0.5

    jb = xla_stats.snapshot()
    jbatch = JBatch.from_arrow(rb)
    jput = xla_stats.delta(jb)
    import jax.numpy as jnp
    jsel = jnp.asarray(np.pad(sel, (0, jbatch.capacity - n)))
    jb = xla_stats.snapshot()
    jout = jbatch.with_selection(jsel).to_arrow()
    jget = xla_stats.delta(jb)

    tb = device_stats.snapshot()
    tbatch = ColumnBatch.from_arrow(rb)
    tput = device_stats.delta(tb)
    tsel = torch.from_numpy(np.pad(sel, (0, tbatch.capacity - n)))
    tb = device_stats.snapshot()
    tout = tbatch.with_selection(tsel).to_arrow()
    tget = device_stats.delta(tb)

    assert tout.equals(jout)
    assert tput["h2d_bytes"] == jput["h2d_bytes"] > 0
    assert tput["h2d_transfers"] == jput["h2d_transfers"] == 1
    assert tget["d2h_bytes"] == jget["d2h_bytes"] > 0
    assert tget["d2h_transfers"] == jget["d2h_transfers"] == 1


def test_a_batch_of_host_columns_places_nothing():
    rb = pa.record_batch({"s": pa.array(["a", None, "c"])})
    before = device_stats.snapshot()
    cb = ColumnBatch.from_arrow(rb)
    d = device_stats.delta(before)
    assert d["h2d_bytes"] == 0 and d["h2d_transfers"] == 0
    assert cb.to_arrow().equals(rb)


def test_no_fixed_width_column_takes_no_stage_call_on_the_card():
    """The card's branch: an empty column list returns before the stager
    (no pinned block, no event, no stream wait)."""
    from blaze_tpu_torch import batch as B

    class Recording:
        calls = 0

        def stage(self, nbytes, pack):
            Recording.calls += 1
            raise AssertionError("staged a batch with no column")
    before = device_stats.snapshot()
    assert B._stage_columns([], torch.device("cuda"), Recording()) == []
    d = device_stats.delta(before)
    assert Recording.calls == 0
    assert d["h2d_transfers"] == 0 and d["h2d_bytes"] == 0


def test_one_column_from_arrow_is_one_copy():
    arr = pa.array([1, None, 3], pa.int64())
    from blaze_tpu_torch.schema import DataType, TypeId
    before = device_stats.snapshot()
    c = DeviceColumn.from_arrow(arr, DataType(TypeId.INT64), 128,
                                torch.device("cpu"))
    d = device_stats.delta(before)
    assert d["h2d_transfers"] == 1 and d["h2d_bytes"] == 128 * 9
    assert c.data[:3].tolist() == [1, 0, 3]
    assert c.validity[:4].tolist() == [True, False, True, False]


def test_dates_and_timestamps_keep_their_values():
    rb = pa.record_batch({
        "d": pa.array([dt.date(1969, 12, 31), None], pa.date32()),
        "ts": pa.array([dt.datetime(1960, 1, 1, 0, 0, 1), None],
                       pa.timestamp("ms"))})
    cb = ColumnBatch.from_arrow(rb)
    assert cb.columns[0].data[:2].tolist() == [-1, 0]
    assert cb.columns[1].data[0].item() == -315619199000000
    assert cb.to_arrow().column(0).equals(rb.column(0))
