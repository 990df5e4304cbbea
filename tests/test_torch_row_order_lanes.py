"""Float sums in row order on the port's two table lanes and its window,
on the CPU, against the JAX package and a sequential loop.

  * parallel/stage.py `scatter_accumulate` (the hash lane's accumulators,
    behind `fold_step`, `hash_agg_step`, `rehash_carry` and the scatter
    dense lane) adds a float `sum` into a non-zero carry in row order,
    over several batches: bit for bit the JAX package's
    `scatter_accumulate` (`.at[g].add(..., mode="drop")`, row order on its
    CPU) and a loop that adds each live row to its slot's carry, a null
    or masked row as +0.0.  Cases: dropped rows (slot S), masked rows,
    null values, -0.0 (also in the carry), NaN and +-inf, float32 and
    float64, in place and into new tensors;
  * `fold_step` and `hash_agg_step`, now one insert body, give the same
    carry bit for bit over several batches into a non-zero float carry,
    and an overflowing batch leaves the carry as it was in both
    (test_torch_placement_carry.py holds the staged carry to the JAX
    package's `hash_agg_step`);
  * the window's float running sums (ops/window.py `_segmented_cumsum`,
    kernels/sort.py `segmented_running_sum`) equal a per-partition loop
    from +0.0 bit for bit, a partition whose first value is -0.0
    included, and the running and whole-partition sums of `WindowExec`
    equal that loop read at each row's frame end, and the JAX package's
    `WindowExec` within REL.

On the card the same functions run csrc/segment_sum.cu; `chip_smoke.py`
holds it to these CPU results.  Tolerance: none (bits equal; a NaN equals
a NaN), except against the JAX `WindowExec`: |a - b| <= 1e-9 max(1, |a|,
|b|), as tests/test_torch_window.py (its `jnp.cumsum` is not row order).
"""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu import config as jconf
from blaze_tpu.parallel import stage as JS
from blaze_tpu_torch import interop
from blaze_tpu_torch.kernels import sort as K
from blaze_tpu_torch.ops import window as TW
from blaze_tpu_torch.parallel import stage as TS

import test_torch_window as W

CPU = torch.device("cpu")
SEED = 18


@pytest.fixture(autouse=True)
def _jax_scatter_lane():
    jconf.conf.set("auron.tpu.kernels.pallas", "off")
    yield
    jconf.conf.unset("auron.tpu.kernels.pallas")


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    view = {4: np.int32, 8: np.int64}[want.dtype.itemsize]
    assert np.array_equal(got[~nan].view(view), want[~nan].view(view))


def _values(rng, n, dtype, specials):
    v = (rng.standard_normal(n) * 10.0 ** rng.integers(-4, 7, n)).astype(
        dtype)
    v[rng.random(n) < 0.05] = -0.0
    if specials:
        at = rng.choice(n, size=9, replace=False)
        v[at[:3]] = np.nan
        v[at[3:6]] = np.inf
        v[at[6:]] = -np.inf
    return v


def _loop(carry, g, v, take):
    """Each live row (slot < S) added to its slot in row order, from the
    carry; a row not taken adds +0.0."""
    out = carry.copy()
    zero = out.dtype.type(0.0)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(len(g)):
            if g[i] < len(out):
                out[g[i]] = out[g[i]] + (v[i] if take[i] else zero)
    return out


LANE_CASES = {
    # name: (dropped rows, masked rows, null values, NaN and +-inf)
    "plain": (False, False, False, False),
    "dropped": (True, False, False, False),
    "masked and null": (False, True, True, False),
    "all, with nan and infinities": (True, True, True, True),
}


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(LANE_CASES))
def test_scatter_accumulate_float_sums_equal_jax(case, dtype, inplace):
    dropped, masked, nulls, specials = LANE_CASES[case]
    rng = np.random.default_rng(SEED)
    S, n = 64, 1500
    carry = (rng.standard_normal(S) * 100).astype(dtype)
    carry[::5] = -0.0
    cvalid = rng.random(S) < 0.5
    j_acc, j_av = jnp.asarray(carry), jnp.asarray(cvalid)
    t_acc, t_av = torch.from_numpy(carry.copy()), torch.from_numpy(
        cvalid.copy())
    want = carry
    for _batch in range(3):
        g = rng.integers(0, S, n).astype(np.int32)
        if dropped:
            g[rng.random(n) < 0.2] = S
        v = _values(rng, n, dtype, specials)
        vv = rng.random(n) > 0.25 if nulls else np.ones(n, bool)
        mask = rng.random(n) > 0.25 if masked else np.ones(n, bool)
        (ja,), (jv,) = JS.scatter_accumulate(
            jnp.asarray(g), [("sum", jnp.asarray(v), jnp.asarray(vv))],
            jnp.asarray(mask), [j_acc], [j_av])
        (ta,), (tv,) = TS.scatter_accumulate(
            torch.from_numpy(g), [("sum", torch.from_numpy(v),
                                   torch.from_numpy(vv))],
            torch.from_numpy(mask), [t_acc], [t_av], inplace=inplace)
        want = _loop(want, g, v, vv & mask)
        _same_bits(np.asarray(ja), want)
        _same_bits(ta.numpy(), want)
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert (ta is t_acc) == inplace
        j_acc, j_av, t_acc, t_av = ja, jv, ta, tv


def test_segment_sum_into_leaves_untouched_slots_and_adds_plus_zero():
    """-0.0 + (+0.0) is +0.0: a live null row turns a -0.0 carry into
    +0.0, as JAX's `jnp.where(cv, v, 0)` does; a dropped row changes no
    bit, and a slot with no rows keeps -0.0."""
    acc = torch.tensor([-0.0, -0.0, -0.0, 5.0], dtype=torch.float64)
    v = torch.tensor([7.0, -0.0, 3.0, 1.0], dtype=torch.float64)
    g = torch.tensor([0, 1, 4, 3])
    valid = torch.tensor([False, True, True, True])
    K.segment_sum_into(acc, v, g, valid)
    assert acc.tolist() == [0.0, -0.0, -0.0, 6.0]
    assert np.signbit(acc.numpy()).tolist() == [False, True, True, False]


# ---------------------------------------------------------------------------
# one insert body: fold_step and hash_agg_step
# ---------------------------------------------------------------------------

def _keys_batch(rng, n, distinct, dtype):
    pool = rng.integers(-2**40, 2**40, distinct)
    k = pool[rng.integers(0, distinct, n)]
    kv = rng.random(n) > 0.05
    keys = [(torch.from_numpy(k), torch.from_numpy(kv))]
    v = _values(rng, n, dtype, specials=False)
    vv = rng.random(n) > 0.2
    specs = [("sum", torch.from_numpy(v), torch.from_numpy(vv)),
             ("count", torch.from_numpy(np.ones(n, np.int64)),
              torch.from_numpy(vv))]
    return keys, specs, torch.from_numpy(rng.random(n) > 0.1)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fold_step_and_hash_agg_step_are_one_body(dtype):
    """Three batches into a carry holding non-zero float sums, then one
    that overflows the table: both steps give the same carry bit for bit,
    and the overflow leaves it as it was (the staged step hands back the
    carry it was given)."""
    rng = np.random.default_rng(SEED + 1)
    S, n = 512, 800
    kinds = ["sum", "count"]
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    staged = TS.init_hash_carry([torch.int64], kinds, [tdt, torch.int64], S,
                                CPU)
    keys, specs, mask = _keys_batch(rng, n, 30, dtype)
    staged, ovf, _ = TS.hash_agg_step(staged, keys, specs, mask)
    assert ovf == 0
    folded = TS.HashAggCarry(*(tuple(t.clone() for t in f)
                               if isinstance(f, tuple) else f.clone()
                               for f in staged))
    for step, distinct in enumerate((20, 25, 30, 700)):
        keys, specs, mask = _keys_batch(rng, n, distinct, dtype)
        before = [t.clone() for t in (*folded.accs, *folded.keys,
                                      folded.used, folded.limbs)]
        new, ovf, _ = TS.hash_agg_step(staged, keys, specs, mask)
        hit = TS.fold_step(folded, keys, specs, mask)
        assert bool(hit) == (ovf > 0)
        if step == 3:
            assert ovf > 0 and new is staged
            after = [t for t in (*folded.accs, *folded.keys, folded.used,
                                 folded.limbs)]
            assert all(a.numpy().tobytes() == b.numpy().tobytes()
                       for a, b in zip(before, after))
        else:
            assert ovf == 0
            staged = new
        got = interop.carry_to_numpy(folded)
        want = interop.carry_to_numpy(staged)
        for field in interop.CARRY_FIELDS:
            xs, ys = got[field], want[field]
            if field == "used":
                xs, ys = [xs], [ys]
            for x, y in zip(xs, ys):
                assert x.tobytes() == y.tobytes(), field
    assert np.any(got["accs"][0] != 0)


# ---------------------------------------------------------------------------
# the window's running float sums
# ---------------------------------------------------------------------------

def _partition_loop(v, starts):
    """Each row's sum from +0.0 of its partition's values up to it."""
    out = np.empty_like(v)
    with np.errstate(invalid="ignore", over="ignore"):
        for i in range(len(v)):
            acc = v.dtype.type(0.0) if i == 0 or starts[i] != starts[i - 1] \
                else out[i - 1]
            out[i] = acc + v[i]
    return out


RUN_CASES = {
    # name: (rows, mean partition length, NaN and +-inf)
    "short partitions": (3000, 3, False),
    "mixed partitions": (20_000, 150, False),
    "one partition": (8000, 0, False),
    "nan and infinities": (5000, 40, True),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_segmented_cumsum_is_the_partition_loop(case, dtype):
    n, mean, specials = RUN_CASES[case]
    rng = np.random.default_rng(SEED + 2)
    v = _values(rng, n, dtype, specials)
    head = rng.random(n) < (1.0 / mean if mean else 0.0)
    head[0] = True
    # a partition that starts at -0.0 starts its sum at +0.0
    v[np.flatnonzero(head)[::4]] = -0.0
    starts = np.maximum.accumulate(np.where(head, np.arange(n), 0))
    got = TW._segmented_cumsum(torch.from_numpy(v),
                               torch.from_numpy(starts)).numpy()
    want = _partition_loop(v, starts)
    _same_bits(got, want)
    assert not np.signbit(got[head & (v == 0)]).any()
    if not specials and mean:
        # the global cumsum minus base, the JAX package's method, cancels
        # and differs: the test tells the two apart
        total = np.cumsum(v)
        base = np.where(starts > 0, total[np.maximum(starts - 1, 0)], 0.0)
        assert not np.array_equal((total - base).astype(dtype), want)


def test_integer_running_sums_stay_exact():
    v = torch.tensor([5, 3, -7, 2, 1], dtype=torch.int64)
    starts = torch.tensor([0, 0, 2, 2, 4])
    got = TW._segmented_cumsum(v, starts)
    assert got.dtype == torch.int64 and got.tolist() == [5, 8, -7, -5, 1]


@pytest.fixture
def window_confs():
    """The window tests' settings: the port on the CPU, a JAX memory
    manager."""
    from blaze_tpu.memory import MemManager
    from blaze_tpu_torch import config as tconf
    MemManager.init(4 << 30)
    tconf.conf.set(tconf.TORCH_DEVICE.key, "cpu")
    yield
    tconf.conf.unset(tconf.TORCH_DEVICE.key)


@pytest.mark.parametrize("case", ["running aggs", "whole aggs"])
def test_window_float_sums_are_the_partition_loop(case, window_confs):
    """WindowExec's float sum over x (nulls as +0.0) in each row's frame:
    the partition loop read at the frame's last row, bit for bit; and the
    JAX WindowExec within REL."""
    part, order, desc, _ = W.CASES[case]
    table = W._table(SEED, 900, 9, part, order, desc)
    _op, got = W._run("torch", case, table, 900)
    _jop, want = W._run("jax", case, table, 900)
    W._assert_same(got, want)
    x = table.column("x").combine_chunks()
    v = x.fill_null(0.0).to_numpy(zero_copy_only=False)
    rb = table.combine_chunks().to_batches()[0]
    g = rb.column(W.G)
    gkey = np.asarray(g.fill_null(-1).to_numpy(zero_copy_only=False))
    gnull = ~np.asarray(g.is_valid())
    new_part = np.ones(len(v), bool)
    new_part[1:] = (gkey[1:] != gkey[:-1]) | (gnull[1:] != gnull[:-1])
    starts = np.maximum.accumulate(np.where(new_part, np.arange(len(v)), 0))
    loop = _partition_loop(v, starts)
    o = np.asarray(rb.column(W.O).to_numpy(zero_copy_only=False))
    if case == "running aggs":
        # RANGE frame: ties of the order key share the frame end
        tie_end = np.ones(len(v), bool)
        tie_end[:-1] = new_part[1:] | (o[1:] != o[:-1])
    else:
        tie_end = np.ones(len(v), bool)
        tie_end[:-1] = new_part[1:]
    end = np.minimum.accumulate(
        np.where(tie_end, np.arange(len(v)), len(v))[::-1])[::-1]
    sums = got.column("sum_x").fill_null(0.0).to_numpy(
        zero_copy_only=False)
    valid = np.asarray(got.column("sum_x").is_valid())
    _same_bits(sums, np.where(valid, loop[end], 0.0))


# ---------------------------------------------------------------------------
# the generic engine: every segment one run of ids
# ---------------------------------------------------------------------------

def _one_run_each(gids, S):
    """Whether each id in [0, S) covers one stretch of consecutive rows:
    the contract of `segment_sum(..., contiguous=True)`, which the card's
    kernel relies on (a second run of an id would lose the first's
    sum)."""
    g = np.asarray(gids)
    live = np.flatnonzero((g >= 0) & (g < S))
    if not len(live):
        return True
    ids = g[live]
    first = np.full(S, len(g))
    last = np.full(S, -1)
    np.minimum.at(first, ids, live)
    np.maximum.at(last, ids, live)
    used = last >= 0
    return bool(np.array_equal(np.bincount(ids, minlength=S)[used],
                               (last - first + 1)[used]))


@pytest.mark.parametrize("mode", ["partial", "complete"])
@pytest.mark.parametrize("keys", [[], [0]])
def test_engine_float_sums_come_in_one_run_per_group(mode, keys,
                                                     window_confs,
                                                     monkeypatch):
    """AggExec over filtered batches (the filter's rows stay in the batch,
    masked): every `segment_sum` the engine marks contiguous holds each
    group's rows in one run, a global aggregation's too, and the results
    equal the JAX package's AggExec as tests/test_torch_agg_engine.py
    holds them.  A global sum over one batch is bit for bit its surviving
    rows added in row order from +0.0."""
    import test_torch_agg_engine as A
    calls = []
    real = K.segment_sum

    def checked(values, gids, num_segments, valid=None, contiguous=False):
        if contiguous:
            calls.append(_one_run_each(gids.numpy(), num_segments))
        return real(values, gids, num_segments, valid, contiguous)
    monkeypatch.setattr(K, "segment_sum", checked)
    batches = []
    for b in A._raw_batches(np.random.default_rng(SEED), 1, 1024):
        x = b.column(2)
        finite = pc.if_else(pc.is_nan(x), pa.scalar(1.5), x)
        batches.append(b.set_column(2, "x", finite))
    # batches of 512: the filter's output (about 800 of 1,024 rows) passes
    # the coalescer with its holes, as a full batch does at 32,768
    confs = {"auron.batch.size": 512}
    A._set_both(confs)
    try:
        t, _tm, _jm = A._both(batches, keys, [("sum", [2])], mode,
                              filtered=True)
    finally:
        A._unset_both(confs)
    assert calls and all(calls)
    if keys:
        return
    b = batches[0]
    take = np.asarray(b.column(4)) & np.asarray(b.column(2).is_valid())
    acc = np.float64(0.0)
    for x in np.asarray(b.column(2).fill_null(0.0))[take]:
        acc = acc + x
    _same_bits(t.column(0).to_numpy(), np.array([acc]))
