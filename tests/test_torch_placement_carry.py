"""Placement into the carry's own table (blaze_tpu_torch/kernels/
hash_update.py `place_in_carry`, plain version on the CPU) and the key-limb
table the port's hash carry keeps (parallel/stage.py `HashAggCarry.limbs`):

  * `place_in_carry`'s plain version places exactly as the JAX package's
    Pallas kernel in interpret mode, from a row mask instead of a pending
    list, and claims into the `used` flags and limb table it is handed;
  * through consecutive `hash_agg_step`s, an overflow and a `rehash_carry`,
    the carry stays bit-identical to the JAX package's scatter lane, its
    `limbs` equal `encode_limbs(keys, key_valid)` where used and zero
    elsewhere, and an overflowing step leaves the carry it was given
    untouched."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu import config as jconf
from blaze_tpu.kernels import hash_update as JHU
from blaze_tpu.parallel import stage as JS
from blaze_tpu_torch import interop
from blaze_tpu_torch.kernels import hash_update as THU
from blaze_tpu_torch.parallel import stage as TS

from test_torch_placement import _operands

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _jax_scatter_lane():
    jconf.conf.set("auron.tpu.kernels.pallas", "off")
    yield
    jconf.conf.unset("auron.tpu.kernels.pallas")


@pytest.mark.parametrize("n,S,L,load,rounds", [
    (64, 128, 3, 0.0, 16),      # empty table
    (256, 512, 6, 0.3, 16),     # two int64 keys, load < 1
    (512, 256, 6, 0.95, 4),     # overflowing: most rows stay unplaced
    (300, 1024, 4, 0.5, 1),     # a single round
    (4096, 8192, 6, 0.4, 16),   # a main-path-shaped batch, scaled down
])
def test_place_in_carry_matches_pallas_interpret(n, S, L, load, rounds):
    h, limbs, pend0, npend, used0, tab0 = _operands(
        n, n, S, L, load, dup_keys=max(4, n // 3))
    want_p, want_w = JHU.placement(
        *[jnp.asarray(a) for a in (h, limbs, pend0)], jnp.asarray(npend[0]),
        jnp.asarray(used0), jnp.asarray(tab0), rounds, interpret=True)
    want_p, want_w = np.asarray(want_p), np.asarray(want_w)
    mask = np.zeros(n, bool)
    mask[pend0[:npend[0]]] = True
    used = torch.from_numpy(used0.astype(bool))
    tab = torch.from_numpy(tab0.copy())
    before = THU.placement_launches
    placed, wslot, unplaced = THU.place_in_carry(
        torch.from_numpy(h).long(), torch.from_numpy(limbs),
        torch.from_numpy(mask), used, tab, rounds)
    assert THU.placement_launches == before  # the CPU takes the plain one
    np.testing.assert_array_equal(placed.numpy(), want_p)
    np.testing.assert_array_equal(wslot.numpy(), want_w)
    assert int(unplaced) == int((mask & (want_p == S)).sum())
    # the claims went into the table handed in, and nowhere else
    won = np.flatnonzero(want_w < S)
    want_used = used0.astype(bool).copy()
    want_used[want_w[won]] = True
    want_tab = tab0.copy()
    want_tab[:, want_w[won]] = limbs[:, won]
    np.testing.assert_array_equal(used.numpy(), want_used)
    np.testing.assert_array_equal(tab.numpy(), want_tab)


def test_empty_batch_places_nothing():
    used = torch.zeros(16, dtype=torch.bool)
    tab = torch.zeros(3, 16, dtype=torch.int32)
    placed, wslot, unplaced = THU.place_in_carry(
        torch.zeros(0, dtype=torch.int64),
        torch.zeros(3, 0, dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool), used, tab, 16)
    assert placed.shape == wslot.shape == (0,) and int(unplaced) == 0
    assert not used.any() and not tab.any()


KINDS = ["sum", "min", "max", "count"]
ACC_DTYPES = (np.float64, np.float64, np.float64, np.int64)


def _batch(rng, n, distinct):
    keys = [(rng.integers(0, distinct, n).astype(np.int64),
             rng.random(n) > 0.1),
            (rng.integers(-3, 4, n).astype(np.int32), rng.random(n) > 0.05)]
    vals = rng.random(n) * 100
    av = rng.random(n) > 0.2
    cnt = rng.integers(0, 5, n).astype(np.int64)
    specs = [("sum", vals, av), ("min", vals, av), ("max", vals, av),
             ("count", cnt, av)]
    return keys, specs, rng.random(n) > 0.2


def _leaves(jc):
    return {"keys": [np.asarray(a) for a in jc.keys],
            "key_valid": [np.asarray(a) for a in jc.key_valid],
            "accs": [np.asarray(a) for a in jc.accs],
            "acc_valid": [np.asarray(a) for a in jc.acc_valid],
            "used": np.asarray(jc.used)}


def _same(a, b):
    for field in interop.CARRY_FIELDS:
        xs, ys = a[field], b[field]
        if field == "used":
            xs, ys = [xs], [ys]
        for x, y in zip(xs, ys):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


def _check_limbs(carry):
    """limbs == encode_limbs(keys, key_valid) on used slots, 0 elsewhere."""
    want = THU.encode_limbs(list(zip(carry.keys, carry.key_valid)))
    want = want * carry.used.to(torch.int32)
    assert carry.limbs.dtype == torch.int32
    assert carry.limbs.shape == (want.shape[0], carry.used.shape[0])
    assert torch.equal(carry.limbs, want)
    assert not carry.limbs[:, ~carry.used].any()


def _snapshot(carry):
    return [t.clone() for t in (*carry.keys, *carry.key_valid, *carry.accs,
                                *carry.acc_valid, carry.used, carry.limbs)]


def test_carry_limbs_through_steps_overflow_and_rehash():
    rng = np.random.default_rng(17)
    S, n = 256, 200
    jc = JS.init_hash_carry([jnp.int64, jnp.int32], KINDS,
                            [jnp.dtype(d) for d in ACC_DTYPES], S)
    tc = TS.init_hash_carry([torch.int64, torch.int32], KINDS,
                            [torch.from_numpy(np.zeros(1, d)).dtype
                             for d in ACC_DTYPES], S, CPU)
    assert tc.limbs.shape == (3 + 2, S) and not tc.limbs.any()
    overflowed = grown = 0
    for step in range(8):
        keys, specs, mask = _batch(rng, n, distinct=60 + 40 * step)
        jn, jovf, jng = JS.hash_agg_step(
            jc, [(jnp.asarray(d), jnp.asarray(v)) for d, v in keys],
            [(k, jnp.asarray(d), jnp.asarray(v)) for k, d, v in specs],
            jnp.asarray(mask), lane="scatter")
        before = _snapshot(tc)
        tn, tovf, tng = TS.hash_agg_step(
            tc, [(torch.from_numpy(d), torch.from_numpy(v))
                 for d, v in keys],
            [(k, torch.from_numpy(d), torch.from_numpy(v))
             for k, d, v in specs], torch.from_numpy(mask))
        assert int(jovf) == tovf and int(jng) == int(tng)
        # a step never writes into the carry it was given
        assert all(torch.equal(a, b) for a, b in zip(before, _snapshot(tc)))
        if tovf:
            overflowed += 1
            assert tn is tc  # the given carry comes back unchanged
            jg, jgo, _ = JS.rehash_carry(jc, KINDS, 4 * S, lane="scatter")
            tg, tgo, _ = TS.rehash_carry(tc, KINDS, 4 * S)
            assert int(jgo) == tgo == 0
            S *= 4
            grown += 1
            jc, tc = jg, tg
            _same(interop.carry_to_numpy(tc), _leaves(jc))
            _check_limbs(tc)
            continue
        jc, tc = jn, tn
        _same(interop.carry_to_numpy(tc), _leaves(jc))
        _check_limbs(tc)
    assert overflowed >= 1 and grown >= 1 and int(tc.used.sum()) > 256
    # the carry brought across from the JAX leaves derives the same limbs
    back = interop.carry_from_numpy(_leaves(jc), CPU)
    assert torch.equal(back.limbs, tc.limbs)


# ---------------------------------------------------------------------------
# atomic placement in place (rollback) and the stage loop's fold step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,L,load,rounds", [
    (64, 128, 3, 0.0, 16),
    (256, 2048, 6, 0.3, 16),
    (1000, 4096, 4, 0.25, 16),
    (4096, 32768, 6, 0.3, 16),
])
def test_rollback_matches_pallas_interpret_without_overflow(n, S, L, load,
                                                            rounds):
    """Where nothing overflows, `rollback` changes nothing: the plain
    version still places exactly as the interpret-mode Pallas kernel."""
    h, limbs, pend0, npend, used0, tab0 = _operands(
        n, n, S, L, load, dup_keys=max(4, n // 3))
    want_p, want_w = JHU.placement(
        *[jnp.asarray(a) for a in (h, limbs, pend0)], jnp.asarray(npend[0]),
        jnp.asarray(used0), jnp.asarray(tab0), rounds, interpret=True)
    mask = np.zeros(n, bool)
    mask[pend0[:npend[0]]] = True
    used = torch.from_numpy(used0.astype(bool))
    tab = torch.from_numpy(tab0.copy())
    placed, wslot, unplaced = THU.place_in_carry(
        torch.from_numpy(h).long(), torch.from_numpy(limbs),
        torch.from_numpy(mask), used, tab, rounds, rollback=True)
    assert int(unplaced) == 0
    np.testing.assert_array_equal(placed.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(wslot.numpy(), np.asarray(want_w))
    won = np.flatnonzero(np.asarray(want_w) < S)
    assert used.numpy()[np.asarray(want_w)[won]].all()


@pytest.mark.parametrize("n,S,L,load,rounds", [
    (512, 256, 6, 0.95, 4),     # most rows stay unplaced
    (300, 1024, 4, 0.5, 1),     # a single round
    (64, 64, 3, 0.0, 1),        # an empty table, one round
])
def test_rollback_on_overflow_leaves_table_as_it_was(n, S, L, load, rounds):
    h, limbs, pend0, npend, used0, tab0 = _operands(
        n, n, S, L, load, dup_keys=max(4, n // 3))
    mask = np.zeros(n, bool)
    mask[pend0[:npend[0]]] = True
    # the carry's invariant: an unused slot holds zero limbs
    tab0 = tab0 * used0[None, :].astype(np.int32)
    used = torch.from_numpy(used0.astype(bool))
    tab = torch.from_numpy(tab0.copy())
    args = (torch.from_numpy(h).long(), torch.from_numpy(limbs),
            torch.from_numpy(mask))
    # without rollback the same call claims slots and leaves rows unplaced
    u2, t2 = used.clone(), tab.clone()
    _p, w_keep, left = THU.place_in_carry(*args, u2, t2, rounds)
    assert int(left) > 0 and bool((w_keep < S).any())
    placed, wslot, unplaced = THU.place_in_carry(*args, used, tab, rounds,
                                                 rollback=True)
    assert int(unplaced) == int(left)
    assert torch.equal(used, torch.from_numpy(used0.astype(bool)))
    assert torch.equal(tab, torch.from_numpy(tab0))
    assert bool((placed == S).all()) and bool((wslot == S).all())


def _fold_batch(rng, n, distinct):
    keys, specs, mask = _batch(rng, n, distinct)
    return ([(torch.from_numpy(d), torch.from_numpy(v)) for d, v in keys],
            [(k, torch.from_numpy(d), torch.from_numpy(v))
             for k, d, v in specs], torch.from_numpy(mask))


def test_fold_step_matches_hash_agg_step():
    """The in-place fold step leaves the carry `hash_agg_step` returns, bit
    for bit, through overflows (the carry stays as it was) and a rehash."""
    rng = np.random.default_rng(23)
    S, n = 256, 200
    dts = [torch.from_numpy(np.zeros(1, d)).dtype for d in ACC_DTYPES]
    staged = TS.init_hash_carry([torch.int64, torch.int32], KINDS, dts, S,
                                CPU)
    folded = TS.init_hash_carry([torch.int64, torch.int32], KINDS, dts, S,
                                CPU)
    overflowed = 0
    for step in range(8):
        keys, specs, mask = _fold_batch(rng, n, 60 + 40 * step)
        new, ovf, _ng = TS.hash_agg_step(staged, keys, specs, mask)
        hit = TS.fold_step(folded, keys, specs, mask)
        assert hit.shape == (1,) and bool(hit) == (ovf > 0)
        if ovf:
            overflowed += 1
            S *= 4
            staged, _o, _ = TS.rehash_carry(staged, KINDS, S)
            folded, _o, _ = TS.rehash_carry(folded, KINDS, S)
        else:
            staged = new
        _same(interop.carry_to_numpy(folded), interop.carry_to_numpy(staged))
        assert torch.equal(folded.limbs, staged.limbs)
    assert overflowed >= 1


def test_fold_step_gated_off_changes_nothing():
    """A batch whose rows are all gated off (the loop's `live` after an
    overflow: mask & ~ovf_seen) leaves every bit of the carry, including a
    -0.0 sum in slot 0, and reports no overflow."""
    rng = np.random.default_rng(29)
    dts = [torch.from_numpy(np.zeros(1, d)).dtype for d in ACC_DTYPES]
    carry = TS.init_hash_carry([torch.int64, torch.int32], KINDS, dts, 512,
                               CPU)
    keys, specs, mask = _fold_batch(rng, 300, 80)
    assert not bool(TS.fold_step(carry, keys, specs, mask))
    carry.accs[0][0] = -0.0
    before = _snapshot(carry)
    ovf_seen = torch.ones(1, dtype=torch.bool)
    keys, specs, mask = _fold_batch(rng, 300, 400)
    hit = TS.fold_step(carry, keys, specs, mask & ~ovf_seen)
    assert not bool(hit)
    after = _snapshot(carry)
    assert all(a.dtype == b.dtype and
               a.numpy().tobytes() == b.numpy().tobytes()
               for a, b in zip(before, after))


def test_reset_hash_carry_restores_init():
    rng = np.random.default_rng(31)
    dts = [torch.from_numpy(np.zeros(1, d)).dtype for d in ACC_DTYPES]
    carry = TS.init_hash_carry([torch.int64, torch.int32], KINDS, dts, 256,
                               CPU)
    fresh = _snapshot(carry)
    keys, specs, mask = _fold_batch(rng, 200, 50)
    TS.fold_step(carry, keys, specs, mask)
    assert bool(carry.used.any())
    TS.reset_hash_carry(carry, KINDS)
    assert all(torch.equal(a, b) for a, b in zip(fresh, _snapshot(carry)))
