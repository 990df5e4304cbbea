"""Port hash placement (blaze_tpu_torch/kernels/hash_update.py, plain
version on the CPU) against the JAX package's Pallas kernel in interpret
mode, below and above table capacity and up to n = 4096: `placed` and
`wslot` must be exact.  tests/test_torch_hash_agg.py holds whole steps
against the JAX scatter lane, n = 4096 included."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import hash_update as JHU
from blaze_tpu_torch.kernels import hash_update as THU


def _operands(seed, n, S, L, load, dup_keys):
    """Random placement operands: a table at `load`, rows whose limbs
    repeat (duplicates within the batch) and partly equal stored keys."""
    rng = np.random.default_rng(seed)
    used0 = (rng.random(S) < load).astype(np.int32)
    tab0 = (rng.integers(-3, 3, (L, S)) * used0).astype(np.int32)
    keys = rng.integers(-3, 3, (L, dup_keys)).astype(np.int32)
    pick = rng.integers(0, dup_keys, n)
    limbs = np.ascontiguousarray(keys[:, pick])
    stored = np.flatnonzero(used0)
    if len(stored):
        # a quarter of the rows carry a key that sits in the table
        from_tab = rng.random(n) < 0.25
        src = stored[rng.integers(0, len(stored), n)]
        limbs[:, from_tab] = tab0[:, src[from_tab]]
    h = rng.integers(0, S, n).astype(np.int32)
    mask = rng.random(n) < 0.85
    pend = np.flatnonzero(mask).astype(np.int32)
    pend0 = np.full(n, n, np.int32)
    pend0[:len(pend)] = pend
    npend = np.array([len(pend)], np.int32)
    return h, limbs, pend0, npend, used0, tab0


@pytest.mark.parametrize("n,S,L,load,rounds", [
    (64, 128, 3, 0.0, 16),      # empty table
    (256, 512, 6, 0.3, 16),     # two int64 keys, load < 1
    (512, 1024, 2, 0.6, 16),    # one int32 key
    (512, 256, 6, 0.95, 4),     # overflowing: most rows stay unplaced
    (300, 1024, 4, 0.5, 1),     # a single round
    (4096, 8192, 6, 0.4, 16),   # a main-path-shaped batch, scaled down
])
def test_placement_matches_pallas_interpret(n, S, L, load, rounds):
    for seed in range(2):
        ops = _operands(seed, n, S, L, load, dup_keys=max(4, n // 3))
        want_p, want_w = JHU.placement(
            *[jnp.asarray(a) for a in ops[:3]], jnp.asarray(ops[3][0]),
            *[jnp.asarray(a) for a in ops[4:]], rounds, interpret=True)
        got_p, got_w = THU.placement_plain(
            *[torch.from_numpy(a) for a in ops], rounds)
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
        if load > 0.9:
            assert int((got_p[torch.from_numpy(ops[2][:ops[3][0]]).long()]
                        == S).sum()) > 0


def test_placement_routes_cpu_tensors_to_plain():
    ops = [torch.from_numpy(a) for a in _operands(3, 128, 256, 3, 0.4, 20)]
    h, limbs = ops[:2]
    mask, used, tab = THU._carry_operands(*ops[2:])
    got = THU.place_in_carry(h, limbs, mask, used.clone(), tab.clone(), 16)
    want = THU.place_in_carry_plain(h, limbs, mask, used.clone(),
                                    tab.clone(), 16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(
        got[:2], THU.placement_plain(*ops, 16)))
    assert THU.placement_launches == 0  # no kernel runs on the CPU


def test_limb_encoding_matches_jax():
    rng = np.random.default_rng(5)
    n = 100
    cols = [(rng.integers(-2**62, 2**62, n), rng.random(n) > 0.2),
            (rng.integers(-2**31, 2**31, n).astype(np.int32),
             rng.random(n) > 0.2),
            (rng.random(n) < 0.5, np.ones(n, bool))]
    want = JHU.encode_limbs([(jnp.asarray(d), jnp.asarray(v))
                             for d, v in cols])
    got = THU.encode_limbs([(torch.from_numpy(d), torch.from_numpy(v))
                            for d, v in cols])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert [THU.limbs_per_column(torch.from_numpy(d).dtype)
            for d, _ in cols] == [3, 2, 2]
