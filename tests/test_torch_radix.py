"""Port radix partition (blaze_tpu_torch/kernels/radix.py, plain version
on the CPU) against the JAX Pallas kernel in interpret mode and a stable
numpy argsort: exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import radix as JR
from blaze_tpu_torch.kernels import radix as TR


@pytest.mark.parametrize("n,P,capacity", [
    (1, 1, 8), (777, 9, 1000), (2048, 16, 2048), (3000, 16, 100),
    (1500, 200, 1500)])
def test_partition_ranks_match_pallas_interpret(n, P, capacity):
    rng = np.random.default_rng(n + P)
    # some pids out of range on both sides: clamped to [0, P], P is parked
    pid = rng.integers(-2, P + 3, n).astype(np.int32)
    want = JR.partition_ranks(jnp.asarray(pid), P, capacity, interpret=True)
    got = TR.partition_ranks(torch.from_numpy(pid), P, capacity)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,n_parts", [(1, 3), (777, 9), (4096, 16),
                                       (5000, 200)])
def test_partition_order_matches_jax_and_stable_argsort(n, n_parts):
    rng = np.random.default_rng(n)
    pids = rng.integers(0, n_parts, n).astype(np.int32)
    order, starts, ends = TR.partition_order(torch.from_numpy(pids), n_parts)
    ref = np.argsort(pids, kind="stable")
    np.testing.assert_array_equal(order.numpy(), ref)
    j_order, j_starts, j_ends = JR.partition_order(pids, n_parts,
                                                   interpret=True)
    np.testing.assert_array_equal(order.numpy(), j_order)
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_array_equal(ends, j_ends)
    np.testing.assert_array_equal(
        starts, np.searchsorted(pids[ref], np.arange(n_parts), "left"))


def test_partition_order_empty_and_launch_free_on_cpu():
    order, starts, ends = TR.partition_order(
        torch.zeros(0, dtype=torch.int32), 3)
    assert order.shape == (0,) and not ends.any() and not starts.any()
    TR.partition_ranks(torch.zeros(64, dtype=torch.int32), 4, 64)
    assert TR.partition_launches == 0  # no kernel runs on the CPU
