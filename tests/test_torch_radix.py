"""Port radix partition (blaze_tpu_torch/kernels/radix.py, plain version
on the CPU) against the JAX Pallas kernel in interpret mode and a stable
numpy argsort: exact."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from blaze_tpu.kernels import radix as JR
from blaze_tpu_torch.kernels import radix as TR


@pytest.mark.parametrize("n,P,capacity", [
    (1, 1, 8), (777, 9, 1000), (2048, 16, 2048), (3000, 16, 100),
    (1500, 200, 1500),
    # one row short of, at, and past the CUDA kernel's 4096-row tile, and
    # past two tiles; P = 1; capacity below the counts
    (4095, 16, 4095), (4096, 16, 4096), (4097, 16, 4097), (8193, 16, 8193),
    (5000, 1, 6000), (8193, 3, 1000)])
def test_partition_ranks_match_pallas_interpret(n, P, capacity):
    rng = np.random.default_rng(n + P)
    # some pids out of range on both sides: clamped to [0, P], P is parked
    pid = rng.integers(-2, P + 3, n).astype(np.int32)
    want = JR.partition_ranks(jnp.asarray(pid), P, capacity, interpret=True)
    got = TR.partition_ranks(torch.from_numpy(pid), P, capacity)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _column(kind, n, P, rng):
    """A pid column of one kind: every row in one partition, every row
    parked (at P and above), every pid negative (partition 0), or runs of
    one pid across the CUDA kernel's warp (32-row steps) and tile (4096
    rows) edges."""
    if kind == "one partition":
        return np.full(n, P // 2, np.int32)
    if kind == "all parked":
        return rng.integers(P, P + 3, n).astype(np.int32)
    if kind == "negative":
        return rng.integers(-5, 0, n).astype(np.int32)
    return ((np.arange(n) + 17) // 31 % (P + 1)).astype(np.int32)


@pytest.mark.parametrize("kind", ["one partition", "all parked", "negative",
                                  "runs"])
@pytest.mark.parametrize("n", [4097, 8193])
def test_partition_ranks_edge_columns_match_pallas_interpret(kind, n):
    P, capacity = 5, 3000
    pid = _column(kind, n, P, np.random.default_rng(n))
    want = JR.partition_ranks(jnp.asarray(pid), P, capacity, interpret=True)
    got = TR.partition_ranks(torch.from_numpy(pid), P, capacity)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n,n_parts", [(1, 3), (777, 9), (4096, 16),
                                       (5000, 200), (4095, 16), (4097, 16),
                                       (8193, 16), (8193, 1)])
def test_partition_order_matches_jax_and_stable_argsort(n, n_parts):
    rng = np.random.default_rng(n)
    pids = rng.integers(0, n_parts, n).astype(np.int32)
    order, starts, ends = TR.partition_order(torch.from_numpy(pids), n_parts)
    assert isinstance(order, np.ndarray) and order.dtype == np.int64
    ref = np.argsort(pids, kind="stable")
    np.testing.assert_array_equal(order, ref)
    j_order, j_starts, j_ends = JR.partition_order(pids, n_parts,
                                                   interpret=True)
    np.testing.assert_array_equal(order, j_order)
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_array_equal(ends, j_ends)
    np.testing.assert_array_equal(
        starts, np.searchsorted(pids[ref], np.arange(n_parts), "left"))


@pytest.mark.parametrize("n,n_parts", [(1, 3), (3000, 9), (4097, 16),
                                       (8193, 200)])
def test_partition_order_out_of_range_pids_match_jax(n, n_parts):
    rng = np.random.default_rng(n + n_parts)
    pids = rng.integers(-3, n_parts + 3, n).astype(np.int32)
    got = TR.partition_order(torch.from_numpy(pids), n_parts)
    want = JR.partition_order(pids, n_parts, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # parked rows (pid >= n_parts) leave the bucket in `order`, after the
    # real rows; negative pids count as partition 0
    bucket = max(1024, 1 << (n - 1).bit_length())
    parked = int((pids >= n_parts).sum())
    real = n - parked
    assert (got[0][real:] == bucket).all() and (got[0][:real] < n).all()
    assert got[2][-1] == real and got[2][0] == int((pids <= 0).sum())


def test_partition_order_plain_is_the_cpu_route():
    pids = np.random.default_rng(5).integers(0, 7, 3000).astype(np.int32)
    t = torch.from_numpy(pids)
    for a, b in zip(TR.partition_order(t, 7), TR.partition_order_plain(t, 7)):
        np.testing.assert_array_equal(a, b)


def test_scratch_bookkeeping_clears_nothing_between_calls():
    """The host's share of the CUDA kernel's scratch: a multi-tile call
    takes the parity of the totals it adds into, and the next one the
    other; a one-tile call touches neither; the counts matrix grows only
    when too small, and the totals are never zeroed again."""
    sc = object.__new__(TR._Scratch)
    sc.state = torch.zeros(8, dtype=torch.int32)
    sc.agg = torch.empty(0, dtype=torch.int32)
    sc.parity = 0
    agg, parity = sc.take(3, 17)
    assert parity == 0 and agg.numel() == 51
    assert sc.take(1, 17)[1] == 0 and sc.parity == 1
    sc.state.fill_(7)
    again, parity = sc.take(2, 5)
    assert parity == 1 and again is agg  # not regrown
    assert sc.take(2, 5)[1] == 0
    assert sc.take(4, 17)[0].numel() == 68
    assert (sc.state == 7).all()


def test_concurrent_calls_launch_in_the_order_they_took_the_parity(
        monkeypatch):
    """Threads on one stream share its scratch: each multi-tile call must
    launch with the other parity than the call launched just before it on
    that scratch (whose launch 2 zeroed that totals buffer), however the
    threads interleave; another stream keeps a scratch of its own.  The C
    entry is replaced by one that records its launches."""
    from blaze_tpu_torch.kernels import build
    launched = []  # (stream, state pointer, parity) in launch order
    stream_of_thread = {}

    def fake_partition(pid, part, slot, order, counts, state, agg, n, P,
                       capacity, sentinel, parity, stream):
        launched.append((stream, state, parity))
        return 0

    fns = {"blaze_radix_partition": fake_partition,
           "blaze_radix_tile_rows": lambda: 4096,
           "blaze_radix_state_cells": lambda: 8}
    monkeypatch.setattr(build, "bound", lambda lib, name: fns[name])
    monkeypatch.setattr(build, "stream_of",
                        lambda dev: stream_of_thread[threading.get_ident()])
    take = TR._Scratch.take
    jitter = random.Random(3)

    def slow_take(self, tiles, bins):
        out = take(self, tiles, bins)
        time.sleep(jitter.random() * 2e-4)  # let another thread in
        return out

    monkeypatch.setattr(TR._Scratch, "take", slow_take)
    monkeypatch.setattr(TR, "_scratch", {})
    monkeypatch.setattr(TR, "partition_launches", 0)
    monkeypatch.setattr(TR, "kernel_launches", {"upsweep": 0,
                                                "downsweep": 0})
    pid = torch.zeros(5000, dtype=torch.int32)  # two tiles

    def worker(stream):
        stream_of_thread[threading.get_ident()] = stream
        for _ in range(30):
            TR._launch(pid, 3, 5000, 5000, None, None,
                       torch.empty(5000, dtype=torch.int32),
                       torch.empty(3, dtype=torch.int32))

    threads = [threading.Thread(target=worker, args=(7 + 2 * (i % 2),))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(launched) == 180 == TR.kernel_launches["upsweep"]
    assert len(TR._scratch) == 2
    by_state = {}
    for stream, state, parity in launched:
        by_state.setdefault((stream, state), []).append(parity)
    assert len(by_state) == 2
    for parities in by_state.values():
        assert parities == [i % 2 for i in range(90)]


def test_partition_order_empty_and_launch_free_on_cpu():
    order, starts, ends = TR.partition_order(
        torch.zeros(0, dtype=torch.int32), 3)
    assert order.shape == (0,) and not ends.any() and not starts.any()
    TR.partition_ranks(torch.zeros(64, dtype=torch.int32), 4, 64)
    TR.partition_order(torch.zeros(64, dtype=torch.int32), 4)
    assert TR.partition_launches == 0  # no kernel runs on the CPU
    assert TR.kernel_launches == {"upsweep": 0, "downsweep": 0}
