"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the three CUDA sources of blaze_tpu_torch/csrc, built with nvcc
     for sm_90a into build/kernels/ (one nvcc per source, started
     together);
  3. kernel parity and times at the main paths' shapes: each kernel entry
     (placement, radix's two entries, window step) against its plain
     PyTorch version on the same CUDA tensors (outputs must be exactly
     equal), timed with CUDA events (median of 25 after warm-up), beside
     the plain version, a one-call PyTorch yardstick where one exists, and
     a bound from the bytes moved; the device time per call and launches
     per call from torch.profiler; radix also at its edge cases (tile
     edges, one partition, all parked, P = 12288, the rollup's one-tile
     shape), with its launches per route (1 for one tile, 2 beyond) and
     the shuffle writer's grouping (device operations, syncs and host
     time per call); the host cost of the wrappers' stream lookup; first,
     one cooperative placement launch captured into a CUDA graph and
     replayed twice, exact both times;
  4. the device stage loop's fold at q01's reduce shape as CUDA graph
     replays against the same fold on the CPU (integer columns exact,
     float sums within 1e-9), its host launches and placement kernels
     under torch.profiler, and one fold graph replayed alone: its device
     operations, the host time of a replay against issuing the same body
     eagerly, and its device time;
  5. the two main paths, each as TaskDefinition bytes through the port's
     runtime on the card over the same SF10 data (2,875,140 store_returns
     rows in 4 parquet files; 4 map tasks, 16 reduce tasks), each with the
     stage loop under auto (the loop) and off (staged), each run checked
     against a pyarrow group-by and the two modes against each other, with
     every kernel's launch count set to 0 just before the path and read
     just after it, and the loop's route checked (16 loop tasks on each
     reduce stage, q01's fallbacks equal to its partial skips, the
     rollup's map side outside the loop):
       q01     TPC-DS q01's inner two-stage query (hash lane: placement
               and radix kernels);
       rollup  the store-by-day returns rollup (dense window-table lane on
               the map side, one window-step launch per map batch; hash
               lane on the reduce side);
  6. where the time goes: each path again under torch.profiler in both
     modes, with the card's busy share of the wall, the top kernels and
     host ops, the host launches (cudaLaunch* and cudaGraphLaunch apart)
     and graph replays, and a check that each of the port's device kernels
     ran on the card exactly as often as its wrapper counted;
  7. regrow: q01 under auto with a 4,096-slot table, every reduce task
     regrowing in the loop, one graph per table size, equal to the oracle;
  8. crc32c: the port's built CRC32C (csrc/crc32c.cu, host code) against
     its plain version on 1 B, 4 KiB and 1 MiB seeded payloads and the
     check value CRC32C("123456789") = 0xE3069283, and a frame written on
     the card verified through the plain version;
  9. q01 branches (itest/q01_branches.py): q01's map and reduce stages,
     the reduce output re-exchanged by store, then avg by store through
     the generic aggregation engine with `avg_return * 1.2` (stage 3a)
     and the top returns through a sort with fetch (stage 3b), each into
     one partition, and a sort with fetch and a limit over each (stages
     4a, 4b), under auto and off, each against the pyarrow oracle
     (averages and totals within 1e-9, keys and order exact up to ties);
     fails unless every generic-engine batch of stage 3a ran on the card,
     every sort of 1024 rows or more ran on the device, and the kernels
     ran; its shuffle frames verified through the plain CRC32C; one run
     profiled (busy share, cudaLaunch* per stage, placement and radix on
     the card as often as their wrappers counted);
 10. q01 full (stage DAG): date_dim, store, customer and store_returns at
     SF10 from their seeds, written with write_parquet_splits(..., 4), and
     TPC-DS q01 (itest/queries.py) through the port's DagScheduler
     (plan/stages.py) with 16 exchange partitions: 6 stages, broadcast
     joins to date_dim, the TN stores and customer on the device probe, a
     sort-merge join, under auto and off, each held to the pandas oracle
     (the 100 c_customer_id exact and in order); fails unless no batch
     and no join probe ran off the card, the device probe calls equal the
     probe batches, and placement and radix launched; one run profiled,
     each stage under its own profiler with device activity only (stage
     walls, tasks and cudaLaunch* per stage, busy share, top device ops
     and CUDA runtime calls, placement and radix on the card as often as
     counted, one searchsorted kernel per device probe call, peak
     memory); and a
     lineage probe (one byte of a committed map output flipped: the
     result equal, exactly one map task run twice);
 11. q06, q42 and q03 (stage DAG): store_sales at SF10 in 4 files, item
     and date_dim in one file each, from their seeds, and TPC-DS q06
     (BASELINE config #2) through the DagScheduler with 4 exchange
     partitions under auto, off and auto profiled, then q42 and q03 under
     auto, and q42 once more with auron.tpu.fused.dictDevice.maxSlots
     64; each with a fresh plan (its broadcast builds run again), held
     to its pandas oracle (rows in order; sums within compare_frames'
     1e-6); fails unless 3 stages, no batch and no join probe off the
     card, the device probe calls equal the probe batches, radix launched
     (and placement on q06's count by store), q06's average by category
     ran on the generic engine on the card, q42's and q03's partial and
     final stages ran on the dict-device lane (q03's brands doubling past
     16 codes), and the maxSlots run fell back to the generic engine in
     both; the profiled run as in phase 10;
 12. q17 and q18 (stage DAG, BASELINE config #3): catalog_sales,
     store_returns (4 files each), customer, customer_demographics,
     customer_address and store (one file each) at SF10 from their seeds,
     store_sales and item from phase 11; q18 (ROLLUP through an Expand,
     an IN list, a shuffled hash join to customer) with 4 exchange
     partitions under auto, off and auto profiled, and its plan cut above
     the sort over all five grouping sets; q17 (two shuffled hash joins
     on two-column keys, the second over the first's output exchanged
     again) on the generator's tables (empty, as the oracle) and on
     itest/q17_q18.py q17_linked's copy; each with a fresh plan, held to
     its pandas frame (rows in order, the all-sets run as a set; floats
     within 1e-9 relative); fails unless the reference's stage count
     (5, 7), no batch and no join probe off the card, device probe calls
     equal to probe batches, radix launched, the Expand's batches on the
     card, every grouping id with null keys where the ROLLUP puts them,
     and both of q17's shuffled hash joins probing on the card; prints
     stage walls, tasks, peak memory, data and oracle seconds, joined
     and expanded rows; the profiled run as in phase 10;
 13. q95 and windows (stage DAG, BASELINE config #4 and the window
     operator): web_sales and web_returns at SF10 from their seeds (4
     files each), the other tables from phases 11 and 12; q95 (EXISTS as
     a shuffled semi join with a `!=` filter, NOT EXISTS as a shuffled
     anti join, web_sales hashed whole into the semi join's exchange)
     under auto, off and auto profiled; q12, q20, q98 (a whole-partition
     window sum), q51 (running window sums joined by a full outer
     sort-merge join) and q67 (rank() over ROLLUP totals) under auto, and
     q51 profiled; 4 exchange partitions, a fresh plan each, held to the
     pandas frame in the plan's order (floats within 1e-9 relative);
     fails unless the reference's stage count, no batch and no join probe
     off the card, device probe calls equal to probe batches, radix
     launched and every grouping it made exact against its plain
     version, every eager placement (q95's per-order sums under off)
     exact against its plain version, q95's semi and anti joins each
     removing rows and keeping some, and every WindowExec batch on the
     card; prints stage walls, tasks, peak memory, data and oracle
     seconds, q95's rows after each join, and for the profiled runs the
     busy share, cudaLaunch* per stage and the cumulative scans' device
     time;
 14. q19, q07 and gq1 (stage DAG): promotion (300 rows) and
     web_clickstreams (500,000 sessions with a list of 0-5 clicked items
     each, 4 files) at SF10 from their seeds, the other tables from
     phases 11 and 12; q19 (two broadcasts, a shuffled hash join to
     customer, two more broadcasts), q07 (four broadcasts, four averages
     by item id) and gq1 (posexplode of the list on the host, renamed,
     a broadcast to item) under auto, q07 under off, and each profiled;
     4 exchange partitions, a fresh plan each, held to the pandas frame
     in order (floats within 1e-9 relative); fails unless the
     reference's stage count, no batch and no join probe off the card,
     device probe calls equal to probe batches, radix launched and every
     grouping exact against its plain version, every eager placement
     exact against its plain version, every join keeping rows and gq1's
     generator emitting one row per click; prints stage walls, tasks,
     peak memory, data and oracle seconds, io_bytes and the rows out of
     each join and generator;
 15. breadth (the single-task local mode, Union, Cast and the
     nested-loop join): catalog_returns (4 files), reason and time_dim at
     SF10 from their seeds, the other tables from phases 10-13; the
     local-mode query (the first of q84 and q41 whose scans fit the
     default auron.tpu.dag.singleTaskBytes, 64 MiB, at SF10) under the
     default (one local task) and with the key at 0 (staged), the same
     rows in the same order both ways; full q01 as one local task (the
     key one byte above its scan bytes, which exceed the default); q05
     (a Union of the three channels' sales and returns), q93 (Casts in a
     left join's measures) and q90 (a ratio of two global counts through
     a nested-loop join) under the default, staged at SF10; q05 once more
     profiled stage by stage; 4 exchange partitions, a fresh plan each,
     held to the pandas frame as a set (floats within 1e-9 relative);
     fails unless each run's exec_mode, no batch and no join probe off
     the card, device probe calls equal to probe batches, every radix
     grouping exact against its plain version as many times as the
     wrapper counted, every eager placement exact against its plain
     version (q93's are not recorded, as q51's), q01's local run launching
     radix and placement, and q90's nested-loop join emitting rows;
     prints each run's wall, exec_mode, stages, scan bytes, io_bytes and
     rows after each join;
 16. the dict-device lane through dictionary growth on the card: a
     partial aggregation over 6 batches whose brands grow from 10 to 260,
     re-laid out 4 times, against the same fold on the CPU (keys and
     integers exact, float sums within 1e-9);
 17. the paths' profile summary (with io_bytes per stage of every path:
     every task prunes its scans' columns and collapses Filter->Project
     chains, as the JAX package does) and the kernel table as JSON lines,
     the card's name and power limit, and the result line.

The script imports nothing of the JAX package.  It needs a CUDA card: it
exits non-zero where torch sees none.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
SCALE = 10.0                # TPC-DS scale factor of the main path
N_FILES = N_MAPS = 4
N_REDUCES = 16
N = 32768                   # auron.batch.size
S = 262144                  # auron.tpu.agg.table.capacity
ROUNDS = 16                 # hash_agg_step probe rounds


T0 = time.perf_counter()


def phase(name):
    print(f"== [{time.perf_counter() - T0:.1f} s] {name}", flush=True)


def time_ms(fn, warmup=3, iters=25):
    """Median milliseconds of one call, each timed with CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


#: the radix wrapper's device kernels, by the name of its launch counter
RADIX_KERNELS = {"upsweep": "::upsweep_kernel(",
                 "downsweep": "::downsweep_kernel<"}
#: the device kernels (csrc/, in anonymous namespaces) behind each wrapper
KERNEL_NAMES = {
    "hash_placement": ("::place_kernel(",),
    "radix_partition": tuple(RADIX_KERNELS.values()),
    "window_step": ("::window_step_kernel(",),
}
PROFILED_CALLS = 20


def _on_card(e):
    """Whether a profiler event is work the card ran: a kernel, copy or
    memset.  A named range (torch.profiler.record_function, as
    itest/q01.py `run_stages` and plan/stages.py's DagScheduler open one
    per stage) also appears on the device's timeline and is left out."""
    import torch
    from blaze_tpu_torch.itest.q01 import STAGE_RANGE
    from blaze_tpu_torch.plan.stages import STAGE_RANGE as DAG_RANGE
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith((STAGE_RANGE, DAG_RANGE)))


def _device_events(prof, names):
    """(device microseconds, launches) of the kernels named `names` in a
    profile (copies and memsets left out; "" names every kernel)."""
    import torch
    us, count = 0.0, 0
    for e in prof.events():
        if (_on_card(e)
                and not e.name.startswith(("Memcpy", "Memset"))
                and any(k in e.name for k in names)):
            us += e.time_range.elapsed_us()
            count += 1
    return us, count


def device_us_of(fn, names, calls=PROFILED_CALLS):
    """Device time per call of the kernels `names` over `calls` calls of
    fn under torch.profiler, and their launches per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = _device_events(prof, names)
    return us / calls, count / calls


def host_us_of(fn, calls=200):
    """Host microseconds per call of fn, without waiting for the card."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def environment():
    phase("environment")
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    from blaze_tpu_torch.kernels import build
    out = subprocess.run([build.nvcc_path(), "--version"],
                         capture_output=True, text=True, check=True).stdout
    print("nvcc:", out.strip().splitlines()[-1])
    return smi


def build_kernels():
    phase("build")
    from blaze_tpu_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build_all()
    for name, r in report.items():
        print(f"built {name} in {r['seconds']:.2f} s")
    print(f"build wall {time.perf_counter() - t0:.2f} s "
          f"(into {build.BUILD_DIR})")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _key_batch(gen, pool, fresh, n, dev):
    """n rows of (customer, store) int64 keys on `dev`: half drawn from
    `pool` (keys already in the table), half from `fresh`, 2% NULL
    customers, 90% of rows selected."""
    import torch
    take_old = torch.rand(n, generator=gen) < 0.5
    old = pool[torch.randint(0, pool.shape[0], (n,), generator=gen)]
    new = fresh[torch.randint(0, fresh.shape[0], (n,), generator=gen)]
    keys = torch.where(take_old[:, None], old, new)
    cvalid = torch.rand(n, generator=gen) >= 0.02
    mask = torch.rand(n, generator=gen) < 0.9
    return ([(keys[:, 0].to(dev), cvalid.to(dev)),
             (keys[:, 1].to(dev), torch.ones(n, dtype=torch.bool,
                                             device=dev))],
            mask.to(dev))


def _placement_state(gen, dev, load):
    """The operands of `place_in_carry` for one full batch against a carry
    of S slots filled to `load` with (customer, store) keys by linear
    probing (the port's own tail, replayed through the plain placement run
    to completion): half the batch's keys are in the table, half are not.
    Returns (h, limbs, mask, used, tab) as hash_agg_step hands them over."""
    import torch
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels.hashing import hash_columns
    from blaze_tpu_torch.parallel.stage import (_hash_step_tail,
                                                init_hash_carry)

    def hashed(kc):
        cols = [(d, v, "int64") for d, v in kc]
        return hash_columns(cols, seed=42, algo="xxhash64") & (S - 1)

    fresh = torch.stack([torch.randint(1, 1_000_001, (2 * S,), generator=gen),
                         torch.randint(1, 13, (2 * S,), generator=gen)], 1)
    n_fill = int(load * S)
    ones = torch.ones(n_fill, dtype=torch.bool, device=dev)
    kc = [(fresh[:n_fill, 0].to(dev), ones), (fresh[:n_fill, 1].to(dev), ones)]
    carry = init_hash_carry([torch.int64, torch.int64], ["sum"],
                            [torch.float64], S, dev)
    used, tab = carry.used.clone(), carry.limbs.clone()
    placed, wslot, unplaced = HU.place_in_carry_plain(
        hashed(kc), HU.encode_limbs(kc), ones, used, tab, 1 << 16)
    if int(unplaced):
        raise SystemExit("placement state: the table could not be filled")
    specs = [("sum", torch.ones(n_fill, dtype=torch.float64, device=dev),
              ones)]
    carry = _hash_step_tail(carry, kc, specs, ones, placed, wslot, used, tab)
    kc, mask = _key_batch(gen, fresh[:n_fill], fresh[n_fill:], N, dev)
    return hashed(kc), HU.encode_limbs(kc), mask, carry.used, carry.limbs


def _placement_bytes(h, mask, placed, L, S_):
    """Bytes the placement must move for these inputs: each round reads,
    for every row still pending, its hash (8 B), mask byte and L key
    limbs, the probed slot's used byte and L limbs, and writes its two
    outputs; rows unplaced after the last round stay pending through every
    round."""
    import torch
    rows = torch.nonzero(mask).squeeze(1)
    p = placed[rows].long()
    hit_round = torch.where(p < S_, (p - h[rows].long()) & (S_ - 1),
                            torch.full_like(p, ROUNDS - 1))
    row_rounds = int((hit_round + 1).sum().item())
    return row_rounds * (8 + 1 + 8 * L + 1 + 8), row_rounds


def placement_cases(gen, dev):
    import torch
    from blaze_tpu_torch.kernels import hash_update as HU
    out = []
    for label, load in (("load 0.5", 0.5), ("overflowing", 0.9)):
        h, limbs, mask, used0, tab0 = _placement_state(gen, dev, load)
        used, tab = used0.clone(), tab0.clone()
        got = HU.place_in_carry(h, limbs, mask, used, tab, ROUNDS)
        ref_used, ref_tab = used0.clone(), tab0.clone()
        ref = HU.place_in_carry_plain(h, limbs, mask, ref_used, ref_tab,
                                      ROUNDS)
        torch.cuda.synchronize()
        exact = (all(torch.equal(a, b) for a, b in zip(got, ref))
                 and torch.equal(used, ref_used) and torch.equal(tab, ref_tab))
        err = max([int((a.long() - b.long()).abs().max())
                   for a, b in zip(got, ref)] +
                  [int((tab.long() - ref_tab.long()).abs().max()),
                   int((used != ref_used).sum())])
        # each call claims into fresh copies of the carry's used flags and
        # table, as hash_agg_step hands them over (the copies are timed
        # too: the step pays for them)
        ms = time_ms(lambda: HU.place_in_carry(
            h, limbs, mask, used0.clone(), tab0.clone(), ROUNDS))
        plain_ms = time_ms(lambda: HU.place_in_carry_plain(
            h, limbs, mask, used0.clone(), tab0.clone(), ROUNDS))
        dev_us, per_call = device_us_of(
            lambda: HU.place_in_carry(h, limbs, mask, used0.clone(),
                                      tab0.clone(), ROUNDS),
            KERNEL_NAMES["hash_placement"])
        nbytes, row_rounds = _placement_bytes(h, mask, got[0],
                                              limbs.shape[0], S)
        load = float(used0.float().mean())
        unplaced = int(got[2])
        print(f"placement {label}: n={N} S={S} L={limbs.shape[0]} "
              f"table load {load:.3f} pending {int(mask.sum())} unplaced "
              f"{unplaced} row-rounds {row_rounds} exact={exact} "
              f"kernel {ms:.4f} ms ({dev_us:.2f} us on the card, "
              f"{per_call:g} launches per call) plain {plain_ms:.4f} ms")
        if not exact:
            raise SystemExit(f"placement ({label}) disagrees with its "
                             f"plain version (max abs err {err})")
        out.append({"case": label, "ms": ms, "plain_ms": plain_ms,
                    "device_us": dev_us, "launches_per_call": per_call,
                    "bytes": nbytes, "err": err})
    return out


def cooperative_capture_probe(gen, dev):
    """One cooperative placement launch captured into a CUDA graph (global
    capture error mode) and replayed twice on the same table state: both
    replays must equal the plain version, which holds only if the kernel
    takes a fresh round tag from its scratch on every replay.  Then the
    stage loop's mode: an overflowing batch at the same shape with
    `rollback`, eagerly and replayed from a graph, must equal the plain
    rollback in every output and leave `used` and the limb table exactly
    as they were before the call."""
    import torch
    from blaze_tpu_torch.kernels import hash_update as HU
    phase("cooperative launch captured into a CUDA graph")
    for label, load, rollback in (("load 0.5", 0.5, False),
                                  ("overflowing, rollback", 0.9, True)):
        h, limbs, mask, used0, tab0 = _placement_state(gen, dev, load)
        sc = HU.Scratch(dev, S, ROUNDS)
        ref_used, ref_tab = used0.clone(), tab0.clone()
        ref = HU.place_in_carry_plain(h, limbs, mask, ref_used, ref_tab,
                                      ROUNDS, rollback=rollback)
        if rollback and not (int(ref[2]) > 0 and torch.equal(ref_used, used0)
                             and torch.equal(ref_tab, tab0)):
            raise SystemExit(f"placement ({label}): the plain version did "
                             f"not overflow and roll back")

        def exact_after(got, used, tab):
            torch.cuda.synchronize()
            return (all(torch.equal(a, b) for a, b in zip(got, ref))
                    and torch.equal(used, ref_used)
                    and torch.equal(tab, ref_tab))

        # eager first: loads the kernel before the capture
        used, tab = used0.clone(), tab0.clone()
        ok = exact_after(HU.place_in_carry(h, limbs, mask, used, tab, ROUNDS,
                                           rollback=rollback, scratch=sc),
                         used, tab)
        print(f"placement {label}, eager: exact={ok} unplaced "
              f"{int(ref[2])}")
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = HU.place_in_carry(h, limbs, mask, used, tab, ROUNDS,
                                    rollback=rollback, scratch=sc)
        for replay in (1, 2):
            used.copy_(used0)
            tab.copy_(tab0)
            sc.reserve(ROUNDS + 1)
            graph.replay()
            exact = exact_after(got, used, tab)
            print(f"placement {label}, replay {replay}: exact={exact} (tag "
                  f"word {int(sc.buf[0])})")
            ok = ok and exact
        del graph
        if not ok:
            raise SystemExit(f"the captured placement launch ({label}) "
                             f"disagrees with its plain version")


def _reduce_batches(n_batches, dev):
    """q01's reduce-side input (customer, store, partial sum) as batches of
    32768 rows on `dev`, from a numpy seed: ~40,000 distinct keys, 2%
    NULL customers, 1% NULL sums."""
    import numpy as np
    from blaze_tpu_torch.interop import batch_from_numpy
    from blaze_tpu_torch.plan.types import schema_from_dict
    from blaze_tpu_torch.itest import q01
    schema = schema_from_dict(q01.PARTIAL_SCHEMA_D)
    rng = np.random.default_rng(77)
    out = []
    for _ in range(n_batches):
        cust = rng.integers(1, 20_001, N)
        store = (cust * 7 + rng.integers(0, 2, N)) % 12 + 1
        amt = np.round(rng.random(N) * 1000, 2)
        cols = [(cust, rng.random(N) >= 0.02), (store, np.ones(N, bool)),
                (amt, rng.random(N) >= 0.01)]
        out.append(batch_from_numpy(schema, cols, N, dev))
    return out


def fold_graph_parity(dev):
    """The stage loop's fold at q01's reduce shape (final sum by customer
    and store, 2^18 slots, chunks of 8 over 11 batches: a full chunk on the
    8-slot graph, then 3 batches on the 4-slot graph, one slot padded), as
    CUDA graph replays on the card against the same fold
    run eagerly on the CPU with the plain placement: `used`, keys, key
    validity, limbs and sum validity exact, sums within 1e-9 relative
    (float64 atomics add in a run-dependent order).  Then the card's
    replays again under torch.profiler: host launches (cudaLaunch* and
    cudaGraphLaunch apart) and the placement kernels it ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.plan import create_plan, stage_compiler
    from blaze_tpu_torch.plan.fused import fuse_plan
    from blaze_tpu_torch.runtime import loop
    phase("stage loop: the fold graph against the same fold on the CPU, "
          "q01 reduce shape")
    n_batches = 11

    def fold(device):
        config.conf.set(config.TORCH_DEVICE.key, device)
        try:
            agg = fuse_plan(create_plan(q01.stage2_td(0, N_REDUCES)["plan"]))
            prog = stage_compiler.compile_fused_agg(agg)
            batches = _reduce_batches(n_batches, torch.device(device))
            t0 = time.perf_counter()
            carry = loop.run_partition(prog, 0, source_stream=iter(batches))
            if device == "cuda":
                torch.cuda.synchronize()
            return carry, agg.metrics.values, time.perf_counter() - t0, \
                (prog, batches)
        finally:
            config.conf.set(config.TORCH_DEVICE.key, "cuda")

    stats0 = dict(loop.graph_stats)
    cuda, m, first_s, (prog, batches) = fold("cuda")
    captured = {k: loop.graph_stats[k] - stats0[k] for k in stats0}
    cuda2, _m, second_s, _ = fold("cuda")
    cpu, _m, cpu_s, _ = fold("cpu")
    ints = ["used", "limbs"]
    exact = all(torch.equal(getattr(cuda, f).cpu(), getattr(cpu, f))
                for f in ints)
    for f in ("keys", "key_valid", "acc_valid"):
        exact = exact and all(torch.equal(a.cpu(), b) for a, b in
                              zip(getattr(cuda, f), getattr(cpu, f)))
    got, want = cuda.accs[0].cpu(), cpu.accs[0]
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
    again = torch.equal(cuda.used, cuda2.used) and all(
        torch.equal(a, b) for a, b in zip(cuda.keys, cuda2.keys))
    print(f"fold of {n_batches} batches x {N} rows into {S} slots: "
          f"{int(cuda.used.sum())} groups; integer columns exact={exact}, "
          f"sums max relative error {rel:.3e} (limit 1e-9); second run "
          f"equal={again}; counters {m}; graphs {captured}; wall "
          f"{first_s:.3f} s (with the capture), {second_s:.4f} s replayed, "
          f"{cpu_s:.3f} s on the CPU")
    if not exact or rel > 1e-9 or not again:
        raise SystemExit("the fold graph disagrees with the same fold on "
                         "the CPU")
    if (m["stage_loop_batches"] != n_batches or m["stage_loop_regrows"]
            or captured["captures"] != 2 or captured["replays"] != 2):
        raise SystemExit(f"fold: expected two captures (8 and 4 batch "
                         f"slots), two replays and no regrow: {m}, "
                         f"{captured}")
    def replays():
        before = HU.placement_launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loop.run_partition(prog, 0, source_stream=iter(batches))
            torch.cuda.synchronize()
        counted = HU.placement_launches - before
        _us, kernels = _device_events(prof, KERNEL_NAMES["hash_placement"])
        _count_on_card([prof], "fold", f"{kernels} placement kernels on "
                       f"the card where the wrapper counted {counted}",
                       kernels, counted)
        return prof, counted

    # the replays under the profiler
    prof, counted = _profiled(replays, "fold replays")
    place_us, kernels = _device_events(prof, KERNEL_NAMES["hash_placement"])
    launches = _host_launches(prof)
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if _on_card(e))
    nodes = sum(1 for e in prof.events()
                if _on_card(e))
    launch_us = sum(e.self_cpu_time_total for e in prof.key_averages()
                    if e.key.startswith("cudaGraphLaunch"))
    print(f"fold replays profiled: host cudaLaunch* {launches['kernel']}, "
          f"cudaGraphLaunch {launches['graph']} ({launch_us:.1f} us of host "
          f"time for {nodes} device operations); placement counted "
          f"{counted}, device kernels {kernels}, "
          f"{place_us / max(kernels, 1):.2f} us on the card per graph node "
          f"(live and gated-off slots); device busy {busy_us / 1e3:.3f} ms")
    replay = replay_cost(prog)
    return {"groups": int(cuda.used.sum()), "max_rel_err": rel,
            "wall_first_s": first_s, "wall_replayed_s": second_s,
            "wall_cpu_s": cpu_s, "graphs": captured,
            "host_launches": launches, "placement_kernels": kernels,
            "placement_us_per_node": place_us / max(kernels, 1),
            "device_operations": nodes, "graph_launch_host_us": launch_us,
            "device_busy_ms": busy_us / 1e3, "replay": replay}


def replay_cost(prog, replays=10):
    """The 8-slot fold graph of `prog` (left loaded with its last chunk)
    replayed on its own: device operations in one replay (profiled), and
    without the profiler the host microseconds of one `replay()` call
    (median, each on an idle card) beside the host microseconds of
    issuing the same body eagerly, and the device milliseconds of one
    replay (CUDA events over `replays`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.runtime import loop
    fold = next(f for k, f in loop._FOLDS.items()
                if k[0] == prog.fingerprint and k[2] == 8 and
                f.graph is not None)
    fold.acquire(prog)
    try:
        def once():
            fold.scratch.reserve(fold.placement_nodes *
                                 (loop.PROBE_ROUNDS + 1))
            fold.graph.replay()

        once()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            once()
            torch.cuda.synchronize()
        nodes = sum(1 for e in prof.events()
                    if _on_card(e))
        host = []
        for _ in range(replays):  # each call timed on an idle card
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            once()
            host.append((time.perf_counter() - t0) * 1e6)
        host_us = statistics.median(host)
        torch.cuda.synchronize()
        eager = []
        for _ in range(3):  # the same body issued eagerly, op by op
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fold._body(prog)
            eager.append((time.perf_counter() - t0) * 1e6)
        eager_us = statistics.median(eager)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            once()
        b.record()
        b.synchronize()
        device_ms = a.elapsed_time(b) / replays
    finally:
        fold.release()
    print(f"8-slot fold graph, replayed alone: {nodes} device operations a "
          f"replay; {host_us:.1f} us of host time per replay() call "
          f"({host_us / nodes:.3f} us a node; the same body issued eagerly "
          f"{eager_us:.1f} us), {device_ms:.4f} ms on the card per replay "
          f"(no profiler for any of these times)")
    return {"nodes": nodes, "host_us": host_us, "eager_host_us": eager_us,
            "device_ms": device_ms}


def _host_launches(prof):
    """Host calls that launched work in a profile: cudaLaunch* (kernels)
    and cudaGraphLaunch (graph replays), counted apart."""
    averages = prof.key_averages()
    return {"kernel": sum(e.count for e in averages
                          if e.key.startswith("cudaLaunch")),
            "graph": sum(e.count for e in averages
                         if e.key.startswith("cudaGraphLaunch"))}


def ops_per_call(fn, calls=PROFILED_CALLS):
    """Per call of fn under torch.profiler: device operations (kernels,
    copies and memsets), kernels alone, and host synchronisations
    (cuda*Synchronize calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def count(f, k):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                f()
            torch.cuda.synchronize()
        ops = kernels = syncs = 0
        for e in prof.events():
            if _on_card(e):
                ops += 1
                kernels += not e.name.startswith(("Memcpy", "Memset"))
            elif e.name.startswith("cuda") and "Synchronize" in e.name:
                syncs += 1
        return ops, kernels, syncs

    fn()
    torch.cuda.synchronize()
    ops, kernels, syncs = count(fn, calls)
    # the closing synchronize() is the profile's, not fn's
    syncs -= count(lambda: None, 1)[2]
    return ops / calls, kernels / calls, syncs / calls


def _radix_column(gen, kind, n, P, dev):
    """A pid column on the card: "hashed" (the writer's spark partition
    ids of (customer, store) keys), "mixed" (uniform over [-2, P + 3):
    clamped on both sides), "one partition", "all parked" or "negative"
    (every pid below 0, so partition 0)."""
    import torch
    from blaze_tpu_torch.kernels.hashing import spark_partition_ids
    if kind == "hashed":
        keys = torch.randint(1, 1_000_001, (n,), generator=gen).to(dev)
        store = torch.randint(1, 13, (n,), generator=gen).to(dev)
        ones = torch.ones(n, dtype=torch.bool, device=dev)
        return spark_partition_ids([(keys, ones), (store, ones)],
                                   ["int64", "int64"], P)
    if kind == "mixed":
        pid = torch.randint(-2, P + 3, (n,), generator=gen)
    elif kind == "one partition":
        pid = torch.full((n,), P // 2)
    elif kind == "all parked":
        pid = torch.randint(P, P + 3, (n,), generator=gen)
    else:
        pid = torch.randint(-5, 0, (n,), generator=gen)
    return pid.to(torch.int32).to(dev)


def _radix_exact(got, ref):
    import torch
    exact = all(torch.equal(a, b) for a, b in zip(got, ref))
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, ref))
    return exact, err


def _order_exact(got, ref):
    import numpy as np
    exact = all(np.array_equal(a, b) for a, b in zip(got, ref))
    err = max(int(np.abs(a - b).max()) if a.size else 0
              for a, b in zip(got, ref))
    return exact, err


#: the radix edge cases, each held exact to the plain version through both
#: entries: (label, n, P, capacity, column kind); capacity None is n
RADIX_EDGES = [
    ("n=1", 1, 16, None, "mixed"),
    ("n=4095", 4095, 16, None, "mixed"),
    ("n=4096", 4096, 16, None, "mixed"),
    ("n=4097", 4097, 16, None, "mixed"),
    ("n=8193", 8193, 16, None, "mixed"),
    ("P=1", 70_000, 1, None, "mixed"),
    ("one partition", 70_000, 16, None, "one partition"),
    ("all parked", 70_000, 16, None, "all parked"),
    ("negative pids", 8193, 16, None, "negative"),
    ("capacity below the counts", 70_000, 16, 1000, "mixed"),
    ("P=200 mixed", 290_000, 200, 1000, "mixed"),
    ("P=3000", 290_000, 3000, None, "mixed"),
    ("P=12288", 290_000, 12288, None, "mixed"),
    # the q18 and q17 writers: 4 partitions over a map task's rows
    ("P=4 q18 shape", 204_941, 4, None, "hashed"),
    ("P=4 q17 shape", 360_000, 4, None, "hashed"),
]


def radix_cases(gen, dev):
    """The radix kernel's two entries on the card.  Main case:
    `partition_ranks` over the shuffle writer's 2^19 bucket at P = 16
    (maps 1 and 2 of the q01 path emit about 290,000 rows each over 16
    reducers; the JAX package pads them to that bucket), timed beside its
    plain version and a stable argsort.  Then the writer's order-only
    entry (`partition_order`) at q01's shape (290,000 unpadded hashed
    pids), timed with its one copy to the host and its host work beside
    the plain version and a stable argsort with a bincount copied to the
    host, with its device operations, kernels, syncs and host
    microseconds per call; `partition_ranks` over the bucket at P = 200;
    the rollup's shapes (one tile); and the edge cases of RADIX_EDGES,
    q18's and q17's writer shapes (P = 4) among them.
    Every case exact against the plain version or the run fails."""
    import numpy as np
    import torch
    from blaze_tpu_torch.kernels import radix as R
    out = []
    names = KERNEL_NAMES["radix_partition"]
    real, bucket, P = 290_000, 1 << 19, 16

    def order_case(label, pid, P):
        n = pid.shape[0]
        got = R.partition_order(pid, P)
        ref = R.partition_order_plain(pid, P)
        exact, err = _order_exact(got, ref)
        # pids in range: `order` is a stable argsort of the pids
        if int(pid.min()) >= 0 and int(pid.max()) < P:
            argsorted = torch.argsort(pid, stable=True).cpu().numpy()
            exact = exact and np.array_equal(got[0], argsorted)
        dev_us, per_call = device_us_of(lambda: R.partition_order(pid, P),
                                        names)
        return {"case": f"partition_order {label}", "entry": "order",
                "n": n, "P": P, "exact": exact, "err": err,
                "device_us": dev_us,
                "launches_per_call": kernels_of(
                    lambda: R.partition_order(pid, P)),
                "profiled_launches_per_call": per_call,
                "bytes": 8 * n + 4 * P}

    def ranks_case(label, pid, P, capacity):
        got = R.partition_ranks(pid, P, capacity)
        ref = R.partition_ranks_plain(pid, P, capacity)
        torch.cuda.synchronize()
        exact, err = _radix_exact(got, ref)
        dev_us, per_call = device_us_of(
            lambda: R.partition_ranks(pid, P, capacity), names)
        return {"case": f"partition_ranks {label}", "entry": "ranks",
                "n": pid.shape[0], "P": P, "exact": exact, "err": err,
                "device_us": dev_us,
                "launches_per_call": kernels_of(
                    lambda: R.partition_ranks(pid, P, capacity)),
                "profiled_launches_per_call": per_call,
                "bytes": 16 * pid.shape[0] + 4 * P}

    def kernels_of(fn):
        """Device kernels one call of fn launched, by the wrapper's own
        counts (the profiler's per-call averages may drop an event)."""
        before = sum(R.kernel_launches.values())
        fn()
        return sum(R.kernel_launches.values()) - before

    def timed(case, fn, plain, library):
        case["ms"] = time_ms(fn)
        case["plain_ms"] = time_ms(plain)
        case["library_ms"] = time_ms(library)
        return case

    def bucket_case(P_):
        """partition_ranks over the writer's padded 2^19 bucket"""
        pid = torch.full((bucket,), P_, dtype=torch.int32, device=dev)
        pid[:real] = _radix_column(gen, "hashed", real, P_, dev)
        return timed(ranks_case(f"P={P_} bucket 2^19", pid, P_, bucket),
                     lambda: R.partition_ranks(pid, P_, bucket),
                     lambda: R.partition_ranks_plain(pid, P_, bucket),
                     lambda: torch.argsort(pid, stable=True))

    out.append(bucket_case(P))  # the main case

    # the writer's order-only entry at q01's shape
    pid = _radix_column(gen, "hashed", real, P, dev)
    writer = timed(order_case("q01 shape", pid, P),
                   lambda: R.partition_order(pid, P),
                   lambda: R.partition_order_plain(pid, P),
                   lambda: torch.cat((torch.bincount(pid, minlength=P),
                                      torch.argsort(pid, stable=True))).cpu())
    writer["host_us"] = host_us_of(lambda: R.partition_order(pid, P))
    (writer["device_ops_per_call"], writer["kernels_per_call"],
     writer["syncs_per_call"]) = ops_per_call(
        lambda: R.partition_order(pid, P))
    out.append(writer)
    print(f"radix {writer['case']}: per call {writer['device_ops_per_call']:g}"
          f" device operations ({writer['kernels_per_call']:g} kernels), "
          f"{writer['syncs_per_call']:g} syncs, {writer['host_us']:.1f} us "
          f"of host time (yardstick: argsort(stable) and bincount copied to "
          f"the host)")

    out.append(bucket_case(200))

    # the rollup's writer calls: a few thousand groups, one tile
    groups = 2190
    pid = _radix_column(gen, "hashed", groups, P, dev)
    out.append(order_case("rollup shape", pid, P))
    padded = torch.full((4096,), P, dtype=torch.int32, device=dev)
    padded[:groups] = pid
    out.append(ranks_case("rollup bucket 4096", padded, P, 4096))

    for label, n, P_, cap, kind in RADIX_EDGES:
        pid = _radix_column(gen, kind, n, P_, dev)
        out.append(ranks_case(label, pid, P_, n if cap is None else cap))
        out.append(order_case(label, pid, P_))

    for c in out:
        print(f"radix {c['case']}: n={c['n']} P={c['P']} exact={c['exact']} "
              f"{c['device_us']:.2f} us on the card, "
              f"{c['launches_per_call']:g} launches per call, bound "
              f"{c['bytes']} B" + (
                  f"; kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"library {c['library_ms']:.4f} ms"
                  if "ms" in c else ""))
    bad = [c["case"] for c in out if not c["exact"]]
    if bad:
        raise SystemExit(f"radix disagrees with its plain version: {bad}")
    routes = {}
    for c in out:
        route = "one tile" if c["n"] <= 4096 else "more tiles"
        routes.setdefault(route, set()).add(c["launches_per_call"])
    print(f"radix launches per call by route: "
          f"{ {k: sorted(v) for k, v in routes.items()} }")
    if routes.get("one tile") != {1} or routes.get("more tiles") != {2}:
        raise SystemExit(f"radix launches per call by route: {routes}")
    # the edge cases sized the kernel's scratch for P = 12288 (10.5 MB);
    # drop it, so that the paths' peak memory counts what they need
    R._scratch.clear()
    return out


def _step_case(gen, dev, label):
    """One map batch of the window-table lane: (meta, ranges, kd, kv, ad,
    av, m).  "rollup map batch": the rollup's shape (12 stores x ~457 days,
    date-ordered rows over ~21 days, ~60% filtered, float64 amounts in
    cents with ~2% NULL) with sum and count of the amount, plus a min over
    an int64 quantity and a max over the amount; "dirty amounts": the same
    with one kept amount off the cents grid (the verify fails); "one int32
    key": count(*) and the sum of an int32 by day alone; "five narrow
    keys": store as int8 and day as int16 beside int32, int64 and int16
    flags (107,172 slots), with count(*), the sum and the max of an int16
    quantity."""
    import torch
    from blaze_tpu_torch.kernels import window_table as WT
    d_lo = 2450820
    days = torch.sort(torch.randint(0, 21, (N,), generator=gen)).values
    date = (days + d_lo + 200).to(torch.int64)
    store = torch.randint(1, 13, (N,), generator=gen)
    m = torch.rand(N, generator=gen) >= 0.6
    qty = torch.randint(1, 101, (N,), generator=gen)
    qty_valid = torch.rand(N, generator=gen) >= 0.02

    def on(*ts):
        return [t.to(dev) for t in ts]

    if label == "one int32 key":
        ranges = [(d_lo, d_lo + 456)]
        specs = (WT.MxuSpec("count_star", -1, -1, -1, 0, 1, False),
                 WT.MxuSpec("sum", 0, 1, -1, 1, 1, False))
        layout = WT.plan_layout(458, [1, WT.limb_bits_for(1, 100)])
        meta = WT.MxuMeta(layout, specs, (("valid", 1), ("cents", 1)), ())
        kd, kv = on(date.to(torch.int32)), on(torch.ones(N, dtype=torch.bool))
        ad = [None] + on(qty.to(torch.int32))
        av = [None] + on(qty_valid)
        return meta, ranges, kd, kv, ad, av, m.to(dev)
    if label == "five narrow keys":
        ranges = [(1, 12), (0, 456), (0, 1), (0, 0), (0, 1)]
        specs = (WT.MxuSpec("count_star", -1, -1, -1, 0, 1, False),
                 WT.MxuSpec("sum", 0, 1, -1, 1, 1, False),
                 WT.MxuSpec("max", 0, -1, 0, 1, 1, False))
        layout = WT.plan_layout(13 * 458 * 3 * 2 * 3,
                                [1, WT.limb_bits_for(1, 100)])
        meta = WT.MxuMeta(layout, specs, (("valid", 1), ("cents", 1)),
                          ((False, 2),))
        flags = [torch.randint(0, hi + 1, (N,), generator=gen)
                 for _lo, hi in ranges[2:]]
        kd = on(store.to(torch.int8), (days + 200).to(torch.int16),
                flags[0].to(torch.int32), flags[1], flags[2].to(torch.int16))
        kv = on(torch.rand(N, generator=gen) >= 0.01,
                *[torch.ones(N, dtype=torch.bool)] * 4)
        ad = [None] + on(qty.to(torch.int16), qty.to(torch.int16))
        av = [None] + on(qty_valid, qty_valid)
        return meta, ranges, kd, kv, ad, av, m.to(dev)
    amt = torch.round(torch.rand(N, generator=gen, dtype=torch.float64)
                      * 20000) / 100
    amt_valid = torch.rand(N, generator=gen) >= 0.02
    if label == "dirty amounts":
        kept = torch.nonzero(m & amt_valid).squeeze(1)
        amt[kept[kept.shape[0] // 2]] = 1.234567
    store_valid = torch.rand(N, generator=gen) >= 0.01
    ranges = [(1, 12), (d_lo, d_lo + 456)]
    clo, chi = -1, 20001  # floor(0 * 100) - 1, ceil(200 * 100) + 1
    specs = (WT.MxuSpec("sum", 0, 1, -1, clo, 100, True),
             WT.MxuSpec("count", 0, -1, -1, 0, 1, False),
             WT.MxuSpec("min", 2, -1, 0, 1, 1, False),
             WT.MxuSpec("max", 0, -1, 1, clo, 100, True))
    layout = WT.plan_layout(13 * 458, [1, WT.limb_bits_for(clo, chi), 1])
    meta = WT.MxuMeta(layout, specs,
                      (("valid", 0), ("cents", 0), ("valid", 2)),
                      ((True, 2), (False, 3)))
    kd = on(store.to(torch.int64), date)
    kv = on(store_valid, torch.ones(N, dtype=torch.bool))
    ad = on(amt, amt, qty, amt)
    av = on(amt_valid, amt_valid, qty_valid, amt_valid)
    return meta, ranges, kd, kv, ad, av, m.to(dev)


def _step_carry(meta, dev):
    import torch
    from blaze_tpu_torch.kernels import window_table as WT
    lay = meta.layout
    return (torch.zeros(lay.sh, lay.sl * lay.n_blocks, dtype=torch.int32,
                        device=dev),
            [torch.full((lay.num_slots + 1,), WT.MM_IDENT[is_min],
                        dtype=torch.int32, device=dev)
             for is_min, _si in meta.scatter],
            torch.ones((), dtype=torch.bool, device=dev))


def _eager_step_launches(args, dev):
    """Device launches per batch of the eager formulation the step kernel
    replaced: window_step_plain's launches, with its table update (the
    plain table's launches and the add into the carry) counted as the one
    window-table launch it was; and the table's operands (gid, arrays,
    layout) as that formulation made them."""
    from blaze_tpu_torch.kernels import window_table as WT
    table_plain = WT.window_table_plain
    seen = {}

    def spy(g, arrays, layout):
        seen["args"] = (g, arrays, layout)
        return table_plain(g, arrays, layout)

    carry = _step_carry(args[0], dev)
    WT.window_table_plain = spy
    try:
        _, step = device_us_of(lambda: WT.window_step_plain(*args, carry),
                               ("",), calls=1)
    finally:
        WT.window_table_plain = table_plain
    _, table = device_us_of(lambda: table_plain(*seen["args"]), ("",),
                            calls=1)
    # the plain table and its add into the carry were one kernel launch
    return int(step - table), seen["args"]


def _table_index_add_ms(g, arrays, layout, dev):
    """A yardstick for the table update alone: the same sums, slot-major,
    as one index_add_ of the (n, nb) limb matrix, built beforehand, into
    an (S + 1, nb) table."""
    import torch
    S, nb = layout.num_slots, layout.n_blocks
    cols = [torch.ones_like(g)] if layout.presence else []
    for a, nl in zip(arrays, layout.limbs):
        for li in range(nl):
            cols.append((a >> (8 * li)) & 255)
    wmat = torch.stack(cols, 1).contiguous()
    slot = torch.where(g < S, g, S).long()
    yard = torch.zeros(S + 1, nb, dtype=torch.int32, device=dev)
    return time_ms(lambda: yard.index_add_(0, slot, wmat))


def window_step_cases(gen, dev):
    import torch
    from blaze_tpu_torch.kernels import window_table as WT
    out = []
    for label in ("rollup map batch", "dirty amounts", "one int32 key",
                  "five narrow keys"):
        args = _step_case(gen, dev, label)
        meta = args[0]
        got = WT.window_step(*args, _step_carry(meta, dev))
        ref = WT.window_step_plain(*args, _step_carry(meta, dev))
        torch.cuda.synchronize()
        ok = bool(got[2])
        if label == "dirty amounts":
            # a failed verify: the lane re-runs the partition, so only the
            # flag is compared
            exact = not ok and not bool(ref[2])
            err = int(ok != bool(ref[2]))
        else:
            exact = (ok and bool(ref[2]) and torch.equal(got[0], ref[0])
                     and all(torch.equal(a, b)
                             for a, b in zip(got[1], ref[1])))
            err = max([int((got[0].long() - ref[0].long()).abs().max())] +
                      [int((a.long() - b.long()).abs().max())
                       for a, b in zip(got[1], ref[1])] +
                      [int(ok != bool(ref[2]))])
        if not exact:
            raise SystemExit(f"window step ({label}) disagrees with its "
                             f"plain version (max abs err {err}, ok "
                             f"{ok} vs {bool(ref[2])})")
        carry_k, carry_p = _step_carry(meta, dev), _step_carry(meta, dev)
        ms = time_ms(lambda: WT.window_step(*args, carry_k))
        plain_ms = time_ms(lambda: WT.window_step_plain(*args, carry_p))
        dev_us, per_call = device_us_of(
            lambda: WT.window_step(*args, carry_k),
            KERNEL_NAMES["window_step"])
        host_us = host_us_of(lambda: WT.window_step(*args, carry_k))
        eager, table_args = _eager_step_launches(args, dev)
        index_add_ms = _table_index_add_ms(*table_args, dev)
        # each input read once; the table and the min/max accumulators
        # read and written once, the ok flag written
        inputs = {id(t): t for t in (*args[2], *args[3], *args[4],
                                     *args[5], args[6]) if t is not None}
        nbytes = (sum(t.numel() * t.element_size() for t in inputs.values())
                  + 2 * got[0].numel() * 4
                  + sum(2 * a.numel() * 4 for a in got[1]) + 1)
        lay = meta.layout
        live = int(args[6].sum())
        print(f"window step {label}: n={N} keys {len(args[1])} aggregates "
              f"{len(meta.specs)} sh={lay.sh} sl={lay.sl} limbs={lay.limbs} "
              f"kept rows {live} ok={ok} exact={exact} kernel {ms:.4f} ms "
              f"({dev_us:.2f} us on the card, {per_call:g} launches per "
              f"call, wrapper {host_us:.1f} us of host time) plain "
              f"{plain_ms:.4f} ms; the eager step it replaced: {eager} "
              f"launches; the table update alone as one index_add_ "
              f"{index_add_ms:.4f} ms")
        out.append({"case": label, "ms": ms, "plain_ms": plain_ms,
                    "device_us": dev_us, "launches_per_call": per_call,
                    "host_us": host_us, "eager_launches": eager,
                    "table_index_add_ms": index_add_ms, "bytes": nbytes,
                    "err": err})
    return out


def launch_floor(dev):
    """Device microseconds of the smallest kernel: one fill_ of 1024
    floats, the floor of any launch's time on the card."""
    import torch
    x = torch.empty(1024, device=dev)
    us, per_call = device_us_of(lambda: x.fill_(1.0), ("",))
    print(f"launch floor: one fill_ of 1024 floats {us:.2f} us on the "
          f"card ({per_call:g} launches per call)")
    return us


def stream_lookup_cost(dev):
    """Host microseconds of the two ways a wrapper finds its stream, for a
    tensor's device (which names its index)."""
    import torch
    from blaze_tpu_torch.kernels import build
    dev = torch.empty(1, device=dev).device
    public = host_us_of(lambda: torch.cuda.current_stream(dev).cuda_stream,
                        calls=10000)
    raw = host_us_of(lambda: build.stream_of(dev), calls=10000)
    empty = host_us_of(lambda: None, calls=10000)
    print(f"stream lookup: torch.cuda.current_stream(dev).cuda_stream "
          f"{public:.2f} us, build.stream_of {raw:.2f} us per call (an "
          f"empty Python call {empty:.2f} us)")
    return {"current_stream_us": public, "stream_of_us": raw,
            "empty_call_us": empty}


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

def make_data(root):
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.itest.tpcds_data import (gen_date_dim,
                                                  gen_store_returns)
    phase("data: TPC-DS store_returns at SF10")
    t0 = time.perf_counter()
    sr = gen_store_returns(SCALE)
    sr_paths, dd_path = q01.write_dataset(root, sr, gen_date_dim(SCALE),
                                          N_FILES)
    lo, hi = q01.date_sk_range(dd_path)
    print(f"generated store_returns: {sr.num_rows} rows in {N_FILES} files "
          f"({time.perf_counter() - t0:.1f} s); date_sk in [{lo}, {hi}]")
    return sr_paths, lo, hi


def _zero_launches():
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import window_table as WT
    HU.placement_launches = 0
    R.partition_launches = 0
    for k in R.kernel_launches:
        R.kernel_launches[k] = 0
    WT.window_step_launches = 0


def _read_launches():
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import window_table as WT
    return {"hash_placement": HU.placement_launches,
            "radix_partition": R.partition_launches,
            "window_step": WT.window_step_launches,
            "radix_kernels": dict(R.kernel_launches)}


def _check_on_card(res, launches, needed, path):
    for k in needed:
        if launches[k] <= 0:
            raise SystemExit(f"{path} path: kernel {k} was never launched")
    for stage in ("map", "reduce"):
        counts = res["counters"][stage]
        if counts["cpu_batches"] or not counts["cuda_batches"]:
            raise SystemExit(f"{path} path: {stage} batches not all on the "
                             f"card: {counts}")


def _loop_mode(mode):
    from blaze_tpu_torch import config
    config.conf.set(config.STAGE_DEVICE_LOOP_ENABLE.key, mode)
    print(f"{config.STAGE_DEVICE_LOOP_ENABLE.key} = {mode}")


def _sums_close(a, b, name):
    """Max relative error of float column `name` of two sorted tables
    (NULLs where the other has NULLs)."""
    import numpy as np
    got = np.asarray(a[name].fill_null(np.nan))
    want = np.asarray(b[name].fill_null(np.nan))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    max_rel = float(np.nanmax(rel)) if len(rel) else 0.0
    return np.array_equal(np.isnan(got), np.isnan(want)), max_rel


def q01_path(root, sr_paths, lo, hi, mode, label="q01"):
    """q01 with the stage loop under `mode` (auto: on the card, the loop;
    off: the staged executor), checked against the oracle.  Returns its
    launches, counters, walls and sorted output."""
    import pyarrow as pa
    import torch

    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.runtime import loop

    phase(f"main path {label}: TPC-DS q01 inner, SF10, 4 maps x 16 "
          f"reduces, stage loop {mode}")
    _loop_mode(mode)
    for opt in (config.TORCH_DEVICE, config.BATCH_SIZE,
                config.ON_DEVICE_AGG_CAPACITY,
                config.STAGE_DEVICE_LOOP_CHUNK):
        print(f"{opt.key} = {opt.get()}")
    shuffle_dir = os.path.join(root, f"shuffle_{label}_{mode}")
    os.makedirs(shuffle_dir)

    torch.cuda.reset_peak_memory_stats()
    graphs0 = dict(loop.graph_stats)
    _zero_launches()
    res = q01.run_q01(sr_paths, lo, hi, shuffle_dir, N_MAPS, N_REDUCES)
    launches = _read_launches()
    graphs = {k: loop.graph_stats[k] - graphs0[k] for k in graphs0}
    peak = torch.cuda.max_memory_allocated()

    out = pa.Table.from_batches(
        [b for bs in res["reduce_outputs"] for b in bs])
    ora = q01.oracle(sr_paths, lo, hi).select(out.column_names)
    keys = ["ctr_customer_sk", "ctr_store_sk"]
    order = [(k, "ascending") for k in keys]
    a = out.sort_by(order)
    b = ora.sort_by(order)
    rows_in = sum(pq_rows(p) for p in sr_paths)
    print(f"map stage {res['map_s']:.3f} s, reduce stage "
          f"{res['reduce_s']:.3f} s, total "
          f"{res['map_s'] + res['reduce_s']:.3f} s (host wall, each ending "
          f"in a device synchronisation)")
    print(f"rows in {rows_in}, groups out {out.num_rows} (oracle "
          f"{ora.num_rows}); shuffle bytes "
          f"{sum(o[2][-1] for o in res['shuffle'])}")
    print(f"aggregation counters per stage: {res['counters']}")
    print(f"CUDA graphs: {graphs}")
    print(f"launches on the {label} path: {launches}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")
    if a.num_rows != b.num_rows or not a.select(keys).equals(b.select(keys)):
        raise SystemExit(f"{label}: the group set differs from the oracle")
    nulls_ok, max_rel = _sums_close(a, b, "ctr_total_return")
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: float64 "
          f"atomics add in a run-dependent order)")
    if not nulls_ok or max_rel > 1e-9:
        raise SystemExit(f"{label}: sums differ from the oracle")
    _check_on_card(res, launches, ("hash_placement", "radix_partition"),
                   label)
    _check_loop(res["counters"], mode, label, map_eligible=True)
    return {"launches": launches, "counters": res["counters"],
            "graphs": graphs, "map_s": res["map_s"],
            "reduce_s": res["reduce_s"], "peak_bytes": peak, "table": a}


def _check_loop(counters, mode, label, map_eligible):
    """Under auto every reduce task folds through the loop, and a map task
    falls back exactly where its partial table overflows (q01) or never
    enters the loop (the rollup's dense map side); under off nothing
    does."""
    m, r = counters["map"], counters["reduce"]
    if mode == "off":
        bad = {k: v for st in (m, r) for k, v in st.items()
               if k.startswith("stage_loop") and v}
        if bad:
            raise SystemExit(f"{label}: stage loop counters under off: {bad}")
        return
    if r["stage_loop_tasks"] != N_REDUCES or r["stage_loop_fallback"]:
        raise SystemExit(f"{label}: {r['stage_loop_tasks']} reduce tasks "
                         f"folded in the loop, {r['stage_loop_fallback']} "
                         f"fell back (expected {N_REDUCES}, 0)")
    if map_eligible:
        if (m["stage_loop_fallback"] != m["partial_skipped"]
                or m["stage_loop_tasks"] + m["stage_loop_fallback"]
                != N_MAPS):
            raise SystemExit(f"{label}: map stage loop tasks "
                             f"{m['stage_loop_tasks']}, fallbacks "
                             f"{m['stage_loop_fallback']}, partial skips "
                             f"{m['partial_skipped']}")
    elif m["stage_loop_tasks"] or m["stage_loop_fallback"]:
        raise SystemExit(f"{label}: the dense map side entered the loop")


def rollup_path(root, sr_paths, lo, hi, mode):
    import pyarrow as pa
    import torch

    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import rollup
    from blaze_tpu_torch.runtime import loop

    phase(f"main path rollup: store-by-day returns rollup, SF10, 4 maps x "
          f"16 reduces, stage loop {mode}")
    _loop_mode(mode)
    for opt in (config.AGG_MXU_ENABLE, config.AGG_MXU_MAX_SLOTS,
                config.AGG_MXU_DECIMAL_SCALE):
        print(f"{opt.key} = {opt.get()}")
    shuffle_dir = os.path.join(root, f"shuffle_rollup_{mode}")
    os.makedirs(shuffle_dir)

    torch.cuda.reset_peak_memory_stats()
    graphs0 = dict(loop.graph_stats)
    _zero_launches()
    res = rollup.run_rollup(sr_paths, lo, hi, shuffle_dir, N_MAPS,
                            N_REDUCES)
    launches = _read_launches()
    graphs = {k: loop.graph_stats[k] - graphs0[k] for k in graphs0}
    peak = torch.cuda.max_memory_allocated()

    out = pa.Table.from_batches(
        [b for bs in res["reduce_outputs"] for b in bs])
    ora = rollup.oracle(sr_paths, lo, hi).select(out.column_names)
    keys = ["store", "d"]
    order = [(k, "ascending") for k in keys]
    a = out.sort_by(order)
    b = ora.sort_by(order)
    filtered = rollup.filtered_rows(sr_paths, lo, hi)
    counters = res["counters"]
    print(f"map stage {res['map_s']:.3f} s, reduce stage "
          f"{res['reduce_s']:.3f} s, total "
          f"{res['map_s'] + res['reduce_s']:.3f} s (host wall, each ending "
          f"in a device synchronisation)")
    print(f"rows kept by the filter {filtered}, groups out {out.num_rows} "
          f"(oracle {ora.num_rows}); shuffle bytes "
          f"{sum(o[2][-1] for o in res['shuffle'])}")
    print(f"aggregation counters per stage: {counters}")
    print(f"CUDA graphs: {graphs}")
    print(f"launches on the rollup path: {launches}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")
    if a.num_rows != b.num_rows or not a.select(keys + ["cnt"]).equals(
            b.select(keys + ["cnt"])):
        raise SystemExit("rollup path: groups or counts differ from the "
                         "oracle")
    nulls_ok, max_rel = _sums_close(a, b, "amt")
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: the reduce "
          f"side adds float64 with atomics)")
    if not nulls_ok or max_rel > 1e-9:
        raise SystemExit("rollup path: sums differ from the oracle")
    if counters["map"]["mxu_verify_fallback"]:
        raise SystemExit("rollup path: the window-table lane fell back to "
                         "the scatter dense lane")
    if counters["map"]["mxu_rows"] != filtered:
        raise SystemExit(f"rollup path: the window tables counted "
                         f"{counters['map']['mxu_rows']} rows, the filter "
                         f"kept {filtered}")
    _check_on_card(res, launches, ("window_step", "hash_placement",
                                   "radix_partition"), "rollup")
    if launches["window_step"] != counters["map"]["cuda_batches"]:
        raise SystemExit(f"rollup path: {launches['window_step']} window "
                         f"steps for {counters['map']['cuda_batches']} map "
                         f"batches")
    _check_loop(counters, mode, "rollup", map_eligible=False)
    return {"launches": launches, "counters": counters, "graphs": graphs,
            "map_s": res["map_s"], "reduce_s": res["reduce_s"],
            "peak_bytes": peak, "table": a}


def same_result(auto, off, keys, exact, value, label):
    """The loop's result against the staged one: the same groups in key
    order, `exact` columns equal, `value` within 1e-9 relative."""
    a, b = auto["table"], off["table"]
    if a.num_rows != b.num_rows or not a.select(keys + exact).equals(
            b.select(keys + exact)):
        raise SystemExit(f"{label}: the stage loop's groups differ from the "
                         f"staged executor's")
    nulls_ok, max_rel = _sums_close(a, b, value)
    print(f"{label}: stage loop (auto) against staged (off): {a.num_rows} "
          f"groups equal, sums max relative error {max_rel:.3e}")
    if not nulls_ok or max_rel > 1e-9:
        raise SystemExit(f"{label}: the stage loop's sums differ from the "
                         f"staged executor's")


def regrow_path(root, sr_paths, lo, hi):
    """q01 under auto with a 4,096-slot table: the map tasks fall back
    where they overflow, and every reduce task regrows its table in the
    loop; one graph captured per table size, the result equal to the
    oracle."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.runtime import loop
    config.conf.set(config.ON_DEVICE_AGG_CAPACITY.key, 4096)
    loop._FOLDS.clear()  # every graph of this phase is its own capture
    try:
        res = q01_path(root, sr_paths, lo, hi, "auto", label="q01 regrow")
    finally:
        config.conf.unset(config.ON_DEVICE_AGG_CAPACITY.key)
    r = res["counters"]["reduce"]
    sizes = sorted({k[3] for k in loop._FOLDS})
    print(f"regrow: reduce regrows {r['stage_loop_regrows']}, captures "
          f"{res['graphs']['captures']} ({res['graphs']['capture_ms']:.1f} "
          f"ms), replays {res['graphs']['replays']}; table sizes with a "
          f"graph: {sizes}")
    if r["stage_loop_regrows"] <= 0:
        raise SystemExit("regrow: no reduce task regrew its table")
    chain = [4096 << i for i in range(len(sizes))]
    if sizes != chain or res["graphs"]["captures"] < len(chain):
        raise SystemExit(f"regrow: table sizes {sizes}, captures "
                         f"{res['graphs']['captures']}")
    del res["table"]
    return res


def profile_path(name, run, root, mode):
    """A second run of one main path, with the stage loop under `mode`,
    under torch.profiler: the share of its wall time the card was busy,
    device time by kernel, host launches (cudaLaunch* and cudaGraphLaunch
    apart), graph replays, and per wrapper of the port the device time per
    call.  Fails unless each of the port's kernels ran as often on the
    card as its wrapper counted (one placement launch per eager call and
    one per batch slot of each graph replay, one window step per map
    batch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.runtime import loop

    phase(f"where the time goes: the {name} path again, stage loop {mode}, "
          f"under torch.profiler")
    _loop_mode(mode)
    shuffle_dir = os.path.join(root, f"shuffle_{name}_{mode}_profiled")
    shutil.rmtree(shuffle_dir, ignore_errors=True)  # a profiled re-run
    os.makedirs(shuffle_dir)
    _zero_launches()
    replays0 = loop.graph_stats["replays"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run(shuffle_dir)
    launches = _read_launches()
    replays = loop.graph_stats["replays"] - replays0
    wall_us = (res["map_s"] + res["reduce_s"]) * 1e6

    # kernels and copies on the card: one stream, so their durations add
    # up to the busy time
    by_name = {}
    for e in prof.events():
        if _on_card(e):
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _c in by_name.values())
    print(f"profiled wall {wall_us / 1e6:.3f} s (map {res['map_s']:.3f} s, "
          f"reduce {res['reduce_s']:.3f} s); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / wall_us:.2f}% of the "
          f"wall, idle {100 - 100 * busy_us / wall_us:.2f}%")
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:12]:
        print(f"  device {t / 1e3:9.3f} ms  calls {c:6d}  {kname[:90]}")
    # the port's own kernels (csrc/, anonymous namespaces), wherever they
    # rank: device time per launch on this path
    for kname, (t, c) in sorted(by_name.items()):
        if kname.startswith(("(anonymous namespace)::",
                             "void (anonymous namespace)::")):
            print(f"  own    {t / 1e3:9.3f} ms  calls {c:6d}  "
                  f"{t / c:8.3f} us/call  "
                  f"{kname.split('::')[1].split('(')[0]}")
    averages = prof.key_averages()
    host = sorted((e for e in averages
                   if not e.key.startswith(q01.STAGE_RANGE)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    for e in host:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
              f"{e.count:6d}  {e.key[:90]}")
    host = _host_launches(prof)
    print(f"host launches on the {name} path ({mode}): cudaLaunch* "
          f"{host['kernel']}, cudaGraphLaunch {host['graph']} (graph "
          f"replays {replays})")
    torch.cuda.synchronize()
    out = {"mode": mode, "wall_s": wall_us / 1e6, "busy_s": busy_us / 1e6,
           "busy_share": busy_us / wall_us,
           "host_launches": host["kernel"],
           "graph_launches": host["graph"], "graph_replays": replays,
           "counters": res["counters"], "kernels": {}}
    for kernel, names in KERNEL_NAMES.items():
        us, count = _device_events(prof, names)
        calls = launches[kernel]
        print(f"  {kernel}: wrapper launches {calls}, device kernels "
              f"{count}" + (f", {us / calls:.2f} us on the card per call"
                            if calls else ""))
        # each device kernel as often as the wrapper counted it: one per
        # call, or for radix by name (the upsweep only for columns of more
        # than one tile)
        expected = ({RADIX_KERNELS[k]: c
                     for k, c in launches["radix_kernels"].items()}
                    if kernel == "radix_partition" else {names[0]: calls})
        for pattern, want in expected.items():
            _us, got = _device_events(prof, (pattern,))
            _count_on_card([prof], f"{name} path", f"{kernel} ran {got} "
                           f"device kernels {pattern} where its wrapper "
                           f"counted {want}", got, want)
        out["kernels"][kernel] = {"launches": calls,
                                  "device_us": us / calls if calls else None,
                                  "device_kernels": count}
    return out


# ---------------------------------------------------------------------------
# crc32c and the q01 branches
# ---------------------------------------------------------------------------

CRC_CHECK = 0xE3069283  # CRC32C("123456789")


def _frames(data):
    """(stored CRC32C, payload) of each frame of a shuffle byte string
    (codec byte with the CRC flag, u32 length, u32 CRC, payload)."""
    import struct
    from blaze_tpu_torch.shuffle.ipc import FLAG_CRC
    out, off = [], 0
    while off < len(data):
        codec, length = struct.unpack_from("<BI", data, off)
        if not codec & FLAG_CRC:
            raise SystemExit("shuffle frame written without a checksum")
        (crc,) = struct.unpack_from("<I", data, off + 5)
        out.append((crc, data[off + 9:off + 9 + length]))
        off += 9 + length
    return out


def _verify_frames(data, what):
    from blaze_tpu_torch.shuffle.crc32c import crc32c_plain
    frames = _frames(data)
    for crc, payload in frames:
        if crc != crc32c_plain(payload):
            raise SystemExit(f"{what}: a frame's checksum is not the "
                             f"CRC32C of its payload")
    return len(frames)


def crc32c_phase(dev):
    """The built CRC32C against its plain version and the check value; the
    implementation the shuffle writer takes; a frame written from a batch
    on the card, verified through the plain version."""
    import io
    import numpy as np
    import pyarrow as pa
    import torch
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.shuffle import ipc
    from blaze_tpu_torch.shuffle.crc32c import crc32c_built, crc32c_plain

    phase("crc32c: the built CRC32C (csrc/crc32c.cu) against its plain "
          "version")
    rng = np.random.default_rng(32)
    out = {}
    for n in (1, 4096, 1 << 20):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        built, plain = crc32c_built(data), crc32c_plain(data)
        t0 = time.perf_counter()
        reps = max(1, min(10_000, (64 << 20) // n))
        for _ in range(reps):
            crc32c_built(data)
        us = (time.perf_counter() - t0) / reps * 1e6
        print(f"{n} B: built 0x{built:08x}, plain 0x{plain:08x}, built "
              f"{us:.2f} us per call ({n / us / 1e3:.3f} GB/s on the host)")
        if built != plain:
            raise SystemExit(f"crc32c: built and plain differ on {n} B")
        out[n] = {"crc": built, "us": us}
    check = crc32c_built(b"123456789")
    print(f'CRC32C("123456789") = 0x{check:08x} (expected '
          f"0x{CRC_CHECK:08X})")
    if check != CRC_CHECK or crc32c_plain(b"123456789") != CRC_CHECK:
        raise SystemExit("crc32c: the check value differs")
    impl = ipc._pick_crc32c()
    name = ("built" if impl is crc32c_built else "google_crc32c")
    print(f"shuffle frames checksum with: {name}")
    rb = pa.record_batch({"a": pa.array(rng.integers(0, 1 << 40, 50_000)),
                          "b": pa.array(rng.random(50_000))})
    cb = ColumnBatch.from_arrow(rb, device=dev)
    if cb.columns[0].data.device.type != "cuda":
        raise SystemExit("crc32c: the frame's batch is not on the card")
    sink = io.BytesIO()
    w = ipc.IpcCompressionWriter(sink, checksum=True)
    w.write_batch(cb.to_arrow())
    w.finish()
    frames = _verify_frames(sink.getvalue(), "crc32c")
    torch.cuda.synchronize()
    print(f"frame written from a batch on the card: {frames} frame(s) "
          f"verified through crc32c_plain")
    return {"sizes": out, "check": check, "impl": name}


def _per_stage(prof, stages, prefix=None):
    """cudaLaunch* host calls, and the card's busy microseconds, inside
    each stage's named range `prefix + stage` (a stage ends in a device
    synchronisation, so its device work falls inside its range)."""
    import torch
    from blaze_tpu_torch.itest.q01 import STAGE_RANGE
    prefix = STAGE_RANGE if prefix is None else prefix
    ranges = {}
    for e in prof.events():
        st = e.name[len(prefix):]
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(prefix) and st in stages):
            ranges[st] = (e.time_range.start, e.time_range.end)
    launches = {st: 0 for st in stages}
    busy = {st: 0.0 for st in stages}
    for e in prof.events():
        launch = e.name.startswith("cudaLaunch")
        card = _on_card(e)
        if not (launch or card):
            continue
        for st, (a, b) in ranges.items():
            if a <= e.time_range.start <= b:
                if launch:
                    launches[st] += 1
                else:
                    busy[st] += e.time_range.elapsed_us()
    return launches, busy


def branches_path(root, sr_paths, lo, hi, mode, oracle, profiled=False):
    """q01's two branches over four stages with the stage loop under
    `mode`, checked against the oracle and for their route on the card.
    With `profiled`, under torch.profiler: the busy share, cudaLaunch*
    per stage, and each kernel of the path run on the card as often as
    its wrapper counted."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.itest import q01_branches as QB
    from blaze_tpu_torch.ops.sort import DEVICE_SORT_MIN_ROWS

    label = f"q01 branches {mode}" + (" profiled" if profiled else "")
    phase(f"main path {label}: stages 1-4 of the avg-by-store and "
          f"top-returns branches, SF10, 4 maps x 16 reduces")
    _loop_mode(mode)
    out_dir = os.path.join(root, label.replace(" ", "_"))
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = QB.run_branches(sr_paths, lo, hi, out_dir, N_MAPS,
                                  N_REDUCES)
    else:
        res = QB.run_branches(sr_paths, lo, hi, out_dir, N_MAPS, N_REDUCES)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    walls = {st: res[st]["seconds"] for st in QB.STAGES}
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in walls.items()))
    for st in QB.STAGES:
        c = {k: v for k, v in res[st]["counters"].items() if v}
        print(f"  {st}: {c}")
    print(f"launches on the branches path: {launches}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")

    avg = QB.table(res["avg_limit"]["outputs"][0])
    top = QB.table(res["top_limit"]["outputs"][0])
    try:
        avg_err = QB.check_avg(avg, oracle["avg"], 1e-9)
        top_err = QB.check_top(top, oracle["top"], 1e-9)
    except AssertionError as e:
        raise SystemExit(f"{label}: {e}")
    print(f"avg by store: {avg.num_rows} stores, keys and order exact, "
          f"max relative error {avg_err:.3e} (limit 1e-9)")
    print(f"top returns: {top.num_rows} rows, keys and order exact (ties "
          f"aside), totals max relative error {top_err:.3e} (limit 1e-9)")
    a = res["avg"]["counters"]
    if a.get("cpu_batches") or not a.get("cuda_batches"):
        raise SystemExit(f"{label}: stage 3a's generic-engine batches not "
                         f"all on the card: {a}")
    for st in QB.STAGES:
        if res[st]["counters"].get("cpu_batches"):
            raise SystemExit(f"{label}: stage {st} ran batches off the "
                             f"card")
    rows = QB.top_input_rows(res)
    want, ran = QB.device_sorts(res)
    print(f"sorts of the top branch read {rows} rows; sorts of "
          f">= {DEVICE_SORT_MIN_ROWS} rows {want}, sort_device_runs {ran}")
    if ran != want or ran <= 0:
        raise SystemExit(f"{label}: sort_device_runs {ran}, expected {want}")
    for k in ("hash_placement", "radix_partition"):
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    data, _index, _offs = res["ctr"]["shuffle"][0]
    with open(data, "rb") as f:
        n_frames = _verify_frames(f.read(), label)
    print(f"stage-2 shuffle file 0: {n_frames} frames verified through "
          f"crc32c_plain")
    out = {"mode": mode, "walls": walls, "wall_s": wall,
           "launches": launches, "peak_bytes": peak,
           "counters": {st: res[st]["counters"] for st in QB.STAGES},
           "sort_input_rows": rows, "sort_device_runs": ran,
           "avg_max_rel": avg_err, "top_max_rel": top_err}
    if profiled:
        busy = sum(e.time_range.elapsed_us() for e in prof.events()
                   if _on_card(e))
        per_stage, busy_stage = _per_stage(prof, QB.STAGES)
        host = _host_launches(prof)
        print(f"profiled wall {wall:.3f} s; device busy {busy / 1e6:.4f} s "
              f"= {100 * busy / 1e6 / wall:.2f}% of the wall")
        print(f"cudaLaunch* per stage: {per_stage} (all {host['kernel']}, "
              f"cudaGraphLaunch {host['graph']})")
        print("device busy per stage, ms: " + ", ".join(
            f"{st} {us / 1e3:.3f}" for st, us in busy_stage.items()))
        by_name = {}
        for e in prof.events():
            if _on_card(e):
                t, c = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
        for kname, (t, c) in sorted(by_name.items(), key=lambda kv: kv[1][0],
                                    reverse=True)[:10]:
            print(f"  device {t / 1e3:9.3f} ms  calls {c:6d}  {kname[:90]}")
        from blaze_tpu_torch.itest.q01 import STAGE_RANGE
        for e in sorted((e for e in prof.key_averages()
                         if not e.key.startswith(STAGE_RANGE)),
                        key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:10]:
            print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
                  f"{e.count:6d}  {e.key[:90]}")
        for kernel in ("hash_placement", "radix_partition"):
            names = KERNEL_NAMES[kernel]
            expected = ({RADIX_KERNELS[k]: c
                         for k, c in launches["radix_kernels"].items()}
                        if kernel == "radix_partition"
                        else {names[0]: launches[kernel]})
            for pattern, want_n in expected.items():
                _us, got = _device_events(prof, (pattern,))
                _count_on_card([prof], label, f"{kernel} ran {got} device "
                               f"kernels {pattern} where its wrapper "
                               f"counted {want_n}", got, want_n)
            print(f"  {kernel}: wrapper launches {launches[kernel]}, the "
                  f"same on the card")
        out.update(busy_s=busy / 1e6, busy_share=busy / 1e6 / wall,
                   launches_per_stage=per_stage,
                   busy_ms_per_stage={k: v / 1e3
                                      for k, v in busy_stage.items()},
                   host_launches=host["kernel"],
                   graph_launches=host["graph"])
    return out


def branches_oracle(sr_paths, lo, hi):
    from blaze_tpu_torch.itest import q01, q01_branches as QB
    ctr = q01.oracle(sr_paths, lo, hi)
    return {"avg": QB.avg_oracle(ctr), "top": QB.top_oracle(ctr)}


FULL_PARTS = 16             # q01 full: the exchanges' partitions
FULL_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                 "stage_loop_tasks", "stage_loop_fallback",
                 "partial_skipped", "sort_device_runs", "io_bytes")


def full_data(root):
    """q01's four tables at SF10 from their seeds, written as
    write_parquet_splits(..., 4) writes them, the plan, the pandas
    oracle's frame and a maker of a fresh plan (new broadcast ids)."""
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest.tpcds_data import (make_tables,
                                                   write_parquet_splits)
    phase("data: TPC-DS date_dim, store, customer and store_returns at "
          "SF10 for q01 full")
    t0 = time.perf_counter()
    tables = make_tables(SCALE, QD.TABLES)
    paths = write_parquet_splits(tables, os.path.join(root, "q01_full"),
                                 N_FILES)
    plan, oracle = Q.q01(paths, tables, partitions=FULL_PARTS)
    t1 = time.perf_counter()
    want = oracle()
    print("rows: " + ", ".join(f"{k} {t.num_rows} in {len(paths[k])} "
                               f"file(s)" for k, t in tables.items())
          + f" ({t1 - t0:.1f} s); pandas oracle {time.perf_counter() - t1:.1f}"
          f" s, {len(want)} rows")
    return plan, want, lambda: Q.q01(paths, tables,
                                     partitions=FULL_PARTS)[0]


def full_path(plan, want, mode, profiled=False, corrupt=False):
    """Full q01 through the port's DagScheduler with the stage loop under
    `mode`: 6 stages, the 100 c_customer_id exact and in order against the
    pandas oracle, every batch and every join probe on the card, the
    kernels launched.  With `profiled`, each stage under torch.profiler
    (see _dag_profile).  With `corrupt`, the lineage probe: one byte of the
    first non-empty map output of stage 0 is flipped after it commits, and
    exactly that map task must run twice."""
    import pandas as pd
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest.runner import compare_frames, same_order
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    label = (f"q01 full {mode}" + (" profiled" if profiled else "")
             + (" lineage probe" if corrupt else ""))
    phase(f"main path {label}: TPC-DS q01 through the stage DAG, SF10, "
          f"{N_FILES} file splits, {FULL_PARTS} exchange partitions")
    _loop_mode(mode)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = (QD.CorruptingScheduler(0) if corrupt else
             _stage_profiling_scheduler() if profiled else DagScheduler())
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    t0 = time.perf_counter()
    out = sched.run_collect(plan)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = out.to_pandas() if out.num_rows else pd.DataFrame(
        {n: [] for n in out.schema.names})
    counters = QD.stage_counters(sched, FULL_COUNTERS)
    tasks = {st.sid: st.num_tasks for st in sched.stages}
    print(sched.describe())
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(
              f"{sid} {w:.3f}" for sid, w in sorted(sched.stage_walls.items()))
          + f"; run {wall:.3f} s")
    for sid in sorted(counters):
        print(f"  stage {sid} ({tasks[sid]} tasks): "
              f"{ {k: v for k, v in counters[sid].items() if v} }")
    print(f"launches on the q01 full path: {launches}; join probes "
          f"{probes}; task runs {sorted(sched.task_runs.items())}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")
    if len(sched.stages) != 6:
        raise SystemExit(f"{label}: {len(sched.stages)} stages, expected 6")
    err = compare_frames(got, want) or same_order(got, want)
    if len(got) != 100 or err:
        raise SystemExit(f"{label}: {len(got)} rows against the oracle: "
                         f"{err}")
    print(f"result: {len(got)} c_customer_id equal to the pandas oracle, in "
          f"order (first {got.iloc[0, 0]}, last {got.iloc[-1, 0]})")
    for k in ("hash_placement", "radix_partition"):
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    off_card = {sid: c["cpu_batches"] for sid, c in counters.items()
                if c["cpu_batches"]}
    if off_card or probes["cpu"]:
        raise SystemExit(f"{label}: work off the card: cpu_batches "
                         f"{off_card}, CPU join probes {probes['cpu']}")
    probe_batches = sum(c["probe_batches"] for c in counters.values())
    if probes["cuda"] != probe_batches or probe_batches <= 0:
        raise SystemExit(f"{label}: {probes['cuda']} device probe calls for "
                         f"{probe_batches} probe batches")
    runs = {k: v for k, v in sched.task_runs.items() if v != 1}
    if corrupt:
        if sched.corrupted_at is None or runs != {sched.target: 2}:
            raise SystemExit(f"{label}: task runs other than one map task "
                             f"twice: {runs}")
        print(f"lineage probe: byte {sched.corrupted_at} of the output of "
              f"map task {sched.target} flipped after its commit; that map "
              f"task ran twice, every other once, the result equal")
    elif runs:
        raise SystemExit(f"{label}: tasks ran more than once: {runs}")
    leaks = sched.leak_report()
    if any(leaks.values()):
        raise SystemExit(f"{label}: the scheduler leaked {leaks}")
    res = {"mode": mode, "wall_s": wall, "stage_walls": sched.stage_walls,
           "tasks": tasks, "counters": counters, "launches": launches,
           "probe_calls": probes, "peak_bytes": peak,
           "task_runs": {f"{k[0]},{k[1]}": v
                         for k, v in sched.task_runs.items()}}
    if profiled:
        res.update(_dag_profile(sched, label, wall, launches, probes))
    return res


def _stage_profiling_scheduler():
    """A DagScheduler that runs each stage under its own torch.profiler,
    device activity only (kernels, copies and the CUDA runtime calls that
    issue them): a trace with host ops of q06's 880 probe batches holds
    millions of events, which take minutes to read."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.plan.stages import DagScheduler

    class StageProfiling(DagScheduler):
        def __init__(self):
            super().__init__()
            self.profiles = {}

        def _stage_scope(self, sid):
            inner = super()._stage_scope(sid)

            @contextlib.contextmanager
            def scope():
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    with inner:
                        yield
                self.profiles[sid] = prof
            return scope()
    return StageProfiling()


class IncompleteProfile(Exception):
    """A kernel count read from a profile fell short of its wrapper's
    count by no more than the kernel launches whose device records the
    profiler lost: the profiled run is made again."""


def _lost_kernel_records(prof):
    """(lost, captured): the kernel launches (cudaLaunch*,
    cudaGraphLaunch) of a profile with no device kernel record of the
    same correlation id, by the runtime call's name, and the number of
    such launches left out because they were made while a stream was
    captured into a graph (between a cudaStreamBeginCapture record and the
    next cudaStreamEndCapture): those run only when the graph is
    replayed, and have no record of their own."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    launched, ran, marks = {}, set(), []
    for e in prof.events():
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False) and \
                    not e.name.startswith(("Memcpy", "Memset")):
                ran.add(e.id)
        elif e.name.startswith(("cudaLaunch", "cudaGraphLaunch")):
            launched[e.id] = (e.name, e.time_range.start)
        elif e.name.startswith(("cudaStreamBeginCapture",
                                "cudaStreamEndCapture")):
            marks.append((e.time_range.start, "Begin" in e.name))
    windows, begin = [], None
    for t, is_begin in sorted(marks):
        if is_begin:
            begin = t
        elif begin is not None:
            windows.append((begin, t))
            begin = None
    if begin is not None:
        windows.append((begin, float("inf")))
    lost, captured = {}, 0
    for i in launched.keys() - ran:
        name, t = launched[i]
        if any(lo <= t <= hi for lo, hi in windows):
            captured += 1
        else:
            lost[name] = lost.get(name, 0) + 1
    return lost, captured


def _count_on_card(profs, label, what, got, want):
    """A kernel count read from the profiles `profs` against its
    wrapper's count `want`: above it fails; below it fails unless the
    profiles hold at least `want - got` kernel launches made outside a
    graph capture whose device records the profiler lost, and then
    raises IncompleteProfile."""
    if got > want:
        raise SystemExit(f"{label}: {what}")
    if got < want:
        found = [_lost_kernel_records(p) for p in profs]
        lost = {}
        for by_name, _captured in found:
            for name, n in by_name.items():
                lost[name] = lost.get(name, 0) + n
        note = (f"{sum(lost.values())} kernel launches without a device "
                f"record outside a capture {lost}, "
                f"{sum(c for _l, c in found)} inside one")
        if sum(lost.values()) >= want - got:
            raise IncompleteProfile(f"{what}; {note}")
        raise SystemExit(f"{label}: {what}; {note}")


#: profiled runs at most: the profiler loses device records now and then
#: in a long process (PERF.md §6)
PROFILE_ATTEMPTS = 4


def _profiled(run, label):
    """run() for a profiled run, again where a kernel count fell short in
    a profile that lost device records (IncompleteProfile), at most
    PROFILE_ATTEMPTS times.  A run passes only on exact counts."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        try:
            return run()
        except IncompleteProfile as e:
            print(f"{label}: attempt {attempt}: {e}")
    raise SystemExit(f"{label}: the profiler lost device records in "
                     f"{PROFILE_ATTEMPTS} attempts")


def _dag_profile(sched, label, wall, launches, probes):
    """A DagScheduler run profiled per stage (_stage_profiling_scheduler):
    the busy share, cudaLaunch* and busy ms per stage, the top device ops
    and CUDA runtime calls, the device ms of torch's cumulative scans
    (cummax, cummin, cumsum), and placement, radix and the join probe's
    searchsorted run on the card as often as their wrappers counted
    (_count_on_card)."""
    import torch
    from blaze_tpu_torch.plan.stages import STAGE_RANGE
    t0 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    profs = list(sched.profiles.values())
    per_stage, busy_stage, graphs = {}, {}, 0
    by_name, host_calls = {}, {}
    for sid, prof in sorted(sched.profiles.items()):
        n_launch = busy_us = 0
        for e in prof.events():
            name = e.name
            us = e.time_range.elapsed_us()
            if e.device_type == cuda:
                if getattr(e, "is_user_annotation", False):
                    continue
                busy_us += us
                t, c = by_name.get(name, (0.0, 0))
                by_name[name] = (t + us, c + 1)
                continue
            if name.startswith(STAGE_RANGE):
                continue
            t, c = host_calls.get(name, (0.0, 0))
            host_calls[name] = (t + us, c + 1)
            n_launch += name.startswith("cudaLaunch")
            graphs += name.startswith("cudaGraphLaunch")
        per_stage[str(sid)] = n_launch
        busy_stage[str(sid)] = busy_us
    busy = sum(busy_stage.values())
    # the run's wall also holds each stage's profiler start and stop
    staged = sum(sched.stage_walls.values())
    print(f"profiled wall {wall:.3f} s; device busy {busy / 1e6:.4f} s = "
          f"{100 * busy / 1e6 / wall:.2f}% of the wall, "
          f"{100 * busy / 1e6 / staged:.2f}% of the stage walls "
          f"({staged:.3f} s)")
    print(f"cudaLaunch* per stage: {per_stage} (all "
          f"{sum(per_stage.values())}, cudaGraphLaunch {graphs})")
    print("device busy per stage, ms: " + ", ".join(
        f"{st} {us / 1e3:.3f}" for st, us in busy_stage.items()))
    for kname, (t, c) in sorted(by_name.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:12]:
        print(f"  device {t / 1e3:9.3f} ms  calls {c:6d}  {kname[:90]}")
    for kname, (t, c) in sorted(host_calls.items(), key=lambda kv: kv[1][0],
                                reverse=True)[:8]:
        print(f"  host   {t / 1e3:9.3f} ms  calls {c:6d}  {kname[:90]}")

    def kernels(pattern):
        hits = [(t, c) for n, (t, c) in by_name.items() if pattern in n
                and not n.startswith(("Memcpy", "Memset"))]
        return sum(t for t, _c in hits), sum(c for _t, c in hits)

    kernel_us = {}
    for kernel in ("hash_placement", "radix_partition"):
        names = KERNEL_NAMES[kernel]
        expected = ({RADIX_KERNELS[k]: c
                     for k, c in launches["radix_kernels"].items()}
                    if kernel == "radix_partition"
                    else {names[0]: launches[kernel]})
        us = 0.0
        for pattern, want_n in expected.items():
            p_us, n_dev = kernels(pattern)
            us += p_us
            _count_on_card(profs, label, f"{kernel} ran {n_dev} device "
                           f"kernels {pattern} where its wrapper counted "
                           f"{want_n}", n_dev, want_n)
        calls = launches[kernel]
        kernel_us[kernel] = us / calls if calls else None
        print(f"  {kernel}: wrapper launches {calls}, the same on the card"
              + (f", {us / calls:.2f} us a call" if calls else ""))
    # the join probe's torch ops on the card: one searchsorted kernel per
    # device probe call
    probe_us, n_search = kernels("searchsorted")
    _count_on_card(profs, label, f"{n_search} searchsorted kernels on "
                   f"the card for {probes['cuda']} device probe calls",
                   n_search, probes["cuda"])
    # torch's cummax, cummin and cumsum kernels are its "scan" kernels
    # (the template arguments of other kernels may name a scan too)
    scans = {n: t for n, (t, _c) in by_name.items()
             if "scan" in n.split("<")[0].lower()}
    print(f"  cumulative scans: {sum(scans.values()) / 1e3:.3f} ms of "
          f"{busy / 1e3:.3f} ms device time: " + "; ".join(
              f"{t / 1e3:.3f} ms {n[:70]}" for n, t in
              sorted(scans.items(), key=lambda kv: -kv[1])))
    print(f"  join probe: {probes['cuda']} device probe calls, "
          f"{n_search} searchsorted kernels on the card "
          f"({probe_us / 1e3:.3f} ms); profile read in "
          f"{time.perf_counter() - t0:.1f} s")
    return dict(busy_s=busy / 1e6, busy_share=busy / 1e6 / wall,
                busy_share_of_stage_walls=busy / 1e6 / staged,
                launches_per_stage=per_stage,
                busy_ms_per_stage={k: v / 1e3 for k, v in busy_stage.items()},
                host_launches=sum(per_stage.values()), graph_launches=graphs,
                searchsorted_kernels=n_search, kernel_us_per_call=kernel_us,
                scan_ms=sum(scans.values()) / 1e3)


FAMILY_PARTS = 4            # q06, q42, q03: the exchanges' partitions
FALLBACK_MAX_SLOTS = 64     # the cap-fallback run's dictDevice.maxSlots


def family_data(root):
    """store_sales, item and date_dim at SF10 from their seeds
    (store_sales in N_FILES files, item and date_dim one each); for each
    of q06, q42 and q03 a maker of its plan (each run gets a fresh plan,
    so its broadcast builds run again rather than come from the cache of
    the plan's broadcast ids) and its pandas oracle's frame; and the
    seconds each step took."""
    from blaze_tpu_torch.itest import q06 as D
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    phase("data: TPC-DS store_sales, item and date_dim at SF10 for q06, "
          "q42 and q03")
    t0 = time.perf_counter()
    tables = T.make_tables(SCALE, D.TABLES)
    t1 = time.perf_counter()
    paths = T.write_splits(tables, os.path.join(root, "q06"), N_FILES)
    t2 = time.perf_counter()
    secs = {"generate": t1 - t0, "write": t2 - t1}
    print("rows: " + ", ".join(f"{k} {t.num_rows} in {len(paths[k])} "
                               f"file(s)" for k, t in tables.items())
          + f"; generated in {secs['generate']:.1f} s, written in "
          f"{secs['write']:.1f} s")
    plans = {}
    for name, (_plan, oracle) in Q.plans(paths, tables, FAMILY_PARTS,
                                         D.QUERY_NAMES).items():
        t = time.perf_counter()
        want = oracle()
        secs[f"oracle {name}"] = time.perf_counter() - t
        plans[name] = (lambda n=name: Q.plans(paths, tables, FAMILY_PARTS,
                                              [n])[n][0], want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return plans, secs, tables, paths


def family_path(name, make_plan, want, mode, profiled=False,
                max_slots=None):
    """One of q06, q42 and q03 through the port's DagScheduler with the
    stage loop under `mode`: 3 stages, the rows equal to the pandas
    oracle's in order, every batch and every join probe on the card, radix
    launched (and placement on q06's count by store).  q06: its average
    by category ran on the generic engine on the card.  q42 and q03: the
    partial and the final stage ran on the dict-device lane, or, with
    `max_slots`, both fell back to the generic engine.  With `profiled`,
    each stage under torch.profiler (see _dag_profile)."""
    import pandas as pd
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q06 as D
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.itest.runner import compare_frames, same_order
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    label = (f"{name} {mode}" + (" profiled" if profiled else "")
             + (f" maxSlots {max_slots}" if max_slots else ""))
    phase(f"main path {label}: TPC-DS {name} through the stage DAG, SF10, "
          f"{N_FILES} store_sales files, {FAMILY_PARTS} exchange "
          f"partitions")
    _loop_mode(mode)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    if max_slots:
        config.conf.set(config.FUSED_DICT_DEVICE_MAX_SLOTS.key, max_slots)
    sched = _stage_profiling_scheduler() if profiled else DagScheduler()
    plan = make_plan()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    try:
        t0 = time.perf_counter()
        out = sched.run_collect(plan)
        wall = time.perf_counter() - t0
    finally:
        config.conf.unset(config.FUSED_DICT_DEVICE_MAX_SLOTS.key)
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = out.to_pandas() if out.num_rows else pd.DataFrame(
        {n: [] for n in out.schema.names})
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    engine = D.operator_counters(sched, "AggExec",
                                 ("cuda_batches", "cpu_batches"))
    tasks = {st.sid: st.num_tasks for st in sched.stages}
    print(sched.describe())
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(
              f"{sid} {w:.3f}" for sid, w in sorted(sched.stage_walls.items()))
          + f"; run {wall:.3f} s")
    for sid in sorted(counters):
        print(f"  stage {sid} ({tasks[sid]} tasks): "
              f"{ {k: v for k, v in counters[sid].items() if v} }")
    print(f"launches: {launches}; join probes {probes}; generic engine "
          f"batches {engine}; peak {peak} bytes")
    if len(sched.stages) != 3:
        raise SystemExit(f"{label}: {len(sched.stages)} stages, expected 3")
    err = compare_frames(got, want) or same_order(got, want)
    if not len(got) or err:
        raise SystemExit(f"{label}: {len(got)} rows against the oracle's "
                         f"{len(want)}: {err}")
    print(f"result: {len(got)} rows equal to the pandas oracle, in order "
          f"(first {got.iloc[0].tolist()})")
    needed = ["radix_partition"] + (["hash_placement"] if name == "q06"
                                    else [])
    for k in needed:
        if launches[k] <= 0:
            raise SystemExit(f"{label}: kernel {k} was never launched")
    off_card = {sid: c["cpu_batches"] for sid, c in counters.items()
                if c["cpu_batches"]}
    if off_card or probes["cpu"]:
        raise SystemExit(f"{label}: work off the card: cpu_batches "
                         f"{off_card}, CPU join probes {probes['cpu']}")
    probe_batches = sum(c["probe_batches"] for c in counters.values())
    if probes["cuda"] != probe_batches or probe_batches <= 0:
        raise SystemExit(f"{label}: {probes['cuda']} device probe calls for "
                         f"{probe_batches} probe batches")
    if name == "q06":
        on_card = sum(c["cuda_batches"] for c in engine.values())
        if on_card <= 0:
            raise SystemExit(f"{label}: the average by category did not run "
                             f"on the card: {engine}")
    elif max_slots:
        # each task that fell back: the lane's first batch, then the
        # generic engine's batches from the start of the partition
        if any(counters[s]["dict_device_fallback"] <= 0
               or counters[s]["dict_device_batches"]
               or counters[s]["cuda_batches"]
               < 2 * counters[s]["dict_device_fallback"] for s in (0, 1)):
            raise SystemExit(f"{label}: the dict lane did not fall back to "
                             f"the generic engine on the card: {counters}")
    elif any(counters[s]["dict_device_batches"] <= 0
             or counters[s]["dict_device_fallback"] for s in (0, 1)):
        raise SystemExit(f"{label}: a string-keyed stage off the dict "
                         f"lane: {counters}")
    elif name == "q03" and any(counters[s]["dict_device_doublings"] <= 0
                               for s in (0, 1)):
        raise SystemExit(f"{label}: i_brand's dictionary (50 brands) never "
                         f"grew past 16 codes: {counters}")
    runs = {k: v for k, v in sched.task_runs.items() if v != 1}
    leaks = sched.leak_report()
    if runs or any(leaks.values()):
        raise SystemExit(f"{label}: tasks ran more than once {runs} or the "
                         f"scheduler leaked {leaks}")
    res = {"query": name, "mode": mode, "max_slots": max_slots,
           "wall_s": wall, "stage_walls": sched.stage_walls,
           "tasks": tasks, "counters": counters, "engine": engine,
           "launches": launches, "probe_calls": probes, "peak_bytes": peak}
    if profiled:
        res.update(_dag_profile(sched, label, wall, launches, probes))
    return res


def _arrow_source(batches, device):
    """Fixed Arrow batches as port batches on `device` (one partition):
    the relayout probe's source."""
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.ops.base import ExecutionPlan
    from blaze_tpu_torch.schema import Schema

    class Source(ExecutionPlan):
        @property
        def schema(self):
            return Schema.from_arrow(batches[0].schema)

        def execute(self, partition):
            for rb in batches:
                yield ColumnBatch.from_arrow(rb, device=device)
    return Source()


def dict_relayout_probe(dev):
    """The dict-device lane on the card through key growth: a partial sum,
    count and min/max by (brand, store) over 6 batches of 32,768 rows
    whose brands grow from 10 to 260 (the brand key's capacity doubles 16
    -> 32 -> ... -> 512 with a carry in place, re-laying the table out
    each time), against the same fold on the CPU: keys, counts and
    integers exact, float sums within 1e-9 relative."""
    import numpy as np
    import pyarrow as pa
    import torch
    from blaze_tpu_torch.exprs import BoundReference
    from blaze_tpu_torch.ops.agg import AggExec, AggMode, make_agg
    from blaze_tpu_torch.plan.fused import FusedPartialAggExec, fuse_plan
    phase("dict-device lane on the card: dictionary growth re-lays the "
          "table out, against the same fold on the CPU")
    rng = np.random.default_rng(61)
    batches = []
    for b in range(6):
        n = N
        brands = np.array([f"brand_{i}" for i in range(10 + 50 * b)])
        batches.append(pa.record_batch({
            "brand": pa.array(brands[rng.integers(0, len(brands), n)],
                              mask=rng.random(n) < 0.01),
            "store": pa.array(rng.integers(1, 13, n)),
            "price": pa.array(np.round(rng.random(n) * 300, 2),
                              mask=rng.random(n) < 0.05),
            "qty": pa.array(rng.integers(1, 100, n).astype(np.int32))}))
    fns = [("sum", 2), ("count", 2), ("min", 3), ("max", 3), ("sum", 3)]
    out = []
    for d in (dev, torch.device("cpu")):
        src = _arrow_source(batches, d)
        agg = fuse_plan(AggExec(
            src, [(BoundReference(0), "brand"), (BoundReference(1), "store")],
            [(make_agg(fn, [BoundReference(c)]), AggMode.PARTIAL, f"a{j}")
             for j, (fn, c) in enumerate(fns)]))
        if not isinstance(agg, FusedPartialAggExec):
            raise SystemExit("relayout probe: the dict lane was not planned")
        t0 = time.perf_counter()
        rows = [b.to_arrow() for b in agg.execute(0)]
        secs = time.perf_counter() - t0
        out.append((pa.Table.from_batches(rows).combine_chunks(),
                    dict(agg.metrics.values), secs))
    (got, m, secs), (want, cm, _) = out
    if m.get(f"{dev.type}_batches") != len(batches) or \
            m.get("dict_device_relayouts", 0) < 3 or \
            m.get("dict_device_relayouts") != cm.get("dict_device_relayouts"):
        raise SystemExit(f"relayout probe: metrics {m} (CPU {cm})")
    if got.num_rows != want.num_rows or got.schema != want.schema:
        raise SystemExit("relayout probe: shape differs from the CPU's")
    max_rel = 0.0
    for col in got.schema.names:
        a, b = got[col], want[col]
        if pa.types.is_floating(a.type):
            ok, rel = _sums_close(got, want, col)
            max_rel = max(max_rel, rel)
            if not ok or rel > 1e-9:
                raise SystemExit(f"relayout probe: {col} off by {rel}")
        elif not a.equals(b):
            raise SystemExit(f"relayout probe: column {col} differs")
    print(f"{got.num_rows} groups equal to the CPU fold (float sums within "
          f"{max_rel:.3g} relative); {m['dict_device_relayouts']} relayouts,"
          f" {m['dict_device_doublings']} doublings, "
          f"{m['dict_device_batches']} batches on the card in "
          f"{secs:.3f} s")
    return {"groups": got.num_rows, "max_rel": max_rel, "seconds": secs,
            "relayouts": m["dict_device_relayouts"],
            "doublings": m["dict_device_doublings"]}


def family_phase(root):
    """q06 (BASELINE config #2) under auto, off and auto profiled, then q42
    and q03 under auto, and q42 with a small maxSlots (the generic
    engine's fallback: its 17 x 17 codes pass 64), over one SF10 data
    set; returns the runs and the tables and file paths, which the q17
    and q18 phase reads again."""
    plans, secs, tables, paths = family_data(root)
    q06_plan, q06_want = plans["q06"]
    runs = {"q06 auto": family_path("q06", q06_plan, q06_want, "auto"),
            "q06 off": family_path("q06", q06_plan, q06_want, "off"),
            "q06 profiled": _profiled(lambda: family_path(
                "q06", q06_plan, q06_want, "auto", profiled=True), "q06")}
    for name in ("q42", "q03"):
        runs[f"{name} auto"] = family_path(name, *plans[name], "auto")
    runs["q42 fallback"] = family_path("q42", *plans["q42"], "auto",
                                       max_slots=FALLBACK_MAX_SLOTS)
    return {"data_s": secs, "runs": runs}, tables, paths


Q1718_PARTS = 4             # q17, q18: the exchanges' partitions
LINK_SEED = 17              # q17_linked's draw
Q18_STAGES, Q17_STAGES = 5, 7


def q17_q18_data(root, fam_tables, fam_paths):
    """The tables of q17 and q18 at SF10 from their seeds: store_sales and
    item as the q06 phase wrote them (same seeds), the others generated
    and written here (store_returns and catalog_sales in N_FILES files,
    every dimension in one); q17's linked copy (itest/q17_q18.py
    q17_linked) with its store_returns and catalog_sales written again;
    for each run a maker of a fresh plan and its pandas frame; and the
    seconds each step took."""
    from blaze_tpu_torch.itest import q17_q18 as D
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    phase("data: TPC-DS catalog_sales, store_returns, customer, "
          "customer_demographics, customer_address and store at SF10 for "
          "q17 and q18 (store_sales and item from the q06 phase)")
    t0 = time.perf_counter()
    reused = ("store_sales", "item")
    made = [n for n in D.TABLES if n not in reused]
    tables = T.make_tables(SCALE, made)
    tables.update({n: fam_tables[n] for n in reused})
    t1 = time.perf_counter()
    paths = T.write_splits({n: tables[n] for n in made},
                           os.path.join(root, "q17_q18"), N_FILES)
    paths.update({n: fam_paths[n] for n in reused})
    t2 = time.perf_counter()
    linked, k = D.q17_linked(tables, LINK_SEED)
    lpaths = dict(paths)
    lpaths.update(T.write_splits(
        {n: linked[n] for n in ("store_returns", "catalog_sales")},
        os.path.join(root, "q17_linked"), N_FILES))
    t3 = time.perf_counter()
    secs = {"generate": t1 - t0, "write": t2 - t1, "link": t3 - t2}
    print("rows: " + ", ".join(f"{n} {tables[n].num_rows} in "
                               f"{len(paths[n])} file(s)" for n in D.TABLES)
          + f"; generated in {secs['generate']:.1f} s, written in "
          f"{secs['write']:.1f} s; q17_linked: {k} rows linked, written in "
          f"{secs['link']:.1f} s")
    makers = {
        "q18": lambda: Q.plans(paths, tables, Q1718_PARTS, ["q18"])["q18"],
        "q18 all sets": lambda: D.q18_all_sets(paths, tables, Q1718_PARTS),
        "q17": lambda: Q.plans(paths, tables, Q1718_PARTS, ["q17"])["q17"],
        "q17 linked": lambda: Q.plans(lpaths, linked, Q1718_PARTS,
                                      ["q17"])["q17"]}
    runs = {}
    for name, make in makers.items():
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs, k, tables, paths


def _rollup_nulls(got):
    """None when every grouping set of q18's ROLLUP is present and holds
    null keys exactly where the set rolls a column up, else what is
    wrong."""
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest.q17_q18 import Q18_GIDS
    gids = sorted(set(got["g_id"].tolist()))
    if gids != list(Q18_GIDS):
        return f"grouping ids {gids}, expected {list(Q18_GIDS)}"
    for kept, gid in zip((4, 3, 2, 1, 0), Q18_GIDS):
        rows = got[got["g_id"] == gid]
        for i, col in enumerate(Q.Q18_COLS):
            nulls = rows[col].isna()
            if (i < kept and nulls.any()) or (i >= kept
                                              and not nulls.all()):
                return f"g_id {gid}: column {col} nulls {int(nulls.sum())}" \
                       f" of {len(rows)}"
    return None


class _RecordedGroupings:
    """Within a `with` block, every call of kernels/radix.py
    `partition_order` on the card (the shuffle writer's grouping) is
    recorded: its pid column copied to the host, its partition count and
    what the kernel returned.  `check` then holds each one exact against
    the plain version on the same pids."""

    def __enter__(self):
        from blaze_tpu_torch.kernels import radix as R
        self.calls, self._real = [], R.partition_order

        def recording(pids, n_parts):
            got = self._real(pids, n_parts)
            if pids.is_cuda:
                self.calls.append((pids.cpu(), int(n_parts), got))
            return got
        R.partition_order = recording
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch.kernels import radix as R
        R.partition_order = self._real
        return False

    def check(self, label, wrapper_calls):
        """Fails unless the recorded calls are as many as the wrapper
        counted (every launch of the run is checked) and each one's order,
        starts and ends equal partition_order_plain's on the same pids
        (and, pids in range, a stable argsort); returns the calls' row
        counts and partition counts."""
        import numpy as np
        import torch
        from blaze_tpu_torch.kernels import radix as R
        if len(self.calls) != wrapper_calls:
            raise SystemExit(f"{label}: {len(self.calls)} radix groupings "
                             f"recorded for {wrapper_calls} counted")
        shapes = []
        for pids, P, got in self.calls:
            exact, err = _order_exact(got, R.partition_order_plain(pids, P))
            if pids.numel() and int(pids.min()) >= 0 and int(pids.max()) < P:
                exact = exact and np.array_equal(
                    got[0], torch.argsort(pids, stable=True).numpy())
            if not exact:
                raise SystemExit(f"{label}: radix's grouping of {len(pids)} "
                                 f"pids over {P} partitions disagrees with "
                                 f"its plain version (max error {err})")
            shapes.append((len(pids), P))
        print(f"{label}: {len(shapes)} radix groupings on the card, each "
              f"exact against the plain version on its pids (rows, P): "
              f"{shapes}")
        return shapes


class _RecordedPlacements:
    """Within a `with` block, every eager call of kernels/hash_update.py
    `place_in_carry` on the card (outside a CUDA graph capture, where a
    call only records a graph node) is recorded: copies of its operands
    before the call, what it returned, and the `used` flags and key limbs
    it left.  `check` replays each call's operands through the plain
    version and holds every output exact."""

    def __enter__(self):
        import torch
        from blaze_tpu_torch.kernels import hash_update as HU
        self.calls, self._real = [], HU.place_in_carry

        def recording(h, limbs, mask, used, tab, probe_rounds,
                      rollback=False, scratch=None):
            eager = h.is_cuda and not torch.cuda.is_current_stream_capturing()
            before = tuple(t.clone() for t in (h, limbs, mask, used, tab)) \
                if eager else None
            got = self._real(h, limbs, mask, used, tab, probe_rounds,
                             rollback, scratch)
            if eager:
                self.calls.append((before, probe_rounds, rollback,
                                   tuple(g.clone() for g in got),
                                   used.clone(), tab.clone()))
            return got
        HU.place_in_carry = recording
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch.kernels import hash_update as HU
        HU.place_in_carry = self._real
        return False

    def check(self, label):
        """Fails unless each recorded call's outputs, `used` and limbs
        equal the plain version's on the same operands; returns the calls'
        (rows, limbs, slots, masked rows)."""
        import torch
        from blaze_tpu_torch.kernels import hash_update as HU
        shapes = []
        for (h, limbs, mask, used, tab), rounds, rollback, got, used_after, \
                tab_after in self.calls:
            ref = HU.place_in_carry_plain(h, limbs, mask, used, tab, rounds,
                                          rollback)
            exact = (all(torch.equal(a.long(), b.long())
                         for a, b in zip(got, ref))
                     and torch.equal(used, used_after)
                     and torch.equal(tab, tab_after))
            if not exact:
                raise SystemExit(f"{label}: placement of {h.shape[0]} rows "
                                 f"into {tab.shape[1]} slots disagrees with "
                                 f"its plain version")
            shapes.append((h.shape[0], limbs.shape[0], tab.shape[1],
                           int(mask.sum())))
        print(f"{label}: {len(shapes)} eager placements on the card, each "
              f"exact against the plain version on its operands (rows, "
              f"limbs, slots, masked rows): {shapes}")
        return shapes


def q17_q18_path(name, make_plan, want, mode, profiled=False):
    """q18, q18 over all its grouping sets, q17 or q17 on its linked input
    through the port's DagScheduler with the stage loop under `mode`,
    with a fresh plan: the stage count of the reference's split (5 for
    q18, 7 for q17), the rows equal to the pandas frame (in order; the
    all-sets run, which has no sort, as a set), floats within 1e-9
    relative; every batch and every join probe on the card (device probe
    calls = probe batches), radix launched and on the card as counted,
    and each of its groupings exact against the plain version on the
    pids the shuffle writer gave it (_RecordedGroupings).
    q18: the Expand's batches on the card; the all-sets run holds every
    grouping id with null keys where the ROLLUP puts them.  q17: both
    shuffled hash joins probed on the card (the second wherever the
    first emitted rows); on the generator's tables the result is empty,
    on the linked tables not.  With `profiled`, each stage under
    torch.profiler (see _dag_profile)."""
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q06 as F
    from blaze_tpu_torch.itest import q17_q18 as D
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.itest.runner import compare_frames, frame, same_order
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    label = f"{name} {mode}" + (" profiled" if profiled else "")
    query = name.split()[0]
    phase(f"main path {label}: TPC-DS {name} through the stage DAG, SF10, "
          f"{N_FILES} files a fact table, {Q1718_PARTS} exchange partitions")
    _loop_mode(mode)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = _stage_profiling_scheduler() if profiled else DagScheduler()
    plan = make_plan()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    with _RecordedGroupings() as groupings:
        t0 = time.perf_counter()
        out = sched.run_collect(plan)
        wall = time.perf_counter() - t0
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = frame(out)
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    ops = {op: F.operator_counters(sched, op, keys) for op, keys in (
        ("ExpandExec", ("cuda_batches", "cpu_batches", "output_rows")),
        ("ShuffledHashJoinExec", ("probe_batches", "output_rows")),
        ("BroadcastJoinExec", ("probe_batches", "output_rows")),
        ("AggExec", ("cuda_batches", "cpu_batches")))}
    ops = {op: {sid: c for sid, c in per.items() if any(c.values())}
           for op, per in ops.items()}
    tasks = {st.sid: st.num_tasks for st in sched.stages}
    print(sched.describe())
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(
              f"{sid} {w:.3f}" for sid, w in sorted(sched.stage_walls.items()))
          + f"; run {wall:.3f} s")
    for sid in sorted(counters):
        print(f"  stage {sid} ({tasks[sid]} tasks): "
              f"{ {k: v for k, v in counters[sid].items() if v} }")
    print(f"launches: {launches}; join probes {probes}; peak {peak} bytes")
    print(f"per operator and stage: {ops}")
    n_stages = Q18_STAGES if query == "q18" else Q17_STAGES
    if len(sched.stages) != n_stages:
        raise SystemExit(f"{label}: {len(sched.stages)} stages, expected "
                         f"{n_stages}")
    if name == "q18 all sets":  # no sort: the pandas frame as a set
        err = compare_frames(got, want, 1e-9) or (
            list(got.columns) != list(want.columns)
            and f"columns {list(got.columns)}, want {list(want.columns)}")
    else:
        err = same_order(got, want, 1e-9)
    if err or (len(got) == 0) != (name == "q17"):
        raise SystemExit(f"{label}: {len(got)} rows against the oracle's "
                         f"{len(want)}: {err}")
    if name == "q18 all sets":
        err = _rollup_nulls(got)
        if err:
            raise SystemExit(f"{label}: {err}")
        print("grouping sets: " + ", ".join(
            f"g_id {g} {n} rows" for g, n in
            sorted(got["g_id"].value_counts().items())))
    print(f"result: {len(got)} rows equal to the pandas oracle"
          + (", in order" if name != "q18 all sets" else "")
          + (f" (first {got.iloc[0].tolist()})" if len(got) else ""))
    if launches["radix_partition"] <= 0:
        raise SystemExit(f"{label}: radix was never launched")
    shapes = groupings.check(label, launches["radix_partition"])
    off_card = {sid: c["cpu_batches"] for sid, c in counters.items()
                if c["cpu_batches"]}
    if off_card or probes["cpu"]:
        raise SystemExit(f"{label}: work off the card: cpu_batches "
                         f"{off_card}, CPU join probes {probes['cpu']}")
    probe_batches = sum(c["probe_batches"] for c in counters.values())
    if probes["cuda"] != probe_batches or probe_batches <= 0:
        raise SystemExit(f"{label}: {probes['cuda']} device probe calls for "
                         f"{probe_batches} probe batches")
    expand = ops["ExpandExec"]
    if query == "q18" and (not expand or any(
            c["cpu_batches"] or c["cuda_batches"] <= 0
            for c in expand.values())):
        raise SystemExit(f"{label}: the Expand's batches off the card: "
                         f"{expand}")
    if query == "q17":
        shj = [c for _sid, c in
               sorted(ops["ShuffledHashJoinExec"].items())]
        # stage order: ss ⨝ sr feeds the exchange of the second join
        if len(shj) < 1 or shj[0]["probe_batches"] <= 0 or (
                shj[0]["output_rows"] > 0 and (
                    len(shj) != 2 or shj[1]["probe_batches"] <= 0)):
            raise SystemExit(f"{label}: the shuffled hash joins did not "
                             f"both probe on the card: {shj}")
    runs = {k: v for k, v in sched.task_runs.items() if v != 1}
    leaks = sched.leak_report()
    if runs or any(leaks.values()):
        raise SystemExit(f"{label}: tasks ran more than once {runs} or the "
                         f"scheduler leaked {leaks}")
    res = {"query": name, "mode": mode, "wall_s": wall, "rows": len(got),
           "stage_walls": sched.stage_walls, "tasks": tasks,
           "counters": counters, "operators": ops, "launches": launches,
           "probe_calls": probes, "peak_bytes": peak,
           "radix_groupings": shapes}
    if profiled:
        res.update(_dag_profile(sched, label, wall, launches, probes))
    return res


def q17_q18_phase(root, fam_tables, fam_paths):
    """q18 (BASELINE config #3's rollup) under auto, off and auto
    profiled, q18 over all five grouping sets under auto, then q17 under
    auto on the generator's tables (an empty result, as the oracle's) and
    on its linked copy.  Returns the phase's results, and its tables and
    paths (the q06 phase's among them) for the next phase."""
    runs, secs, k, tables, paths = q17_q18_data(root, fam_tables, fam_paths)
    out = {"q18 auto": q17_q18_path("q18", *runs["q18"], "auto"),
           "q18 off": q17_q18_path("q18", *runs["q18"], "off"),
           "q18 profiled": _profiled(lambda: q17_q18_path(
               "q18", *runs["q18"], "auto", profiled=True), "q18"),
           "q18 all sets auto": q17_q18_path(
               "q18 all sets", *runs["q18 all sets"], "auto")}
    for name in ("q17", "q17 linked"):
        out[f"{name} auto"] = q17_q18_path(name, *runs[name], "auto")
    return {"data_s": secs, "linked_rows": k, "runs": out}, tables, paths


Q95W_PARTS = 4              # q95 and the window queries' exchanges


def q95_windows_data(root, tables, paths):
    """The tables of q95 and the window queries at SF10 from their
    seeds: web_sales and web_returns generated and written here (in
    N_FILES files each), store_sales, catalog_sales, item, date_dim and
    customer_address as the earlier phases wrote them (`tables` and
    `paths` hold them, by name); for each query a
    maker of a fresh plan and its pandas frame; and the seconds each step
    took."""
    from blaze_tpu_torch.itest import q95_windows as D
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    phase("data: TPC-DS web_sales and web_returns at SF10 for q95, q12 and "
          "q51 (store_sales, catalog_sales, item, date_dim and "
          "customer_address from the earlier phases)")
    t0 = time.perf_counter()
    made = ("web_sales", "web_returns")
    tables = dict({n: tables[n] for n in D.TABLES if n not in made},
                  **T.make_tables(SCALE, made))
    t1 = time.perf_counter()
    paths = dict({n: paths[n] for n in D.TABLES if n not in made},
                 **T.write_splits({n: tables[n] for n in made},
                                  os.path.join(root, "q95_windows"),
                                  N_FILES))
    t2 = time.perf_counter()
    secs = {"generate": t1 - t0, "write": t2 - t1}
    print("rows: " + ", ".join(f"{n} {tables[n].num_rows} in "
                               f"{len(paths[n])} file(s)" for n in D.TABLES)
          + f"; generated in {secs['generate']:.1f} s, written in "
          f"{secs['write']:.1f} s")
    runs = {}
    for name in D.QUERIES:
        def make(n=name):
            return Q.plans(paths, tables, Q95W_PARTS, [n])[n]
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs, tables, paths


def _dag_query(D, name, make_plan, want, mode, parts, profiled=False,
               record_placements=True):
    """One run of query `name` of the itest module D through the
    port's DagScheduler with the stage loop under `mode`, with a fresh
    plan, and the checks every such path shares: the stage count of the
    reference's split (D.STAGES), the rows equal to the pandas frame in
    the plan's order (D.in_plan_order), floats within 1e-9 relative;
    every batch and every join probe on the card (device probe calls =
    probe batches); radix launched and each of its groupings exact
    against the plain version on the pids the shuffle writer gave it
    (_RecordedGroupings); with `record_placements`, each eager placement
    exact against the plain version on its operands (_RecordedPlacements;
    under `off` every placement is eager, so as many as counted); every
    task run once and nothing leaked.  Returns (the run's result dict,
    the scheduler); the caller
    adds its own checks, then the profile (`profiled`: each stage under
    torch.profiler, _dag_profile)."""
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.itest.runner import frame, same_order
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    label = f"{name} {mode}" + (" profiled" if profiled else "")
    phase(f"main path {label}: TPC-DS {name} through the stage DAG, SF10, "
          f"{N_FILES} files a fact table, {parts} exchange partitions")
    _loop_mode(mode)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = _stage_profiling_scheduler() if profiled else DagScheduler()
    plan = make_plan()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    recorded = _RecordedPlacements() if record_placements else \
        contextlib.nullcontext()
    with _RecordedGroupings() as groupings, recorded as placements:
        t0 = time.perf_counter()
        out = sched.run_collect(plan)
        wall = time.perf_counter() - t0
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = frame(out)
    counters = stage_counters(sched, D.STAGE_COUNTERS)
    tasks = {st.sid: st.num_tasks for st in sched.stages}
    print(sched.describe())
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(
              f"{sid} {w:.3f}" for sid, w in sorted(sched.stage_walls.items()))
          + f"; run {wall:.3f} s")
    for sid in sorted(counters):
        print(f"  stage {sid} ({tasks[sid]} tasks): "
              f"{ {k: v for k, v in counters[sid].items() if v} }")
    print(f"launches: {launches}; join probes {probes}; peak {peak} bytes")
    if len(sched.stages) != D.STAGES[name]:
        raise SystemExit(f"{label}: {len(sched.stages)} stages, expected "
                         f"{D.STAGES[name]}")
    err = same_order(*D.in_plan_order(name, got, want), 1e-9)
    if err or not len(got):
        raise SystemExit(f"{label}: {len(got)} rows against the oracle's "
                         f"{len(want)}: {err}")
    print(f"result: {len(got)} rows equal to the pandas oracle, in order "
          f"(first {got.iloc[0].tolist()})")
    if launches["radix_partition"] <= 0:
        raise SystemExit(f"{label}: radix was never launched")
    shapes = groupings.check(label, launches["radix_partition"])
    placed = placements.check(label) if placements else None
    if placed is not None and mode == "off" and \
            len(placed) != launches["hash_placement"]:
        raise SystemExit(f"{label}: {len(placed)} eager placements recorded "
                         f"for {launches['hash_placement']} counted")
    off_card = {sid: c["cpu_batches"] for sid, c in counters.items()
                if c["cpu_batches"]}
    if off_card or probes["cpu"]:
        raise SystemExit(f"{label}: work off the card: cpu_batches "
                         f"{off_card}, CPU join probes {probes['cpu']}")
    probe_batches = sum(c["probe_batches"] for c in counters.values())
    if probes["cuda"] != probe_batches:
        raise SystemExit(f"{label}: {probes['cuda']} device probe calls for "
                         f"{probe_batches} probe batches")
    runs = {k: v for k, v in sched.task_runs.items() if v != 1}
    leaks = sched.leak_report()
    if runs or any(leaks.values()):
        raise SystemExit(f"{label}: tasks ran more than once {runs} or the "
                         f"scheduler leaked {leaks}")
    res = {"query": name, "mode": mode, "label": label,
           "wall_s": wall, "rows": len(got),
           "stage_walls": sched.stage_walls, "tasks": tasks,
           "counters": counters, "launches": launches,
           "probe_calls": probes, "peak_bytes": peak,
           "radix_groupings": shapes, "placements": placed}
    return res, sched


def q95_windows_path(name, make_plan, want, mode, profiled=False):
    """q95 or a window query through `_dag_query` (itest/q95_windows.py).
    q95: the semi join (EXISTS) and the anti join (NOT EXISTS) each emit
    fewer rows than they take in, and more than 0; its per-order sums
    take the fused hash lane on the card, and each of its eager
    placements equals the plain version on its operands (q51's 1,400 a
    run, its map-side sums, are not recorded: each would keep a copy of
    the table).  The window queries: every WindowExec batch on the
    card."""
    from blaze_tpu_torch.itest import q06 as F
    from blaze_tpu_torch.itest import q95_windows as D
    res, sched = _dag_query(D, name, make_plan, want, mode, Q95W_PARTS,
                            profiled, record_placements=(name == "q95"))
    label, launches = res["label"], res["launches"]
    ops = {op: F.operator_counters(sched, op, keys) for op, keys in (
        ("WindowExec", ("cuda_batches", "cpu_batches", "output_rows")),
        ("SortMergeJoinExec", ("output_rows",)),
        ("AggExec", ("cuda_batches", "cpu_batches")))}
    ops = {op: {sid: c for sid, c in per.items() if any(c.values())}
           for op, per in ops.items()}
    print(f"per operator and stage: {ops}")
    res["operators"] = ops
    if name == "q95":
        rows = D.q95_join_rows(sched)
        print(f"q95 rows after each join: {rows}")
        if launches["hash_placement"] <= 0:
            raise SystemExit(f"{label}: the per-order sums never launched "
                             f"placement")
        if not D.joins_cut(rows):
            raise SystemExit(f"{label}: the semi and anti joins must each "
                             f"remove rows and keep some: {rows}")
        res["join_rows"] = rows
    else:
        windows = ops["WindowExec"]
        if not windows or any(c["cpu_batches"] or c["cuda_batches"] <= 0
                              for c in windows.values()):
            raise SystemExit(f"{label}: WindowExec batches off the card: "
                             f"{windows}")
    if profiled:
        res.update(_dag_profile(sched, label, res["wall_s"], launches,
                                res["probe_calls"]))
    return res


def q95_windows_phase(root, tables, paths):
    """q95 (BASELINE config #4) under auto, off and auto profiled, then
    q12, q20, q98, q51 and q67 under auto and q51 once more profiled;
    returns the runs, and the tables and file paths (web_sales and
    web_returns among them), which the breadth phase reads again."""
    runs, secs, tables, paths = q95_windows_data(root, tables, paths)
    out = {"q95 auto": q95_windows_path("q95", *runs["q95"], "auto"),
           "q95 off": q95_windows_path("q95", *runs["q95"], "off"),
           "q95 profiled": _profiled(lambda: q95_windows_path(
               "q95", *runs["q95"], "auto", profiled=True), "q95")}
    for name in ("q12", "q20", "q98", "q51", "q67"):
        out[f"{name} auto"] = q95_windows_path(name, *runs[name], "auto")
    out["q51 profiled"] = _profiled(lambda: q95_windows_path(
        "q51", *runs["q51"], "auto", profiled=True), "q51")
    return {"data_s": secs, "runs": out}, tables, paths


def _io_bytes(res):
    """`io_bytes` by stage: the Arrow bytes of the batches its scans
    decoded and its shuffle reads returned."""
    return {sid: c["io_bytes"] for sid, c in sorted(res["counters"].items())}


QNEW_PARTS = 4              # q19, q07 and gq1: the exchanges' partitions


def q19_q07_gq1_data(root, tables, paths):
    """The tables of q19, q07 and gq1 at SF10 from their seeds: promotion
    (300 rows, one file) and web_clickstreams (500,000 sessions with a
    list of clicked items each, N_FILES files) generated and written
    here; store_sales, item, date_dim, customer, customer_address,
    customer_demographics and store as the earlier phases wrote them
    (`tables` and `paths` hold them, by name); for each query a maker of
    a fresh plan and its pandas frame; the clicks gq1 must explode; and
    the seconds each step took."""
    import pyarrow.compute as pc
    from blaze_tpu_torch.itest import q19_q07_gq1 as D
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    phase("data: TPC-DS promotion and web_clickstreams at SF10 for q19, q07 "
          "and gq1 (the other tables from the earlier phases)")
    t0 = time.perf_counter()
    made = ("promotion", "web_clickstreams")
    tables = dict({n: tables[n] for n in D.TABLES if n not in made},
                  **T.make_tables(SCALE, made))
    t1 = time.perf_counter()
    paths = dict({n: paths[n] for n in D.TABLES if n not in made},
                 **T.write_splits({n: tables[n] for n in made},
                                  os.path.join(root, "q19_q07_gq1"),
                                  N_FILES))
    t2 = time.perf_counter()
    secs = {"generate": t1 - t0, "write": t2 - t1}
    clicks = int(pc.sum(pc.list_value_length(
        tables["web_clickstreams"].column("wc_clicked_items"))).as_py())
    print("rows: " + ", ".join(f"{n} {tables[n].num_rows} in "
                               f"{len(paths[n])} file(s)" for n in D.TABLES)
          + f"; {clicks} clicks; generated in {secs['generate']:.1f} s, "
          f"written in {secs['write']:.1f} s")
    runs = {}
    for name in D.QUERIES:
        def make(n=name):
            return Q.plans(paths, tables, QNEW_PARTS, [n])[n]
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs, clicks


def q19_q07_gq1_path(name, make_plan, want, mode, clicks, profiled=False):
    """q19, q07 or gq1 through `_dag_query` (itest/q19_q07_gq1.py), every
    eager placement recorded: some join probes on the card, every join
    keeps rows, and gq1's generator emits one row per click."""
    from blaze_tpu_torch.itest import q19_q07_gq1 as D
    res, sched = _dag_query(D, name, make_plan, want, mode, QNEW_PARTS,
                            profiled)
    label = res["label"]
    rows = D.operator_rows(sched)
    print(f"rows out of each join and generator (stage by stage, parents "
          f"first): {rows}")
    res["operator_rows"] = rows
    if res["probe_calls"]["cuda"] <= 0:
        raise SystemExit(f"{label}: no join probed on the card")
    if not rows or any(r <= 0 for v in rows.values() for r in v):
        raise SystemExit(f"{label}: a join or generator emitted no row: "
                         f"{rows}")
    if name == "gq1" and rows.get("GenerateExec") != [clicks]:
        raise SystemExit(f"{label}: the generator emitted "
                         f"{rows.get('GenerateExec')} rows for {clicks} "
                         f"clicks")
    if profiled:
        res.update(_dag_profile(sched, label, res["wall_s"],
                                res["launches"], res["probe_calls"]))
    return res


def q19_q07_gq1_phase(root, tables, paths):
    """q19, q07 and gq1 under auto, q07 under off, then each once more
    under auto, profiled."""
    from blaze_tpu_torch.itest.q19_q07_gq1 import QUERIES
    runs, secs, clicks = q19_q07_gq1_data(root, tables, paths)
    out = {f"{n} auto": q19_q07_gq1_path(n, *runs[n], "auto", clicks)
           for n in QUERIES}
    out["q07 off"] = q19_q07_gq1_path("q07", *runs["q07"], "off", clicks)
    for n in QUERIES:
        out[f"{n} profiled"] = _profiled(
            lambda n=n: q19_q07_gq1_path(n, *runs[n], "auto", clicks,
                                         profiled=True), n)
    return {"data_s": secs, "clicks": clicks, "runs": out}


BREADTH_PARTS = 4           # the breadth phase: the exchanges' partitions
#: the local-mode query: the first whose scans total at most the default
#: auron.tpu.dag.singleTaskBytes at SF10
LOCAL_CANDIDATES = ("q84", "q41")
#: the new shapes: Union, Cast and the nested-loop join
BREADTH_SHAPES = {"q05": "Union", "q93": "Cast",
                  "q90": "the nested-loop join"}
BREADTH_COUNTERS = ("cuda_batches", "cpu_batches", "probe_batches",
                    "io_bytes")
BREADTH_JOINS = ("BroadcastJoinExec", "ShuffledHashJoinExec",
                 "SortMergeJoinExec", "BroadcastNestedLoopJoinExec")


def breadth_data(root, tables, paths):
    """The tables of the breadth phase's queries at SF10 from their
    seeds: those no earlier phase wrote (catalog_returns in N_FILES
    files, reason and time_dim in one) generated and written here, every
    other one as the earlier phases wrote it (`tables` and `paths` hold
    them, by name); for each query a maker of a fresh plan and its
    pandas frame; and the seconds each step took."""
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    names = LOCAL_CANDIDATES + tuple(BREADTH_SHAPES)
    needed = sorted({t for n in names for t in Q.QUERIES[n][1]})
    made = [n for n in needed if n not in tables]
    phase(f"data: TPC-DS {', '.join(made)} at SF10 for the breadth phase "
          f"({', '.join(n for n in needed if n not in made)} from the "
          f"earlier phases)")
    t0 = time.perf_counter()
    tables = dict({n: tables[n] for n in needed if n not in made},
                  **T.make_tables(SCALE, made))
    t1 = time.perf_counter()
    paths = dict({n: paths[n] for n in needed if n not in made},
                 **T.write_splits({n: tables[n] for n in made},
                                  os.path.join(root, "breadth"), N_FILES))
    t2 = time.perf_counter()
    secs = {"generate": t1 - t0, "write": t2 - t1}
    print("rows: " + ", ".join(f"{n} {tables[n].num_rows} in "
                               f"{len(paths[n])} file(s)" for n in needed)
          + f"; generated in {secs['generate']:.1f} s, written in "
          f"{secs['write']:.1f} s")
    runs = {}
    for name in names:
        def make(n=name):
            return Q.plans(paths, tables, BREADTH_PARTS, [n])[n]
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs


def breadth_path(name, make_plan, want, single_task_bytes, expect,
                 profiled=False, record_placements=True):
    """One run of query `name` through the port's DagScheduler with the
    stage loop under auto, a fresh plan, and auron.tpu.dag.singleTaskBytes
    at `single_task_bytes` (None: its default, 64 MiB): fails unless its
    `exec_mode` is `expect`, its rows equal the pandas frame as a set
    (floats within 1e-9 relative), every batch and every join probe on
    the card (device probe calls = probe batches), every radix grouping
    exact against the plain version on its pids, as many as the wrapper
    counted (_RecordedGroupings), with `record_placements` every eager
    placement exact against the plain version on its operands
    (_RecordedPlacements), every task run once and nothing leaked.
    Returns (the run's result dict, the result frame); with `profiled`,
    each stage under torch.profiler (_dag_profile)."""
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.itest.q19_q07_gq1 import operator_rows
    from blaze_tpu_torch.itest.runner import compare_frames, frame
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    stb = ("default" if single_task_bytes is None else single_task_bytes)
    label = f"{name} {expect}" + (" profiled" if profiled else "")
    phase(f"breadth {label}: TPC-DS {name} through DagScheduler, SF10, "
          f"auron.tpu.dag.singleTaskBytes {stb}")
    _loop_mode("auto")
    if single_task_bytes is None:
        config.conf.unset(config.DAG_SINGLE_TASK_BYTES.key)
    else:
        config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, single_task_bytes)
    sched = _stage_profiling_scheduler() if profiled else DagScheduler()
    plan = make_plan()
    scan_bytes = DagScheduler._scan_input_bytes(plan)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    recorded = _RecordedPlacements() if record_placements else \
        contextlib.nullcontext()
    try:
        with _RecordedGroupings() as groupings, recorded as placements:
            t0 = time.perf_counter()
            out = sched.run_collect(plan)
            wall = time.perf_counter() - t0
    finally:
        config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = frame(out)
    counters = stage_counters(sched, BREADTH_COUNTERS)
    tasks = {st.sid: st.num_tasks for st in sched.stages}
    joins = operator_rows(sched, BREADTH_JOINS)
    print(f"exec_mode {sched.exec_mode}; scans {scan_bytes} bytes; "
          f"{len(sched.stages)} stages")
    if sched.stages:
        print(sched.describe())
    print("stage walls, s (host clock, each ending in a device "
          "synchronisation): " + ", ".join(
              f"{sid} {w:.3f}" for sid, w in sorted(sched.stage_walls.items()))
          + f"; run {wall:.3f} s")
    for sid in sorted(counters):
        print(f"  stage {sid} ({tasks.get(sid, 1)} tasks): "
              f"{ {k: v for k, v in counters[sid].items() if v} }")
    print(f"rows out of each join (stage by stage, parents first): {joins}")
    print(f"launches: {launches}; join probes {probes}; peak {peak} bytes")
    if sched.exec_mode != expect:
        raise SystemExit(f"{label}: exec_mode {sched.exec_mode}, expected "
                         f"{expect}")
    err = compare_frames(got, want, 1e-9)
    if err or not len(got):
        raise SystemExit(f"{label}: {len(got)} rows against the oracle's "
                         f"{len(want)}: {err}")
    print(f"result: {len(got)} rows equal to the pandas oracle (first "
          f"{got.iloc[0].tolist()})")
    shapes = groupings.check(label, launches["radix_partition"])
    placed = placements.check(label) if placements else None
    off_card = {sid: c["cpu_batches"] for sid, c in counters.items()
                if c["cpu_batches"]}
    if off_card or probes["cpu"]:
        raise SystemExit(f"{label}: work off the card: cpu_batches "
                         f"{off_card}, CPU join probes {probes['cpu']}")
    if not (sum(c["cuda_batches"] for c in counters.values())
            or probes["cuda"]):
        raise SystemExit(f"{label}: no batch counted on the card and no "
                         f"join probed there")
    probe_batches = sum(c["probe_batches"] for c in counters.values())
    if probes["cuda"] != probe_batches:
        raise SystemExit(f"{label}: {probes['cuda']} device probe calls for "
                         f"{probe_batches} probe batches")
    runs = {k: v for k, v in sched.task_runs.items() if v != 1}
    leaks = sched.leak_report()
    if runs or any(leaks.values()):
        raise SystemExit(f"{label}: tasks ran more than once {runs} or the "
                         f"scheduler leaked {leaks}")
    res = {"query": name, "label": label, "exec_mode": sched.exec_mode,
           "single_task_bytes": stb, "scan_bytes": scan_bytes,
           "wall_s": wall, "rows": len(got), "stages": len(sched.stages),
           "stage_walls": sched.stage_walls, "tasks": tasks,
           "counters": counters, "join_rows": joins, "launches": launches,
           "probe_calls": probes, "peak_bytes": peak,
           "radix_groupings": shapes,
           "placements": None if placed is None else len(placed)}
    if profiled:
        res.update(_dag_profile(sched, label, wall, launches, probes))
    return res, got


def breadth_phase(root, tables, paths, make_q01, q01_want):
    """The local mode at SF10: a query whose scans fit the default
    auron.tpu.dag.singleTaskBytes under the default (local) and with the
    key at 0 (staged), the same rows in the same order both ways; full
    q01 as one local task (the key just above its scan bytes), radix and
    placement launched; then the new shapes under the default settings
    (staged at SF10): q05 (Union), q93 (Cast) and q90 (the nested-loop
    join), and q05 once more profiled stage by stage."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest.runner import same_order
    from blaze_tpu_torch.plan.stages import DagScheduler
    runs, secs = breadth_data(root, tables, paths)
    default = config.DAG_SINGLE_TASK_BYTES.default
    sizes = {n: DagScheduler._scan_input_bytes(runs[n][0]())
             for n in LOCAL_CANDIDATES}
    local = next((n for n in LOCAL_CANDIDATES if sizes[n] <= default), None)
    print(f"scan bytes at SF10: {sizes}; the default singleTaskBytes "
          f"{default}: the local-mode query is {local}")
    if local is None:
        raise SystemExit(f"breadth: none of {LOCAL_CANDIDATES} fits the "
                         f"local mode at SF10: {sizes}")
    out = {}
    out[f"{local} local"], got_local = breadth_path(
        local, *runs[local], None, "local")
    out[f"{local} staged"], got_staged = breadth_path(
        local, *runs[local], 0, "staged")
    err = same_order(got_local, got_staged, 1e-9)
    if err:
        raise SystemExit(f"breadth {local}: local and staged runs differ: "
                         f"{err}")
    print(f"{local}: the local and the staged run give the same "
          f"{len(got_local)} rows in the same order")
    q01_bytes = DagScheduler._scan_input_bytes(make_q01())
    if q01_bytes <= default:
        raise SystemExit(f"breadth: q01's scans ({q01_bytes} bytes) fit the "
                         f"default singleTaskBytes: the full q01 phase would "
                         f"not be staged under the default")
    out["q01 local"], _ = breadth_path("q01", make_q01, q01_want,
                                       q01_bytes + 1, "local")
    for k in ("hash_placement", "radix_partition"):
        if out["q01 local"]["launches"][k] <= 0:
            raise SystemExit(f"breadth q01 local: kernel {k} was never "
                             f"launched")
    for name in BREADTH_SHAPES:
        # q93's 2,700 map-side placements a run are not recorded: each
        # would keep a copy of the table (as q51's in phase 13)
        out[f"{name} staged"], _ = breadth_path(
            name, *runs[name], None, "staged",
            record_placements=(name != "q93"))
    if not out["q90 staged"]["join_rows"].get(
            "BroadcastNestedLoopJoinExec"):
        raise SystemExit("breadth q90: no nested-loop join rows")
    out["q05 profiled"] = _profiled(lambda: breadth_path(
        "q05", *runs["q05"], None, "staged", profiled=True)[0], "q05")
    return {"data_s": secs, "scan_bytes": dict(sizes, q01=q01_bytes),
            "local_query": local, "runs": out}


def pq_rows(path):
    import pyarrow.parquet as pq
    return pq.ParquetFile(path).metadata.num_rows


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from blaze_tpu_torch import config  # fails outside a checkout
    smi = environment()
    config.conf.set(config.TORCH_DEVICE.key, "cuda")
    dev = torch.device("cuda")
    build_kernels()
    crc = crc32c_phase(dev)

    phase("kernels against their plain versions, main-path shapes")
    gen = torch.Generator().manual_seed(1234)
    stream_lookup_cost(dev)
    launch_floor(dev)
    cooperative_capture_probe(gen, dev)
    cases = {"hash_placement": placement_cases(gen, dev),
             "radix_partition": radix_cases(gen, dev),
             "window_step": window_step_cases(gen, dev)}

    loop_phases = {"fold": fold_graph_parity(dev)}

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sr_paths, lo, hi = make_data(root)
        runs = {"q01": q01_path(root, sr_paths, lo, hi, "auto"),
                "rollup": rollup_path(root, sr_paths, lo, hi, "auto"),
                "q01 off": q01_path(root, sr_paths, lo, hi, "off"),
                "rollup off": rollup_path(root, sr_paths, lo, hi, "off")}
        same_result(runs["q01"], runs["q01 off"],
                    ["ctr_customer_sk", "ctr_store_sk"], [],
                    "ctr_total_return", "q01")
        same_result(runs["rollup"], runs["rollup off"], ["store", "d"],
                    ["cnt"], "amt", "rollup")
        by_path = {k: runs[k]["launches"] for k in ("q01", "rollup")}
        from blaze_tpu_torch.itest import q01, rollup

        def q01_run(d):
            return q01.run_q01(sr_paths, lo, hi, d, N_MAPS, N_REDUCES)

        def rollup_run(d):
            return rollup.run_rollup(sr_paths, lo, hi, d, N_MAPS, N_REDUCES)

        profiled = {
            f"{name}{label}": _profiled(
                lambda: profile_path(name, run, root, mode), name)
            for mode, label in (("auto", ""), ("off", " off"))
            for name, run in (("q01", q01_run), ("rollup", rollup_run))}
        oracle = branches_oracle(sr_paths, lo, hi)
        branches = {
            "auto": branches_path(root, sr_paths, lo, hi, "auto", oracle),
            "off": branches_path(root, sr_paths, lo, hi, "off", oracle),
            "profiled": _profiled(lambda: branches_path(
                root, sr_paths, lo, hi, "auto", oracle, profiled=True),
                "q01 branches")}
        by_path["q01 branches"] = branches["auto"]["launches"]
        plan, q01_want, make_q01 = full_data(root)
        full = {"auto": full_path(plan, q01_want, "auto"),
                "off": full_path(plan, q01_want, "off"),
                "profiled": _profiled(lambda: full_path(
                    plan, q01_want, "auto", profiled=True), "q01 full"),
                "lineage": full_path(plan, q01_want, "auto", corrupt=True)}
        by_path["q01 full"] = full["auto"]["launches"]
        family, fam_tables, fam_paths = family_phase(root)
        for name in ("q06", "q42", "q03"):
            by_path[name] = family["runs"][f"{name} auto"]["launches"]
        q17_q18, tables, paths = q17_q18_phase(root, fam_tables, fam_paths)
        for name in ("q18", "q17", "q17 linked"):
            by_path[name] = q17_q18["runs"][f"{name} auto"]["launches"]
        all_tables = dict(fam_tables, **tables)
        all_paths = dict(fam_paths, **paths)
        del fam_tables, tables
        q95_windows, tables, paths = q95_windows_phase(root, all_tables,
                                                        all_paths)
        all_tables.update(tables)
        all_paths.update(paths)
        del tables
        for name in ("q95", "q12", "q20", "q98", "q51", "q67"):
            by_path[name] = q95_windows["runs"][f"{name} auto"]["launches"]
        q19_q07_gq1 = q19_q07_gq1_phase(root, all_tables, all_paths)
        for name in ("q19", "q07", "gq1"):
            by_path[name] = q19_q07_gq1["runs"][f"{name} auto"]["launches"]
        breadth = breadth_phase(root, all_tables, all_paths, make_q01,
                                q01_want)
        del all_tables
        for k, r in breadth["runs"].items():
            if "profiled" not in k:
                by_path[k] = r["launches"]
        relayout = dict_relayout_probe(dev)
        _loop_mode("auto")
        loop_phases["regrow"] = regrow_path(root, sr_paths, lo, hi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("summary")
    for k, r in runs.items():
        del r["table"]
        loop_counters = {st: {c: v for c, v in r["counters"][st].items()
                              if "loop" in c} for st in ("map", "reduce")}
        print(f"{k}: walls map {r['map_s']:.3f} s reduce {r['reduce_s']:.3f}"
              f" s; loop counters {loop_counters}; graphs {r['graphs']}")
    for k, p in profiled.items():
        print(f"{k} profiled: wall {p['wall_s']:.3f} s, busy "
              f"{100 * p['busy_share']:.2f}%, cudaLaunch* "
              f"{p['host_launches']}, cudaGraphLaunch {p['graph_launches']},"
              f" replays {p['graph_replays']}")

    def device_us(name, modes):
        """Device us per call of a kernel on the paths' profiles under the
        stage-loop modes `modes`, or None where no such path ran it."""
        seen = [p["kernels"][name] for p in profiled.values()
                if p["mode"] in modes and p["kernels"][name]["launches"]]
        calls = sum(r["launches"] for r in seen)
        return (sum(r["device_us"] * r["launches"] for r in seen) / calls
                if calls else None)

    def entry(name, source, replaces):
        """One kernel's line: its main case (the first: the main path's
        shape), launches on the main paths (the stage loop under auto),
        and its device time per call on those paths' profiles (on its
        case's profile where no path runs it), beside the staged paths'."""
        main_case = cases[name][0]
        on_paths = device_us(name, ("auto",))
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name] for k, p in by_path.items()},
                "max_abs_err": max(c["err"] for c in cases[name]),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bytes"] / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": main_case.get("library_ms"),
                "device_us": (on_paths if on_paths is not None
                              else main_case["device_us"]),
                "device_us_from": ("main paths" if on_paths is not None
                                   else "kernel case"),
                "device_us_staged": device_us(name, ("off",)),
                "launches_per_call": main_case["launches_per_call"],
                "launches_per_call_by_route": {
                    route: sorted({c["launches_per_call"] for c in cases[name]
                                   if (c.get("n", 0) <= 4096) == (
                                       route == "one tile")})
                    for route in ("one tile", "more tiles")}
                if name == "radix_partition" else None,
                "writer_entry": writer_entry(cases[name][1])
                if name == "radix_partition" else None,
                "parity": True, "cases": cases[name]}

    def writer_entry(c):
        """The shuffle writer's partition_order at q01's shape: its times
        include the copy to the host and the host's work, as does its
        library yardstick (a stable argsort and a bincount, copied)."""
        keys = ("ms", "plain_ms", "library_ms", "device_us",
                "launches_per_call", "device_ops_per_call",
                "kernels_per_call", "syncs_per_call", "host_us")
        return dict({k: c[k] for k in keys}, case=c["case"],
                    bound_ms=c["bytes"] / HBM_BYTES_PER_S * 1e3)

    # main cases: placement at load 0.5 (the map side's steady state),
    # radix's partition_ranks over the writer's 2^19 bucket at P = 16 (the
    # writer's reduce count; its order-only entry at q01's shape beside
    # it), the window step at the rollup's map-side batch
    kernels = [
        entry("hash_placement", "blaze_tpu_torch/csrc/hash_update.cu",
              "blaze_tpu/kernels/hash_update.py:182"),
        entry("radix_partition", "blaze_tpu_torch/csrc/radix.cu",
              "blaze_tpu/kernels/radix.py:122"),
        entry("window_step", "blaze_tpu_torch/csrc/window_table.cu",
              "blaze_tpu/kernels/mxu_agg.py:200"),
    ]
    print("radix on the paths, us on the card per call: " + ", ".join(
        f"{k} {p['kernels']['radix_partition']['device_us']:.2f} "
        f"({p['kernels']['radix_partition']['launches']} calls, "
        f"{p['kernels']['radix_partition']['device_kernels']} kernels)"
        for k, p in profiled.items()))
    for k, b in branches.items():
        print(f"q01 branches {k}: stage walls {b['walls']}, peak "
              f"{b['peak_bytes']} bytes" + (
                  f", busy {100 * b['busy_share']:.2f}%, cudaLaunch* per "
                  f"stage {b['launches_per_stage']}" if "busy_share" in b
                  else ""))
    for k, f in full.items():
        print(f"q01 full {k}: run {f['wall_s']:.3f} s, stage walls "
              f"{ {s: round(w, 3) for s, w in f['stage_walls'].items()} }, "
              f"peak {f['peak_bytes']} bytes" + (
                  f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                  f"stage {f['launches_per_stage']}" if "busy_share" in f
                  else ""))
    print("q06 family data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in family["data_s"].items()))
    for k, f in family["runs"].items():
        print(f"{k}: run {f['wall_s']:.3f} s, stage walls "
              f"{ {s: round(w, 3) for s, w in f['stage_walls'].items()} }, "
              f"peak {f['peak_bytes']} bytes" + (
                  f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                  f"stage {f['launches_per_stage']}" if "busy_share" in f
                  else ""))
    print("q17/q18 data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in q17_q18["data_s"].items())
        + f"; q17_linked rows {q17_q18['linked_rows']}")
    for k, f in q17_q18["runs"].items():
        ops = f["operators"]
        expanded = sum(c["output_rows"] for c in ops["ExpandExec"].values())
        joined = {op: {sid: c["output_rows"] for sid, c in ops[op].items()}
                  for op in ("ShuffledHashJoinExec", "BroadcastJoinExec")}
        print(f"{k}: run {f['wall_s']:.3f} s, {f['rows']} rows, stage walls "
              f"{ {s: round(w, 3) for s, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes; expanded "
              f"rows {expanded}, joined rows by stage {joined}" + (
                  f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                  f"stage {f['launches_per_stage']}" if "busy_share" in f
                  else ""))
    print("q95/windows data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in q95_windows["data_s"].items()))
    for k, f in q95_windows["runs"].items():
        print(f"{k}: run {f['wall_s']:.3f} s, {f['rows']} rows, stage walls "
              f"{ {s: round(w, 3) for s, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes, radix "
              f"groupings (rows, P) {f['radix_groupings']}"
              + (f", join rows {f['join_rows']}" if "join_rows" in f else "")
              + (f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                 f"stage {f['launches_per_stage']}, cumulative scans "
                 f"{f['scan_ms']:.3f} of {1e3 * f['busy_s']:.3f} device ms"
                 if "busy_share" in f else ""))
    print("q19/q07/gq1 data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in q19_q07_gq1["data_s"].items())
        + f"; {q19_q07_gq1['clicks']} clicks")
    for k, f in q19_q07_gq1["runs"].items():
        print(f"{k}: run {f['wall_s']:.3f} s, {f['rows']} rows, stage walls "
              f"{ {s: round(w, 3) for s, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes, join and "
              f"generate rows {f['operator_rows']}, radix groupings (rows, "
              f"P) {f['radix_groupings']}, eager placements "
              f"{len(f['placements'])}"
              + (f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                 f"stage {f['launches_per_stage']}"
                 if "busy_share" in f else ""))
    print("breadth data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in breadth["data_s"].items())
        + f"; scan bytes {breadth['scan_bytes']}")
    for k, f in breadth["runs"].items():
        print(f"{k}: run {f['wall_s']:.3f} s, {f['exec_mode']}, "
              f"{f['stages']} stages, {f['rows']} rows, stage walls "
              f"{ {s_: round(w, 3) for s_, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes, join rows "
              f"{f['join_rows']}, radix groupings (rows, P) "
              f"{f['radix_groupings']}, eager placements {f['placements']}"
              + (f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                 f"stage {f['launches_per_stage']}"
                 if "busy_share" in f else ""))
    # io_bytes by stage on every path, now that every task prunes
    io_bytes = {k: {st: r["counters"][st]["io_bytes"]
                      for st in ("map", "reduce")} for k, r in runs.items()}
    io_bytes.update({f"q01 branches {k}": {
        st: c["io_bytes"] for st, c in b["counters"].items()}
        for k, b in branches.items()})
    for group, prefix in ((full, "q01 full "), (family["runs"], ""),
                          (q17_q18["runs"], ""), (q95_windows["runs"], ""),
                          (q19_q07_gq1["runs"], ""),
                          (breadth["runs"], "breadth ")):
        io_bytes.update({prefix + k: _io_bytes(r)
                         for k, r in group.items()})
    print("io_bytes per stage (scans' decoded and shuffle reads' Arrow "
          "bytes): " + "; ".join(f"{k} {v}" for k, v in io_bytes.items()))
    print(json.dumps({"paths": profiled, "runs": runs,
                      "stage_loop": loop_phases, "branches": branches,
                      "q01_full": full, "q06_family": family,
                      "q17_q18": q17_q18, "q95_windows": q95_windows,
                      "q19_q07_gq1": q19_q07_gq1, "breadth": breadth,
                      "io_bytes": io_bytes,
                      "dict_relayout": relayout, "crc32c": crc}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
