"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the three CUDA kernels of blaze_tpu_torch/csrc, built with nvcc
     for sm_90a into build/kernels/ (one nvcc per source, started
     together);
  3. kernel parity and times at the main paths' shapes: each kernel
     against its plain PyTorch version on the same CUDA tensors (outputs
     must be exactly equal), timed with CUDA events (median of 25 after
     warm-up), beside the plain version, a one-call PyTorch yardstick
     where one exists, and a bound from the bytes moved;
  4. the two main paths, each as TaskDefinition bytes through the port's
     runtime on the card over the same SF10 data (2,875,140 store_returns
     rows in 4 parquet files; 4 map tasks, 16 reduce tasks), each checked
     against a pyarrow group-by, with every kernel's launch count set to 0
     just before the path and read just after it:
       q01     TPC-DS q01's inner two-stage query (hash lane: placement
               and radix kernels);
       rollup  the store-by-day returns rollup (dense window-table lane on
               the map side, hash lane on the reduce side: all three
               kernels);
  5. where the time goes: each path again under torch.profiler, with the
     card's busy share of the wall and the top kernels and host ops;
  6. the kernel table as one JSON line, the card's name and power limit,
     and the result line.

The script imports nothing of the JAX package.  It needs a CUDA card: it
exits non-zero where torch sees none.
"""

from __future__ import annotations

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


def phase(name):
    print(f"== {name}", flush=True)


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
    """The placement operands of one full batch against a table of S
    slots filled to `load` with (customer, store) keys by linear probing
    (the port's own tail, replayed through the plain placement run to
    completion): half the batch's keys are in the table, half are not."""
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
    placed, wslot = HU.placement_plain(
        *HU.placement_inputs(hashed(kc), kc, ones, carry), 1 << 16)
    if bool((placed == S).any()):
        raise SystemExit("placement state: the table could not be filled")
    specs = [("sum", torch.ones(n_fill, dtype=torch.float64, device=dev),
              ones)]
    carry = _hash_step_tail(carry, kc, specs, ones, placed, wslot)
    kc, mask = _key_batch(gen, fresh[:n_fill], fresh[n_fill:], N, dev)
    return HU.placement_inputs(hashed(kc), kc, mask, carry)


def _placement_bytes(h, pend0, npend, placed, L, S_):
    """Bytes the placement must move for these inputs: each round reads,
    for every row still pending, its hash, its L key limbs, the probed
    slot's used flag and L limbs, and its pending entry, and writes its
    two outputs; rows unplaced after the last round stay pending through
    every round."""
    import torch
    k = int(npend.item())
    rows = pend0[:k].long()
    p = placed[rows].long()
    hit_round = torch.where(p < S_, (p - h[rows].long()) & (S_ - 1),
                            torch.full_like(p, ROUNDS - 1))
    row_rounds = int((hit_round + 1).sum().item())
    return row_rounds * (4 + 8 * L + 16), row_rounds


def placement_cases(gen, dev):
    import torch
    from blaze_tpu_torch.kernels import hash_update as HU
    out = []
    for label, load in (("load 0.5", 0.5), ("overflowing", 0.9)):
        h, limbs, pend0, npend, used0, tab0 = _placement_state(gen, dev,
                                                               load)
        args = (h, limbs, pend0, npend, used0, tab0, ROUNDS)
        placed, wslot = HU.placement(*args)
        ref_p, ref_w = HU.placement_plain(*args)
        torch.cuda.synchronize()
        exact = torch.equal(placed, ref_p) and torch.equal(wslot, ref_w)
        err = max(int((placed.long() - ref_p.long()).abs().max()),
                  int((wslot.long() - ref_w.long()).abs().max()))
        ms = time_ms(lambda: HU.placement(*args))
        plain_ms = time_ms(lambda: HU.placement_plain(*args))
        nbytes, row_rounds = _placement_bytes(h, pend0, npend, placed,
                                              limbs.shape[0], S)
        load = float(used0.float().mean())
        unplaced = int((placed[pend0[:int(npend)].long()] == S).sum())
        print(f"placement {label}: n={N} S={S} L={limbs.shape[0]} "
              f"table load {load:.3f} pending {int(npend)} unplaced "
              f"{unplaced} row-rounds {row_rounds} exact={exact} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not exact:
            raise SystemExit(f"placement ({label}) disagrees with its "
                             f"plain version (max abs err {err})")
        out.append({"case": label, "ms": ms, "plain_ms": plain_ms,
                    "bytes": nbytes, "err": err})
    return out


def radix_cases(gen, dev):
    import torch
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels.hashing import spark_partition_ids
    out = []
    bucket = 1 << 19
    real = 290_000
    for P in (16, 200):
        keys = torch.randint(1, 1_000_001, (real,), generator=gen).to(dev)
        store = torch.randint(1, 13, (real,), generator=gen).to(dev)
        ones = torch.ones(real, dtype=torch.bool, device=dev)
        pid = torch.full((bucket,), P, dtype=torch.int32, device=dev)
        pid[:real] = spark_partition_ids([(keys, ones), (store, ones)],
                                         ["int64", "int64"], P)
        got = R.partition_ranks(pid, P, bucket)
        ref = R.partition_ranks_plain(pid, P, bucket)
        torch.cuda.synchronize()
        exact = all(torch.equal(a, b) for a, b in zip(got, ref))
        err = max(int((a.long() - b.long()).abs().max())
                  for a, b in zip(got, ref))
        ms = time_ms(lambda: R.partition_ranks(pid, P, bucket))
        plain_ms = time_ms(lambda: R.partition_ranks_plain(pid, P, bucket))
        lib_ms = time_ms(lambda: torch.argsort(pid, stable=True))
        nbytes = 16 * bucket + 4 * P
        print(f"radix P={P}: bucket {bucket} real rows {real} exact={exact} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
              f"argsort {lib_ms:.4f} ms")
        if not exact:
            raise SystemExit(f"radix (P={P}) disagrees with its plain "
                             f"version (max abs err {err})")
        out.append({"case": f"P={P}", "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bytes": nbytes, "err": err})
    return out


def _window_table_case(gen, dev, layout, gid):
    """Operands of one window-table call: the layout's value arrays for
    the rows of `gid` (a validity 0/1 array, then arrays spanning their
    limbs), on `dev`."""
    import torch
    arrays = []
    for nl in layout.limbs:
        top = (1 << min(31, 8 * nl)) - 1
        if nl == 1 and not arrays:
            top = 1  # the validity array of the rollup's amount
        arrays.append(torch.randint(0, top + 1, (gid.shape[0],),
                                    generator=gen, dtype=torch.int64)
                      .to(torch.int32).to(dev))
    return gid.to(dev), arrays


def window_table_cases(gen, dev):
    import torch
    from blaze_tpu_torch.kernels import window_table as WT
    out = []
    # the rollup's map side at SF10: 12 stores x ~457 days (5,954 dense
    # slots with the NULL slots), amount validity + 16-bit cents; a batch
    # of date-ordered rows covers ~21 days; ~60% of rows are filtered
    rollup = WT.plan_layout(13 * 458, [1, 16])
    if tuple(rollup) != (48, 128, (1, 2), True):
        raise SystemExit(f"window table: the rollup plans {rollup}")
    days = torch.sort(torch.randint(0, 21, (N,), generator=gen)).values
    store = torch.randint(0, 12, (N,), generator=gen)
    gid = (store + 13 * (days + 200)).to(torch.int32)
    gid[torch.rand(N, generator=gen) < 0.6] = rollup.num_slots
    largest = WT.plan_layout(512 * 256, [31, 24])
    if (largest.sh, largest.sl * largest.n_blocks) != (512, 2048):
        raise SystemExit(f"window table: the largest layout is {largest}")
    big_gid = torch.randint(0, largest.num_slots, (N,), generator=gen,
                            dtype=torch.int64).to(torch.int32)
    big_gid[torch.rand(N, generator=gen) < 0.1] = largest.num_slots
    for label, layout, g in (("rollup map batch", rollup, gid),
                             ("largest layout", largest, big_gid)):
        g, arrays = _window_table_case(gen, dev, layout, g)
        got = WT.window_table(g, arrays, layout)
        ref = WT.window_table_plain(g, arrays, layout)
        torch.cuda.synchronize()
        exact = torch.equal(got, ref)
        err = int((got.long() - ref.long()).abs().max())
        table = torch.zeros_like(got)
        ms = time_ms(lambda: WT.window_table(g, arrays, layout, out=table))
        plain_ms = time_ms(lambda: WT.window_table_plain(g, arrays, layout))
        # yardstick: the same sums, slot-major, as one index_add_ of the
        # (n, nb) limb matrix into an (S + 1, nb) table
        S, nb = layout.num_slots, layout.n_blocks
        cols = [torch.ones_like(g)] if layout.presence else []
        for a, nl in zip(arrays, layout.limbs):
            for li in range(nl):
                cols.append((a >> (8 * li)) & 255)
        wmat = torch.stack(cols, 1).contiguous()
        slot = torch.where(g < S, g, S).long()
        yard = torch.zeros(S + 1, nb, dtype=torch.int32, device=dev)
        lib_ms = time_ms(lambda: yard.index_add_(0, slot, wmat))
        live = int((g < S).sum())
        nbytes = 4 * N * (1 + len(arrays)) + 2 * 4 * S * nb
        print(f"window table {label}: n={N} sh={layout.sh} sl={layout.sl} "
              f"limbs={layout.limbs} nb={nb} live rows {live} distinct "
              f"slots {int(torch.unique(g[g < S]).numel())} exact={exact} "
              f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms index_add_ "
              f"{lib_ms:.4f} ms")
        if not exact:
            raise SystemExit(f"window table ({label}) disagrees with its "
                             f"plain version (max abs err {err})")
        out.append({"case": label, "ms": ms, "plain_ms": plain_ms,
                    "library_ms": lib_ms, "bytes": nbytes, "err": err})
    return out


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
    WT.window_table_launches = 0


def _read_launches():
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import window_table as WT
    return {"hash_placement": HU.placement_launches,
            "radix_partition": R.partition_launches,
            "window_table": WT.window_table_launches}


def _check_on_card(res, launches, needed, path):
    for k in needed:
        if launches[k] <= 0:
            raise SystemExit(f"{path} path: kernel {k} was never launched")
    for stage in ("map", "reduce"):
        counts = res["counters"][stage]
        if counts["cpu_batches"] or not counts["cuda_batches"]:
            raise SystemExit(f"{path} path: {stage} batches not all on the "
                             f"card: {counts}")


def q01_path(root, sr_paths, lo, hi):
    import numpy as np
    import pyarrow as pa
    import torch

    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01

    phase("main path q01: TPC-DS q01 inner, SF10, 4 maps x 16 reduces")
    for opt in (config.TORCH_DEVICE, config.BATCH_SIZE,
                config.ON_DEVICE_AGG_CAPACITY):
        print(f"{opt.key} = {opt.get()}")
    shuffle_dir = os.path.join(root, "shuffle")
    os.makedirs(shuffle_dir)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = q01.run_q01(sr_paths, lo, hi, shuffle_dir, N_MAPS, N_REDUCES)
    launches = _read_launches()
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
    print(f"launches on the q01 path: {launches}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")
    if a.num_rows != b.num_rows or not a.select(keys).equals(b.select(keys)):
        raise SystemExit("main path: the group set differs from the oracle")
    got = np.asarray(a["ctr_total_return"].fill_null(np.nan))
    want = np.asarray(b["ctr_total_return"].fill_null(np.nan))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    max_rel = float(np.nanmax(rel)) if len(rel) else 0.0
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: float64 "
          f"atomics add in a run-dependent order)")
    if not np.array_equal(np.isnan(got), np.isnan(want)) or max_rel > 1e-9:
        raise SystemExit("main path: sums differ from the oracle")
    _check_on_card(res, launches, ("hash_placement", "radix_partition"),
                   "q01")
    return launches


def rollup_path(root, sr_paths, lo, hi):
    import numpy as np
    import pyarrow as pa
    import torch

    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import rollup

    phase("main path rollup: store-by-day returns rollup, SF10, 4 maps x "
          "16 reduces")
    for opt in (config.AGG_MXU_ENABLE, config.AGG_MXU_MAX_SLOTS,
                config.AGG_MXU_DECIMAL_SCALE):
        print(f"{opt.key} = {opt.get()}")
    shuffle_dir = os.path.join(root, "shuffle_rollup")
    os.makedirs(shuffle_dir)

    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    res = rollup.run_rollup(sr_paths, lo, hi, shuffle_dir, N_MAPS,
                            N_REDUCES)
    launches = _read_launches()
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
    print(f"launches on the rollup path: {launches}")
    print(f"torch.cuda.max_memory_allocated: {peak} bytes")
    if a.num_rows != b.num_rows or not a.select(keys + ["cnt"]).equals(
            b.select(keys + ["cnt"])):
        raise SystemExit("rollup path: groups or counts differ from the "
                         "oracle")
    got = np.asarray(a["amt"].fill_null(np.nan))
    want = np.asarray(b["amt"].fill_null(np.nan))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    max_rel = float(np.nanmax(rel)) if len(rel) else 0.0
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: the reduce "
          f"side adds float64 with atomics)")
    if not np.array_equal(np.isnan(got), np.isnan(want)) or max_rel > 1e-9:
        raise SystemExit("rollup path: sums differ from the oracle")
    if counters["map"]["mxu_verify_fallback"]:
        raise SystemExit("rollup path: the window-table lane fell back to "
                         "the scatter dense lane")
    if counters["map"]["mxu_rows"] != filtered:
        raise SystemExit(f"rollup path: the window tables counted "
                         f"{counters['map']['mxu_rows']} rows, the filter "
                         f"kept {filtered}")
    _check_on_card(res, launches, ("window_table", "hash_placement",
                                   "radix_partition"), "rollup")
    return launches


def profile_path(name, run, root):
    """A second run of one main path under torch.profiler: the share of
    its wall time the card was busy, and device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    phase(f"where the time goes: the {name} path again, under "
          f"torch.profiler")
    shuffle_dir = os.path.join(root, f"shuffle_{name}_profiled")
    os.makedirs(shuffle_dir)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = run(shuffle_dir)
    wall_us = (res["map_s"] + res["reduce_s"]) * 1e6

    # kernels and copies on the card: one stream, so their durations add
    # up to the busy time
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, c = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    busy_us = sum(t for t, _c in by_name.values())
    print(f"profiled wall {wall_us / 1e6:.3f} s (map {res['map_s']:.3f} s, "
          f"reduce {res['reduce_s']:.3f} s); device busy "
          f"{busy_us / 1e6:.4f} s = {100 * busy_us / wall_us:.2f}% of the "
          f"wall, idle {100 - 100 * busy_us / wall_us:.2f}%")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: kv[1][0],
                               reverse=True)[:12]:
        print(f"  device {t / 1e3:9.3f} ms  calls {c:6d}  {name[:90]}")
    # the port's own kernels (csrc/, anonymous namespaces), wherever they
    # rank: device time per launch on this path
    for name, (t, c) in sorted(by_name.items()):
        if name.startswith("(anonymous namespace)::"):
            print(f"  own    {t / 1e3:9.3f} ms  calls {c:6d}  "
                  f"{t / c:8.3f} us/call  "
                  f"{name.split('::')[1].split('(')[0]}")
    host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    for e in host:
        print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
              f"{e.count:6d}  {e.key[:90]}")
    torch.cuda.synchronize()


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

    phase("kernels against their plain versions, main-path shapes")
    gen = torch.Generator().manual_seed(1234)
    place = placement_cases(gen, dev)
    radix = radix_cases(gen, dev)

    wtab = window_table_cases(gen, dev)

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sr_paths, lo, hi = make_data(root)
        by_path = {"q01": q01_path(root, sr_paths, lo, hi),
                   "rollup": rollup_path(root, sr_paths, lo, hi)}
        from blaze_tpu_torch.itest import q01, rollup
        profile_path("q01", lambda d: q01.run_q01(
            sr_paths, lo, hi, d, N_MAPS, N_REDUCES), root)
        profile_path("rollup", lambda d: rollup.run_rollup(
            sr_paths, lo, hi, d, N_MAPS, N_REDUCES), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def launches(name):
        return {"launches": sum(p[name] for p in by_path.values()),
                "launches_by_path": {k: p[name]
                                     for k, p in by_path.items()}}

    main_place = place[0]   # load 0.5: the map side's steady state
    main_radix = radix[0]   # P = 16: the writer's reduce count
    main_wtab = wtab[0]     # the rollup's map-side batch
    kernels = [
        {"name": "hash_placement", "route": "cuda",
         "source": "blaze_tpu_torch/csrc/hash_update.cu",
         "replaces": "blaze_tpu/kernels/hash_update.py:182",
         **launches("hash_placement"),
         "max_abs_err": max(c["err"] for c in place),
         "ms": main_place["ms"],
         "plain_ms": main_place["plain_ms"],
         "bound_ms": main_place["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": None,
         "parity": True, "cases": place},
        {"name": "radix_partition", "route": "cuda",
         "source": "blaze_tpu_torch/csrc/radix.cu",
         "replaces": "blaze_tpu/kernels/radix.py:122",
         **launches("radix_partition"),
         "max_abs_err": max(c["err"] for c in radix),
         "ms": main_radix["ms"],
         "plain_ms": main_radix["plain_ms"],
         "bound_ms": main_radix["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": main_radix["library_ms"],
         "parity": True, "cases": radix},
        {"name": "window_table", "route": "cuda",
         "source": "blaze_tpu_torch/csrc/window_table.cu",
         "replaces": "blaze_tpu/kernels/mxu_agg.py:200",
         **launches("window_table"),
         "max_abs_err": max(c["err"] for c in wtab),
         "ms": main_wtab["ms"],
         "plain_ms": main_wtab["plain_ms"],
         "bound_ms": main_wtab["bytes"] / HBM_BYTES_PER_S * 1e3,
         "bound_by": "bytes", "library_ms": main_wtab["library_ms"],
         "parity": True, "cases": wtab},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
