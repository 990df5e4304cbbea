"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --short-max-sweep   # only the threshold sweep

Phases, each printing its own lines; any failure exits non-zero:
  1. environment: card name and power limit, torch/CUDA/nvcc versions;
  2. build: the five sources of blaze_tpu_torch/csrc (four CUDA kernel
     sources and the host CRC32C), built with nvcc for sm_90a into
     build/kernels/ (one nvcc per source, started together);
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
     float sums bit for bit: row order on both), its host launches and
     placement kernels under torch.profiler, and one fold graph replayed
     alone: its device operations, the host time of a replay against
     issuing the same body eagerly, and its device time;
  5. the two main paths, each as TaskDefinition bytes through the port's
     runtime on the card over the same SF10 data (2,875,140 store_returns
     rows in 4 parquet files; 4 map tasks, 16 reduce tasks), each with the
     stage loop under auto (the loop) and off (staged), each run checked
     against a pyarrow group-by and the two modes against each other, with
     every kernel's launch count set to 0 just before the path and read
     just after it, and the loop's route checked (16 loop tasks on each
     reduce stage, q01's fallbacks equal to its partial skips, the
     rollup's map side outside the loop):
       q01     TPC-DS q01's inner two-stage query (hash lane: placement,
               radix and the row-order sum's carry form);
       rollup  the store-by-day returns rollup (dense window-table lane on
               the map side, one window-step launch per map batch; hash
               lane on the reduce side);
  6. where the time goes: each path again under torch.profiler with the
     stage loop under auto (q01's staged re-run was cut for the staging
     phase's time), with the card's busy share of the wall, the top
     kernels and host ops, the host launches (cudaLaunch* and
     cudaGraphLaunch apart) and graph replays, and a check that each of
     the port's device kernels ran on the card exactly as often as its
     wrapper counted;
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
     ran; its shuffle frames verified through the plain CRC32C;
 10. q01 full (stage DAG): date_dim, store, customer and store_returns at
     SF10 from their seeds, written with write_parquet_splits(..., 4), and
     TPC-DS q01 (itest/queries.py) through the port's DagScheduler
     (plan/stages.py) with 16 exchange partitions: 6 stages, broadcast
     joins to date_dim, the TN stores and customer on the device probe, a
     sort-merge join, under auto and off, each held to the pandas oracle
     (the 100 c_customer_id exact and in order); fails unless no batch
     and no join probe ran off the card, the device probe calls equal the
     probe batches, and placement and radix launched; the auto run is
     explain_analyze's (plan/explain.py), traced, its tree printed: fails
     unless the bottleneck attribution's categories sum to the span
     extent and the extent to the wall within 1%, the counter registry's
     placement, radix and segment_sum launches equal the wrappers'
     counts, every graph capture left its trace instant, no synchronising
     call (torch's sync debug mode, per stage) came from the operator
     meter, and the profiling service on localhost (port 0) serves
     /metrics.prom and the query's timeline; one run profiled,
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
     partitions under auto and off, then q42 and q03 under
     auto, and q42 once more with auron.tpu.fused.dictDevice.maxSlots
     64; each with a fresh plan (its broadcast builds run again), held
     to its pandas oracle (rows in order; sums within compare_frames'
     1e-6); fails unless 3 stages, no batch and no join probe off the
     card, the device probe calls equal the probe batches, radix launched
     (and placement on q06's count by store), q06's average by category
     ran on the generic engine on the card, q42's and q03's partial and
     final stages ran on the dict-device lane (q03's brands doubling past
     16 codes), and the maxSlots run fell back to the generic engine in
     both;
 12. q17 and q18 (stage DAG, BASELINE config #3): catalog_sales,
     store_returns (4 files each), customer, customer_demographics,
     customer_address and store (one file each) at SF10 from their seeds,
     store_sales and item from phase 11; q18 (ROLLUP through an Expand,
     an IN list, a shuffled hash join to customer) with 4 exchange
     partitions under auto and off, and its plan cut above
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
     and expanded rows;
 13. q95 and windows (stage DAG, BASELINE config #4 and the window
     operator): web_sales and web_returns at SF10 from their seeds (4
     files each), the other tables from phases 11 and 12; q95 (EXISTS as
     a shuffled semi join with a `!=` filter, NOT EXISTS as a shuffled
     anti join, web_sales hashed whole into the semi join's exchange)
     under auto, off and auto profiled; q12, q20, q98 (a whole-partition
     window sum), q51 (running window sums joined by a full outer
     sort-merge join) and q67 (rank() over ROLLUP totals) under auto; 4
     exchange partitions, a fresh plan each, held to the
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
     a broadcast to item) under auto, and gq1 profiled (no run under
     off: q07 has no stage the loop takes, so off is auto's route);
     4 exchange partitions, a fresh plan each, held to the pandas frame
     in order (floats within 1e-9 relative); fails unless the
     reference's stage count, no batch and no join probe off the card,
     device probe calls equal to probe batches, radix launched and every
     grouping exact against its plain version, every eager placement
     exact against its plain version, every join keeping rows and gq1's
     generator emitting one row per click; prints stage walls, tasks,
     peak memory, data and oracle seconds, io_bytes and the rows out of
     each join and generator; then the expressions phase
     (exprs/program.py, itest/runtime_filter.py): (a) three chains (q01's
     date filter over store_returns; a FilterProject with arithmetic,
     Cast, CASE WHEN and COALESCE over store_sales; an IN list of 50
     members) at 32,768 rows and at a lower rung, each replayed as its
     CUDA graph against the same chain eagerly on the card and on the
     CPU, bit for bit, with ms a batch both ways (CUDA events, median of
     25), cudaLaunch* and cudaGraphLaunch a batch, the copy out of the
     graph's buffer, the capture's ms, the chain's operator nodes and
     the route the evaluator takes on the card; fails unless equal, one
     replay a batch and one capture a rung; then the route's break-even:
     filters of 1 to 6 comparisons, replay against eager at 32,768 rows
     (the same bits; ms both ways, eager cudaLaunch*); (b) q19 (its
     date_dim filter, two operator nodes, stays outside the fused
     aggregations) once more under auto with auron.tpu.expr.fuse=false:
     fails unless its frame equals the fused run's bit for bit, with
     fused batches in that run and none off; (c) the runtime filter:
     date_dim's bloom filter (the bloom_filter aggregate over the
     d_year=2000 keys) registered by uuid and probed beside q01 inner's
     range filter at SF10, 4 maps x 16 reduces, then once more in the
     same process under the same uuid with a filter rebuilt over the
     first half of the range: fails unless each run equals the oracle of
     its own filter (phase 5's for the first), no store_returns key in
     the build range fails the probe, the keys and rows outside it pass
     at no more than Spark's fpp of 0.03 plus three standard deviations,
     the second run drops rows the first kept and captures its own map
     graphs, and placement and radix ran on the card; then the adaptive
     phase (plan/adaptive.py, plan/statstore.py, itest/adaptive.py):
     four legs over seeded data, each static and then adaptive with the
     statistics store on, staged, the default thresholds (broadcast 8 MiB,
     coalesce 16 MiB, skew factor 4, 8 splits) unless a leg says other:
     broadcast (a 2^16-key dim shuffle-joined with a 2^22-row fact in 8
     files, 32 partitions; 2^18 and 2^24 before the serving phase came
     in, 2^17 and 2^23 before the streaming phase), skew (the fact's
     keys 70% on one key, 160 partitions, broadcast threshold 0),
     coalesce (partial sum over 2^22 rows, 200
     partitions, the final sum) and history
     (the broadcast leg's adaptive run, made in a fresh store, then one
     run more with auron.tpu.aqe.historySeed), then full q01 and q17 on
     its linked
     tables at SF10 under AQE against their earlier static runs; fails
     unless every run equals its static run (order-insensitive, bit for
     bit) and its pandas oracle, each leg's counters moved (one broadcast
     switch, one stage elided and bytes saved; a skew split and
     partitions coalesced; partitions coalesced; a history seed in the
     second run), radix launched on the card in every leg and the
     coalesce leg's sums ran an aggregation kernel (placement, the
     row-order sum or the window step, by lane), and no rule, history
     seed or ingest logged a warning (a rule that fails keeps the static
     plan); each adaptive run is traced; prints each leg's walls, tasks
     per stage, events, the traced run's bottleneck report
     (bridge/critical_path.py) and the advisor's findings for its stored
     record and that report, with the card's name and power limit; then
     the staging
     and accounting phase's
     second part: one map task of q19's store_sales stage (task 1: the
     first file holds no row of its window) and of q67's fact stage (task
     0), alone, with the IO prefetcher (ops/base.py) on and off, each
     under a profiler of device activity, after the task's scan alone
     under its own profiler: fails unless both ways write the same rows
     (some), map bytes (sha256) and count of cudaMemcpyAsync calls, the
     scan alone makes exactly one cudaMemcpyAsync a batch (its
     host-to-device copies on the card, any stream, short of that by no
     more than the records the profiler lost) and no more batches than
     the task's scans (its broadcast dimension scans too), every scanned
     batch is one placement (`DeviceStager.stage`
     call) and one count of the registry's h2d_transfers, the
     host-to-device copies on the card's copy streams no more than the
     placements and short of them by no more than the lost records, and
     prefetch batches flow only when it is on; prints each task's wall,
     cudaMemcpyAsync calls and host ms, the scan's measured copies a
     batch, the placements a scanned batch and the consumer's prefetch
     wait;
 15. breadth (the single-task local mode, Union, Cast and the
     nested-loop join): catalog_returns (4 files), reason and time_dim at
     SF10 from their seeds, the other tables from phases 10-13; the
     local-mode query (the first of q84 and q41 whose scans fit the
     default auron.tpu.dag.singleTaskBytes, 64 MiB, at SF10) under the
     default (one local task) and with the key at 0 (staged), the same
     rows in the same order both ways; full q01 as one local task (the
     key one byte above its scan bytes, which exceed the default); q05
     (a Union of the three channels' sales and returns), q93 (Casts in a
     left join's measures, over the first of store_sales' 4 files since
     the adaptive phase came in) and q90 (a ratio of two global counts through
     a nested-loop join) under the default, staged at SF10; 4 exchange
     partitions, a fresh plan each,
     held to the pandas frame as a set (floats within 1e-9 relative);
     fails unless each run's exec_mode, no batch and no join probe off
     the card, device probe calls equal to probe batches, every radix
     grouping exact against its plain version as many times as the
     wrapper counted, every eager placement exact against its plain
     version (q93's are not recorded, as q51's), q01's local run launching
     radix and placement, and q90's nested-loop join emitting rows;
     prints each run's wall, exec_mode, stages, scan bytes, io_bytes and
     rows after each join;
 16. strings (the utf8 comparisons, the string expressions and the
     scalar-function registry): q08 (a utf8 `<` on the addresses' zip
     under a broadcast, a left semi join of store_sales by customer) and
     q45 (`substring(ca_zip, 1, 2) IN (...)` OR an item IN list after
     three joins over web_sales) at SF10 over the tables the earlier
     phases wrote (any missing one generated from its seed), each under
     the default auron.tpu.dag.singleTaskBytes (the profiled re-runs
     were cut for the script's time); held to its pandas frame as a set
     with the checks of phase 15; prints each run's wall, exec_mode,
     stages, stage-0 io_bytes, radix and placement launches, and q45's `substring` calls, rows and host seconds beside its stage
     walls; then every case of the port's Spark conformance corpus
     (itest/spark_corpus.py, 357 cases) on the CPU and on CUDA tensors:
     fails unless the same cases pass on both and every case passes (no
     case waits for a later item since the decimal slice);
 17. decimal (the decimal slice): store_returns and web_sales from the
     earlier phases with their money columns as decimal(7,2)
     (itest/decimal_money.py, 4 files each), full q01 (its literal 1.2 a
     decimal(2,1), so `ctr_total_return > avg_return * 1.2` is a p > 18
     comparison on the host) and q12 (its ratio a decimal division) under
     the default auron.tpu.dag.singleTaskBytes, once each under auto,
     unprofiled; each held to its exact oracle (integer cents, Python
     Decimal) with zero tolerance, with the checks of phase 15; fails
     unless radix groups every exchange and placement never runs (the
     decimal sums stay on the generic AggExec), the corpus's 27 decimal
     cases passed on the card in phase 16, and every entry of
     kernels/decimal128.py, the decimal casts and roundings equal their
     CPU results on 2^20 seeded int128 pairs; prints each query's wall,
     stage walls, exec_mode, radix launches and decimal_arith's host
     calls, rows and seconds, and the phase's wall;
 18. front door: the seven checked-in Spark plans (tests/fixtures/: q01,
     q06, q17, q18, q67, q95 and the hand-captured Spark 3.5 q01 agg)
     through plan/stages.py `execute_spark_plan_json` (the port's
     converter, convert/spark.py, then the DagScheduler) at SF10, the
     earlier phases' tables written again in the fixtures' own file
     layout (itest/spark_fixtures.py); each held to its oracle as a set
     (the earlier phases' pandas frames; floats within 1e-6 relative);
     fails unless each is equal and no batch ran off the card; prints
     each plan's converted node classes, exec_mode, stage count and wall;
 19. wire kinds (itest/wire_kinds.py, over phase 5's store_returns, each
     path once under auto): W1, a global sort through a range exchange
     (4 map tasks: a scan with the date predicate pruning row groups, a
     filter, a shuffle writer with range partitioning into 16 by
     customer nulls first and ticket, the bounds from
     `sample_range_bounds` over a seeded 1% sample; 16 reduce tasks:
     ipc_reader, coalesce_batches, sort, ipc_writer into memory), radix
     profiled, then four times more with the scan's post-decode filter
     on, off, off, on (the map walls and fused batches, each run equal
     to the oracle); W2, a round-robin exchange through
     `execute_spark_plan_json` (a Spark plan: FileScan, Exchange
     RoundRobinPartitioning(16), partial and final HashAggregate around a
     hash exchange); W3, q01's inner query over a Hive layout of the same
     rows (one file a store without its column, 4 file groups, the date
     predicate, a debug node at the reduce root) and the FFI probe (one
     map task's scanned batches through an ffi_reader: the same map
     bytes); fails unless W1 equals a pandas sort row for row, W2 a
     pandas group-by (counts exact, sums within 1e-9), W3 phase 5's
     oracle, pruned_row_groups the footers' count and above 0, radix on
     the card as often as counted and every grouping exact, no
     aggregation batch off the card;
 20. q70 at SF1 through itest/breadth.py, held to its oracle (its ROLLUP
     sums one state's single store at two levels and rank() must tie
     them: the dict-device lane's and the generic engine's float sums in
     row order on the card); fails unless equal, the row-order sum kernel
     ran, and every float segment sum of the run equals the CPU's row
     order bit for bit;
 21. segment_sum: the dependent-add probe (one thread, 2^20 adds, float64
     and float32: the floor of any row-order sum), then the three forms of
     csrc/segment_sum.cu against the CPU's row-order sums, bit for bit:
     from +0.0 at q70's recorded call with the longest segment (also
     through the other route) and at one segment of 2^20 rows, into a
     carry at q01's map shape, hot and one segment of 2^20 rows, running
     over 2^20 rows in window partitions of 4,096 and in one; each timed
     beside its plain version and one PyTorch call (`index_add_`,
     `torch.cumsum`), with device time and kernels per call and its bound
     (the larger of the bytes at 3.35 TB/s and the longest segment's
     adds at the probe's latency), failing unless the profile holds its
     two kernels a call; and the engine's lexsort equal on the card and
     the CPU (the sums rest on its stability);
 22. row-order lanes: the hash lane (`scatter_accumulate` into a non-zero
     carry over three batches), staged `hash_agg_step`, the dense lane
     (batch tables and the scatter carry) at q01's map shape and hot, the
     window's running sums (2^20 rows in partitions of 4,096 and in one)
     and the generic engine's global float sum and avg over filtered
     batches whose masked rows stay among the others (AggExec, no keys),
     each run twice on the card: fails unless both runs give the same
     bits and the CPU's, and the engine's sums ran the kernel;
 23. spill: q17 and q95 at SF10 under 32 MiB, q06 under 325 bytes (half
     the 651 its consumers hold) and q51 under half its
     window buffers' peak (memory/manager.py, memory/spill.py), staged,
     each held to its earlier phase's pandas frame; fails unless each
     spilled, every consumer kind spilled and the writer's spill route's
     radix groupings are exact;
 24. the dict-device lane through dictionary growth on the card: a
     partial aggregation over 6 batches whose brands grow from 10 to 260,
     re-laid out 4 times, against the same fold on the CPU (keys and
     integers exact, float sums within 1e-9);
 25. serving (serving/service.py, itest/serving.py): first four checks
     only the card can make: two threads on two private CUDA streams each make
     100 eager placements and 100 `partition_order` calls at q01's shapes
     at once, every result exact against the plain version and the
     wrappers' counts exact; the stage loop's fold at q01's reduce shape
     captured (the thread-local error mode) while another thread
     allocates fresh sizes, copies, waits on events and synchronises on
     its own stream and the legacy default one, equal to the CPU's fold
     (itest/capture_modes.py shows which calls break a capture by mode:
     in thread-local mode only a device-wide synchronisation); two
     threads on two private streams folding through one stage-loop entry
     back to back, the first with a long wait kernel before its drain,
     each carry equal to the CPU's fold (the entry's event orders the
     second's reset after the first's drain; the same run without the
     event is printed, not checked); four running queries'
     streams distinct from each other, from the capture stream and from
     all 64 streams of PyTorch's pool.
     Then full q01, q06 and q95 twice each through QueryService at
     maxConcurrent 1 and then 4 (staged, the loop under auto, the SF10
     tables of phases 10, 11 and 13), each result equal to its oracle and
     to that query's serial run of those phases bit for bit, with each
     level's p50, p99, wall, queries a second and peak memory; q95
     cancelled from the progress hook as its second stage starts
     (QueryCancelled before that stage runs a task), a deadline that
     expires inside its first map task (DeadlineExceeded), then the
     quota ladder over the bytes each task's consumers declared at level
     1 (the quota's unit): full q01 one byte under its largest task's
     peak climbs one or two rungs without the kill and equals its oracle,
     q01 at an eighth of it is killed (QueryMemoryExceeded after three
     breaches), q95 one byte under its peak is killed (its four map tasks
     hold the peak alike), q06 one byte under its peak climbs, each
     leaving no shuffle file, no scratch dir and no manager bytes,
     and a rerun equal to the oracle; admission (maxQueue 1 behind a
     blocked slot: two queue-full; tenant.maxInflight 1: two
     tenant-quota; counts exact; the admitted queries cancelled before
     their slots open); chaos (three full q01 at 2 exchange partitions,
     the JAX soak's, at concurrency 3 under
     task-start=0.05,shuffle-read=0.03, seed 23, 8 recovery rounds,
     each equal to its oracle); then the leaks: device memory back to its level before the
     phase once the fold and program caches are dropped (their size
     printed), no service thread alive, no scratch dir left;
 26. streaming (itest/nexmark.py, itest/streaming.py): Nexmark's bid
     stream (Beam's NEXMark defaults, bids only), 2^20 bids over 4 Kafka
     partitions from seed 7, each bid a JSON record; N1, the Flink front
     door: q2 and a reduced q17 (COMPILE PLAN JSONs) through
     convert/flink_runtime.py's FlinkMicroBatchOperator in micro-batches
     of 32,768 records a partition, each plan partition a TaskDefinition
     through the runtime on the card, every micro-batch held to its
     pyarrow oracle (q2 in order, q17 grouped within each partition;
     integers exact, avg the integer sum over the count), then a committed
     epoch fed again to an operator over the same checkpoints, which must
     run nothing and count one dup skip; N2, the stream:
     StreamExecutor.from_flink_plan on the projection of auction and price
     with q5's hop window (10 s sliding 2 s) keyed by auction (count(*),
     max and sum of price), lateness 0, policy drop, polls of 8,192
     records a partition (32 epochs and the final one), through
     QueryService at maxConcurrent 1 with one stream-epoch and one
     checkpoint-commit fault; fails unless the sink equals a pyarrow
     group-by over the bids row for row (0 lost, 0 duplicated), no late
     record, 2 recoveries, the stream counters agree (epochs,
     checkpoints, sink commits, records, rows) and every decoded batch
     was copied to the card; prints the bids a second, the epoch walls'
     p50 and p99, the checkpoint bytes, the window state's peak bytes, the
     device memory before, after and at its peak, and each kernel's
     launches on N1 and N2;
 27. the paths' profile summary (with io_bytes per stage of every path:
     every task prunes its scans' columns and collapses Filter->Project
     chains, as the JAX package does; each path's expression programs:
     fused and eager batches, programs built, cache hits, graph
     captures, capture ms and replays) and the kernel table as JSON lines
     (the three ported kernels, the row-order sum with its launches by
     form and the host CRC32C: all five built libraries), the card's name
     and power limit, and the result line.

The script imports nothing of the JAX package.  It needs a CUDA card: it
exits non-zero where torch sees none.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types
import weakref

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
#: query -> (maker of a fresh plan, its pandas frame), as the phases that
#: first ran it made them; the spill phase runs them again
ORACLES = {}
#: the query the expressions phase runs again with the fuse off (its
#: date_dim filter, two operator nodes and so a graph on the card, stays
#: outside the fused aggregations), and its result frames by run label
FUSE_OFF_QUERY = "q19"
FRAMES = {}
#: the adaptive phase's TPC-DS legs, by the label of the earlier static
#: run whose frame each is held to
ADAPTIVE_TPCDS = {"q01 full auto": "q01 full", "q17 linked auto": "q17"}
ADAPTIVE_ROWS_LOG2 = 22     # the adaptive legs' fact rows: 2^22 (2^24
                            # before the serving phase came in, 2^23
                            # before the streaming phase)


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
    "segment_sum": ("::heads_kernel<", "::long_kernel<"),
}
PROFILED_CALLS = 20


def _expected_kernels(kernel, launches):
    """The device kernels, by name pattern, that a wrapper's counts
    `launches` (_read_launches) say ran: radix's by kernel (the upsweep
    only for columns of more than one tile), one heads and one long kernel
    per row-order sum, one kernel per call of the others."""
    if kernel == "radix_partition":
        return {RADIX_KERNELS[k]: c
                for k, c in launches["radix_kernels"].items()}
    return {pattern: launches[kernel] for pattern in KERNEL_NAMES[kernel]}


@functools.cache
def _card_consts():
    """The CUDA device type and the stage ranges' prefixes."""
    import torch
    from blaze_tpu_torch.itest.q01 import STAGE_RANGE
    from blaze_tpu_torch.plan.stages import STAGE_RANGE as DAG_RANGE
    return torch.autograd.DeviceType.CUDA, (STAGE_RANGE, DAG_RANGE)


def _on_card(e):
    """Whether a profiler event is work the card ran: a kernel, copy or
    memset.  A named range (torch.profiler.record_function, as
    itest/q01.py `run_stages` and plan/stages.py's DagScheduler open one
    per stage) also appears on the device's timeline and is left out."""
    cuda, ranges = _card_consts()
    return (e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(ranges))


def _once_a_profile(fn):
    """fn(prof) made once a profile, and dropped with the profile (no
    profile is kept alive past its step)."""
    made = weakref.WeakKeyDictionary()

    @functools.wraps(fn)
    def once(prof):
        if prof not in made:
            made[prof] = fn(prof)
        return made[prof]
    return once


@_once_a_profile
def _card_kernels(prof):
    """A profile's kernels on the card (copies and memsets left out)."""
    return [e for e in prof.events()
            if _on_card(e) and not e.name.startswith(("Memcpy", "Memset"))]


@_once_a_profile
def _averages(prof):
    """A profile's key_averages()."""
    return prof.key_averages()


def _device_events(prof, names):
    """(device microseconds, launches) of the kernels named `names` in a
    profile (copies and memsets left out; "" names every kernel)."""
    us, count = 0.0, 0
    for e in _card_kernels(prof):
        if any(k in e.name for k in names):
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
    from blaze_tpu_torch.parallel.stage import init_hash_carry

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
    kc, mask = _key_batch(gen, fresh[:n_fill], fresh[n_fill:], N, dev)
    return hashed(kc), HU.encode_limbs(kc), mask, used, tab


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
    validity, limbs and sum validity exact, and the float sums bit for bit
    (row order into the carry on both: the captured carry form of
    csrc/segment_sum.cu, `index_add_` on the CPU).  Then the card's
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
    sums_exact = _same_float_bits(got, want)
    again = torch.equal(cuda.used, cuda2.used) and all(
        torch.equal(a, b) for a, b in zip(cuda.keys, cuda2.keys)) and \
        _same_float_bits(cuda.accs[0], cuda2.accs[0])
    print(f"fold of {n_batches} batches x {N} rows into {S} slots: "
          f"{int(cuda.used.sum())} groups; integer columns exact={exact}, "
          f"sums bit for bit={sums_exact} (max relative error {rel:.3e}); "
          f"second run equal={again}; counters {m}; graphs {captured}; "
          f"wall {first_s:.3f} s (with the capture), {second_s:.4f} s "
          f"replayed, {cpu_s:.3f} s on the CPU")
    if not exact or not sums_exact or not again:
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
    launch_us = sum(e.self_cpu_time_total for e in _averages(prof)
                    if e.key.startswith("cudaGraphLaunch"))
    print(f"fold replays profiled: host cudaLaunch* {launches['kernel']}, "
          f"cudaGraphLaunch {launches['graph']} ({launch_us:.1f} us of host "
          f"time for {nodes} device operations); placement counted "
          f"{counted}, device kernels {kernels}, "
          f"{place_us / max(kernels, 1):.2f} us on the card per graph node "
          f"(live and gated-off slots); device busy {busy_us / 1e3:.3f} ms")
    replay = replay_cost(prog)
    return {"groups": int(cuda.used.sum()), "max_rel_err": rel,
            "sums_bit_equal": sums_exact, "wall_first_s": first_s, "wall_replayed_s": second_s,
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
    averages = _averages(prof)
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
    from blaze_tpu_torch.kernels import sort as K
    from blaze_tpu_torch.kernels import window_table as WT
    from blaze_tpu_torch.shuffle import crc32c as C
    HU.placement_launches = 0
    R.partition_launches = 0
    for k in R.kernel_launches:
        R.kernel_launches[k] = 0
    WT.window_step_launches = 0
    for form in K.form_launches:
        K.form_launches[form] = 0
    C.built_calls = 0
    _EXPR0.clear()
    _EXPR0.update(_expr_snapshot())


def _read_launches():
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.kernels import sort as K
    from blaze_tpu_torch.kernels import window_table as WT
    from blaze_tpu_torch.shuffle import crc32c as C
    return {"hash_placement": HU.placement_launches,
            "radix_partition": R.partition_launches,
            "window_step": WT.window_step_launches,
            "segment_sum": sum(K.form_launches.values()),
            "segment_sum_forms": dict(K.form_launches),
            "crc32c": C.built_calls,
            "radix_kernels": dict(R.kernel_launches),
            "expr": _expr_delta()}


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
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: the "
          f"oracle's group-by adds in its own order)")
    if not nulls_ok or max_rel > 1e-9:
        raise SystemExit(f"{label}: sums differ from the oracle")
    _check_on_card(res, launches, ("hash_placement", "radix_partition",
                                   "segment_sum"), label)
    _check_loop(res["counters"], mode, label, map_eligible=True)
    return {"launches": launches, "counters": res["counters"],
            "graphs": graphs, "map_s": res["map_s"],
            "reduce_s": res["reduce_s"], "peak_bytes": peak, "table": a,
            "oracle": b}


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
    print(f"sums: max relative error {max_rel:.3e} (limit 1e-9: the "
          f"oracle's group-by adds in its own order)")
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
                                   "radix_partition", "segment_sum"),
                   "rollup")
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
    del res["table"], res["oracle"]
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
    averages = _averages(prof)
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
        # each device kernel as often as the wrapper counted it
        for pattern, want in _expected_kernels(kernel, launches).items():
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
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    crc32c_plain(data)
    plain_ms = (time.perf_counter() - t0) * 1e3
    print(f"1 MiB through the plain version: {plain_ms:.1f} ms")
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
    return {"sizes": out, "check": check, "impl": name, "plain_ms": plain_ms}


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
        for e in sorted((e for e in _averages(prof)
                         if not e.key.startswith(STAGE_RANGE)),
                        key=lambda e: e.self_cpu_time_total,
                        reverse=True)[:10]:
            print(f"  host   {e.self_cpu_time_total / 1e3:9.3f} ms  calls "
                  f"{e.count:6d}  {e.key[:90]}")
        for kernel in ("hash_placement", "radix_partition", "segment_sum"):
            expected = _expected_kernels(kernel, launches)
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
    return plan, want, lambda parts=FULL_PARTS: Q.q01(
        paths, tables, partitions=parts)[0]


def full_path(plan, want, mode, profiled=False, corrupt=False,
              explain=False):
    """Full q01 through the port's DagScheduler with the stage loop under
    `mode`: 6 stages, the 100 c_customer_id exact and in order against the
    pandas oracle, every batch and every join probe on the card, the
    kernels launched.  With `profiled`, each stage under torch.profiler
    (see _dag_profile).  With `corrupt`, the lineage probe: one byte of the
    first non-empty map output of stage 0 is flipped after it commits, and
    exactly that map task must run twice.  With `explain`, the run is
    `explain_analyze`'s, traced, with its checks (_explain_checks)."""
    import pandas as pd
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01_dag as QD
    from blaze_tpu_torch.itest.runner import compare_frames, same_order
    from blaze_tpu_torch.kernels import join as JK
    from blaze_tpu_torch.plan.stages import DagScheduler

    label = (f"q01 full {mode}" + (" profiled" if profiled else "")
             + (" lineage probe" if corrupt else "")
             + (" under explain_analyze" if explain else ""))
    phase(("staging and accounting: " if explain else "main path ")
          + f"{label}: TPC-DS q01 through the stage DAG, SF10, "
          f"{N_FILES} file splits, {FULL_PARTS} exchange partitions")
    _loop_mode(mode)
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    sched = (QD.CorruptingScheduler(0) if corrupt else
             _stage_profiling_scheduler() if profiled else
             _sync_counting_scheduler() if explain else DagScheduler())
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    probes0 = dict(JK.probe_calls)
    t0 = time.perf_counter()
    if explain:
        prof, spans = _explained(plan, sched)
        out = prof.result
    else:
        out = sched.run_collect(plan)
    wall = time.perf_counter() - t0
    launches = _read_launches()
    probes = {k: JK.probe_calls[k] - probes0[k] for k in probes0}
    peak = torch.cuda.max_memory_allocated()
    got = out.to_pandas() if out.num_rows else pd.DataFrame(
        {n: [] for n in out.schema.names})
    if mode == "auto" and not (profiled or corrupt):
        FRAMES["q01 full auto"] = got  # the adaptive phase's static run
        SERIAL["q01"] = got            # and the serving phase's serial one
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
    if explain:
        res.update(_explain_checks(label, prof, spans, sched, launches))
    return res


#: the query id of full q01's explain_analyze run
EXPLAIN_QID = "q01-full-explain"


def _explained(plan, sched):
    """explain_analyze of `plan` on `sched`, traced, the stage loop's fold
    cache emptied first (so its graphs are captured in this run, and each
    capture's trace instant is read); returns (the profile, the spans)."""
    from blaze_tpu_torch.bridge import tracing
    from blaze_tpu_torch.plan.explain import explain_analyze
    from blaze_tpu_torch.runtime import loop
    loop._FOLDS.clear()
    tracing.start_tracing()
    try:
        with sched.counting_syncs():
            prof = explain_analyze(plan, query_id=EXPLAIN_QID,
                                   scheduler=sched, keep_result=True)
    finally:
        spans = tracing.stop_tracing()
    return prof, spans


def _sync_counting_scheduler():
    """A DagScheduler that counts, per stage, the synchronising CUDA calls
    made while the stage runs: torch's sync debug mode set to warn turns
    each into a warning, whose Python stack says whether the operator
    meter (ops/base.py `_count_rows`, `_MeteredIter._finish`) or a metric
    read (bridge/metrics.py `MetricNode.resolve`) made it."""
    import warnings
    import torch
    from blaze_tpu_torch.plan.stages import DagScheduler

    meter = {("base.py", "_count_rows"), ("base.py", "_finish")}
    resolve = {("metrics.py", "resolve")}

    class SyncCounting(DagScheduler):
        def __init__(self):
            super().__init__()
            self.syncs = {}
            self._sid = "outside a stage"

        def _stage_scope(self, sid):
            inner = super()._stage_scope(sid)

            @contextlib.contextmanager
            def scope():
                prev, self._sid = self._sid, sid
                try:
                    with inner:
                        yield
                finally:
                    self._sid = prev
            return scope()

        def _note(self, message, category, filename, lineno, file=None,
                  line=None):
            if "synchroniz" not in str(message):
                return
            frames, f = set(), sys._getframe()
            while f is not None:
                frames.add((os.path.basename(f.f_code.co_filename),
                            f.f_code.co_name))
                f = f.f_back
            c = self.syncs.setdefault(str(self._sid), {
                "syncs": 0, "in_meter": 0, "in_metric_reads": 0})
            c["syncs"] += 1
            c["in_meter"] += bool(frames & meter)
            c["in_metric_reads"] += bool(frames & resolve)

        @contextlib.contextmanager
        def counting_syncs(self):
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = self._note
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    yield
                finally:
                    torch.cuda.set_sync_debug_mode("default")
    return SyncCounting()


def _explain_checks(label, prof, spans, sched, launches):
    """explain_analyze's tree and footers printed; fails unless the
    bottleneck attribution's categories sum to the span extent and the
    extent to the query's wall within 1%, the registry's placement,
    radix and segment_sum launches equal the wrappers' counts the script
    reads, every graph capture of the run left its trace instant, no
    synchronising call came from the operator meter, and the profiling
    service on localhost serves /metrics.prom and the query's timeline."""
    import urllib.request
    from blaze_tpu_torch.bridge import profiling
    from blaze_tpu_torch.runtime import loop
    print(prof.render_text())
    bn = prof.bottleneck
    if bn is None:
        raise SystemExit(f"{label}: no spans for the attribution")
    cats = sum(bn["categories"].values())
    wall_s = prof.wall_ns / 1e9
    print(f"attribution: categories sum {cats:.6f} s, span extent "
          f"{bn['wall_s']:.6f} s, query wall {wall_s:.6f} s; dominant "
          f"{bn['dominant']} ({100 * bn['dominant_fraction']:.1f}%); "
          f"{bn['span_count']} spans")
    if abs(cats - bn["wall_s"]) > 0.01 * bn["wall_s"] or \
            abs(bn["wall_s"] - wall_s) > 0.01 * wall_s:
        raise SystemExit(f"{label}: the categories ({cats:.6f} s), the "
                         f"extent ({bn['wall_s']:.6f} s) and the wall "
                         f"({wall_s:.6f} s) differ by more than 1%")
    reg = {"hash_placement": prof.counters["placement_launches"],
           "radix_partition": prof.counters["radix_launches"],
           "segment_sum": prof.counters["segment_sum_launches"]}
    mine = {k: launches[k] for k in reg}
    print(f"kernel launches: the registry {reg}, the wrappers' counters "
          f"{mine}")
    if reg != mine:
        raise SystemExit(f"{label}: the registry's launches {reg} differ "
                         f"from the wrappers' {mine}")
    captures = [s for s in spans if s["name"] == "graph_capture"]
    # the stage loop's graphs and the expression programs' (exprs/
    # program.py) each leave an instant
    compiled = sum(e.get("compiles", 0) for k, e in prof.kernels.items()
                   if k == "stage_loop_graph"
                   or k.startswith("expr_program_"))
    print(f"graph captures: {len(captures)} trace instants, "
          f"{prof.counters['total_compiles']} compiles in the registry's "
          f"delta, {loop.graph_stats['captures']} since the start")
    if not captures or len(captures) != prof.counters["total_compiles"] \
            or compiled < len(captures):
        raise SystemExit(f"{label}: {len(captures)} graph_capture instants "
                         f"for {prof.counters['total_compiles']} compiles")
    print("synchronising calls per stage (torch's sync debug mode): "
          + "; ".join(f"{sid} {c}" for sid, c in sched.syncs.items()))
    in_meter = sum(c["in_meter"] for c in sched.syncs.values())
    if in_meter:
        raise SystemExit(f"{label}: {in_meter} synchronising calls in the "
                         f"operator meter")
    port = profiling.start_http_service(0)
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics.prom",
                                    timeout=30) as r:
            prom = r.read().decode()
        with urllib.request.urlopen(
                f"{base}/query/{EXPLAIN_QID}/timeline", timeout=30) as r:
            timeline = json.loads(r.read().decode())
    finally:
        profiling.stop_http_service()
    want = "blaze_placement_launches_total"
    events = [e for e in timeline["traceEvents"] if e.get("ph") != "M"]
    print(f"profiling service on port {port}: /metrics.prom "
          f"{len(prom.splitlines())} lines; /query/{EXPLAIN_QID}/timeline "
          f"{len(events)} events, attribution {timeline['attribution']}")
    if want not in prom or len(events) != bn["span_count"]:
        raise SystemExit(f"{label}: the service's exposition or timeline "
                         f"is short ({len(events)} events for "
                         f"{bn['span_count']} spans)")
    return {"explain": {"tree": prof.render_text().splitlines(),
                        "attribution": bn, "syncs": sched.syncs,
                        "registry_launches": reg,
                        "graph_captures": len(captures),
                        "timeline_events": len(events)}}


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
    for kernel in ("hash_placement", "radix_partition", "segment_sum"):
        expected = _expected_kernels(kernel, launches)
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
        ORACLES[name] = plans[name]
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
    if (name, mode, profiled, max_slots) == ("q06", "auto", False, None):
        SERIAL["q06"] = got  # the serving phase's serial run
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
    """q06 (BASELINE config #2) under auto and off, then q42
    and q03 under auto, and q42 with a small maxSlots (the generic
    engine's fallback: its 17 x 17 codes pass 64), over one SF10 data
    set; returns the runs and the tables and file paths, which the q17
    and q18 phase reads again."""
    plans, secs, tables, paths = family_data(root)
    q06_plan, q06_want = plans["q06"]
    runs = {"q06 auto": family_path("q06", q06_plan, q06_want, "auto"),
            "q06 off": family_path("q06", q06_plan, q06_want, "off")}
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
    ORACLES["q17"] = runs["q17"]
    ORACLES["q18"] = runs["q18"]
    ORACLES["q17 linked"] = runs["q17 linked"]
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
    if label in ADAPTIVE_TPCDS:
        FRAMES[label] = got  # the adaptive phase's static run
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
    """q18 (BASELINE config #3's rollup) under auto and off, q18 over all
    five grouping sets under auto, then q17 under
    auto on the generator's tables (an empty result, as the oracle's) and
    on its linked copy.  Returns the phase's results, and its tables and
    paths (the q06 phase's among them) for the next phase."""
    runs, secs, k, tables, paths = q17_q18_data(root, fam_tables, fam_paths)
    out = {"q18 auto": q17_q18_path("q18", *runs["q18"], "auto"),
           "q18 off": q17_q18_path("q18", *runs["q18"], "off"),
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
        ORACLES[name] = runs[name]
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs, tables, paths


def _node_values(sched, op_name, key):
    """`key` of every node named `op_name` in the stages' merged metric
    trees (a peak such as `mem_used` is the largest over its tasks)."""
    out = []
    for tree in sched.stage_metrics.values():
        todo = [tree]
        while todo:
            node = todo.pop()
            if node.name == op_name:
                out.append(node.values.get(key, 0))
            todo.extend(node.children)
    return out


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
    if name == FUSE_OFF_QUERY:
        FRAMES[label] = got
    if (name, mode, profiled) == ("q95", "auto", False):
        SERIAL["q95"] = got  # the serving phase's serial run
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
        # the largest bytes each window buffer held (its MemConsumer's
        # peak), from which the spill phase takes q51's budget
        res["window_buffer_peaks"] = _node_values(sched, "WindowExec",
                                                  "mem_used")
    if profiled:
        res.update(_dag_profile(sched, label, res["wall_s"], launches,
                                res["probe_calls"]))
    return res


def q95_windows_phase(root, tables, paths):
    """q95 (BASELINE config #4) under auto, off and auto profiled, then
    q12, q20, q98, q51 and q67 under auto;
    returns the runs, and the tables and file paths (web_sales and
    web_returns among them), which the breadth phase reads again."""
    runs, secs, tables, paths = q95_windows_data(root, tables, paths)
    out = {"q95 auto": q95_windows_path("q95", *runs["q95"], "auto"),
           "q95 off": q95_windows_path("q95", *runs["q95"], "off"),
           "q95 profiled": _profiled(lambda: q95_windows_path(
               "q95", *runs["q95"], "auto", profiled=True), "q95")}
    for name in ("q12", "q20", "q98", "q51", "q67"):
        out[f"{name} auto"] = q95_windows_path(name, *runs[name], "auto")
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
        ORACLES[name] = runs[name]
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
    """q19, q07 and gq1 under auto, then gq1 once more under auto,
    profiled (no run under off: no stage of q07 enters the loop, so off
    takes auto's route; q19 runs again with the fuse off in the
    expressions phase's (b))."""
    from blaze_tpu_torch.itest.q19_q07_gq1 import QUERIES
    runs, secs, clicks = q19_q07_gq1_data(root, tables, paths)
    out = {f"{n} auto": q19_q07_gq1_path(n, *runs[n], "auto", clicks)
           for n in QUERIES}
    out["gq1 profiled"] = _profiled(lambda: q19_q07_gq1_path(
        "gq1", *runs["gq1"], "auto", clicks, profiled=True), "gq1")
    return {"data_s": secs, "clicks": clicks, "runs": out}


#: the staging phase: (query, the table of the fact stage, the map task
#: it runs: q19's first file holds no row of its date window)
STAGED_FACTS = (("q19", "store_sales", 1), ("q67", "store_sales", 0))


def _table_scan(d, table):
    """The parquet_scan node under plan dict `d` that reads `table`'s
    files, or None."""
    stack = [d]
    while stack:
        d = stack.pop()
        if d.get("kind") == "parquet_scan" and any(
                f"{os.sep}{table}{os.sep}" in p
                for g in d.get("file_groups", []) for p in g):
            return d
        for v in d.values():
            if isinstance(v, dict):
                stack.append(v)
            elif isinstance(v, list):
                stack.extend(x for x in v if isinstance(x, dict))
    return None


def _fact_stage(sched, plan, table):
    """The leaf map stage of `plan` whose scans read `table`'s files."""
    for st in sched.split(plan):
        if st.partitioning is None or st.deps:
            continue
        if _table_scan(st.plan, table) is not None:
            return st
    raise SystemExit(f"no leaf stage of the plan scans {table}")


def _scan_copies(sched, st, table, task, label):
    """The stage's scan of `table` alone, map task `task`, drained under a
    profiler of device activity: its batches and fixed-width columns, the
    cudaMemcpyAsync calls it made, and the host-to-device copies the card
    recorded on any stream.  Nothing but the scan runs, so these are the
    scan's own copies a batch, measured (the task's other operators, and
    its broadcast dimension scans, make copies of their own).  The prefetcher's setting is the caller's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.plan.planner import create_plan
    scan = create_plan(sched._per_task(_table_scan(st.plan, table), task,
                                       st.num_tasks))
    fixed = sum(f.data_type.is_fixed_width for f in scan.schema)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        batches = sum(1 for _ in scan.execute(task))
        torch.cuda.synchronize()
    calls, copied, htod = set(), set(), 0
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if n == "cudaMemcpyAsync":
            calls.add(e.correlation_id())
        elif n.startswith("Memcpy"):
            copied.add(e.correlation_id())
            htod += n.startswith("Memcpy HtoD")
    lost = len(calls - copied)
    print(f"{label}, the scan alone: {batches} batches of {fixed} "
          f"fixed-width columns; cudaMemcpyAsync {len(calls)}, "
          f"host-to-device copies on the card {htod}, {lost} without a "
          f"device record: {len(calls) / max(1, batches):.3f} copies a "
          f"scanned batch")
    if batches <= 0 or len(calls) != batches or \
            not htod <= batches <= htod + lost:
        raise SystemExit(f"{label}: the scan alone made {len(calls)} "
                         f"copies ({htod} host-to-device seen, {lost} "
                         f"records lost) for {batches} batches: not one "
                         f"copy a scanned batch")
    return {"batches": batches, "fixed_columns": fixed,
            "copies": len(calls), "htod_seen": htod, "lost": lost}


def _staged_task(name, table, task, prefetch):
    """Map task `task` of `name`'s stage over `table`, alone, with the IO
    prefetcher on or off, under a profiler of device activity: its wall,
    the cudaMemcpyAsync calls and their host ms, the host-to-device
    copies on the card by stream (a stream that runs no kernel is a
    stager's copy stream), the batch placements by stager (a scan's
    stager, or a thread's for the other batches built on the host), the
    scan batches, the consumer's prefetch wait, and the map output's rows
    and bytes (sha256 of .data and .index)."""
    import hashlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch import config
    from blaze_tpu_torch.batch import DeviceStager
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.plan.stages import DagScheduler
    label = (f"{name} {table} task {task}, prefetch "
             f"{'on' if prefetch else 'off'}")
    _loop_mode("auto")
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    config.conf.set(config.IO_PREFETCH_ENABLE.key, prefetch)
    sched = DagScheduler()
    st = _fact_stage(sched, ORACLES[name][0](), table)
    scan = _scan_copies(sched, st, table, task, label)
    placed = {"scan": 0, "thread": 0}
    stage = DeviceStager.stage

    def counted(self, nbytes, pack):
        placed["scan" if self.consumer is not None else "thread"] += 1
        return stage(self, nbytes, pack)
    DeviceStager.stage = counted
    before = device_stats.snapshot()
    try:
        os.makedirs(sched._dir, exist_ok=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sched._run_map_task(st, sched._part_of(st), task)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        delta = device_stats.delta(before)
        data = sched._map_data_path(st.sid, task)
        digest = {}
        for suffix, path in (("data", data), ("index", data[:-5] + ".index")):
            with open(path, "rb") as f:
                digest[suffix] = hashlib.sha256(f.read()).hexdigest()
        tree = sched.stage_metrics[st.sid]
    finally:
        DeviceStager.stage = stage
        sched.cleanup()
        config.conf.unset(config.IO_PREFETCH_ENABLE.key)
    memcpy = memcpy_ns = 0
    htod, kernels, calls, copied = {}, set(), set(), set()
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        if n == "cudaMemcpyAsync":
            memcpy += 1
            memcpy_ns += (e.duration_ns() if hasattr(e, "duration_ns")
                          else e.duration_us() * 1e3)
            calls.add(e.correlation_id())
        elif n.startswith("Memcpy"):
            copied.add(e.correlation_id())
            if n.startswith("Memcpy HtoD"):
                htod[e.device_resource_id()] = \
                    htod.get(e.device_resource_id(), 0) + 1
        elif e.device_type() == torch.autograd.DeviceType.CUDA and \
                not n.startswith("Memset"):
            kernels.add(e.device_resource_id())
    on_copy_streams = sum(c for sid, c in htod.items() if sid not in kernels)
    # copies whose device record the profiler lost (PERF.md §7)
    lost = len(calls - copied)
    scans, todo = 0, [tree]
    while todo:
        node = todo.pop()
        if node.name == "ParquetScanExec":
            scans += node.values.get("output_batches", 0)
        todo.extend(node.children)
    res = {"query": name, "stage": st.sid, "task": task,
           "prefetch": prefetch, "lost_copy_records": lost,
           "wall_s": wall, "rows": tree.values.get("output_rows", 0),
           "digest": digest, "scan_batches": scans, "scan_alone": scan,
           "placements": placed, "htod_copies": sum(htod.values()),
           "htod_on_copy_streams": on_copy_streams,
           "cudaMemcpyAsync": memcpy, "memcpy_host_ms": memcpy_ns / 1e6,
           "prefetch_batches": delta["prefetch_batches"],
           "prefetch_wait_ns": delta["prefetch_wait_ns"],
           "h2d_transfers": delta["h2d_transfers"],
           "h2d_bytes": delta["h2d_bytes"]}
    print(f"{label} (stage {st.sid}): wall {wall:.3f} s, {res['rows']} rows "
          f"written; cudaMemcpyAsync {memcpy} ({memcpy_ns / 1e6:.1f} host "
          f"ms); host-to-device copies on the card {sum(htod.values())}, "
          f"{on_copy_streams} of them on copy streams; placements (stage "
          f"calls) {placed} for {res['scan_batches']} scanned batches "
          f"({placed['scan'] / max(1, res['scan_batches']):.3f} placements "
          f"a batch); "
          f"prefetch {delta['prefetch_batches']} batches, consumer wait "
          f"{delta['prefetch_wait_ns'] / 1e6:.1f} ms; {lost} copies without "
          f"a device record")
    staged = placed["scan"] + placed["thread"]
    if scan["batches"] > res["scan_batches"] or \
            placed["scan"] != res["scan_batches"] or \
            delta["h2d_transfers"] != staged or res["rows"] <= 0:
        raise SystemExit(f"{label}: not one placement a scanned batch, "
                         f"the scan alone gave more batches than all the "
                         f"task's scans, or no row written: {res}")
    # the profiler drops some copies' device records in every run of
    # this size (PERF.md §7): none may be missing beyond those
    if not on_copy_streams <= staged <= on_copy_streams + lost:
        raise SystemExit(f"{label}: {on_copy_streams} copies on copy "
                         f"streams for {staged} placements, {lost} records "
                         f"lost: not one copy a placement")
    if (delta["prefetch_batches"] > 0) != prefetch:
        raise SystemExit(f"{label}: prefetch batches "
                         f"{delta['prefetch_batches']}")
    return res


def staging_phase():
    """q19's store_sales stage and q67's fact stage, one map task of each
    (STAGED_FACTS), with the IO prefetcher on and off: the same rows and
    map bytes both ways, the same cudaMemcpyAsync count both ways, one
    copy a placement, and the scan alone one copy a scanned batch."""
    phase("staging and accounting: q19's store_sales stage and q67's fact "
          "stage (one map task of 4 each, SF10) with the IO prefetcher on "
          "and off")
    t0 = time.perf_counter()
    out = {}
    for name, table, task in STAGED_FACTS:
        on, off = (_staged_task(name, table, task, p) for p in (True, False))
        if (on["rows"], on["digest"]) != (off["rows"], off["digest"]):
            raise SystemExit(f"{name}: prefetch on and off differ: rows "
                             f"{on['rows']} and {off['rows']}, map bytes "
                             f"{on['digest']} and {off['digest']}")
        if on["cudaMemcpyAsync"] != off["cudaMemcpyAsync"]:
            raise SystemExit(f"{name}: cudaMemcpyAsync {on['cudaMemcpyAsync']}"
                             f" with the prefetcher on, "
                             f"{off['cudaMemcpyAsync']} off")
        print(f"{name}: the same {on['rows']} rows, map bytes and "
              f"{on['cudaMemcpyAsync']} cudaMemcpyAsync both ways; "
              f"task wall {on['wall_s']:.3f} s on, {off['wall_s']:.3f} s off")
        out[name] = {"on": on, "off": off}
    out["wall_s"] = time.perf_counter() - t0
    return out


BREADTH_PARTS = 4           # the breadth phase: the exchanges' partitions
#: the local-mode query: the first whose scans total at most the default
#: auron.tpu.dag.singleTaskBytes at SF10
LOCAL_CANDIDATES = ("q84", "q41")
#: the new shapes: Union, Cast and the nested-loop join
BREADTH_SHAPES = {"q05": "Union", "q93": "Cast",
                  "q90": "the nested-loop join"}
#: breadth queries run over the first of their fact table's N_FILES files
#: (a quarter of its rows), to hold the script's time with the adaptive
#: phase: q93's store_sales (its full depth took 46.6 s)
BREADTH_DEPTH_CUT = {"q93": "store_sales"}
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
            p, t = paths, tables
            if n in BREADTH_DEPTH_CUT:  # the first file of the fact only
                fact = BREADTH_DEPTH_CUT[n]
                per = -(-tables[fact].num_rows // len(paths[fact]))
                p = dict(paths, **{fact: paths[fact][:1]})
                t = dict(tables, **{fact: tables[fact].slice(0, per)})
            return Q.plans(p, t, BREADTH_PARTS, [n])[n]
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs


def breadth_path(name, make_plan, want, single_task_bytes, expect,
                 profiled=False, record_placements=True, check=None,
                 allow_empty=False):
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
    each stage under torch.profiler (_dag_profile).  `check(result
    table)`, where given, replaces the pandas comparison: '' where the
    result equals its exact oracle, else what differs.  `allow_empty`
    admits an empty result where the oracle's frame is empty too."""
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
    if allow_empty and not len(want):
        err = f"{len(got)} rows where the oracle has none" if len(got) \
            else None
    else:
        err = check(out) if check else compare_frames(got, want, 1e-9)
    if err or not (len(got) or allow_empty):
        raise SystemExit(f"{label}: {len(got)} rows against the oracle's "
                         f"{len(want)}: {err}")
    print(f"result: {len(got)} rows equal to the "
          f"{'exact' if check else 'pandas'} oracle"
          + (f" (first {got.iloc[0].tolist()})" if len(got) else ""))
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
    join)."""
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
        with _TimedRowOrderSums() as timed:
            out[f"{name} staged"], _ = breadth_path(
                name, *runs[name], None, "staged",
                record_placements=(name != "q93"))
        sums = out[f"{name} staged"]["row_order_sums"] = timed.summary()
        print(f"{name}: wall {out[f'{name} staged']['wall_s']:.3f} s; "
              f"row-order sums by form (calls, ms on the card's clock from "
              f"each call's first operation to its last) {sums}")
    if not out["q90 staged"]["join_rows"].get(
            "BroadcastNestedLoopJoinExec"):
        raise SystemExit("breadth q90: no nested-loop join rows")
    return {"data_s": secs, "scan_bytes": dict(sizes, q01=q01_bytes),
            "local_query": local, "runs": out}


STRINGS_QUERIES = ("q08", "q45")
#: the strings queries run once more profiled (q45's re-run was cut to
#: hold a start inside the script's time with the decimal phase, q08's
#: with the front door: its trace took 60 s to read)
STRINGS_PROFILED = ()


def strings_data(root, tables, paths):
    """q08's and q45's tables at SF10 (those no earlier phase wrote
    generated and written here), a fresh-plan maker and the pandas frame
    of each, and the seconds each step took."""
    from blaze_tpu_torch.itest import queries as Q
    from blaze_tpu_torch.itest import tpcds_data as T
    needed = sorted({t for n in STRINGS_QUERIES for t in Q.QUERIES[n][1]})
    made = [n for n in needed if n not in tables]
    phase(f"data: TPC-DS {', '.join(needed)} at SF10 for q08 and q45 "
          f"({', '.join(made) or 'none'} generated here, the rest from the "
          f"earlier phases)")
    t0 = time.perf_counter()
    tables = dict({n: tables[n] for n in needed if n not in made},
                  **T.make_tables(SCALE, made))
    paths = dict({n: paths[n] for n in needed if n not in made},
                 **T.write_splits({n: tables[n] for n in made},
                                  os.path.join(root, "strings"), N_FILES))
    secs = {"data": time.perf_counter() - t0}
    print("rows: " + ", ".join(f"{n} {tables[n].num_rows} in "
                               f"{len(paths[n])} file(s)" for n in needed))
    runs = {}
    for name in STRINGS_QUERIES:
        def make(n=name):
            return Q.plans(paths, tables, BREADTH_PARTS, [n])[n]
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want)
        print(f"pandas oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs


def corpus_on_card():
    """Every case of the port's Spark conformance corpus on the CPU, then
    on CUDA tensors: the same cases must pass on both, and each other
    case must be one that waits for a later item (`later_item`)."""
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import spark_corpus as C
    phase("strings: the Spark conformance corpus on the CPU and on the "
          "card")
    cases = [(s, c) for s, cs in sorted(C.SUITES.items()) for c in cs]
    passed, secs = {}, {}
    for device in ("cpu", "cuda"):
        config.conf.set(config.TORCH_DEVICE.key, device)
        t0 = time.perf_counter()
        try:
            passed[device] = {(s, c.name) for s, c in cases
                              if C.run_case(s, c).passed}
        finally:
            config.conf.set(config.TORCH_DEVICE.key, "cuda")
        torch.cuda.synchronize()
        secs[device] = time.perf_counter() - t0
        print(f"{device}: {len(passed[device])} of {len(cases)} cases pass "
              f"in {secs[device]:.2f} s")
    later = {(s, c.name): C.later_item(s, c) for s, c in cases
             if C.later_item(s, c) is not None}
    for (s, n), item in sorted(later.items()):
        print(f"  waits for {item}: {s}::{n}")
    if passed["cuda"] != passed["cpu"]:
        raise SystemExit(
            f"corpus: the card's passing set differs from the CPU's: only "
            f"on the CPU {sorted(passed['cpu'] - passed['cuda'])}, only on "
            f"the card {sorted(passed['cuda'] - passed['cpu'])}")
    failing = {(s, c.name) for s, c in cases} - passed["cuda"]
    if failing != set(later):
        raise SystemExit(f"corpus: failing cases {sorted(failing)} are not "
                         f"the later-item cases {sorted(later)}")
    decimal = {(s, c.name) for s, c in cases if C.holds_decimal(c)}
    return {"cases": len(cases), "passed": len(passed["cuda"]),
            "decimal_cases": len(decimal),
            "decimal_passed": len(decimal & passed["cuda"]),
            "later": {f"{s}::{n}": item for (s, n), item in later.items()},
            "seconds": secs}


def strings_phase(root, tables, paths):
    """q08 and q45 at SF10 under the default singleTaskBytes (q08 once
    more profiled stage by stage), q45's `substring` host seconds beside
    its stage walls, and the corpus on the card."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.funcs.strings import SUBSTRING_STATS
    from blaze_tpu_torch.plan.stages import DagScheduler
    runs, secs = strings_data(root, tables, paths)
    default = config.DAG_SINGLE_TASK_BYTES.default
    out, substring = {}, {}
    for name in STRINGS_QUERIES:
        scan = DagScheduler._scan_input_bytes(runs[name][0]())
        expect = "local" if scan <= default else "staged"
        before = dict(SUBSTRING_STATS)
        out[name], _ = breadth_path(name, *runs[name], None, expect)
        substring[name] = {k: SUBSTRING_STATS[k] - before[k]
                           for k in SUBSTRING_STATS}
        r = out[name]
        stage0 = r["counters"].get(min(r["counters"]), {}) \
            if r["counters"] else {}
        print(f"{name}: wall {r['wall_s']:.3f} s, {r['exec_mode']}, "
              f"{r['stages']} stages, stage-0 io_bytes "
              f"{stage0.get('io_bytes')}, radix "
              f"{r['launches']['radix_partition']}, placement "
              f"{r['launches']['hash_placement']}; substring "
              f"{substring[name]['calls']} calls ("
              f"{substring[name]['vector']} vectorised), "
              f"{substring[name]['rows']} rows, "
              f"{substring[name]['seconds']:.3f} host s of "
              f"{r['wall_s']:.3f} s")
        if name in STRINGS_PROFILED:
            out[f"{name} profiled"] = _profiled(
                lambda n=name, e=expect: breadth_path(
                    n, *runs[n], None, e, profiled=True)[0], name)
    if not substring["q45"]["calls"] or substring["q08"]["calls"]:
        raise SystemExit(f"strings: substring calls {substring}: q45 must "
                         f"call it and q08 must not")
    return {"data_s": secs, "runs": out, "substring": substring,
            "corpus": corpus_on_card()}


DECIMAL_QUERIES = ("q01", "q12")


def decimal_data(root, tables, paths):
    """store_returns and web_sales at SF10 from the earlier phases with
    their money columns as decimal(7,2) (itest/decimal_money.py), written
    in N_FILES files each; the dimensions' files reused; each query's
    plan maker, exact oracle and checker; the seconds each step took."""
    from blaze_tpu_torch.itest import decimal_money as M
    from blaze_tpu_torch.itest import tpcds_data as T
    phase("data: TPC-DS store_returns and web_sales at SF10 with their "
          "money as decimal(7,2), the other tables from the earlier phases")
    t0 = time.perf_counter()
    facts = M.with_money({n: tables[n] for n in M.MONEY_COLUMNS})
    secs = {"convert": time.perf_counter() - t0}
    t0 = time.perf_counter()
    dpaths = dict(paths, **T.write_splits(facts, os.path.join(
        root, "decimal"), N_FILES))
    dtables = dict(tables, **facts)
    secs["write"] = time.perf_counter() - t0
    print("rows: " + ", ".join(
        f"{n} {facts[n].num_rows} in {len(dpaths[n])} files, money "
        f"{M.MONEY_COLUMNS[n]}" for n in facts))
    runs = {}
    for name, build, check in (("q01", M.q01, M.check_q01),
                               ("q12", M.q12, M.check_q12)):
        def make(b=build):
            return b(dpaths, dtables, BREADTH_PARTS)
        t = time.perf_counter()
        want = make()[1]()
        secs[f"oracle {name}"] = time.perf_counter() - t
        runs[name] = ((lambda m=make: m()[0]), want,
                      (lambda out, c=check, w=want: c(out, w)))
        print(f"exact oracle {name}: {len(want)} rows in "
              f"{secs[f'oracle {name}']:.1f} s")
    return runs, secs


def decimal128_on_card(n=1 << 20):
    """Every entry of kernels/decimal128.py, the decimal casts of
    kernels/cast.py and the decimal roundings of the aggregates and
    functions on n seeded int128 pairs (and unscaled int64s) on the card,
    each exactly equal to the same call on the CPU: integer semantics
    (shifts, wraps, truncating and flooring division) that could differ on
    CUDA show here."""
    import torch
    from blaze_tpu_torch.funcs.math import _round_unscaled
    from blaze_tpu_torch.kernels import cast as KC
    from blaze_tpu_torch.kernels import decimal128 as K
    from blaze_tpu_torch.ops.agg.functions import decimal_avg
    from blaze_tpu_torch.schema import DataType, TypeId
    phase(f"decimal: kernels/decimal128.py, the decimal casts and roundings "
          f"on {n} seeded int128 pairs on the card against the CPU")
    g = torch.Generator().manual_seed(77)

    def rand(lo, hi):
        return torch.randint(lo, hi, (n,), generator=g, dtype=torch.int64)
    x = {k: rand(-(1 << 63), (1 << 63) - 1) for k in ("ah", "al", "bh", "bl")}
    edge = torch.tensor([-(1 << 63), (1 << 63) - 1, 0, -1, 1, 1 << 32,
                         -(1 << 32), 1 << 31])
    for k in x:
        x[k][:len(edge)] = edge.roll(len(k))
    sign = torch.where(rand(0, 2) == 0, -1, 1)
    x["u18"] = rand(0, 10 ** 18) * sign            # p <= 18 unscaled
    x["odd"] = (rand(0, 10 ** 11) * 10 + 5) * sign  # odd halves, both signs
    x["valid"] = rand(0, 8) > 0
    x["counts"] = rand(1, 1 << 16)
    dec = lambda p, s: DataType(TypeId.DECIMAL, p, s)  # noqa: E731
    entries = {
        "u_lt": lambda x: K.u_lt(x["al"], x["bl"]),
        "add128": lambda x: K.add128(x["ah"], x["al"], x["bh"], x["bl"]),
        "sub128": lambda x: K.sub128(x["ah"], x["al"], x["bh"], x["bl"]),
        "neg128": lambda x: K.neg128(x["ah"], x["al"]),
        "eq128": lambda x: K.eq128(x["ah"], x["al"], x["ah"], x["bl"]),
        "lt128": lambda x: K.lt128(x["ah"], x["al"], x["bh"], x["bl"]),
        "fits_int64": lambda x: K.fits_int64(x["ah"], x["al"]),
        "add_overflows": lambda x: K.add_overflows(x["ah"], x["bh"],
                                                   x["ah"] + x["bh"]),
        "from_int64": lambda x: K.from_int64(x["al"]),
        "rescaled_pair 2->20": lambda x: K.rescaled_pair(x["u18"], 2, 20),
        "decimal_avg": lambda x: decimal_avg(x["odd"], x["counts"]),
        "cast decimal(18,3)->int32": lambda x: KC.cast_column(
            x["odd"], x["valid"], dec(18, 3), DataType(TypeId.INT32)),
        "cast decimal(18,2)->float64": lambda x: KC.cast_column(
            x["u18"], x["valid"], dec(18, 2), DataType(TypeId.FLOAT64)),
        "cast int64->decimal(18,4)": lambda x: KC.cast_column(
            x["al"], x["valid"], DataType(TypeId.INT64), dec(18, 4)),
    }
    for m in (10, 10 ** 9, (1 << 31) - 1):
        entries[f"mul_small {m}"] = \
            lambda x, m=m: K.mul_small(x["ah"], x["al"], m)
    for k in (1, 9, 18, 20):
        entries[f"mul_pow10 {k}"] = \
            lambda x, k=k: K.mul_pow10(x["ah"], x["al"], k)
    for src, dst in (((18, 0), (18, 2)), ((18, 4), (18, 1)),
                     ((12, 1), (9, 0)), ((18, 2), (7, 2))):
        entries[f"rescale {src}->{dst}"] = \
            lambda x, a=src, b=dst: KC.cast_column(
                x["odd"] if a[1] > b[1] else x["u18"], x["valid"],
                dec(*a), dec(*b))
    for q, even in ((10, False), (100, True), (1000, False)):
        entries[f"round to {q} {'HALF_EVEN' if even else 'HALF_UP'}"] = \
            lambda x, q=q, e=even: _round_unscaled(x["odd"], q, e)
    on_card = {k: v.cuda() for k, v in x.items()}
    t0 = time.perf_counter()
    for name, fn in entries.items():
        want, got = fn(x), fn(on_card)
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, c in zip(want, got):
            c = c.cpu()
            if not torch.equal(w, c):
                raise SystemExit(f"decimal128 on the card: {name} differs "
                                 f"from the CPU in {int((w != c).sum())} of "
                                 f"{n} rows")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    print(f"{len(entries)} entries on {n} rows each equal to the CPU's "
          f"exactly, {secs:.2f} s")
    return {"entries": sorted(entries), "rows": n, "seconds": secs}


def decimal_phase(root, tables, paths, corpus):
    """Decimal full q01 and decimal q12 at SF10 under the default
    auron.tpu.dag.singleTaskBytes (staged: their scans exceed it), once
    each under auto, unprofiled, each held to its exact oracle with zero
    tolerance and every radix grouping exact against its plain version;
    no placement (the decimal sums stay on the generic AggExec); the host
    rows and seconds of exprs/decimal_arith.py per query; the int128 ops
    on the card; the corpus's decimal cases on the card (`corpus`, from
    the strings phase)."""
    from blaze_tpu_torch import config
    from blaze_tpu_torch.exprs.decimal_arith import HOST_STATS
    from blaze_tpu_torch.plan.stages import DagScheduler
    t_phase = time.perf_counter()
    runs, secs = decimal_data(root, tables, paths)
    default = config.DAG_SINGLE_TASK_BYTES.default
    out, host = {}, {}
    for name in DECIMAL_QUERIES:
        make, want, check = runs[name]
        scan = DagScheduler._scan_input_bytes(make())
        expect = "local" if scan <= default else "staged"
        before = dict(HOST_STATS)
        out[name], _ = breadth_path(f"decimal {name}", make, want, None,
                                    expect, check=check)
        host[name] = {k: HOST_STATS[k] - before[k] for k in HOST_STATS}
        r = out[name]
        if r["launches"]["hash_placement"] or \
                not r["launches"]["radix_partition"]:
            raise SystemExit(f"decimal {name}: launches {r['launches']}: "
                             f"radix must group every exchange and "
                             f"placement never run (generic AggExec)")
        print(f"decimal {name}: wall {r['wall_s']:.3f} s, {r['exec_mode']},"
              f" {r['stages']} stages, radix "
              f"{r['launches']['radix_partition']}, placement 0; "
              f"decimal_arith on the host: {host[name]['calls']} calls, "
              f"{host[name]['rows']} rows, {host[name]['seconds']:.3f} s "
              f"of {r['wall_s']:.3f} s")
    if not host["q01"]["rows"]:
        raise SystemExit("decimal q01: its p > 18 comparison never reached "
                         "decimal_arith on the host")
    if corpus["decimal_passed"] != corpus["decimal_cases"] or \
            corpus["passed"] != corpus["cases"]:
        raise SystemExit(f"corpus on the card: {corpus}")
    print(f"corpus on the card: {corpus['passed']} of {corpus['cases']} "
          f"cases, the {corpus['decimal_cases']} decimal cases among them")
    limbs = decimal128_on_card()
    wall = time.perf_counter() - t_phase
    print(f"decimal phase: {wall:.1f} s")
    return {"data_s": secs, "runs": out, "decimal_arith": host,
            "decimal128": limbs, "wall_s": wall}


SPILL_QUERIES = ("q06", "q17", "q95", "q51")
#: q06's consumers hold at most 651 bytes at SF10 (under 32 MiB it never
#: spilled): it starts at half of that, the budget the phase's rule
#: would reach on its second run
SPILL_Q06_BUDGET = 325
SPILL_BUDGET = 32 << 20     # bytes: the JAX package's SF10 spill set's
#: the memory consumers the spill phase must see spill, by their names
SPILL_KINDS = ("sort", "agg", "WindowExec.buffer", "shuffle")


class _SpillRouteGroupings:
    """Within a `with` block, the (rows, partitions) of every radix
    grouping the shuffle writer asks for while it spills (the spill
    route), apart from its final write."""

    def __enter__(self):
        from blaze_tpu_torch.kernels import radix as R
        from blaze_tpu_torch.shuffle import writer as W
        self.shapes, self._inside = [], False
        self._order, self._spill = R.partition_order, \
            W.ShuffleRepartitioner.spill

        def order(pids, n_parts):
            if self._inside:
                self.shapes.append((int(pids.numel()), int(n_parts)))
            return self._order(pids, n_parts)

        def spill(rep):
            self._inside = True
            try:
                return self._spill(rep)
            finally:
                self._inside = False
        R.partition_order = order
        W.ShuffleRepartitioner.spill = spill
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch.kernels import radix as R
        from blaze_tpu_torch.shuffle import writer as W
        R.partition_order = self._order
        W.ShuffleRepartitioner.spill = self._spill
        return False


def _spill_run(name, budget, unbudgeted_wall):
    """One run of `name` through breadth_path (staged, auto, its earlier
    phase's pandas frame) with the memory manager at `budget` bytes;
    returns the result with the manager's totals, the spills by consumer,
    the RAM- and file-tier runs and the radix groupings of the writer's
    spill route, which must be as many as the writer's spills."""
    from blaze_tpu_torch.memory import MemManager
    from blaze_tpu_torch.memory.spill import SPILL_TIERS
    make, want = ORACLES[name]
    mm = MemManager.init(budget)
    tiers0 = dict(SPILL_TIERS)
    with _SpillRouteGroupings() as route:
        r, _ = breadth_path(f"spill {name}", make, want, 0, "staged",
                            record_placements=(name != "q51"),
                            allow_empty=(name == "q17"))
    r.update(budget_bytes=mm.total, spill_count=mm.total_spill_count,
             spilled_bytes=mm.total_spilled_bytes,
             peak_mem_bytes=mm.peak_used,
             spills_by_consumer={k: list(v) for k, v in
                                 mm.spills_by_consumer.items()},
             tiers={k: SPILL_TIERS[k] - tiers0[k] for k in SPILL_TIERS},
             spill_route_groupings=route.shapes,
             unbudgeted_wall_s=unbudgeted_wall)
    print(f"spill {name}: wall {r['wall_s']:.3f} s (unbudgeted "
          f"{unbudgeted_wall:.3f} s in its earlier phase), budget "
          f"{budget}, {r['spill_count']} spills, {r['spilled_bytes']} "
          f"bytes, by consumer {r['spills_by_consumer']}, RAM/file tier "
          f"runs {r['tiers']}, peak {r['peak_mem_bytes']}, radix "
          f"{r['launches']['radix_partition']}, of them on the spill route "
          f"{len(route.shapes)}")
    if len(route.shapes) != r["spills_by_consumer"].get("shuffle", [0])[0]:
        raise SystemExit(f"spill {name}: {len(route.shapes)} radix "
                         f"groupings on the spill route for "
                         f"{r['spills_by_consumer']} spills")
    return r


def spill_phase(unbudgeted):
    """q17 and q95 at SF10 under a 32 MiB memory budget, q06 under
    SPILL_Q06_BUDGET, and q51 under
    half of the bytes its window buffers held at most in the q95 phase's
    run (so that a buffer itself spills, not only the sort under it):
    staged, 4 exchange partitions, the stage loop under auto, unprofiled,
    each with a fresh plan and held to the pandas frame the earlier phase
    made for it (breadth_path's checks: rows as a set within 1e-9,
    nothing off the card, every radix grouping exact against its plain
    version, as many as counted).  A query that does not spill under 32
    MiB (its consumers never hold that much) runs once more under half
    the peak its consumers held.  Fails unless every query spilled and
    the sort, the generic aggregation, the window buffer and the shuffle
    writer each spilled in the phase.  `unbudgeted`: each query's wall
    and q51's window buffer peaks from its earlier phase in this start.
    The memory manager goes back to its default budget after."""
    import statistics as st
    import torch
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.memory import MemManager, default_budget_bytes
    t_phase = time.perf_counter()
    peaks = unbudgeted["q51 window buffer peaks"]
    budgets = {n: SPILL_BUDGET for n in SPILL_QUERIES}
    budgets["q51"] = max(peaks) // 2
    budgets["q06"] = SPILL_Q06_BUDGET
    print(f"budgets: {budgets} bytes (q51: half the larger of its window "
          f"buffers' peaks {peaks} in the q95 phase's run)")
    out, kinds = {}, {}
    try:
        for name in SPILL_QUERIES:
            r = _spill_run(name, budgets[name], unbudgeted[name])
            if not r["spill_count"]:
                out[f"{name} at {budgets[name]}"] = r
                budgets[name] = max(1, r["peak_mem_bytes"] // 2)
                r = _spill_run(name, budgets[name], unbudgeted[name])
            if not r["spill_count"]:
                raise SystemExit(f"spill {name}: no spill under "
                                 f"{r['budget_bytes']} bytes")
            for k, (c, b) in r["spills_by_consumer"].items():
                kinds.setdefault(k, [0, 0])
                kinds[k][0] += c
                kinds[k][1] += b
            out[name] = r
    finally:
        MemManager.init(default_budget_bytes())
    missing = [k for k in SPILL_KINDS if not kinds.get(k, [0])[0]]
    if missing:
        raise SystemExit(f"spill phase: {missing} never spilled: {kinds}")
    shapes = [s for r in out.values() for s in r["spill_route_groupings"]]
    n = int(st.median(s[0] for s in shapes))
    P = shapes[0][1]
    gen = torch.Generator(device="cuda").manual_seed(15)
    pids = torch.randint(0, P, (n,), dtype=torch.int32, device="cuda",
                         generator=gen)

    def call():
        return R.partition_order(pids, P)
    before = sum(R.kernel_launches.values())
    call()
    launches = sum(R.kernel_launches.values()) - before
    # the profiler of a long process loses device records now and then:
    # up to three tries for a profile holding every launch, else the
    # device time is left unmeasured
    us = per_call = None
    for _ in range(3):
        us, per_call = device_us_of(call, tuple(RADIX_KERNELS.values()))
        if per_call == launches:
            break
    route = {"calls": len(shapes), "median_rows": n, "P": P,
             "device_us": us if per_call == launches else None,
             "profiled_launches_per_call": per_call,
             "launches_per_call": launches,
             "ms": time_ms(call),
             "plain_ms": time_ms(lambda: R.partition_order_plain(pids, P)),
             "bound_ms": (8 * n + 4 * P) / HBM_BYTES_PER_S * 1e3}
    wall = time.perf_counter() - t_phase
    print(f"spill phase: {wall:.1f} s; budgets {budgets}; spills by "
          f"consumer kind {kinds}; radix on the spill route: {route}")
    return {"runs": out, "by_consumer": kinds, "budgets": budgets,
            "radix_spill_route": route, "wall_s": wall}


# ---------------------------------------------------------------------------
# the Spark front door, q70 and the row-order float sums
# ---------------------------------------------------------------------------

FRONT_DOOR_COUNTERS = ("cuda_batches", "cpu_batches", "io_bytes")


def front_door_phase(root, tables, wants):
    """The seven checked-in Spark plans (tests/fixtures/) through the
    port's `execute_spark_plan_json` at SF10, each held to its oracle as a
    set (itest/spark_fixtures.py): the tables the earlier phases generated,
    written again in the fixtures' own layout; `wants` holds the pandas
    frames the earlier phases computed for the same queries on the same
    tables (the rest are computed here).  Fails unless each equals its
    oracle and every batch ran on the card."""
    from blaze_tpu_torch.itest import spark_fixtures as SF
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.plan.stages import DagScheduler
    phase("front door: the seven checked-in Spark plans through "
          "execute_spark_plan_json at SF10, each against its oracle")
    data_dir = os.path.join(root, "front_door")
    t0 = time.perf_counter()
    fx_tables, paths, secs = SF.make_data(SCALE, data_dir, tables=tables)
    print("rows: " + ", ".join(f"{n} {t.num_rows} in {len(paths[n])} "
                               f"file(s)" for n, t in fx_tables.items())
          + f"; generated {secs['generated'] or 'none'} in "
          f"{secs['generate']:.1f} s, written in {secs['write']:.1f} s")
    runs = {}
    for name in SF.FIXTURES:
        want = wants.get(name)
        t = time.perf_counter()
        if want is None:
            want = SF.oracle(name, fx_tables, paths)
        oracle_s = time.perf_counter() - t
        sched = DagScheduler()
        _zero_launches()
        r = SF.run_fixture(name, data_dir, paths, want, scheduler=sched)
        launches = _read_launches()
        per_stage = stage_counters(sched, FRONT_DOOR_COUNTERS)
        counters = {k: sum(c[k] for c in per_stage.values())
                    for k in FRONT_DOOR_COUNTERS}
        print(f"front door {name}: {r['rows']} rows, {r['exec_mode']}, "
              f"{r['stages']} stages, wall {r['wall_s']:.3f} s, oracle "
              f"{'equal' if r['error'] is None else r['error']} "
              f"({oracle_s:.1f} s), batches and io_bytes {counters}, radix "
              f"{launches['radix_partition']}, placement "
              f"{launches['hash_placement']}, segment_sum "
              f"{launches['segment_sum']}; converted {r['classes']}")
        if r["error"] is not None:
            raise SystemExit(f"front door {name}: {r['error']}")
        # q17's plan, like the reference's, joins to nothing: no batch
        if counters["cpu_batches"] or (r["rows"] and
                                       not counters["cuda_batches"]):
            raise SystemExit(f"front door {name}: batches off the card: "
                             f"{counters}")
        del r["table"]
        runs[name] = dict(r, launches=launches, counters=per_stage,
                          oracle_s=oracle_s,
                          stage_walls=dict(sched.stage_walls))
    secs["phase"] = time.perf_counter() - t0
    shutil.rmtree(data_dir, ignore_errors=True)
    return {"runs": runs, "data_s": secs}


def _wire_batches_on_card(counters, label):
    if counters["cpu_batches"] or not counters["cuda_batches"]:
        raise SystemExit(f"wire kinds {label}: batches off the card: "
                         f"{counters}")


def wire_kinds_phase(root, sr_paths, lo, hi, q01_want):
    """The plan kinds the wire and the front door hand the port
    (itest/wire_kinds.py) at SF10 over phase 5's store_returns, each once
    under the stage loop's `auto`: W1, a range exchange into a sort and an
    IPC writer as TaskDefinitions (radix profiled: its kernels on the card
    as often as counted, every grouping exact against the plain version),
    then unprofiled with the post-decode filter on, off, off, on;
    W2, a round-robin exchange through `execute_spark_plan_json`; W3, q01
    over a Hive layout of the same rows (12 files, one a store) with a
    debug node at the reduce root; and the FFI probe.  Fails unless each
    equals its oracle (W1 row for row, W2's counts exact and sums within
    1e-9, W3 phase 5's oracle), the scans' pruned_row_groups equal the
    footers' count (W1's scans; W3's scans run alone: a map task that the
    loop hands back to the staged path scans twice, its first scan cut
    where the loop fell back) and are above 0, the FFI probe's map bytes
    equal the scan's, radix ran on every path and no aggregation batch
    ran off the card."""
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch.itest import wire_kinds as W
    from blaze_tpu_torch.itest.q01 import file_groups
    from blaze_tpu_torch.itest.q01_dag import stage_counters
    from blaze_tpu_torch.plan.stages import DagScheduler
    phase("wire kinds: W1 a range exchange into a sort and an IPC writer, "
          "W2 a round-robin exchange through the front door, W3 q01 over a "
          "Hive layout, SF10, stage loop auto")
    _loop_mode("auto")
    t_phase = time.perf_counter()
    top = os.path.join(root, "wire_kinds")
    out = {"runs": {}}

    def check_pruning(res, groups, label):
        err = W.pruning_error(res["map_task_counters"], groups, lo, hi)
        if err is not None or res["footer_pruned"] <= 0:
            raise SystemExit(f"wire kinds {label}: {err or 'no row group '
                             'pruned by the footers'}")

    # W1, profiled: radix's kernels on the card as often as counted
    t0 = time.perf_counter()
    bounds = W.w1_bounds(W.w1_sample(sr_paths, lo, hi), N_REDUCES)
    want1 = W.w1_oracle(sr_paths, lo, hi)
    prep_s = time.perf_counter() - t0
    attempt = [0]

    def w1_run():
        attempt[0] += 1
        d = os.path.join(top, f"w1_{attempt[0]}")
        os.makedirs(d)
        _zero_launches()
        with _RecordedGroupings() as rec, \
                profile(activities=[ProfilerActivity.CUDA]) as prof:
            res = W.run_w1(sr_paths, lo, hi, bounds, d, N_MAPS, N_REDUCES)
        launches = _read_launches()
        for pattern, want in _expected_kernels("radix_partition",
                                               launches).items():
            _us, got = _device_events(prof, (pattern,))
            _count_on_card([prof], "wire kinds W1", f"radix ran {got} "
                           f"device kernels {pattern} where its wrapper "
                           f"counted {want}", got, want)
        res["groupings"] = rec.check("wire kinds W1",
                                     launches["radix_partition"])
        res["launches"] = launches
        return res
    w1 = _profiled(w1_run, "wire kinds W1")
    w1["error"] = W.w1_error(w1.pop("table"), want1)
    w1["footer_pruned"] = W.footer_pruned(sr_paths, lo, hi)
    if w1["error"] is not None:
        raise SystemExit(f"wire kinds W1: {w1['error']}")
    check_pruning(w1, file_groups(sr_paths, N_MAPS), "W1")
    if not w1["launches"]["radix_partition"]:
        raise SystemExit("wire kinds W1: radix never ran")
    print(f"W1: {want1.num_rows} rows sorted, equal to the pandas sort row "
          f"for row; map {w1['map_s']:.3f} s, reduce {w1['reduce_s']:.3f} "
          f"s (sample, bounds and oracle {prep_s:.1f} s); pruned_row_groups "
          f"{w1['counters']['map']['pruned_row_groups']} (footers "
          f"{w1['footer_pruned']}); sinks {sum(map(len, w1['sinks']))} "
          f"bytes; radix {w1['launches']['radix_partition']} calls, "
          f"kernels {w1['launches']['radix_kernels']} on the card as "
          f"counted ({attempt[0]} profiled attempt(s))")
    del w1["sinks"], w1["shuffle"]
    out["runs"]["W1"] = w1

    # W1 with the scan's post-decode filter (ops/scan.py) on, off, off, on:
    # the map wall and the fused batches, each run equal to the oracle
    from blaze_tpu_torch.ops.scan import ParquetScanExec
    post = ParquetScanExec._post_decode_filter
    w1_post = []
    for on in (True, False, False, True):
        d = os.path.join(top, f"w1_post_{len(w1_post)}")
        os.makedirs(d)
        if not on:
            ParquetScanExec._post_decode_filter = lambda self: None
        e0 = _expr_snapshot()
        try:
            res = W.run_w1(sr_paths, lo, hi, bounds, d, N_MAPS, N_REDUCES)
        finally:
            ParquetScanExec._post_decode_filter = post
        fused = _expr_snapshot()["expr_fused_batches"] - \
            e0["expr_fused_batches"]
        err = W.w1_error(res.pop("table"), want1)
        if err is not None:
            raise SystemExit(f"wire kinds W1 with the post-decode filter "
                             f"{'on' if on else 'off'}: {err}")
        w1_post.append({"post_decode_filter": on, "map_s": res["map_s"],
                        "reduce_s": res["reduce_s"], "fused_batches": fused})
    print("W1 with the post-decode filter on, off, off, on: map " + ", ".join(
        f"{r['map_s']:.4f}" for r in w1_post) + " s; fused batches "
        + ", ".join(str(r["fused_batches"]) for r in w1_post))
    out["w1_post_decode"] = w1_post

    # W2 through the front door
    sched = DagScheduler()
    _zero_launches()
    w2 = W.run_w2(sr_paths, N_REDUCES, scheduler=sched)
    w2["launches"] = _read_launches()
    w2["error"] = W.w2_error(w2.pop("table"), W.w2_oracle(sr_paths))
    del w2["scheduler"]
    per_stage = stage_counters(sched, FRONT_DOOR_COUNTERS)
    w2["counters"] = per_stage
    w2["stage_walls"] = dict(sched.stage_walls)
    if w2["error"] is not None:
        raise SystemExit(f"wire kinds W2: {w2['error']}")
    _wire_batches_on_card({k: sum(c[k] for c in per_stage.values())
                           for k in FRONT_DOOR_COUNTERS}, "W2")
    if not w2["launches"]["radix_partition"]:
        raise SystemExit("wire kinds W2: radix never ran")
    print(f"W2: {w2['exec_mode']}, {w2['stages']} stages, wall "
          f"{w2['wall_s']:.3f} s, equal to the pandas group-by; radix "
          f"{w2['launches']['radix_partition']}, placement "
          f"{w2['launches']['hash_placement']}, segment_sum "
          f"{w2['launches']['segment_sum']}; stage walls "
          f"{ {k: round(v, 3) for k, v in w2['stage_walls'].items()} }")
    out["runs"]["W2"] = w2

    # W3 over the Hive layout, then the FFI probe
    t0 = time.perf_counter()
    groups, pvals = W.write_hive(sr_paths, os.path.join(top, "hive"),
                                 N_MAPS)
    write_s = time.perf_counter() - t0
    d3 = os.path.join(top, "w3")
    os.makedirs(d3)
    _zero_launches()
    w3 = W.run_w3(groups, pvals, lo, hi, d3, N_REDUCES)
    w3["launches"] = _read_launches()
    w3["error"] = W.q01_error(w3.pop("table"), q01_want)
    w3["footer_pruned"] = W.footer_pruned([p for g in groups for p in g],
                                          lo, hi)
    w3["write_s"] = write_s
    if w3["error"] is not None:
        raise SystemExit(f"wire kinds W3: {w3['error']}")
    check_pruning(w3, groups, "W3")
    t0 = time.perf_counter()
    alone = W.scans_alone(groups, pvals, lo, hi)
    w3["scans_alone_pruned"] = sum(p for _b, p in alone)
    w3["scans_alone_s"] = time.perf_counter() - t0
    if w3["scans_alone_pruned"] != w3["footer_pruned"]:
        raise SystemExit(f"wire kinds W3: the scans alone pruned "
                         f"{w3['scans_alone_pruned']} row groups, the "
                         f"footers {w3['footer_pruned']}")
    for st in ("map", "reduce"):
        _wire_batches_on_card(w3["counters"][st], f"W3 {st}")
    for k in ("radix_partition", "hash_placement"):
        if not w3["launches"][k]:
            raise SystemExit(f"wire kinds W3: {k} never ran")
    os.makedirs(os.path.join(top, "ffi"))
    probe = W.ffi_probe(groups, pvals, lo, hi, N_MAPS // 2,
                        os.path.join(top, "ffi"), d3, N_REDUCES,
                        alone[N_MAPS // 2][0])
    del alone
    if not all(probe["same"].values()):
        raise SystemExit(f"wire kinds FFI probe: map bytes differ "
                         f"{probe['same']}")
    print(f"W3: {sum(len(g) for g in groups)} Hive files written in "
          f"{write_s:.1f} s; map {w3['map_s']:.3f} s, reduce "
          f"{w3['reduce_s']:.3f} s, equal to phase 5's oracle; "
          f"pruned_row_groups {w3['counters']['map']['pruned_row_groups']} "
          f"(footers {w3['footer_pruned']}, the scans alone "
          f"{w3['scans_alone_pruned']} in {w3['scans_alone_s']:.2f} s, loop "
          f"fallbacks {w3['counters']['map']['stage_loop_fallback']}); radix "
          f"{w3['launches']['radix_partition']}, placement "
          f"{w3['launches']['hash_placement']}, segment_sum "
          f"{w3['launches']['segment_sum']}; FFI probe map task "
          f"{N_MAPS // 2}: {probe['batches']} batches, {probe['rows']} "
          f"rows, the scan's .data and .index bytes")
    del w3["shuffle"]
    out["runs"]["W3"] = w3
    out["ffi"] = probe
    shutil.rmtree(top, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"wire kinds phase: {out['wall_s']:.1f} s")
    return out


class _TimedRowOrderSums:
    """Within a `with` block, each eager call of the row-order sums on a
    CUDA float tensor (kernels/sort.py `segment_sum`, `segment_sum_into`,
    `segmented_running_sum`) is bracketed by two CUDA events on the
    current stream (no synchronisation): `summary` gives the calls and
    the device milliseconds between their events (the wrapper's sort,
    memsets and kernels) by form.  Calls inside a graph capture are
    not timed (their replays are the graph's)."""

    NAMES = {"segment_sum": "sum", "segment_sum_into": "into",
             "segmented_running_sum": "running"}

    def __enter__(self):
        import torch
        from blaze_tpu_torch.kernels import sort as K
        self.events = {f: [] for f in self.NAMES.values()}
        self._real = {name: getattr(K, name) for name in self.NAMES}

        def timed(name, real):
            form = self.NAMES[name]

            def call(*args, **kwargs):
                t = args[0] if name != "segment_sum_into" else args[1]
                if not (t.is_cuda and t.is_floating_point()) or \
                        torch.cuda.is_current_stream_capturing():
                    return real(*args, **kwargs)
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = real(*args, **kwargs)
                b.record()
                self.events[form].append((a, b))
                return out
            return call
        for name, real in self._real.items():
            setattr(K, name, timed(name, real))
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch.kernels import sort as K
        for name, real in self._real.items():
            setattr(K, name, real)
        return False

    def summary(self):
        import torch
        torch.cuda.synchronize()
        return {form: {"calls": len(ev),
                       "device_ms": sum(a.elapsed_time(b) for a, b in ev)}
                for form, ev in self.events.items() if ev}


class _RecordedSegmentSums:
    """Within a `with` block, every float call of kernels/sort.py
    `segment_sum` on the card is recorded: its inputs and its result
    copied to the host.  `check` then holds each result, bit for bit, to
    the plain version's (the CPU's row order) on the same inputs."""

    def __enter__(self):
        from blaze_tpu_torch.kernels import sort as K
        self.calls, self._real = [], K.segment_sum

        def recording(values, gids, num_segments, valid=None,
                      contiguous=False):
            out = self._real(values, gids, num_segments, valid, contiguous)
            if values.is_cuda and values.is_floating_point():
                self.calls.append((values.cpu(), gids.cpu(), num_segments,
                                   None if valid is None else valid.cpu(),
                                   contiguous, out.cpu()))
            return out
        K.segment_sum = recording
        return self

    def __exit__(self, *exc):
        from blaze_tpu_torch.kernels import sort as K
        K.segment_sum = self._real
        return False

    def check(self, label, wrapper_calls):
        """Fails unless every recorded call equals the CPU's row-order sums
        bit for bit and the calls with rows and segments are as many as
        the wrapper counted; returns (rows, segments, longest segment) of
        each call and the inputs of the one with the longest segment."""
        import torch
        from blaze_tpu_torch.kernels import sort as K
        shapes, longest = [], None
        for v, g, S, valid, contiguous, got in self.calls:
            if not _same_float_bits(got, K.segment_sum_plain(v, g, S,
                                                             valid)):
                raise SystemExit(f"{label}: a float segment sum of {len(v)} "
                                 f"rows over {S} segments is not the CPU's "
                                 f"row-order sum")
            run = int(torch.bincount(K._slot(g, S), minlength=S + 1)[:-1]
                      .max()) if len(v) and S else 0
            shapes.append((len(v), S, run))
            if longest is None or run > longest[0]:
                longest = (run, v, g, S, valid, contiguous)
        launched = sum(1 for n, S, _run in shapes if n and S)
        if launched != wrapper_calls:
            raise SystemExit(f"{label}: {launched} float segment sums "
                             f"recorded for {wrapper_calls} launches counted")
        print(f"{label}: {len(shapes)} float segment sums on the card, each "
              f"bit-equal to the CPU's row order; (rows, segments, longest) "
              f"from {min(shapes) if shapes else None} to "
              f"{max(shapes) if shapes else None}")
        return shapes, longest


Q70_SCALE = 1.0             # q70's fault showed at SF1 on the card
SEGSUM_LONG = 1 << 20       # rows of the one-segment case


def q70_phase(root):
    """q70 alone at SF1 through itest/breadth.py (its tables from their
    seeds), held to its oracle: its ROLLUP sums one state's single store
    at two grouping levels in the dict-device lane's dense tables, and
    rank() ties them only if both sums are the same bits.  Every float
    segment sum of the run is recorded (_RecordedSegmentSums) and held to
    the CPU's row order; the one with the longest segment is returned for
    the segment_sum cases."""
    from blaze_tpu_torch.itest import breadth as B
    phase("q70 at SF1 through the breadth driver: a ROLLUP's float sums "
          "in row order on the card (csrc/segment_sum.cu), rank() over them")
    with _RecordedSegmentSums() as rec:
        _zero_launches()
        r = B.run(["q70"], Q70_SCALE, os.path.join(root, "q70"))[0]
        launches = _read_launches()
    shutil.rmtree(os.path.join(root, "q70"), ignore_errors=True)
    forms = launches["segment_sum_forms"]
    print(f"q70: {'equal to its oracle' if r['met'] else r['detail']}; "
          f"segment_sum launches {launches['segment_sum']} by form {forms}")
    if not r["met"]:
        raise SystemExit(f"q70 at SF1 misses its oracle: {r['detail']}")
    if not forms["sum"]:
        raise SystemExit("q70: the row-order sum kernel never ran")
    shapes, longest = rec.check("q70", forms["sum"])
    del r["launches"]
    return dict(r, launches=launches, segment_sums=shapes, longest=longest)


def _same_float_bits(got, want):
    """Bits equal where the values are numbers, NaN where they are NaN."""
    import torch
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    view = torch.int64 if want.dtype == torch.float64 else torch.int32
    return torch.equal(got[~nan].view(view), want[~nan].view(view))


ADD_CHAIN = 1 << 20         # dependent adds of the latency probe
WINDOW_PARTS = 4096         # rows per window partition in the running cases
SHORT_MAX_SWEEP = (8, 16, 32, 64, 128)


def add_latency_ns(dev):
    """Nanoseconds of one dependent add on the card, float64 and float32:
    one thread runs a chain of 2^20 adds from registers (csrc/
    segment_sum.cu `blaze_add_chain`), timed with CUDA events (median of
    5).  No row-order sum beats it: a segment of m rows is m such adds."""
    import torch
    from blaze_tpu_torch.kernels import build
    fn = build.bound("segment_sum", "blaze_add_chain")
    out = {}
    for dt in (torch.float64, torch.float32):
        o = torch.empty(1, dtype=dt, device=dev)

        def call(o=o, f64=int(dt == torch.float64)):
            build.check(fn(o.data_ptr(), 1.0, 1e-9, ADD_CHAIN, f64,
                           build.stream_of(dev)), "add chain probe")
        out[dt] = time_ms(call, warmup=2, iters=5) * 1e6 / ADD_CHAIN
    print("one dependent add on the card: " + ", ".join(
        f"{str(dt)[6:]} {ns:.4f} ns" for dt, ns in out.items())
        + f" (a chain of {ADD_CHAIN} adds from registers)")
    return out


def _longest_run(ids):
    import torch
    return int(torch.unique_consecutive(ids, return_counts=True)[1].max())


def _segsum_device_us(label, call, calls=PROFILED_CALLS):
    """(device us, kernels) a call of csrc/segment_sum.cu's two kernels,
    and the same for every kernel of the call (the wrapper's sort
    included), from one profile of `calls` calls.  A profile short of two
    kernels a call (the profiler drops records in a long process, PERF.md
    §7) is made again, at most PROFILE_ATTEMPTS times, and then the
    fullest one is read over the calls its kernels make up; more kernels
    than two a call, or none, fail."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    per_call = len(KERNEL_NAMES["segment_sum"])
    want = per_call * calls
    best = None
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                call()
            torch.cuda.synchronize()
        us, got = _device_events(prof, KERNEL_NAMES["segment_sum"])
        if got > want:
            raise SystemExit(f"segment_sum {label}: {got} kernels on the "
                             f"card for {calls} calls")
        if got and (best is None or got > best[1]):
            best = (us, got) + _device_events(prof, ("",))
        if got == want:
            break
        print(f"segment_sum {label}: attempt {attempt}: the profile holds "
              f"{got} of its {want} kernels")
    if best is None:
        raise SystemExit(f"segment_sum {label}: no kernel record in "
                         f"{PROFILE_ATTEMPTS} profiles")
    us, got, all_us, every = best
    held = got / per_call
    if got < want:
        print(f"segment_sum {label}: device times over the {held:g} calls "
              f"whose kernels the profile holds")
    return us / held, got / held, all_us / held, every / held


def _segsum_case(label, form, v, g, S, valid, contiguous, carry, add_ns,
                 dev):
    """One case of csrc/segment_sum.cu: form "sum" (`segment_sum`), "into"
    (`segment_sum_into` over `carry`) or "running"
    (`segmented_running_sum`, `g` the rows' partition starts), held bit
    for bit to the plain version on the CPU and timed on the card."""
    import torch
    from blaze_tpu_torch.kernels import sort as K
    vd, gd = v.to(dev), g.to(dev)
    okd = None if valid is None else valid.to(dev)
    slots = K._slot(gd, S)
    upd = vd if okd is None else torch.where(okd, vd, torch.zeros_like(vd))
    n, size = v.shape[0], v.element_size()
    in_bytes = n * (size + g.element_size() + (0 if valid is None else 1))
    if form == "sum":
        want = K.segment_sum_plain(v, g, S, valid)
        got = K.segment_sum(vd, gd, S, okd, contiguous=contiguous)

        def call():
            return K.segment_sum(vd, gd, S, okd, contiguous=contiguous)

        def plain():
            return K.segment_sum_plain(vd, gd, S, okd)
        start = torch.zeros(S + 1, dtype=vd.dtype, device=dev)
        longest = int(torch.bincount(slots, minlength=S + 1)[:-1].max())
        nbytes = in_bytes + S * size
    elif form == "into":
        want = K.segment_sum_into_plain(carry.clone(), v, g, valid)
        acc = carry.to(dev)
        got = K.segment_sum_into(acc.clone(), vd, gd, okd)

        def call():
            return K.segment_sum_into(acc, vd, gd, okd)

        def plain():
            return K.segment_sum_into_plain(acc, vd, gd, okd)
        start = torch.cat([acc, acc.new_zeros(1)])
        hits = torch.bincount(slots, minlength=S + 1)[:-1]
        longest = int(hits.max())
        nbytes = in_bytes + 2 * int((hits > 0).sum()) * size
    else:
        want = K.segmented_running_sum_plain(v, g)
        got = K.segmented_running_sum(vd, gd)

        def call():
            return K.segmented_running_sum(vd, gd)

        def plain():
            return K.segmented_running_sum_plain(vd, gd)

        def library():
            return torch.cumsum(vd, 0)
        longest = _longest_run(g)
        S = int(torch.unique_consecutive(g).shape[0])
        nbytes = in_bytes + n * size
    index_add_bits = None
    if form != "running":
        # one index_add_ into the same start: the library's sums
        index_add_bits = _same_float_bits(
            start.clone().index_add_(0, slots, upd)[:S], want)
        table = start.clone()

        def library():
            table.index_add_(0, slots, upd)
    torch.cuda.synchronize()
    exact = _same_float_bits(got, want)
    chain_ms = longest * add_ns[v.dtype] * 1e-6
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    c = {"case": label, "form": form, "dtype": str(v.dtype)[6:], "n": n,
         "segments": S, "longest": longest, "contiguous": contiguous,
         "exact": exact, "err": 0.0 if exact else float("inf"),
         "ms": time_ms(call), "plain_ms": time_ms(plain),
         "library_ms": time_ms(library),
         "library": "torch.cumsum" if form == "running" else "index_add_",
         "bytes": nbytes, "bytes_ms": bytes_ms, "chain_ms": chain_ms,
         "bound_ms": max(bytes_ms, chain_ms),
         "bound_by": "operations" if chain_ms > bytes_ms else "bytes"}
    (c["device_us"], c["launches_per_call"], c["device_us_all"],
     c["device_ops_per_call"]) = _segsum_device_us(f"{form} {label}", call)
    c["host_us"] = host_us_of(call)
    c["of_chain"] = c["ms"] / chain_ms
    print(f"segment_sum {form} {label}: {n} rows, {S} segments, longest "
          f"{longest}, {c['dtype']}: {'bit-equal to' if exact else 'DIFFERS FROM'}"
          f" the CPU's row order"
          + ("" if index_add_bits is None else
             f" (one index_add_ on the card "
             f"{'agrees' if index_add_bits else 'differs'})")
          + f"; {c['ms']:.4f} ms a call ({c['of_chain']:.3f}x the chain "
          f"of the longest segment, {chain_ms:.4f} ms), device "
          f"{c['device_us']:.2f} us in {c['launches_per_call']:.0f} kernels "
          f"({c['device_us_all']:.2f} us in {c['device_ops_per_call']:.0f} "
          f"with the sort; host {c['host_us']:.1f} us a call), plain "
          f"{c['plain_ms']:.4f} ms, {c['library']} "
          f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.5f} ms "
          f"({c['bound_by']}; {nbytes} bytes {bytes_ms:.5f} ms)")
    if not exact:
        raise SystemExit(f"segment_sum {form} {label}: the kernel's sums "
                         f"are not the CPU's row-order sums")
    return c


def segment_sum_cases(dev, q70_call):
    """csrc/segment_sum.cu's three forms against the CPU's row-order sums,
    bit for bit, and timed (`_segsum_case`): from +0.0 at q70's recorded
    call with the longest segment (as q70 made it, then through the other
    route: the ids sorted stably by the wrapper, or on the host first) and
    at one segment of 2^20 rows; into a carry at q01's map shape (32,768
    rows into 2^18 slots, float64 and float32), hot (2^20 rows into 64
    slots) and one segment of 2^20 rows; running over 2^20 rows in window
    partitions of 4,096 and in one.  Then the engine's lexsort, whose
    stability the sums rest on, equal on the card and on the CPU."""
    import numpy as np
    import torch
    from blaze_tpu_torch.kernels import compare
    from blaze_tpu_torch.kernels import sort as K
    phase("segment_sum: the dependent-add probe, then csrc/segment_sum.cu's "
          "three forms against the CPU's row-order sums, bit for bit")
    add_ns = add_latency_ns(dev)
    rng = np.random.default_rng(70)
    keys = [torch.from_numpy(rng.integers(0, 16, SEGSUM_LONG)),
            torch.from_numpy(rng.integers(0, 4, SEGSUM_LONG))]
    mask = torch.from_numpy(rng.random(SEGSUM_LONG) > 0.1)
    on_card = compare.lexsort_indices([k.to(dev) for k in keys],
                                      mask.to(dev)).cpu()
    stable = torch.equal(on_card, compare.lexsort_indices(keys, mask))
    print(f"lexsort_indices over {SEGSUM_LONG} rows of 64 key values, "
          f"masked rows among them: the card's permutation "
          f"{'equals' if stable else 'DIFFERS FROM'} the CPU's")
    if not stable:
        raise SystemExit("lexsort_indices is not the CPU's on the card")
    _longest, v, g, S_q70, valid, contiguous = q70_call
    if contiguous:
        other = ("ids sorted by the wrapper", v, g, valid, False)
    else:
        order = torch.sort(K._slot(g, S_q70), stable=True).indices
        other = ("ids sorted on the host first", v[order],
                 K._slot(g, S_q70)[order],
                 None if valid is None else valid[order], True)
    n_long = SEGSUM_LONG
    long_v = torch.from_numpy(rng.standard_normal(n_long) * 1e4)
    long_ok = torch.from_numpy(rng.random(n_long) > 0.2)
    zeros = torch.zeros(n_long, dtype=torch.int64)
    map_v = torch.from_numpy(rng.standard_normal(N) * 1e3)
    map_g = torch.from_numpy(rng.integers(0, S, N))
    map_g[::97] = S  # unplaced rows drop
    map_ok = torch.from_numpy(rng.random(N) > 0.05)
    map_carry = torch.from_numpy(rng.standard_normal(S) * 1e3)
    hot_g = torch.from_numpy(rng.choice(S, 64, replace=False)[
        rng.integers(0, 64, n_long)])
    parts = torch.arange(n_long) // WINDOW_PARTS * WINDOW_PARTS
    cases = [
        _segsum_case("q70's longest call", "sum", v, g, S_q70, valid,
                     contiguous, None, add_ns, dev),
        _segsum_case(f"q70's longest call, {other[0]}", "sum", other[1],
                     other[2], S_q70, other[3], other[4], None, add_ns, dev),
        _segsum_case("one segment of 2^20 rows", "sum", long_v, zeros, 1,
                     long_ok, True, None, add_ns, dev),
        _segsum_case("q01's map shape", "into", map_v, map_g, S, map_ok,
                     False, map_carry, add_ns, dev),
        _segsum_case("q01's map shape", "into", map_v.float(), map_g, S,
                     map_ok, False, map_carry.float(), add_ns, dev),
        _segsum_case("hot: 2^20 rows into 64 slots", "into", long_v, hot_g,
                     S, long_ok, False, map_carry, add_ns, dev),
        _segsum_case("one segment of 2^20 rows", "into", long_v, zeros, 1,
                     long_ok, False, map_carry[:1], add_ns, dev),
        _segsum_case(f"2^20 rows in partitions of {WINDOW_PARTS}",
                     "running", long_v, parts, 1, None, True, None, add_ns,
                     dev),
        _segsum_case("2^20 rows in one partition", "running", long_v, zeros,
                     1, None, True, None, add_ns, dev)]
    return {"add_ns": {str(dt)[6:]: ns for dt, ns in add_ns.items()},
            "cases": cases}


def short_max_sweep(dev):
    """ms a call of csrc/segment_sum.cu at each short-segment threshold of
    SHORT_MAX_SWEEP (segments of at most that many rows are one thread's,
    longer ones a block's; kernels/sort.py fixes SHORT_MAX from this
    sweep), launched directly with the threshold: the carry form at q01's
    map shape (its ids sorted as the wrapper sorts them) and the running
    form over 2^20 rows in partitions of 64 and of 4,096.  Each result is
    held to the plain version bit for bit first."""
    import numpy as np
    import torch
    from blaze_tpu_torch.kernels import build
    from blaze_tpu_torch.kernels import sort as K
    phase("segment_sum: the short-segment threshold swept")
    fn = build.bound("segment_sum", "blaze_segment_sum")
    rng = np.random.default_rng(70)
    v = torch.from_numpy(rng.standard_normal(N) * 1e3).to(dev)
    g = torch.from_numpy(rng.integers(0, S, N)).to(dev)
    carry = torch.from_numpy(rng.standard_normal(S) * 1e3).to(dev)
    w = torch.from_numpy(rng.standard_normal(SEGSUM_LONG)).to(dev)
    rows = torch.arange(SEGSUM_LONG, device=dev)

    def launch(form, ids, order, values, out, n_out, sm):
        n = values.shape[0]
        scratch = torch.empty(2 + n // (sm + 1), dtype=torch.int32,
                              device=dev)
        build.check(fn(K._FORMS[form], ids.data_ptr(),
                       int(ids.dtype == torch.int64),
                       None if order is None else order.data_ptr(),
                       values.data_ptr(), None, out.data_ptr(),
                       scratch.data_ptr(), n, n_out, sm, 1,
                       build.stream_of(dev)), "segment_sum sweep")
        return out

    def into(sm, acc):
        ids, order = K._grouped(g)
        return launch("into", ids, order, v, acc, S, sm)

    def running(sm, part):
        return launch("running", rows // part * part, None, w,
                      torch.empty_like(w), 1, sm)
    want = {"into": K.segment_sum_into_plain(carry.cpu(), v.cpu(), g.cpu()),
            64: K.segmented_running_sum_plain(w.cpu(), (rows // 64 * 64)
                                              .cpu()),
            4096: K.segmented_running_sum_plain(
                w.cpu(), (rows // WINDOW_PARTS * WINDOW_PARTS).cpu())}
    out = {}
    for sm in SHORT_MAX_SWEEP:
        if not (_same_float_bits(into(sm, carry.clone()), want["into"])
                and _same_float_bits(running(sm, 64), want[64])
                and _same_float_bits(running(sm, WINDOW_PARTS),
                                     want[4096])):
            raise SystemExit(f"segment_sum at threshold {sm}: not the "
                             f"CPU's row-order sums")
        acc = carry.clone()
        out[sm] = {
            "into q01 map": time_ms(lambda: into(sm, acc)),
            "running, partitions of 64": time_ms(lambda: running(sm, 64)),
            f"running, partitions of {WINDOW_PARTS}": time_ms(
                lambda: running(sm, WINDOW_PARTS))}
        print(f"SHORT_MAX {sm}: " + ", ".join(
            f"{k} {ms:.4f} ms" for k, ms in out[sm].items()))
    return out


ENGINE_BATCHES = 4


def _engine_global_sums(rng):
    """A lane of row_order_lanes: the generic engine's global float sum
    and avg (ops/agg/exec.py AggExec, no keys, complete mode) over
    ENGINE_BATCHES batches of N rows behind a FilterExec that keeps about
    80% of them: at that density the filter's batches reach the
    aggregation with their masked rows among the others.  On the card it
    fails unless the row-order sum kernel ran."""
    import pyarrow as pa
    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs import BinaryExpr, BoundReference, Literal
    from blaze_tpu_torch.kernels import sort as K
    from blaze_tpu_torch.ops.agg import exec as AE
    from blaze_tpu_torch.ops.agg.functions import make_agg
    from blaze_tpu_torch.ops.base import ExecutionPlan
    from blaze_tpu_torch.ops.basic import FilterExec
    from blaze_tpu_torch.schema import BOOL, Schema
    batches = [pa.record_batch({
        "x": pa.array(rng.standard_normal(N) * 1e3,
                      mask=rng.random(N) < 0.05),
        "m": pa.array(rng.random(N) < 0.8)}) for _ in range(ENGINE_BATCHES)]

    class Source(ExecutionPlan):
        def __init__(self, d):
            super().__init__()
            self.d = d

        @property
        def schema(self):
            return Schema.from_arrow(batches[0].schema)

        def execute(self, partition):
            for rb in batches:
                yield ColumnBatch.from_arrow(rb, device=self.d)

    def run(d):
        config.conf.set(config.TORCH_DEVICE.key, d.type)
        try:
            return ran(d)
        finally:
            config.conf.set(config.TORCH_DEVICE.key, "cuda")

    def ran(d):
        kept = FilterExec(Source(d), [BinaryExpr("==", BoundReference(1),
                                                 Literal(True, BOOL))])
        op = AE.AggExec(kept, [], [
            (make_agg(fn, [BoundReference(0)]), AE.AggMode("complete"), fn)
            for fn in ("sum", "avg")])
        before = K.form_launches["sum"]
        out = pa.Table.from_batches([b.to_arrow() for b in op.execute(0)])
        if d.type == "cuda" and K.form_launches["sum"] == before:
            raise SystemExit("generic engine lane: the row-order sum kernel "
                             "never ran")
        return torch.tensor([out.column(fn)[0].as_py()
                             for fn in ("sum", "avg")], dtype=torch.float64)
    return run


def row_order_lanes(dev):
    """Every lane that sums floats, run twice on the card on the same
    inputs and once on the CPU: fails unless both runs give the same bits
    and the CPU's.  At q01's map shape (32,768 rows a batch into 2^18
    slots) and hot (2^20 rows a batch into 64 of them): the hash lane
    (parallel/stage.py `scatter_accumulate` into a non-zero carry, three
    batches), staged `hash_agg_step` (three batches, keys drawn from 2^16
    or 64 values), the dense lane's batch tables (`dense_partial_agg`)
    and its scatter carry (`scatter_into_dense_carry`, three batches);
    then the window's running sums (ops/window.py `_segmented_cumsum`)
    over 2^20 rows in partitions of 4,096 and in one, and the generic
    engine's global sums over filtered batches (_engine_global_sums)."""
    import numpy as np
    import torch
    from blaze_tpu_torch.ops.window import _segmented_cumsum
    from blaze_tpu_torch.parallel import stage as ST
    phase("row-order lanes: each float-sum lane twice on the card, "
          "against the CPU's bits")
    rng = np.random.default_rng(72)
    out = {}

    def check(name, fn):
        cpu = fn(torch.device("cpu"))
        a = fn(dev)
        b = fn(dev)
        torch.cuda.synchronize()
        r = {"twice_same": _same_float_bits(a, b),
             "equals_cpu": _same_float_bits(a, cpu)}
        out[name] = r
        print(f"{name}: two runs on the card "
              f"{'agree' if r['twice_same'] else 'DIFFER'} bit for bit; "
              f"{'equal to' if r['equals_cpu'] else 'NOT'} the CPU's row "
              f"order")

    for shape, n, distinct in (("q01 map", N, S // 4), ("hot", SEGSUM_LONG,
                                                         64)):
        slots = rng.choice(S, distinct, replace=False)
        pool = rng.integers(1, 1 << 40, distinct)
        batches = []
        for _ in range(3):
            pick = rng.integers(0, distinct, n)
            g = torch.from_numpy(slots[pick])
            g[::97] = S  # unplaced rows drop
            batches.append((torch.from_numpy(rng.standard_normal(n) * 1e3),
                            g, torch.from_numpy(pool[pick]),
                            torch.from_numpy(rng.random(n) > 0.05),
                            torch.from_numpy(rng.random(n) > 0.02)))
        carry = torch.from_numpy(rng.standard_normal(S) * 1e3)
        carry[::11] = -0.0

        def hash_lane(d):
            acc = carry.clone().to(d)
            av = torch.zeros(S, dtype=torch.bool, device=d)
            for v, g, _k, ok, m in batches:
                ST.scatter_accumulate(g.to(d), [("sum", v.to(d), ok.to(d))],
                                      m.to(d), [acc], [av], inplace=True)
            return acc

        def staged(d):
            c = ST.init_hash_carry([torch.int64], ["sum"], [torch.float64],
                                   S, d)
            for v, _g, k, ok, m in batches:
                keys = [(k.to(d), torch.ones_like(m).to(d))]
                c, ovf, _ = ST.hash_agg_step(c, keys, [("sum", v.to(d),
                                                        ok.to(d))], m.to(d))
                if ovf:
                    raise SystemExit(f"row-order lanes: hash_agg_step "
                                     f"overflowed at {shape}")
            return torch.cat([c.accs[0], c.keys[0].to(torch.float64)])

        def dense_tables(d):
            return torch.cat([ST.dense_partial_agg(
                g.to(d), S, [("sum", v.to(d), ok.to(d))], m.to(d))[0][0]
                for v, g, _k, ok, m in batches])

        def dense_carry(d):
            c = ST.init_dense_carry(["sum"], [torch.float64], S, d)
            for v, g, _k, ok, m in batches:
                c = ST.scatter_into_dense_carry(c, g.to(d), ["sum"],
                                                [v.to(d)], [ok.to(d)],
                                                m.to(d))
            return c[0][0]

        for lane, fn in (("hash lane into a carry", hash_lane),
                         ("hash_agg_step staged", staged),
                         ("dense lane batch tables", dense_tables),
                         ("dense lane scatter carry", dense_carry)):
            check(f"{lane}, {shape} ({n} rows x 3, {distinct} slots)", fn)
    v = torch.from_numpy(rng.standard_normal(SEGSUM_LONG) * 1e3)
    for label, part in ((f"partitions of {WINDOW_PARTS}", WINDOW_PARTS),
                        ("one partition", SEGSUM_LONG)):
        starts = torch.arange(SEGSUM_LONG) // part * part
        check(f"window running sums, {SEGSUM_LONG} rows in {label}",
              lambda d, starts=starts: _segmented_cumsum(v.to(d),
                                                         starts.to(d)))
    check(f"generic engine, global sum and avg over {ENGINE_BATCHES} "
          f"filtered batches of {N} rows", _engine_global_sums(rng))
    bad = [k for k, r in out.items()
           if not (r["twice_same"] and r["equals_cpu"])]
    if bad:
        raise SystemExit(f"row-order lanes: not the CPU's bits twice: {bad}")
    return out


# ---------------------------------------------------------------------------
# the expressions phase (exprs/program.py, kernels/bloom.py)
# ---------------------------------------------------------------------------

#: rows of the lower rung's batch in (a)
EXPR_LOW_ROWS = 4000
#: the expression counters each path reads (`_read_launches` "expr"), the
#: expression graphs' captures, capture ms and replays beside them
EXPR_COUNTERS = ("expr_fused_batches", "expr_eager_batches",
                 "expr_programs_built", "expr_program_cache_hits")
_EXPR0 = {}


def _expr_snapshot():
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.exprs import program
    stats = device_stats.expr_stats()
    snap = {k: stats[k] for k in EXPR_COUNTERS}
    snap.update({f"graph_{k}": v for k, v in program.graph_stats.items()})
    return snap


def _expr_delta():
    now = _expr_snapshot()
    return {k: round(v - _EXPR0.get(k, 0), 3) for k, v in now.items()}


def _expr_chains(lo, hi):
    """(a)'s three chains: (table, columns, filters, projections) as
    expression dicts over the columns by name."""
    def col(n):
        return {"kind": "column", "name": n}

    def lit(v, t):
        return {"kind": "literal", "value": v, "type": {"id": t}}

    def b(op, x, y):
        return {"kind": "binary", "op": op, "l": x, "r": y}

    def cast(e, t):
        return {"kind": "cast", "child": e, "type": {"id": t}}
    ss = ["ss_sold_date_sk", "ss_customer_sk", "ss_item_sk",
          "ss_ext_sales_price", "ss_quantity", "ss_list_price",
          "ss_sales_price", "ss_net_profit"]
    return {
        "q01 date filter": (
            "store_returns", ["sr_returned_date_sk", "sr_customer_sk",
                              "sr_store_sk", "sr_return_amt"],
            [b(">=", col("sr_returned_date_sk"), lit(lo, "int64")),
             b("<=", col("sr_returned_date_sk"), lit(hi, "int64"))], []),
        "filter_project: arithmetic, cast, case, coalesce": (
            "store_sales", ss,
            [b(">", col("ss_quantity"), lit(10, "int32"))],
            [b("+", b("*", col("ss_ext_sales_price"), lit(0.9, "float64")),
               cast(col("ss_quantity"), "float64")),
             {"kind": "case",
              "branches": [[b(">", col("ss_net_profit"), lit(0.0, "float64")),
                            col("ss_net_profit")]],
              "else": b("-", lit(0.0, "float64"), col("ss_net_profit"))},
             {"kind": "coalesce", "args": [col("ss_customer_sk"),
                                           col("ss_item_sk")]},
             b("-", col("ss_list_price"), col("ss_sales_price")),
             cast(col("ss_sold_date_sk"), "int32")]),
        "in list (50 members)": (
            "store_sales", ss,
            [{"kind": "in_list", "child": col("ss_item_sk"),
              "values": list(range(1, 2000, 40))}],
            [col("ss_item_sk"), col("ss_quantity")]),
    }


def _same_bits(a, b):
    """Two Arrow tables with the same validity and, where valid, the same
    value bits (floats as their int64 bits)."""
    import numpy as np
    import pyarrow as pa
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        return False
    for name in a.column_names:
        x, y = a.column(name).combine_chunks(), b.column(name).combine_chunks()
        xv, yv = np.asarray(x.is_valid()), np.asarray(y.is_valid())
        if not (xv == yv).all():
            return False
        if pa.types.is_floating(x.type):
            xf = np.asarray(x.fill_null(0.0))[xv].view(np.int64)
            yf = np.asarray(y.fill_null(0.0))[yv].view(np.int64)
            if not (xf == yf).all():
                return False
        elif not x.filter(x.is_valid()).equals(y.filter(y.is_valid())):
            return False
    return True


def _expr_case(name, table, cols, filters, projections, rows):
    """One chain over `rows` rows: the graph replay (fused: the chain's
    program run directly, whatever route the evaluator picks) against the
    same chain eagerly on the card and against the CPU, bit for bit; ms
    a batch both ways (CUDA events, median of 25); cudaLaunch* and
    cudaGraphLaunch a batch (torch.profiler over 10 batches); the
    device time of the copy out of the graph's buffer; the captures and
    their ms; the chain's operator nodes and the route the evaluator
    takes on the card (`GRAPH_MIN_NODES`)."""
    import pyarrow as pa
    import torch
    from torch.profiler import ProfilerActivity, profile
    from blaze_tpu_torch import config
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs import program
    from blaze_tpu_torch.exprs.evaluator import split_conjuncts
    from blaze_tpu_torch.plan.exprs import expr_from_dict
    from blaze_tpu_torch.schema import Field, Schema
    rb = pa.Table.from_batches(
        table.select(cols).slice(0, rows).combine_chunks().to_batches()
    ).to_batches()[0]
    schema = Schema.from_arrow(rb.schema)
    fs = [expr_from_dict(f, schema) for f in filters]
    ps = [expr_from_dict(p, schema) for p in projections]
    out_schema = Schema([Field(f"c{i}", p.data_type(schema))
                         for i, p in enumerate(ps)])

    conjuncts = [c for f in fs for c in split_conjuncts(f)]
    mode = ("filter_project" if fs and ps else "filter" if fs
            else "project")
    prog = program.get_program(mode, conjuncts, ps, schema)

    # the program itself: a graph replay on the card, whatever the chain's
    # length
    forced = types.SimpleNamespace(filter=prog.run_filter,
                                   project=prog.run_project,
                                   filter_project=prog.run_filter_project)

    config.conf.set(config.EXPR_FUSE.key, False)
    try:
        eager_ev = program.FusedExprsEvaluator(fs, ps, schema)
    finally:
        config.conf.unset(config.EXPR_FUSE.key)

    def run(ev, batch):
        if fs and ps:
            return ev.filter_project(batch, out_schema)
        if fs:
            return ev.filter(batch)
        return ev.project(batch, out_schema)

    cuda = ColumnBatch.from_arrow(rb, device=torch.device("cuda"))
    cpu = ColumnBatch.from_arrow(rb, device=torch.device("cpu"))
    fused_ev = forced
    g0 = dict(program.graph_stats)
    def table(b):
        return pa.Table.from_batches([b.compact().to_arrow()])
    fused = table(run(fused_ev, cuda))
    torch.cuda.synchronize()
    captures = {k: round(program.graph_stats[k] - g0[k], 3)
                for k in ("captures", "capture_ms")}
    eager = table(run(eager_ev, cuda))
    on_cpu = table(run(fused_ev, cpu))
    same = {"eager on the card": _same_bits(fused, eager),
            "the CPU": _same_bits(fused, on_cpu)}

    def per_batch(ev, calls=10):
        run(ev, cuda)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                run(ev, cuda)
            torch.cuda.synchronize()
        launched = _host_launches(prof)
        copy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if _on_card(e) and e.name.startswith("Memcpy DtoD"))
        return ({k: v / calls for k, v in launched.items()},
                copy_us / calls)

    fused_launches, copy_us = per_batch(fused_ev)
    eager_launches, _ = per_batch(eager_ev)
    nodes = program.op_nodes(conjuncts + ps)
    route = "graph" if prog.replays_pay else "eager"
    case = {"chain": name, "rows": rb.num_rows, "capacity": cuda.capacity,
            "op_nodes": nodes, "route": route,
            "out_rows": fused.num_rows, "same_bits": same,
            "fused_ms": time_ms(lambda: run(fused_ev, cuda)),
            "eager_ms": time_ms(lambda: run(eager_ev, cuda)),
            "fused_launches": fused_launches,
            "eager_launches": eager_launches,
            "copy_out_us": copy_us, "captures": captures}
    print(f"{name}, {rb.num_rows} rows (capacity {cuda.capacity}), {nodes} "
          f"operator nodes, the evaluator's route {route}: fused "
          f"{case['fused_ms']:.4f} ms, eager {case['eager_ms']:.4f} ms a "
          f"batch; cudaLaunch*/cudaGraphLaunch a batch fused "
          f"{fused_launches['kernel']:.1f}/{fused_launches['graph']:.1f}, "
          f"eager {eager_launches['kernel']:.1f}/"
          f"{eager_launches['graph']:.1f}; copy out {copy_us:.2f} us; "
          f"captures {captures}; {fused.num_rows} rows out; same bits as "
          f"{same}")
    if not all(same.values()):
        raise SystemExit(f"expressions (a) {name}: the graph replay differs "
                         f"{same}")
    if fused_launches["graph"] != 1 or captures["captures"] != 1:
        raise SystemExit(f"expressions (a) {name}: {fused_launches} launches "
                         f"a batch, {captures} on the first")
    return case


#: (a)'s sweep: filters of 1 to EXPR_SWEEP_MAX comparison conjuncts
EXPR_SWEEP_MAX = 6


def _expr_sweep(table):
    """The route's break-even: filters of k = 1..EXPR_SWEEP_MAX comparisons
    over store_sales columns at 32,768 rows, the graph replay against the
    eager chain on the card (the same bits; ms a batch, CUDA events,
    median of 25; cudaLaunch* a batch eager).  The break-even is the
    fewest nodes from which the replay is faster at every k measured;
    `exprs/program.py` GRAPH_MIN_NODES is set from it."""
    import pyarrow as pa
    import torch
    from blaze_tpu_torch.batch import ColumnBatch
    from blaze_tpu_torch.exprs import program
    from blaze_tpu_torch.exprs.evaluator import CachedExprsEvaluator
    from blaze_tpu_torch.plan.exprs import expr_from_dict
    from blaze_tpu_torch.schema import Schema
    cols = ["ss_quantity", "ss_item_sk", "ss_customer_sk",
            "ss_sold_date_sk", "ss_list_price", "ss_sales_price"]
    lits = [(2, "int32"), (100, "int64"), (1000, "int64"), (0, "int64"),
            (1.0, "float64"), (0.5, "float64")]
    rb = pa.Table.from_batches(
        table.select(cols).slice(0, N).combine_chunks().to_batches()
    ).to_batches()[0]
    schema = Schema.from_arrow(rb.schema)
    cuda = ColumnBatch.from_arrow(rb, device=torch.device("cuda"))
    rows = []
    for k in range(1, EXPR_SWEEP_MAX + 1):
        fs = [expr_from_dict({"kind": "binary", "op": ">",
                              "l": {"kind": "column", "name": c},
                              "r": {"kind": "literal", "value": v,
                                    "type": {"id": t}}}, schema)
              for c, (v, t) in zip(cols[:k], lits[:k])]
        prog = program.get_program("filter", fs, (), schema)
        eager = CachedExprsEvaluator(filters=fs)
        same = _same_bits(
            pa.Table.from_batches([prog.run_filter(cuda).compact().to_arrow()]),
            pa.Table.from_batches([eager.filter(cuda).compact().to_arrow()]))
        if not same:
            raise SystemExit(f"expressions (a) sweep: {k} conjuncts, the "
                             f"graph replay differs from the eager chain")
        launched = _launches_a_call(lambda: eager.filter(cuda))
        row = {"op_nodes": program.op_nodes(fs),
               "fused_ms": time_ms(lambda: prog.run_filter(cuda)),
               "eager_ms": time_ms(lambda: eager.filter(cuda)),
               "eager_launches": launched}
        rows.append(row)
    even = None
    for r in reversed(rows):
        if r["fused_ms"] >= r["eager_ms"]:
            break
        even = r["op_nodes"]
    print("expressions (a) sweep at 32,768 rows, operator nodes: fused / "
          "eager ms a batch (eager cudaLaunch*): " + "; ".join(
              f"{r['op_nodes']}: {r['fused_ms']:.4f} / {r['eager_ms']:.4f} "
              f"({r['eager_launches']:.1f})" for r in rows)
          + f"; break-even {even} nodes, GRAPH_MIN_NODES "
          f"{program.GRAPH_MIN_NODES}")
    return {"rows": rows, "break_even_nodes": even,
            "graph_min_nodes": program.GRAPH_MIN_NODES}


def _launches_a_call(fn, calls=10):
    """cudaLaunchKernel a call of `fn` (torch.profiler over `calls`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _host_launches(prof)["kernel"] / calls


def _frame_bits(a, b):
    """Two pandas frames with the same columns, rows and value bits."""
    import numpy as np
    if list(a.columns) != list(b.columns) or len(a) != len(b):
        return False
    for c in a.columns:
        x, y = a[c].to_numpy(), b[c].to_numpy()
        if x.dtype.kind == "f" and y.dtype.kind == "f":
            if not (np.isnan(x) == np.isnan(y)).all() or not (
                    x[~np.isnan(x)].view(np.int64)
                    == y[~np.isnan(y)].view(np.int64)).all():
                return False
        elif not a[c].equals(b[c]):
            return False
    return True


def expressions_phase(root, tables, sr_paths, lo, hi, fused_query):
    """(a) three chains at the main path's shapes, each at 32,768 rows and
    at a lower rung, and the route's break-even; (b) `fused_query` once
    more under auto with the fuse off, equal bit for bit to its fused run
    (every path's expression counters are in the summary); (c) the
    runtime-filter path (itest/runtime_filter.py) at SF10, 4 maps x 16
    reduces, twice under one uuid, the second filter rebuilt over half
    the range."""
    import pyarrow.parquet as pq
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import runtime_filter as RF
    t_phase = time.perf_counter()
    phase("expressions (a): three chains as CUDA graph replays against "
          "the same chains eagerly on the card and on the CPU")
    sr = pq.ParquetFile(sr_paths[0]).read_row_group(0)
    inputs = {"store_returns": sr, "store_sales": tables["store_sales"]}
    cases = []
    for name, (table, cols, fs, ps) in _expr_chains(lo, hi).items():
        for rows in (N, EXPR_LOW_ROWS):
            cases.append(_expr_case(name, inputs[table], cols, fs, ps,
                                    rows))
    sweep = _expr_sweep(tables["store_sales"])

    q, (make_plan, want, fused_frame, fused_counters) = fused_query
    phase(f"expressions (b): {q} with auron.tpu.expr.fuse=false against "
          f"its fused run, both under auto")
    from blaze_tpu_torch.itest import q19_q07_gq1 as D
    config.conf.set(config.EXPR_FUSE.key, False)
    try:
        res, _sched = _dag_query(D, q, make_plan, want, "auto", QNEW_PARTS)
    finally:
        config.conf.unset(config.EXPR_FUSE.key)
    off_frame = FRAMES.pop(res["label"])
    off = res["launches"]["expr"]
    print(f"{q}: fused {fused_counters}; fuse off {off}")
    if not _frame_bits(fused_frame, off_frame):
        raise SystemExit(f"expressions (b): {q} with the fuse off differs "
                         f"from its fused run")
    if fused_counters["expr_fused_batches"] <= 0 or \
            off["expr_fused_batches"] != 0:
        raise SystemExit(f"expressions (b): {q} fused batches "
                         f"{fused_counters['expr_fused_batches']} fused, "
                         f"{off['expr_fused_batches']} off")
    fuse_off = {"query": q, "fused": fused_counters, "off": off,
                "wall_s": res["wall_s"], "same_bits": True}

    phase(f"expressions (c): the runtime filter: q01 inner at SF10, "
          f"{N_MAPS} maps x {N_REDUCES} reduces, date_dim's bloom filter "
          f"beside the range, then again under the same uuid with a filter "
          f"over the first half of the range")
    _loop_mode("auto")
    runtime = []
    for n, build in enumerate(((lo, hi), (lo, lo + (hi - lo) // 2))):
        shuffle_dir = os.path.join(root, f"shuffle_runtime_filter_{n}")
        os.makedirs(shuffle_dir)
        _zero_launches()
        t0 = time.perf_counter()
        rf = RF.run_runtime_filter(
            sr_paths, os.path.join(root, "date_dim.parquet"), lo, hi,
            shuffle_dir, N_MAPS, N_REDUCES, build=build)
        wall = time.perf_counter() - t0
        launches = _read_launches()
        same = RF.same_as_oracle(rf, sr_paths, lo, hi)
        bad = RF.check(rf["probe"])
        p = rf["probe"]
        rows = sum(b.num_rows for bs in rf["reduce_outputs"] for b in bs)
        captures = rf["counters"]["map"]["stage_loop_graph_captures"]
        print(f"build range {rf['build']}: filter {rf['filter']} built in "
              f"{rf['build_s']:.3f} s; map {rf['map_s']:.3f} s, reduce "
              f"{rf['reduce_s']:.3f} s, run {wall:.3f} s; {rows} groups; "
              f"map graph captures {captures}; probe {p}: in the build "
              f"range {p['rows_in_range_passed']} of {p['rows_in_range']} "
              f"pass, outside it {p['keys_out_of_range_passed']} of "
              f"{p['keys_out_of_range']} keys and "
              f"{p['rows_out_of_range_passed']} of {p['rows_out_of_range']} "
              f"rows (limit {RF.fpp_limit(p['keys_out_of_range']):.4f}); "
              f"launches {launches}")
        if not same or bad:
            raise SystemExit(f"expressions (c) build range {rf['build']}: "
                             f"equal to its oracle {same}; {bad}")
        _check_on_card(rf, launches, ("hash_placement", "radix_partition"),
                       "runtime filter")
        runtime.append({"wall_s": wall, "build": rf["build"],
                        "build_s": rf["build_s"], "map_s": rf["map_s"],
                        "reduce_s": rf["reduce_s"], "filter": rf["filter"],
                        "probe": p, "groups": rows,
                        "counters": rf["counters"], "launches": launches})
    # a graph of the first run replayed for the second would read the
    # first filter's words: the second keeps fewer groups and captures
    # its own map graphs
    if not (runtime[1]["groups"] < runtime[0]["groups"]) or \
            runtime[1]["counters"]["map"]["stage_loop_graph_captures"] < 1:
        raise SystemExit(f"expressions (c): the rebuilt filter's run kept "
                         f"{runtime[1]['groups']} of the first run's "
                         f"{runtime[0]['groups']} groups with map captures "
                         f"{runtime[1]['counters']['map']}")
    return {"wall_s": time.perf_counter() - t_phase, "cases": cases,
            "sweep": sweep, "fuse_off": fuse_off,
            "runtime_filter": runtime[0], "runtime_filter_rebuilt": runtime[1]}


def pq_rows(path):
    import pyarrow.parquet as pq
    return pq.ParquetFile(path).metadata.num_rows


def _sorted_frame(df):
    """A result frame in a canonical row order (columns by position)."""
    df = df.set_axis(range(df.shape[1]), axis=1)
    return df.sort_values(list(df.columns)).reset_index(drop=True)


def _bottleneck_text(bn):
    """A traced run's bottleneck report in one phrase."""
    if not bn:
        return "no bottleneck report (no spans)"
    cats = ", ".join(f"{c} {v:.3f}" for c, v in bn["categories"].items()
                     if v > 0)
    return (f"bottleneck {bn['dominant']} {bn['dominant_fraction']:.1%} of "
            f"{bn['wall_s']:.3f} s traced (s by category: {cats})")


def _adaptive_print(label, r, smi):
    """A leg's walls, tasks per stage, events, counter deltas, kernel
    launches and the advisor's findings, with the card's name and power
    limit."""
    if r["leg"] == "history":  # its static and first runs are shared
        names = ["static (the broadcast leg's)",
                 "adaptive 0 (the broadcast leg's)", "adaptive 1 (seeded)"]
    else:
        names = ["static", "adaptive"]
    runs = list(zip(names, [r["static"]] + r["adaptive"]))
    for name, x in runs:
        print(f"{label} {name}: wall {x['wall_s']:.3f} s ({smi}); "
              f"{x['stages']} stages, tasks by stage {x['tasks']}"
              + (f", elided {x['elided']}" if x["elided"] else "")
              + "; stage walls " + ", ".join(
                  f"{sid} {w:.3f}" for sid, w in
                  sorted(x["stage_walls"].items()))
              + (f"; events {x['events']}; deltas {x['delta']}"
                 if not name.startswith("static") else ""))
    launches = {k: v for k, v in r["launches"].items()
                if k in ("hash_placement", "radix_partition", "segment_sum",
                         "window_step")}
    print(f"{label}: launches over its own adaptive run {launches}; "
          f"{_bottleneck_text(r['adaptive'][-1]['bottleneck'])}; advisor "
          f"findings for the stored record and that report: "
          + ("; ".join(f["summary"] for f in r["findings"]) or "none"))


def adaptive_phase(root, q01_plan, q01_want, static_walls, smi):
    """Adaptive execution on the card (itest/adaptive.py): the four legs
    over seeded data at 2^ADAPTIVE_ROWS_LOG2 fact rows, each static and
    then adaptive, then full q01 and q17 on its linked tables at SF10
    under AQE against their earlier static runs (FRAMES; their walls in
    `static_walls`, full q01's traced under explain_analyze) and
    oracles.
    Every kernel count is set to 0 just before each leg's adaptive run(s)
    and read just after."""
    import pandas as pd
    from blaze_tpu_torch.itest import adaptive as A
    from blaze_tpu_torch.itest.runner import compare_frames, frame
    t_phase = time.perf_counter()
    aroot = os.path.join(root, "adaptive")
    os.makedirs(aroot)
    phase(f"adaptive: data (a dim of 2^{ADAPTIVE_ROWS_LOG2 - 6} keys, two "
          f"facts and an aggregation input of 2^{ADAPTIVE_ROWS_LOG2} rows, "
          f"{A.FACT_FILES} files each)")
    t0 = time.perf_counter()
    data = A.make_data(aroot, ADAPTIVE_ROWS_LOG2)
    data_s = time.perf_counter() - t0
    print(f"data generated and written in {data_s:.1f} s")
    _loop_mode("auto")
    legs = {}
    for leg in A.LEGS:
        phase(f"adaptive {leg}: {A.PARTITIONS[leg]} partitions, "
              + ("the broadcast leg's runs, then a seeded run"
                 if leg == "history" else "static then adaptive"))
        launches = {}

        @contextlib.contextmanager
        def counted(out=launches):
            _zero_launches()
            yield
            out.update(_read_launches())
        r = legs[leg] = A.run_leg(leg, data, aroot, counted,
                                  broadcast=legs.get("broadcast"))
        r["launches"] = launches
        _adaptive_print(f"adaptive {leg}", r, smi)
        if r["failures"]:
            raise SystemExit(f"adaptive {leg}: {r['failures']}")
        # the history leg's seeded run has no exchange: its first run,
        # the broadcast leg's adaptive one, wrote its shuffle
        radix = launches["radix_partition"] + (
            legs["broadcast"]["launches"]["radix_partition"]
            if leg == "history" else 0)
        if radix <= 0:
            raise SystemExit(f"adaptive {leg}: radix was never launched")
        if leg == "coalesce" and not (launches["hash_placement"]
                                      or launches["segment_sum"]
                                      or launches["window_step"]):
            raise SystemExit("adaptive coalesce: the sums ran no "
                             "aggregation kernel on the card")
    del data
    makers = {"q01 full": (lambda: q01_plan, q01_want),
              "q17": ORACLES["q17 linked"]}
    tpcds = {}
    for static_label, name in ADAPTIVE_TPCDS.items():
        phase(f"adaptive {name}: TPC-DS {name} at SF10 under AQE "
              f"(the default thresholds) against its static run")
        make_plan, want = makers[name]
        launches = {}

        @contextlib.contextmanager
        def counted(out=launches):
            _zero_launches()
            yield
            out.update(_read_launches())
        with counted():
            r = A.run_plan(make_plan(), A.leg_conf(
                name, os.path.join(aroot, f"stats-{name}")),
                os.path.join(aroot, name.replace(" ", "-")), traced=True)
        got = frame(r.pop("table"))
        static = FRAMES.pop(static_label)
        r.update(launches=launches, rows=len(got),
                 static_wall_s=static_walls[name], findings=A.findings(
                     os.path.join(aroot, f"stats-{name}"),
                     r["fingerprint"], r["bottleneck"]))
        tpcds[name] = r
        rules = sorted({e["rule"] for e in r["events"]})
        shown = {k: launches[k] for k in ("hash_placement",
                                           "radix_partition", "segment_sum")}
        print(f"adaptive {name}: wall {r['wall_s']:.3f} s (the static run "
              f"{static_walls[name]:.3f} s) ({smi}); "
              f"{r['stages']} stages, tasks by stage {r['tasks']}; rules "
              f"fired {rules or 'none'}; events {r['events']}; deltas "
              f"{r['delta']}; launches {shown}; "
              f"{_bottleneck_text(r['bottleneck'])}; advisor findings: "
              + ("; ".join(f["summary"] for f in r["findings"]) or "none"))
        if r["warnings"]:
            raise SystemExit(f"adaptive {name}: {r['warnings']}")
        err = compare_frames(got, want, 1e-9)
        if err or not len(got):
            raise SystemExit(f"adaptive {name}: {len(got)} rows against the "
                             f"oracle's {len(want)}: {err}")
        if not _frame_bits(_sorted_frame(got), _sorted_frame(
                pd.DataFrame(static))):
            raise SystemExit(f"adaptive {name}: differs from its static run")
        if r["task_runs"] or r["leaks"]:
            raise SystemExit(f"adaptive {name}: tasks ran twice "
                             f"{r['task_runs']} or leaked {r['leaks']}")
        if launches["radix_partition"] <= 0:
            raise SystemExit(f"adaptive {name}: radix was never launched")
        print(f"adaptive {name}: {len(got)} rows, equal to its oracle and "
              f"to its static run")
    wall = time.perf_counter() - t_phase
    print(f"adaptive phase: {wall:.1f} s ({smi})")
    return {"data_s": data_s, "legs": legs, "tpcds": tpcds, "wall_s": wall}


# ---------------------------------------------------------------------------
# the query service: the card under several query threads, then
# concurrent TPC-DS queries through QueryService
# ---------------------------------------------------------------------------

#: the serving phase's mix (BENCH_SERVE.json's) and its levels
SERVING_MIX = ("q01", "q06", "q95")
SERVING_LEVELS = (1, 4)
TWO_STREAM_CALLS = 100      # each thread's eager calls of each kernel
RADIX_Q01_ROWS = 290_000    # a q01 map task's rows into the writer
CAPTURE_FRESH_SIZES = 48    # the capture check's distinct fresh sizes
CHAOS_RULES = "task-start=0.05,shuffle-read=0.03"
CHAOS_SEED = 23
CHAOS_MAX_RECOVERIES = 8    # lineage rounds a chaos query may take and
CHAOS_PARTS = 2             # its exchanges' partitions: the JAX package's
                            # serving soak's (bench.py --serve); at 16 a
                            # consumer stage reads 256 blocks a round, and
                            # at 3% a block no round would come through
DEADLINE_MS = 1500          # the deadline leg's deadline
#: the earlier phases' serial frames of the serving mix, by query
SERIAL = {}


def two_stream_check(gen, dev):
    """Two threads, each on a CUDA stream of its own, each making
    TWO_STREAM_CALLS eager placement calls (q01's map shape: a full batch
    against a table at load 0.5) and as many `partition_order` calls
    (q01's writer shape: 290,000 hashed pids over 16 partitions) at the
    same time, every result held exact against the plain version on the
    same inputs; the wrappers' counts must rise by exactly the calls
    made (they count under their locks), and each stream must have had
    its own placement scratch."""
    import threading

    import torch
    from blaze_tpu_torch.device import lease_stream, release_stream
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    phase(f"serving (a): two threads on two CUDA streams, "
          f"{TWO_STREAM_CALLS} eager placements and {TWO_STREAM_CALLS} "
          f"partition_order calls each at q01's shapes, at once")
    h, limbs, mask, used0, tab0 = _placement_state(gen, dev, 0.5)
    pid = _radix_column(gen, "hashed", RADIX_Q01_ROWS, N_REDUCES, dev)
    ref_used, ref_tab = used0.clone(), tab0.clone()
    ref = HU.place_in_carry_plain(h, limbs, mask, ref_used, ref_tab, ROUNDS)
    ref_order = R.partition_order_plain(pid, N_REDUCES)
    torch.cuda.synchronize()
    placed0, radix0 = HU.placement_launches, R.partition_launches
    barrier = threading.Barrier(2)
    out = [None, None]
    streams = [lease_stream(dev), lease_stream(dev)]

    def worker(k):
        try:
            # a private stream each (torch.cuda.Stream() could hand both
            # threads one of its pool's)
            stream = streams[k]
            bad = []
            with torch.cuda.stream(stream):
                barrier.wait(60)
                for i in range(TWO_STREAM_CALLS):
                    used, tab = used0.clone(), tab0.clone()
                    got = HU.place_in_carry(h, limbs, mask, used, tab,
                                            ROUNDS)
                    order = R.partition_order(pid, N_REDUCES)
                    if not (all(torch.equal(a, b) for a, b in zip(got, ref))
                            and torch.equal(used, ref_used)
                            and torch.equal(tab, ref_tab)):
                        bad.append(f"placement call {i}")
                    if not _order_exact(order, ref_order)[0]:
                        bad.append(f"partition_order call {i}")
            out[k] = {"stream": stream.cuda_stream, "bad": bad}
        except BaseException as e:  # noqa: BLE001 - reported below
            out[k] = {"error": repr(e)}

    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    for stream in streams:
        release_stream(stream)
    placed = HU.placement_launches - placed0
    grouped = R.partition_launches - radix0
    streams = [o.get("stream") for o in out if o]
    scratch_streams = sorted(k[1] for k in HU._scratch
                             if k[1] in streams)
    print(f"two streams: {wall:.3f} s; placement launches {placed}, radix "
          f"{grouped} (expected {2 * TWO_STREAM_CALLS} each); placement "
          f"scratches on the two streams {len(scratch_streams)}; "
          f"results {out}")
    bad = [o for o in out if o is None or "error" in o or o["bad"]]
    if bad or any(t.is_alive() for t in threads):
        raise SystemExit(f"two streams: a result differs from its plain "
                         f"version or a thread failed: {out}")
    if placed != 2 * TWO_STREAM_CALLS or grouped != 2 * TWO_STREAM_CALLS:
        raise SystemExit(f"two streams: the wrappers counted {placed} "
                         f"placements and {grouped} groupings for "
                         f"{2 * TWO_STREAM_CALLS} calls each")
    if len(set(streams)) != 2 or len(scratch_streams) != 2:
        raise SystemExit(f"two streams: streams {streams}, placement "
                         f"scratches on them {scratch_streams}")
    R._scratch.clear()
    HU._scratch.clear()
    return {"calls": TWO_STREAM_CALLS, "wall_s": wall,
            "placement_launches": placed, "radix_launches": grouped}


def concurrent_capture_check(dev):
    """The stage loop's captures (thread-local error mode) while another
    thread allocates fresh device memory (cudaMalloc), copies to the
    host, waits on events and synchronises its streams, on its own stream
    and on the legacy default stream (what another query's slot does):
    the fold at q01's reduce shape (two captures, 8 and 4 batch slots)
    must capture, replay and equal the same fold on the CPU, and the
    other thread's calls must have run during the captures themselves.
    A device-wide synchronisation is left out: it fails beside any
    capture and breaks it whatever the mode (itest/capture_modes.py)."""
    import threading

    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.plan import create_plan, stage_compiler
    from blaze_tpu_torch.plan.fused import fuse_plan
    from blaze_tpu_torch.runtime import loop
    phase("serving (b): the stage loop's captures beside another thread's "
          "allocations, copies, event waits and syncs")
    n_batches = 11
    loop._FOLDS.clear()  # the fold parity's entries: capture afresh
    torch.cuda.empty_cache()  # no capture runs: room for the fresh sizes

    def fold(device):
        config.conf.set(config.TORCH_DEVICE.key, device)
        try:
            agg = fuse_plan(create_plan(q01.stage2_td(0, N_REDUCES)["plan"]))
            prog = stage_compiler.compile_fused_agg(agg)
            batches = _reduce_batches(n_batches, torch.device(device))
            return loop.run_partition(prog, 0, source_stream=iter(batches))
        finally:
            config.conf.set(config.TORCH_DEVICE.key, "cuda")

    capturing = threading.Event()
    done = threading.Event()
    noise = {"calls": 0, "during_capture": 0, "error": None,
             "bytes": 0}
    real = loop._Fold._capture_locked

    def capture(self, program):
        capturing.set()
        try:
            return real(self, program)
        finally:
            capturing.clear()

    def other_thread():
        try:
            own = torch.cuda.Stream(dev)
            k = 0
            while not done.is_set():
                k += 1
                during = capturing.is_set()
                # its first CAPTURE_FRESH_SIZES rounds take sizes the
                # caching allocator has not cached (a cudaMalloc each),
                # then cycle through them
                nbytes = (12 << 20) + (k % CAPTURE_FRESH_SIZES) * (2 << 20)
                for stream in (own, torch.cuda.default_stream(dev)):
                    with torch.cuda.stream(stream):
                        x = torch.empty(nbytes if stream is own
                                        else 4096 + k, dtype=torch.uint8,
                                        device=dev)
                        x.fill_(k & 0xFF)
                        y = x[:4096].to("cpu")
                        ev = torch.cuda.Event()
                        ev.record(stream)
                        ev.synchronize()
                        ev.query()
                        val = int(x[-1].item())
                        stream.synchronize()
                        noise["bytes"] += x.numel()
                        del x
                    if val != k & 0xFF or int(y[0]) != k & 0xFF:
                        raise RuntimeError("the other thread read back "
                                           "wrong bytes")
                # no torch.cuda.synchronize(): a device-wide sync is the
                # one call that fails beside a thread-local capture and
                # breaks it (itest/capture_modes.py), and the port makes
                # none (plan/stages.py syncs a stage's own stream)
                noise["calls"] += 1
                if during and capturing.is_set():
                    noise["during_capture"] += 1
        except BaseException as e:  # noqa: BLE001 - reported below
            noise["error"] = repr(e)

    stats0 = dict(loop.graph_stats)
    t = threading.Thread(target=other_thread)
    loop._Fold._capture_locked = capture
    try:
        t.start()
        while noise["calls"] < 2 and t.is_alive():
            time.sleep(0.01)
        cuda = fold("cuda")
        torch.cuda.synchronize()
    finally:
        loop._Fold._capture_locked = real
        done.set()
        t.join(120)
    captured = {k: loop.graph_stats[k] - stats0[k] for k in stats0}
    torch.cuda.empty_cache()  # the other thread's cached sizes
    cpu = fold("cpu")
    exact = torch.equal(cuda.used.cpu(), cpu.used) and torch.equal(
        cuda.limbs.cpu(), cpu.limbs) and all(
        torch.equal(a.cpu(), b) for a, b in zip(cuda.keys, cpu.keys)) and \
        _same_float_bits(cuda.accs[0].cpu(), cpu.accs[0])
    print(f"captures {captured['captures']}, replays {captured['replays']} "
          f"beside {noise['calls']} rounds of the other thread "
          f"({noise['during_capture']} while a capture ran, "
          f"{noise['bytes']} bytes allocated, error {noise['error']}); "
          f"the fold equal to the CPU's: {exact}")
    if noise["error"] or t.is_alive():
        raise SystemExit(f"the other thread failed beside the captures: "
                         f"{noise['error']}")
    if captured["captures"] != 2 or not exact:
        raise SystemExit(f"the fold captured beside another thread: "
                         f"{captured}, equal to the CPU {exact}")
    if noise["during_capture"] <= 0:
        raise SystemExit("the other thread made no call while a capture "
                         "ran: nothing was shown")
    return {"captures": captured["captures"], "replays":
            captured["replays"], "other_rounds": noise["calls"],
            "other_rounds_during_capture": noise["during_capture"]}


FOLD_SLEEP_CYCLES = 200_000_000  # ~0.1 s of a kernel that only waits


def fold_cross_stream_check(dev, wait=True):
    """Two threads, each on a private stream, fold through ONE stage-loop
    entry back to back: thread A folds q01's 11 reduce batches (its last
    window on the 4-slot entry), and, holding that entry, queues a kernel
    that only waits (FOLD_SLEEP_CYCLES) and then its drain (a clone of the
    carry) on its stream; thread B, started meanwhile, folds the first 3
    batches, whose one window takes the same entry as soon as A releases
    it, and resets the carry first thing.  Only the entry's event orders
    B's reset after A's drain: each carry must equal the same fold on the
    CPU.  `wait=False` leaves the event out of `acquire` (to show that
    the check sees the race)."""
    import threading

    import torch
    from blaze_tpu_torch import config
    from blaze_tpu_torch.device import lease_stream, release_stream
    from blaze_tpu_torch.itest import q01
    from blaze_tpu_torch.parallel.stage import HashAggCarry
    from blaze_tpu_torch.plan import create_plan, stage_compiler
    from blaze_tpu_torch.plan.fused import fuse_plan
    from blaze_tpu_torch.runtime import loop
    phase(f"serving (c): two streams fold through one stage-loop entry "
          f"back to back, a {FOLD_SLEEP_CYCLES}-cycle wait before the "
          f"first one's drain" + ("" if wait else " (the event left out)"))

    def program():
        return stage_compiler.compile_fused_agg(fuse_plan(create_plan(
            q01.stage2_td(0, N_REDUCES)["plan"])))

    def clone(carry):
        return HashAggCarry(*[tuple(t.clone() for t in f)
                              if isinstance(f, tuple) else f.clone()
                              for f in carry])

    def cpu_fold(n):
        config.conf.set(config.TORCH_DEVICE.key, "cpu")
        try:
            return loop.run_partition(program(), 0, source_stream=iter(
                _reduce_batches(n, torch.device("cpu"))))
        finally:
            config.conf.set(config.TORCH_DEVICE.key, "cuda")

    def same(got, want):
        return torch.equal(got.used.cpu(), want.used) and torch.equal(
            got.limbs.cpu(), want.limbs) and all(
            torch.equal(a.cpu(), b) for a, b in zip(got.keys, want.keys)) \
            and _same_float_bits(got.accs[0].cpu(), want.accs[0])

    prog = program()
    data = {"a": _reduce_batches(11, dev), "b": _reduce_batches(3, dev)}
    holding = threading.Event()
    out, errors = {}, {}
    streams = {k: lease_stream(dev) for k in data}

    def run_a():
        try:
            with torch.cuda.stream(streams["a"]):
                with loop._folded(prog, 0, iter(data["a"])) as carry:
                    holding.set()
                    time.sleep(0.05)  # B reaches the entry's lock
                    torch.cuda._sleep(FOLD_SLEEP_CYCLES)
                    out["a"] = clone(carry)
                streams["a"].synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors["a"] = repr(e)
        finally:
            holding.set()

    def run_b():
        try:
            if not holding.wait(120):
                raise RuntimeError("A never held the entry")
            with torch.cuda.stream(streams["b"]):
                out["b"] = loop.run_partition(prog, 0,
                                              source_stream=iter(data["b"]))
                streams["b"].synchronize()
        except BaseException as e:  # noqa: BLE001 - reported below
            errors["b"] = repr(e)

    real = loop._Fold.acquire
    if not wait:
        def acquire(self, program):
            event, self.event = self.event, None
            try:
                return real(self, program)
            finally:
                self.event = event
        loop._Fold.acquire = acquire
    try:
        threads = [threading.Thread(target=f) for f in (run_a, run_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
    finally:
        loop._Fold.acquire = real
    torch.cuda.synchronize()
    for stream in streams.values():
        release_stream(stream)
    keys = [k for k in loop._FOLDS if k[0] == prog.fingerprint]
    exact = {k: k in out and same(out[k], cpu_fold(len(data[k])))
             for k in data}
    print(f"fold entries of the shape {[k[2] for k in keys]}; errors "
          f"{errors}; each carry equal to the CPU's fold: {exact}")
    if not wait:
        return {"exact": exact, "errors": errors}
    if errors or any(t.is_alive() for t in threads) or \
            not all(exact.values()):
        raise SystemExit(f"fold entry across streams: {errors}, equal to "
                         f"the CPU {exact}")
    return {"exact": exact, "sleep_cycles": FOLD_SLEEP_CYCLES}


def private_stream_check(dev):
    """The service's slot streams are private: four queries running at
    once through QueryService (executors gated on a barrier) each see a
    current stream of their own, none of them is the graph captures' side
    stream, and none is any of the 64 streams of PyTorch's pool
    (`torch.cuda.Stream()` at both priorities, 32 each), which the scans'
    stagers draw from."""
    import threading

    import torch
    from blaze_tpu_torch.device import capture_stream
    from blaze_tpu_torch.serving import QueryService
    from blaze_tpu_torch.serving import service as SVC
    phase("serving (d): four running queries' streams against the capture "
          "stream and PyTorch's stream pool")
    barrier = threading.Barrier(4)
    seen = []

    def executor(plan, ctx, handle):
        seen.append(torch.cuda.current_stream(dev).cuda_stream)
        barrier.wait(60)
        return None
    # the default executor's service (it runs on the configured device)
    real, SVC._default_executor = SVC._default_executor, executor
    try:
        svc = QueryService(max_concurrent=4, max_queue=4)
    finally:
        SVC._default_executor = real
    try:
        handles = [svc.submit({}) for _ in range(4)]
        errs = [h.exception(120) for h in handles]
    finally:
        svc.shutdown(wait=True, cancel_running=True)
    cap = capture_stream(dev).cuda_stream
    pool = {torch.cuda.Stream(dev, priority=p).cuda_stream
            for p in (0, -1) for _ in range(32)}
    print(f"slot streams {[hex(x) for x in seen]}; capture stream "
          f"{cap:#x}; {len(pool)} distinct pool streams; errors {errs}")
    if any(errs) or len(set(seen)) != 4 or cap in seen or \
            pool & set(seen + [cap]):
        raise SystemExit(f"serving streams: slots {seen}, capture {cap}, "
                         f"shared with the pool {pool & set(seen + [cap])}, "
                         f"errors {errs}")
    return {"slot_streams": len(set(seen)), "pool_streams": len(pool)}


def _service_consumers(qctx):
    """Bytes the manager still holds for a query's consumers."""
    from blaze_tpu_torch.memory import MemManager
    mm = MemManager.get()
    with mm._lock:
        return sum(c.mem_used for c in mm._consumers if c.query is qctx)


def _clean_after(label, h):
    """The teardown a cancelled or killed query must leave: no shuffle
    file, resource or scratch directory, and no bytes in the manager."""
    import os as _os
    held = _service_consumers(h.ctx)
    if h.leak_report is None or any(h.leak_report.values()) or held or \
            (h.work_dir and _os.path.exists(h.work_dir)):
        raise SystemExit(f"serving {label}: left behind {h.leak_report}, "
                         f"{held} bytes in the manager, work dir "
                         f"{h.work_dir}")


def _rerun_equal(label, svc, make, want, name):
    """A rerun of the query through `svc` completes equal to its oracle
    (no fold entry was left locked)."""
    from blaze_tpu_torch.itest import serving as SV
    h = svc.submit(make())
    h.exception(600)
    out = {"results": [{"name": name, "query_id": h.query_id,
                        "status": h.status, "error": repr(h._error),
                        "table": h._result}]}
    err = SV.check_mix(out, {name: want})[h.query_id]
    if err:
        raise SystemExit(f"serving {label}: the rerun {err}")
    return h.wall_s


def _serving_runs(root, mix, smi):
    """The serving phase's levels and legs (see serving_phase)."""
    import threading

    import torch
    from blaze_tpu_torch import config, faults
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.bridge.context import current_task
    from blaze_tpu_torch.itest import serving as SV
    from blaze_tpu_torch.memory.manager import MemManager
    from blaze_tpu_torch.plan import statstore
    from blaze_tpu_torch.plan.stages import DagScheduler
    from blaze_tpu_torch.serving import (DeadlineExceeded, QueryCancelled,
                                         QueryMemoryExceeded, QueryRejected,
                                         QueryService, progress)
    _loop_mode("auto")
    config.conf.set(config.DAG_SINGLE_TASK_BYTES.key, 0)
    oracles = {n: want for n, (_make, want) in mix.items()}
    makers = {n: make for n, (make, _want) in mix.items()}
    out = {"levels": {}, "launches": {}}
    peaks, task_peaks = {}, {}

    # -- levels -------------------------------------------------------------
    for c in SERVING_LEVELS:
        phase(f"serving (e): {', '.join(SERVING_MIX)} twice each through "
              f"QueryService at maxConcurrent {c} (stage loop auto, "
              f"staged)")
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        # at level 1 (one query at a time) each query's peak of the bytes
        # its consumers declare, the quota's unit, and each task's
        enforce = MemManager._enforce_query_quota
        seen = {}

        def record(self, updated, seen=seen):
            q = updated.query
            if q is not None:
                t = current_task()
                used = sum(x.mem_used for x in self._consumers
                           if x.query is q)
                key = (q.query_id, t.stage_id, t.partition_id)
                seen[key] = max(seen.get(key, 0), used)
            return enforce(self, updated)
        if c == 1:
            MemManager._enforce_query_quota = record
        try:
            r = SV.run_mix([(n, makers[n]) for n in SERVING_MIX] * 2, c,
                           timeout_s=600)
        finally:
            MemManager._enforce_query_quota = enforce
        launches = _read_launches()
        if c == 1:
            names = {x["query_id"]: x["name"] for x in r["results"]}
            for (qid, sid, part), v in seen.items():
                name = names[qid]
                peaks[name] = max(peaks.get(name, 0), v)
                tp = task_peaks.setdefault(name, {})
                tp[(sid, part)] = max(tp.get((sid, part), 0), v)
        peak = torch.cuda.max_memory_allocated()
        errs = SV.check_mix(r, oracles, SERIAL)
        walls = {x["query_id"]: (x["name"], round(x["wall_s"], 3),
                                 round(x["run_s"], 3))
                 for x in r["results"]}
        print(f"maxConcurrent {c} ({smi}): submitted {r['submitted']}, "
              f"completed {r['completed']}, p50 {r['p50_ms']:.1f} ms, p99 "
              f"{r['p99_ms']:.1f} ms, wall {r['wall_s']:.3f} s, "
              f"{r['qps']:.3f} queries/s, sum of the runs' walls "
              f"{r['serial_sum_s']:.3f} s, torch.cuda.max_memory_allocated "
              f"{peak} bytes; (query, wall, run s) {walls}; launches "
              f"{ {k: launches[k] for k in ('hash_placement', 'radix_partition', 'segment_sum', 'window_step')} }")
        bad = {q: e for q, e in errs.items() if e}
        if bad or r["completed"] != r["submitted"] or r["leaks"] or \
                r["threads_alive"]:
            raise SystemExit(f"serving maxConcurrent {c}: {bad}, leaks "
                             f"{r['leaks']}, threads {r['threads_alive']}")
        for k in ("hash_placement", "radix_partition", "segment_sum"):
            if launches[k] <= 0:
                raise SystemExit(f"serving maxConcurrent {c}: {k} never "
                                 f"launched")
        print(f"maxConcurrent {c}: every result equals its oracle and its "
              f"serial run bit for bit")
        for x in r["results"]:
            x.pop("table")
        out["levels"][c] = dict(r, peak_bytes=peak)
        out["launches"][f"c{c}"] = launches

    # -- cancel from the progress hook ---------------------------------------
    phase("serving (f): q95 cancelled from the progress hook as its second "
          "stage starts; the deadline; the quota ladder")
    stats_dir = os.path.join(root, "serving-stats")
    config.conf.set(config.STATS_ENABLE.key, "true")
    config.conf.set(config.STATS_DIR.key, stats_dir)
    statstore.reset_conf_probe()
    legs = {}
    svc = QueryService(max_concurrent=1, max_queue=8)
    try:
        start = progress.note_stage_start

        def hook(qid, sid, tasks):
            start(qid, sid, tasks)
            if sid >= 1:
                svc.cancel(qid, reason="cancelled from the progress hook")
        progress.note_stage_start = hook
        try:
            h = svc.submit(makers["q95"]())
            err = h.exception(600)
        finally:
            progress.note_stage_start = start
        snap = progress.progress(h.query_id)
        later = {s: st["tasks_done"] for s, st in snap["stages"].items()
                 if s != "0"}
        print(f"cancel: {type(err).__name__}: {err}; progress "
              f"{snap['stages']}; leak report {h.leak_report}")
        if not isinstance(err, QueryCancelled) or any(later.values()) or \
                snap["stages"]["0"]["tasks_done"] != \
                snap["stages"]["0"]["tasks_total"]:
            raise SystemExit(f"serving cancel: {err!r}, progress "
                             f"{snap['stages']}")
        _clean_after("cancel", h)
        legs["cancel"] = {"error": repr(err), "stages": snap["stages"],
                          "rerun_s": _rerun_equal("cancel", svc,
                                                  makers["q95"],
                                                  oracles["q95"], "q95")}
        config.conf.unset(config.STATS_ENABLE.key)
        config.conf.unset(config.STATS_DIR.key)
        statstore.reset_conf_probe()

        # -- the deadline: it expires inside the first map task ---------------
        real = DagScheduler._run_map_task
        hit = []

        def first_task_waits(self, stage, part, m):
            if not hit and self._query is not None:
                hit.append((stage.sid, m))
                end = time.monotonic() + 30
                while self._query.remaining_ms() > 0 and \
                        time.monotonic() < end:
                    self._query.wait_cancelled(0.01)
            return real(self, stage, part, m)
        DagScheduler._run_map_task = first_task_waits
        try:
            h = svc.submit(makers["q95"](), deadline_ms=DEADLINE_MS)
            err = h.exception(600)
        finally:
            DagScheduler._run_map_task = real
        print(f"deadline {DEADLINE_MS} ms: {type(err).__name__}: {err}; "
              f"expired in the first map task of stage {hit}; wall "
              f"{h.wall_s:.3f} s")
        if not isinstance(err, DeadlineExceeded) or hit != [(0, 0)]:
            raise SystemExit(f"serving deadline: {err!r}, {hit}")
        _clean_after("deadline", h)
        legs["deadline"] = {"error": repr(err), "wall_s": h.wall_s,
                            "rerun_s": _rerun_equal(
                                "deadline", svc, makers["q95"],
                                oracles["q95"], "q95")}

        # -- the quota ladder ---------------------------------------------------
        def rungs_of(ctx):
            """The rungs a context climbed, in order (the ladder is
            one-way: level n entered its first n rungs, the third a
            kill)."""
            from blaze_tpu_torch.serving.context import DEGRADE_LADDER
            return [DEGRADE_LADDER[min(i, len(DEGRADE_LADDER) - 1)]
                    for i in range(ctx.degrade_level)]

        def laddered(name, quota, label, expect=None):
            """`name` under `quota`: its rungs, breaches and outcome;
            `expect` "climb" (completes on one or two rungs, equal to its
            oracle) or "kill" (QueryMemoryExceeded after the third)."""
            mm = MemManager.get()
            breaches0 = mm.total_quota_breaches
            h = svc.submit(makers[name](), mem_quota=quota)
            err = h.exception(600)
            tops = sorted(task_peaks[name].values(), reverse=True)
            r = {"query": name, "quota": quota, "peak_bytes": peaks[name],
                 "task_peaks": tops[:4],
                 "rungs": rungs_of(h.ctx),
                 "breaches": mm.total_quota_breaches - breaches0,
                 "tasks_above": sum(1 for v in tops if v > quota),
                 "error": None if err is None else repr(err)}
            print(f"quota {label}: {name} under {quota} bytes (its peak "
                  f"{peaks[name]} bytes of its consumers; the largest task "
                  f"peaks {r['task_peaks']}, {r['tasks_above']} task(s) "
                  f"above the quota at level 1): rungs {r['rungs']}, "
                  f"{r['breaches']} breaches, "
                  f"{type(err).__name__ if err else 'completed'}")
            if err is None:
                res = {"results": [{"name": name, "query_id": h.query_id,
                                    "status": h.status, "error": None,
                                    "table": h.result(0)}]}
                e = SV.check_mix(res, {name: oracles[name]})[h.query_id]
                if e or not r["rungs"] or "kill" in r["rungs"] or \
                        expect == "kill":
                    raise SystemExit(f"serving quota {label}: {e}, {r}")
            elif not isinstance(err, QueryMemoryExceeded) or \
                    r["rungs"][-1] != "kill" or r["breaches"] < 3 or \
                    expect == "climb":
                raise SystemExit(f"serving quota {label}: {r}")
            _clean_after(f"quota {label}", h)
            return r

        # full q01 scans store_returns twice (stages 0 and 2), so its
        # largest task peak (the writer's staged rows) is reached by one
        # task of each: one byte under it, two tasks breach, two rungs,
        # no kill.  Each of q95's four web_sales map tasks holds its peak
        # alike: one byte under it, four breach, and the third kills.
        q01_top = max(task_peaks["q01"].values())
        ladder = {"peaks": peaks}
        ladder["q01 climb"] = laddered("q01", q01_top - 1,
                                       "under q01's largest task", "climb")
        ladder["q01 kill"] = laddered("q01", max(1, q01_top // 8),
                                      "kill at an eighth of q01's", "kill")
        ladder["q95 under the peak"] = laddered(
            "q95", peaks["q95"] - 1, "q95 under its peak", "kill")
        ladder["rerun_s"] = _rerun_equal("quota kill", svc, makers["q01"],
                                         oracles["q01"], "q01")
        legs["quota"] = ladder
    finally:
        svc.shutdown(wait=True, cancel_running=True)
        config.conf.unset(config.STATS_ENABLE.key)
        config.conf.unset(config.STATS_DIR.key)
        statstore.reset_conf_probe()

    # -- admission ------------------------------------------------------------
    phase("serving (g): admission (maxQueue 1 with its slot blocked; "
          "tenant.maxInflight 1), then chaos")
    from blaze_tpu_torch.serving.service import _default_executor
    gate, started = threading.Event(), threading.Event()

    def gated(plan, ctx, handle):
        started.set()
        if not gate.wait(120):
            raise SystemExit("serving admission: the gate never opened")
        return _default_executor(plan, ctx, handle)

    kinds = {}
    for label, kw, tenants in (
            ("queue-full", dict(max_concurrent=1, max_queue=1),
             ("a", "a", "b", "c")),
            ("tenant-quota", dict(max_concurrent=2, max_queue=8,
                                  tenant_max_inflight=1),
             ("a", "a", "b", "a"))):
        gate.clear()
        started.clear()
        svc = QueryService(executor=gated, **kw)
        try:
            handles, got = [], []
            for i, tenant in enumerate(tenants):
                try:
                    handles.append(svc.submit(makers["q95"](),
                                              tenant=tenant))
                    got.append("admitted")
                except QueryRejected as e:
                    got.append(e.kind)
                if i == 0 and not started.wait(60):
                    raise SystemExit("serving admission: no slot started")
            # the admitted queries are cancelled before the gate opens:
            # the levels ran the mix to completion already
            for h in handles:
                h.cancel(reason="admission leg done")
            gate.set()
            for h in handles:
                if not isinstance(h.exception(600), QueryCancelled):
                    raise SystemExit(f"serving admission: {h.status}")
            counters = svc.stats()["counters"]
        finally:
            gate.set()
            svc.shutdown(wait=True, cancel_running=True)
        want = (["admitted", "admitted", "queue-full", "queue-full"]
                if label == "queue-full" else
                ["admitted", "tenant-quota", "admitted", "tenant-quota"])
        print(f"admission {label}: {got}; counters {counters}")
        key = "shed_" + label.replace("-", "_")
        if got != want or counters[key] != 2 or \
                counters["admitted"] != 2 or counters["cancelled"] != 2:
            raise SystemExit(f"serving admission {label}: {got}, "
                             f"{counters}")
        kinds[label] = {"outcomes": got, "counters": counters}
    out["admission"] = kinds

    # -- chaos ----------------------------------------------------------------
    config.conf.set(config.STAGE_MAX_RECOVERIES.key, CHAOS_MAX_RECOVERIES)
    before = device_stats.snapshot()
    faults.configure(CHAOS_RULES, seed=CHAOS_SEED)
    try:
        _zero_launches()
        r = SV.run_mix([("q01", lambda: makers["q01"](CHAOS_PARTS))] * 3,
                       3, timeout_s=600)
        out["launches"]["chaos"] = _read_launches()
        fired = faults.stats()
    finally:
        faults.clear()
        config.conf.unset(config.STAGE_MAX_RECOVERIES.key)
    delta = device_stats.delta(before)
    errs = SV.check_mix(r, oracles)
    chaos = {k: delta.get(k, 0) for k in (
        "faults_injected", "task_retries", "task_failures",
        "fetch_failures", "stage_recoveries", "recovered_map_tasks")}
    print(f"chaos {CHAOS_RULES} seed {CHAOS_SEED}, 3 q01 ({CHAOS_PARTS} "
          f"partitions, {CHAOS_MAX_RECOVERIES} recovery rounds) at "
          f"concurrency 3: "
          f"{r['outcomes']}, wall {r['wall_s']:.3f} s; sites {fired}; "
          f"{chaos}")
    if any(errs.values()) or r["leaks"] or r["threads_alive"]:
        raise SystemExit(f"serving chaos: {errs}, leaks {r['leaks']}")
    if chaos["faults_injected"] <= 0:
        raise SystemExit("serving chaos: no fault fired")
    out["chaos"] = dict(chaos, sites=fired, wall_s=r["wall_s"])
    out["legs"] = legs
    return out


def serving_phase(root, mix, smi):
    """The query service on the card (serving/service.py,
    itest/serving.py): the mix (full q01, q06, q95) twice at
    maxConcurrent 1 and then 4, each result against its oracle and its
    serial run bit for bit; a cancel from the progress hook, a deadline,
    the quota ladder, admission, chaos (`_serving_runs`); then the
    leaks, once the runs' frames, handles and tracebacks are gone."""
    import gc
    import tempfile as _tempfile
    import threading

    import torch
    from blaze_tpu_torch.exprs import program as EP
    from blaze_tpu_torch.kernels import hash_update as HU
    from blaze_tpu_torch.kernels import radix as R
    from blaze_tpu_torch.runtime import loop
    t_phase = time.perf_counter()

    def cache_entries():
        return {"fold entries": len(loop._FOLDS),
                "expression programs": EP.program_cache_info()["size"],
                "placement scratches": len(HU._scratch),
                "radix scratches": len(R._scratch)}

    def drop_caches():
        """The fold and program caches, the kernels' per-stream scratch
        and the cuBLAS workspaces of the streams used (after the work
        queued on them)."""
        torch.cuda.synchronize()
        loop._FOLDS.clear()
        EP.clear_program_cache()
        HU._scratch.clear()
        R._scratch.clear()
        gc.collect()
        torch.cuda.synchronize()
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear is not None:
            clear()

    drop_caches()
    mem0 = torch.cuda.memory_allocated()
    tmp0 = set(os.listdir(_tempfile.gettempdir()))
    out = _serving_runs(root, mix, smi)

    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    caches = cache_entries()
    drop_caches()
    mem2 = torch.cuda.memory_allocated()
    alive = [t.name for t in threading.enumerate()
             if t.name.startswith("blaze-serve") and t.is_alive()]
    left = sorted(p for p in set(os.listdir(_tempfile.gettempdir())) - tmp0
                  if p.startswith("blaze-dag-"))
    wall = time.perf_counter() - t_phase
    print(f"serving leaks: torch.cuda.memory_allocated {mem0} before the "
          f"phase (its caches dropped), {mem1} after it, {mem2} with the "
          f"caches dropped again: the fold and program caches and the "
          f"kernels' scratch held {mem1 - mem2} bytes ({caches}); service "
          f"threads alive {alive}; scratch dirs left {left}")
    if mem2 > mem0 or alive or left:
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape),
                        str(o.dtype)) for o in gc.get_objects()
                       if torch.is_tensor(o) and o.is_cuda), reverse=True)
        raise SystemExit(f"serving: device memory {mem0} -> {mem2} "
                         f"bytes, threads {alive}, dirs {left}; the "
                         f"largest live CUDA tensors {live[:12]}")
    print(f"serving phase: {wall:.1f} s ({smi})")
    out.update(wall_s=wall, memory={"before": mem0, "after": mem1,
                                    "caches_dropped": mem2,
                                    "cache_bytes": mem1 - mem2,
                                    "caches": caches})
    return out


STREAM_BIDS_LOG2 = 20      # Nexmark bids of the streaming phase
STREAM_SEED = 7


def streaming_phase(root, smi):
    """The Flink front door and the streaming runtime on the card
    (itest/nexmark.py, itest/streaming.py): Nexmark's bid stream, 2^20
    bids over 4 Kafka partitions from a seed; N1, q2 and a reduced q17
    through FlinkMicroBatchOperator in micro-batches of auron.batch.size
    records a partition, every micro-batch against its oracle, and the
    replay of a committed epoch; N2, the hop-windowed stream (10 s,
    sliding 2 s) through QueryService at maxConcurrent 1 with one
    stream-epoch and one checkpoint-commit fault, its sink against a
    pyarrow group-by.  The kernels' launches are counted on each path."""
    import torch
    from blaze_tpu_torch.bridge import device_stats
    from blaze_tpu_torch.itest import nexmark
    from blaze_tpu_torch.itest import streaming as ST
    t_phase = time.perf_counter()
    phase(f"streaming: Nexmark's bid stream, 2^{STREAM_BIDS_LOG2} bids over "
          f"{nexmark.N_PARTITIONS} Kafka partitions (seed {STREAM_SEED}); "
          f"N1 q2 and a reduced q17 through the Flink front door, N2 the "
          f"hop-windowed stream through QueryService with two faults")
    t0 = time.perf_counter()
    stream = nexmark.generate_bids(1 << STREAM_BIDS_LOG2, seed=STREAM_SEED)
    gen_s = time.perf_counter() - t0
    work = os.path.join(root, "streaming")
    os.makedirs(work, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    out = {"generate_s": gen_s, "bids": stream.num_bids,
           "json_bytes_per_bid": stream.json_bytes / stream.num_bids,
           "decode_records_per_s": ST.decode_rate(stream)}
    failures = []
    for name, run in (("N1", lambda: ST.run_n1(stream, work)),
                      ("N2", lambda: ST.run_n2(stream, work))):
        before = device_stats.snapshot()
        _zero_launches()
        r = run()
        torch.cuda.synchronize()
        r["launches"] = _read_launches()
        delta = device_stats.delta(before)
        r["h2d_transfers"] = delta["h2d_transfers"]
        r["h2d_bytes"] = delta["h2d_bytes"]
        r["memory_after"] = torch.cuda.memory_allocated()
        failures += r.pop("failures")
        out[name] = r
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["memory_before"] = mem0
    n1, n2 = out["N1"], out["N2"]
    # each decoded batch crosses to the card in one copy: q2 scans each
    # partition's micro-batch as one batch and copies nothing else; N2
    # scans each partition's poll, its data epochs and the one replayed
    # after the checkpoint-commit fault (the stream-epoch fault comes
    # before the poll); q17's generic aggregation adds its own copies
    q2_batches = n1["micro_batches"] * nexmark.N_PARTITIONS
    n2_batches = (n2["data_epochs"] + 1) * nexmark.N_PARTITIONS
    if n1["q2"]["h2d_transfers"] != q2_batches or \
            n2["h2d_transfers"] != n2_batches:
        failures.append(f"not one copy a decoded batch: q2 "
                        f"{n1['q2']['h2d_transfers']} for {q2_batches}, N2 "
                        f"{n2['h2d_transfers']} for {n2_batches}")
    if failures:
        raise SystemExit("streaming: " + "; ".join(failures))
    out["wall_s"] = time.perf_counter() - t_phase
    for k in ("q2", "q17"):
        r = n1[k]
        print(f"streaming N1 {k}: {r['equal_micro_batches']} of "
              f"{n1['micro_batches']} micro-batches equal to the oracle, "
              f"{r['rows']} rows, {r['wall_s']:.3f} s, {r['bids_per_s']:.0f}"
              f" bids/s, micro-batch walls "
              f"{[round(w, 3) for w in r['walls_s']]}")
    print(f"streaming N1 replay of epoch 0: {n1['replay']}; copies to the "
          f"card: q2 {n1['q2']['h2d_transfers']} for {q2_batches} scanned "
          f"batches, q17 {n1['q17']['h2d_transfers']} (its aggregation's "
          f"outputs too), {n1['h2d_bytes']} bytes; launches "
          f"{n1['launches']}")
    print(f"streaming N2: {n2['epochs']} epochs ({n2['data_epochs']} with "
          f"records), {n2['wall_s']:.3f} s, {n2['bids_per_s']:.0f} bids/s, "
          f"epoch walls p50 {n2['epoch_ms_p50']:.1f} ms p99 "
          f"{n2['epoch_ms_p99']:.1f} ms, recoveries "
          f"{n2['summary']['recoveries']} ({n2['recovery_ms']} ms) at epochs "
          f"{n2['fault_epochs']}, sink {n2['sink_rows']} rows = oracle "
          f"{n2['oracle_rows']} (lost {n2['lost']}, duplicated "
          f"{n2['duplicated']}), late {n2['counters']['stream_late_records']},"
          f" checkpoint bytes {n2['checkpoint_bytes']}, window-state peak "
          f"{n2['window_state_peak_bytes']} bytes; copies to the card "
          f"{n2['h2d_transfers']} for {n2_batches} scanned batches; launches "
          f"{n2['launches']}")
    print(f"streaming phase {out['wall_s']:.1f} s ({smi}): bids generated in "
          f"{gen_s:.1f} s ({out['json_bytes_per_bid']:.1f} JSON bytes a "
          f"bid), the JSON decode alone {out['decode_records_per_s']:.0f} "
          f"records/s; device memory {mem0} before, {n1['memory_after']} after "
          f"N1, {n2['memory_after']} after N2, peak {out['peak_bytes']}")
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sweep = sys.argv[1:] == ["--short-max-sweep"]
    if sys.argv[1:] and not sweep:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    from blaze_tpu_torch import config  # fails outside a checkout
    from blaze_tpu_torch.kernels import sort as K
    smi = environment()
    config.conf.set(config.TORCH_DEVICE.key, "cuda")
    dev = torch.device("cuda")
    build_kernels()
    if sweep:
        print(json.dumps({"short_max_sweep": short_max_sweep(dev),
                          "short_max": K.SHORT_MAX}))
        return 0
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
            for name, run, mode, label in (
                ("q01", q01_run, "auto", ""),
                ("rollup", rollup_run, "auto", ""))}
        oracle = branches_oracle(sr_paths, lo, hi)
        branches = {
            "auto": branches_path(root, sr_paths, lo, hi, "auto", oracle),
            "off": branches_path(root, sr_paths, lo, hi, "off", oracle)}
        by_path["q01 branches"] = branches["auto"]["launches"]
        plan, q01_want, make_q01 = full_data(root)
        full = {"auto": full_path(plan, q01_want, "auto", explain=True),
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
        q = FUSE_OFF_QUERY
        exprs = expressions_phase(
            root, all_tables, sr_paths, lo, hi,
            (q, (*ORACLES[q], FRAMES.pop(f"{q} auto"),
                 q19_q07_gq1["runs"][f"{q} auto"]["launches"]["expr"])))
        by_path["runtime filter"] = exprs["runtime_filter"]["launches"]
        by_path["runtime filter rebuilt"] = \
            exprs["runtime_filter_rebuilt"]["launches"]
        adaptive = adaptive_phase(
            root, plan, q01_want,
            {"q01 full": full["auto"]["wall_s"],
             "q17": q17_q18["runs"]["q17 linked auto"]["wall_s"]}, smi)
        for k, r in list(adaptive["legs"].items()) + list(
                adaptive["tpcds"].items()):
            by_path[f"adaptive {k}"] = r["launches"]
        staging = staging_phase()
        breadth = breadth_phase(root, all_tables, all_paths, make_q01,
                                q01_want)
        for k, r in breadth["runs"].items():
            if "profiled" not in k:
                by_path[k] = r["launches"]
        strings = strings_phase(root, all_tables, all_paths)
        for k in STRINGS_QUERIES:
            by_path[k] = strings["runs"][k]["launches"]
        decimals = decimal_phase(root, all_tables, all_paths,
                                 strings["corpus"])
        for k in DECIMAL_QUERIES:
            by_path[f"decimal {k}"] = decimals["runs"][k]["launches"]
        front_door = front_door_phase(
            root, all_tables,
            dict({k: ORACLES[k][1] for k in ("q06", "q17", "q18", "q67",
                                             "q95")}, q01=q01_want))
        del all_tables
        for k, r in front_door["runs"].items():
            by_path[f"front door {k}"] = r["launches"]
        wire = wire_kinds_phase(root, sr_paths, lo, hi,
                                runs["q01"]["oracle"])
        for k, r in wire["runs"].items():
            by_path[f"wire kinds {k}"] = r["launches"]
        q70 = q70_phase(root)
        by_path["q70"] = q70["launches"]
        segsum = segment_sum_cases(dev, q70.pop("longest"))
        lanes = row_order_lanes(dev)
        spill = spill_phase({
            "q06": family["runs"]["q06 auto"]["wall_s"],
            "q17": q17_q18["runs"]["q17 auto"]["wall_s"],
            "q95": q95_windows["runs"]["q95 auto"]["wall_s"],
            "q51": q95_windows["runs"]["q51 auto"]["wall_s"],
            "q51 window buffer peaks":
                q95_windows["runs"]["q51 auto"]["window_buffer_peaks"]})
        for k, r in spill["runs"].items():
            by_path[f"spill {k}"] = r["launches"]
        serving_checks = {"two_streams": two_stream_check(gen, dev),
                          "capture": concurrent_capture_check(dev),
                          "fold_streams": fold_cross_stream_check(dev),
                          # the same without the entry's event: printed,
                          # to show what the check above can see
                          "fold_streams_without_event":
                              fold_cross_stream_check(dev, wait=False),
                          "private_streams": private_stream_check(dev)}
        serving = serving_phase(root, {"q01": (make_q01, q01_want),
                                       "q06": ORACLES["q06"],
                                       "q95": ORACLES["q95"]}, smi)
        serving.update(serving_checks)
        for k, v in serving["launches"].items():
            by_path[f"serving {k}"] = v
        streaming = streaming_phase(root, smi)
        for k in ("N1", "N2"):
            by_path[f"streaming {k}"] = streaming[k]["launches"]
        ORACLES.clear()
        relayout = dict_relayout_probe(dev)
        _loop_mode("auto")
        loop_phases["regrow"] = regrow_path(root, sr_paths, lo, hi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase("summary")
    for k, r in runs.items():
        del r["table"]
        r.pop("oracle", None)
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
                "spill_route": spill["radix_spill_route"]
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
    def segment_sum_entry():
        """The row-order float sums: no Pallas site behind them (they
        repair the order of `index_add_`'s and `torch.cumsum`'s float adds
        on the card); launches by form on the paths; the main case is q70's
        recorded call, every form's cases beside it."""
        main_case = segsum["cases"][0]
        return {"name": "segment_sum", "route": "cuda",
                "source": "blaze_tpu_torch/csrc/segment_sum.cu",
                "replaces": None,
                "replaces_note": "no Pallas site: index_add_'s and "
                                 "torch.cumsum's float adds on the card "
                                 "(blaze_tpu_torch/kernels/sort.py "
                                 "segment_sum, segment_sum_into, "
                                 "segmented_running_sum)",
                "launches": sum(p["segment_sum"] for p in by_path.values()),
                "launches_by_form": {
                    f: sum(p["segment_sum_forms"][f]
                           for p in by_path.values())
                    for f in K.form_launches},
                "launches_by_path": {k: p["segment_sum"]
                                     for k, p in by_path.items()},
                "max_abs_err": max(c["err"] for c in segsum["cases"]),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "bound_note": "the larger of the bytes at 3.35 TB/s and the "
                              "longest segment's dependent adds at the "
                              "probe's latency",
                "library_ms": main_case["library_ms"],
                "device_us": main_case["device_us"],
                "launches_per_call": main_case["launches_per_call"],
                "add_ns": segsum["add_ns"],
                "short_max": K.SHORT_MAX,
                "parity": True, "cases": segsum["cases"]}

    def crc32c_entry():
        """The frames' CRC32C: host code that nvcc builds, no Pallas site
        and no device kernel; its times are host times over 1 MiB, its
        `launches` the built entry's calls on the paths."""
        mib = crc["sizes"][1 << 20]
        return {"name": "crc32c", "route": "cuda",
                "source": "blaze_tpu_torch/csrc/crc32c.cu", "replaces": None,
                "replaces_note": "no Pallas site: host code, the shuffle "
                                 "frames' checksum (blaze_tpu/shuffle/ipc.py)",
                "launches": sum(p["crc32c"] for p in by_path.values()),
                "launches_by_path": {k: p["crc32c"]
                                     for k, p in by_path.items()},
                "max_abs_err": 0.0, "ms": mib["us"] / 1e3,
                "plain_ms": crc["plain_ms"],
                "bound_ms": (1 << 20) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None, "host": True,
                "parity": True}

    kernels = [
        entry("hash_placement", "blaze_tpu_torch/csrc/hash_update.cu",
              "blaze_tpu/kernels/hash_update.py:182"),
        entry("radix_partition", "blaze_tpu_torch/csrc/radix.cu",
              "blaze_tpu/kernels/radix.py:122"),
        entry("window_step", "blaze_tpu_torch/csrc/window_table.cu",
              "blaze_tpu/kernels/mxu_agg.py:200"),
        segment_sum_entry(),
        crc32c_entry(),
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
    print("strings data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in strings["data_s"].items()))
    for k, f in strings["runs"].items():
        print(f"{k}: run {f['wall_s']:.3f} s, {f['exec_mode']}, "
              f"{f['stages']} stages, {f['rows']} rows, stage walls "
              f"{ {s_: round(w, 3) for s_, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes, join rows "
              f"{f['join_rows']}, radix groupings (rows, P) "
              f"{f['radix_groupings']}, eager placements {f['placements']}"
              + (f", busy {100 * f['busy_share']:.2f}%, cudaLaunch* per "
                 f"stage {f['launches_per_stage']}"
                 if "busy_share" in f else ""))
    print(f"q45 substring: {strings['substring']['q45']}; corpus: "
          f"{strings['corpus']['passed']} of {strings['corpus']['cases']} "
          f"cases pass on the card and on the CPU")
    print("decimal data, s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in decimals["data_s"].items())
        + f"; phase {decimals['wall_s']:.1f} s")
    for k, f in decimals["runs"].items():
        print(f"decimal {k}: run {f['wall_s']:.3f} s, {f['exec_mode']}, "
              f"{f['stages']} stages, {f['rows']} rows, stage walls "
              f"{ {s_: round(w, 3) for s_, w in f['stage_walls'].items()} }, "
              f"tasks {f['tasks']}, peak {f['peak_bytes']} bytes, radix "
              f"groupings (rows, P) {f['radix_groupings']}, eager "
              f"placements {f['placements']}; decimal_arith on the host "
              f"{decimals['decimal_arith'][k]}")
    print(f"spill phase {spill['wall_s']:.1f} s, budgets "
          f"{spill['budgets']}; spills by consumer kind "
          f"{spill['by_consumer']}; radix on the spill route "
          f"{spill['radix_spill_route']}")
    for k, f in spill["runs"].items():
        print(f"spill {k}: run {f['wall_s']:.3f} s (unbudgeted "
              f"{f['unbudgeted_wall_s']:.3f} s), stage walls "
              f"{ {s_: round(w, 3) for s_, w in f['stage_walls'].items()} }, "
              f"{f['spill_count']} spills, {f['spilled_bytes']} bytes, by "
              f"consumer {f['spills_by_consumer']}, RAM/file tier runs "
              f"{f['tiers']} (the writer's spills are files of their own), "
              f"peak {f['peak_mem_bytes']} of {f['budget_bytes']} bytes, "
              f"radix {f['launches']['radix_partition']} "
              f"({len(f['spill_route_groupings'])} on the spill route)")
    print(f"front door: phase {front_door['data_s']['phase']:.1f} s, data "
          f"written in {front_door['data_s']['write']:.1f} s; " + "; ".join(
              f"{k} {r['exec_mode']} {r['stages']} stages "
              f"{r['wall_s']:.3f} s" for k, r in front_door["runs"].items()))
    print(f"wire kinds: phase {wire['wall_s']:.1f} s; W1 map with the "
          f"post-decode filter on, off, off, on " + ", ".join(
              f"{r['map_s']:.4f}" for r in wire["w1_post_decode"])
          + f" s; W1 map "
          f"{wire['runs']['W1']['map_s']:.3f} s reduce "
          f"{wire['runs']['W1']['reduce_s']:.3f} s; W2 "
          f"{wire['runs']['W2']['exec_mode']} {wire['runs']['W2']['wall_s']:.3f}"
          f" s; W3 map {wire['runs']['W3']['map_s']:.3f} s reduce "
          f"{wire['runs']['W3']['reduce_s']:.3f} s (Hive files written in "
          f"{wire['runs']['W3']['write_s']:.1f} s); pruned_row_groups W1 "
          f"{wire['runs']['W1']['counters']['map']['pruned_row_groups']}, W3 "
          f"{wire['runs']['W3']['counters']['map']['pruned_row_groups']}; "
          f"radix W1/W2/W3 " + "/".join(
              str(wire['runs'][k]['launches']['radix_partition'])
              for k in ('W1', 'W2', 'W3')))
    print(f"staging: phase {staging['wall_s']:.1f} s; " + "; ".join(
        f"{k} {w} task wall {r[w]['wall_s']:.3f} s, cudaMemcpyAsync "
        f"{r[w]['cudaMemcpyAsync']} ({r[w]['memcpy_host_ms']:.1f} ms), "
        f"the scan alone {r[w]['scan_alone']['copies']} copies for "
        f"{r[w]['scan_alone']['batches']} batches, placements a scanned "
        f"batch "
        f"{r[w]['placements']['scan'] / max(1, r[w]['scan_batches']):.3f}, "
        f"prefetch wait {r[w]['prefetch_wait_ns'] / 1e6:.1f} ms"
        for k, r in staging.items() if k != "wall_s" for w in ("on", "off")))
    print(f"q01 full explain_analyze: syncs per stage "
          f"{full['auto']['explain']['syncs']}; attribution "
          f"{full['auto']['explain']['attribution']['categories']}")
    print(f"expressions phase {exprs['wall_s']:.1f} s: " + "; ".join(
        f"{c['chain']} at {c['rows']} rows ({c['op_nodes']} nodes, route "
        f"{c['route']}) fused {c['fused_ms']:.4f} ms / "
        f"eager {c['eager_ms']:.4f} ms, cudaLaunch* "
        f"{c['fused_launches']['kernel']:.1f} / "
        f"{c['eager_launches']['kernel']:.1f}, capture "
        f"{c['captures']['capture_ms']:.1f} ms" for c in exprs["cases"]))
    sw = exprs["sweep"]
    print(f"expressions sweep (nodes: fused / eager ms): " + "; ".join(
        f"{r['op_nodes']}: {r['fused_ms']:.4f} / {r['eager_ms']:.4f}"
        for r in sw["rows"]) + f"; break-even {sw['break_even_nodes']}, "
        f"GRAPH_MIN_NODES {sw['graph_min_nodes']}")
    rf, rf2 = exprs["runtime_filter"], exprs["runtime_filter_rebuilt"]
    print(f"{exprs['fuse_off']['query']} with the fuse off: same bits; "
          f"fused {exprs['fuse_off']['fused']}, off "
          f"{exprs['fuse_off']['off']}; runtime filter run "
          f"{rf['wall_s']:.3f} s, {rf['groups']} groups, probe {rf['probe']};"
          f" rebuilt over {rf2['build']}: run {rf2['wall_s']:.3f} s, "
          f"{rf2['groups']} groups, map captures "
          f"{rf2['counters']['map']['stage_loop_graph_captures']}, probe "
          f"{rf2['probe']}")
    print(f"adaptive phase {adaptive['wall_s']:.1f} s (data "
          f"{adaptive['data_s']:.1f} s), {smi}: " + "; ".join(
              f"{k} static {r['static']['wall_s']:.3f} s, adaptive "
              + " then ".join(f"{a['wall_s']:.3f}" for a in r["adaptive"])
              + f" s, tasks {sum(r['static']['tasks'].values())} -> "
              + " then ".join(str(sum(a["tasks"].values()))
                              for a in r["adaptive"])
              for k, r in adaptive["legs"].items()) + "; " + "; ".join(
              f"{k} adaptive {r['wall_s']:.3f} s, rules "
              f"{sorted({e['rule'] for e in r['events']}) or 'none'}"
              for k, r in adaptive["tpcds"].items()))
    lv = serving["levels"]
    print(f"serving phase {serving['wall_s']:.1f} s ({smi}): " + "; ".join(
        f"maxConcurrent {c}: {r['completed']} of {r['submitted']} in "
        f"{r['wall_s']:.3f} s (sum of the runs {r['serial_sum_s']:.3f} s), "
        f"p50 {r['p50_ms']:.1f} ms, p99 {r['p99_ms']:.1f} ms, "
        f"{r['qps']:.3f} queries/s, peak {r['peak_bytes']} bytes"
        for c, r in lv.items()) + f"; cancel {serving['legs']['cancel']}"
        f"; deadline {serving['legs']['deadline']}; quota "
        f"{serving['legs']['quota']}; admission {serving['admission']}; "
        f"chaos {serving['chaos']}; two streams "
        f"{serving['two_streams']}; capture {serving['capture']}; one fold "
        f"entry across streams {serving['fold_streams']} (without the "
        f"entry's event {serving['fold_streams_without_event']}); private "
        f"streams "
        f"{serving['private_streams']}; memory "
        f"{serving['memory']}")
    s1, s2 = streaming["N1"], streaming["N2"]
    print(f"streaming phase {streaming['wall_s']:.1f} s ({smi}): N1 q2 "
          f"{s1['q2']['wall_s']:.3f} s, q17 {s1['q17']['wall_s']:.3f} s over "
          f"{s1['micro_batches']} micro-batches, every one equal to its "
          f"oracle, the replay ran nothing ({s1['replay']['dup_skips']} dup "
          f"skip); N2 {s2['wall_s']:.3f} s, {s2['bids_per_s']:.0f} bids/s, "
          f"{s2['epochs']} epochs, p50 {s2['epoch_ms_p50']:.1f} ms, p99 "
          f"{s2['epoch_ms_p99']:.1f} ms, {s2['summary']['recoveries']} "
          f"recoveries, sink = oracle ({s2['sink_rows']} rows), checkpoint "
          f"bytes {s2['checkpoint_bytes']}, window-state peak "
          f"{s2['window_state_peak_bytes']} bytes, device peak "
          f"{streaming['peak_bytes']} bytes")
    print("expression programs by path (fused and eager batches, programs "
          "built, cache hits, graph captures, capture ms, replays): "
          + "; ".join(f"{k} {p['expr']}" for k, p in by_path.items()))
    print(f"q70 at SF1: wall {q70['wall_s']:.3f} s, {q70['exec_mode']}, "
          f"{len(q70['segment_sums'])} float segment sums, segment_sum "
          f"launches {q70['launches']['segment_sum']}; equal to its oracle")
    print("row-order lanes, two runs on the card and the CPU: " + "; ".join(
        f"{k} {'same' if r['twice_same'] and r['equals_cpu'] else 'DIFFER'}"
        for k, r in lanes.items()))
    print("segment_sum by form: " + "; ".join(
        f"{c['form']} {c['case']} {c['dtype']} {c['ms']:.4f} ms "
        f"({c['of_chain']:.3f}x its chain; bound {c['bound_ms']:.5f} ms, "
        f"{c['library']} {c['library_ms']:.4f} ms)"
        for c in segsum["cases"]))
    q05 = breadth["runs"]["q05 staged"]
    print(f"q05 at SF10: wall {q05['wall_s']:.3f} s; row-order sums "
          f"{q05['row_order_sums']}")
    # io_bytes by stage on every path, now that every task prunes
    io_bytes = {k: {st: r["counters"][st]["io_bytes"]
                      for st in ("map", "reduce")} for k, r in runs.items()}
    io_bytes.update({f"q01 branches {k}": {
        st: c["io_bytes"] for st, c in b["counters"].items()}
        for k, b in branches.items()})
    for group, prefix in ((full, "q01 full "), (family["runs"], ""),
                          (q17_q18["runs"], ""), (q95_windows["runs"], ""),
                          (q19_q07_gq1["runs"], ""),
                          (breadth["runs"], "breadth "),
                          (strings["runs"], "strings "),
                          (decimals["runs"], ""), (spill["runs"], "spill "),
                          (front_door["runs"], "front door ")):
        io_bytes.update({prefix + k: _io_bytes(r)
                         for k, r in group.items()})
    print("io_bytes per stage (scans' decoded and shuffle reads' Arrow "
          "bytes): " + "; ".join(f"{k} {v}" for k, v in io_bytes.items()))
    print(json.dumps({"paths": profiled, "runs": runs,
                      "stage_loop": loop_phases, "branches": branches,
                      "q01_full": full, "q06_family": family,
                      "q17_q18": q17_q18, "q95_windows": q95_windows,
                      "q19_q07_gq1": q19_q07_gq1, "breadth": breadth,
                      "strings": strings, "decimal": decimals,
                      "spill": spill, "front_door": front_door,
                      "wire_kinds": wire, "staging": staging,
                      "q70": q70, "row_order_lanes": lanes,
                      "expressions": exprs, "adaptive": adaptive,
                      "serving": serving, "streaming": streaming,
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
