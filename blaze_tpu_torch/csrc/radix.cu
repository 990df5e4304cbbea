// Radix (counting) partition of a pid column (CUDA C++, sm_90a).
//
// Replaces: blaze_tpu/kernels/radix.py `_ranks_call` (Pallas body
// `_make_kernel`), reached through `partition_order` by the shuffle
// writer's grouping (shuffle/writer.py `_write_partitioned`).
//
// Contract (bit-identical to the TPU kernel and to a stable argsort):
// pid values are clamped to [0, P]; P means parked.  counts[p] is the
// number of rows of partition p; a row's rank is its position among the
// rows of its partition in row order; order[start[p] + rank] = row, and
// order holds `sentinel` past the last real row (n for partition_ranks;
// the writer's grouping passes its bucket, as the padded JAX call leaves
// it).  part/slot are (p, rank), or (P, capacity) for parked rows and for
// ranks at or above capacity; the order-only entry (part and slot null)
// writes neither.
//
// What bounds it on this card: bytes, in principle.  partition_ranks
// reads the pid column once (4 B/row) and writes part, slot and order
// (12 B/row): 16 B/row, 8.4 MB at 524,288 rows, about 2.5 us at
// 3.35 TB/s; the order-only entry moves 8 B/row.  At the shuffle writer's
// sizes (a few hundred thousand rows, one block per SM) what the card
// waits on is latency: the launches, and the chain of dependent phases
// inside a block (the row loads, a round trip to L2 for the prefix, the
// barriers between phases, the stores).
//
// What the design does about it.  The TPU kernel walks rows serially;
// here a tile of kTile = 4096 rows is one block of up to 16 warps, each
// warp owning a contiguous run of the tile and holding its rows in
// registers.  At most two launches, one for a column of one tile:
//   launch 1, upsweep (more than one tile only): each block counts its
//     tile per bin (P + 1 bins: the last one counts parked rows) in shared
//     memory, writes the counts to row t of a (tiles, P + 1) matrix, and
//     adds them into device totals, one atomic per bin per tile;
//   launch 2, downsweep: each block issues its row loads, then works out
//     its tile's prefix while they land.  A block-wide exclusive scan of
//     the totals gives the partition starts (the parked bin starts at the
//     sum of the real counts).  The tile's prefix over earlier tiles is
//     the sum of their counts, read straight from the matrix that launch 1
//     wrote, by all the block's threads with kBatch loads each in flight.
//     No block waits on another: the counts exist before launch 2 starts.
//     (A decoupled look-back would find no published tile at the
//     writer's sizes: every block of a column of one wave starts at
//     once.)  Then each warp walks its run, 32 rows a step: a row's
//     rank in the run is the count of its bin in
//     the earlier steps plus __popc of its lower peers.  Up to 31 bins,
//     lane b keeps bin b's count in a register and one set of ballots
//     over the bin bits gives both a lane's peers and the mask of bin
//     `lane`; beyond, __match_any_sync gives the peers and the group's
//     leader updates the warp's counter in shared memory.  The warps'
//     counts, scanned in warp order from the tile's base, are their
//     cursors; a row's position is its cursor plus its rank.  Parked rows
//     are bin P: their positions follow the real rows and receive the
//     sentinel, so every order entry is written exactly once.
// The order stores are staged in shared memory, grouped by bin, and
// written out as contiguous runs (about 256 rows a run at P = 16); part
// and slot are per-row stores and already coalesced.
//
// Large P.  The per-warp counts take warps x (P + 1) ints of shared
// memory, so the tile keeps 4096 rows and the block takes fewer warps
// (more rows per lane) as P grows, and stops staging the order stores when
// they no longer fit: 16 warps staged up to P ~ 2,700, 2 warps unstaged at
// P = 12288 (kMaxP).  The prefix then reads (tiles x P) counts with few
// threads: correct, and slow (about 1.1 ms at 290,000 rows on an H100).
//
// Scratch (the caller's, per device and stream, kept across calls):
//   state (uint32, zeroed when allocated): totals[2][kBins].  A call adds
//     into totals[parity] and its launch 2 zeroes totals[parity ^ 1] for
//     the next call;
//   agg (int32): the (tiles, P + 1) counts, rewritten by every call.
// So nothing is cleared between calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 4096;         // rows per tile, one block each
constexpr int kMaxThreads = 512;    // threads of a downsweep block, at most
constexpr int kMaxP = 12288;        // partitions the kernel takes
constexpr int kBins = kMaxP + 1;    // with the parked bin
constexpr int kUpThreads = 512;
constexpr int kUpItems = kTile / kUpThreads;
constexpr int kBatch = 8;          // prefix loads in flight a thread
constexpr int kWarpScanMax = 1024;  // bins that one warp scans
// dynamic shared memory a block may take: the 227 KB opt-in less room for
// the kernels' static shared memory
constexpr int kSmemLimit = 232448 - 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

struct Args {
  const int32_t* pid;  // (n,)
  int32_t* part;       // (n,), or null for the order-only entry
  int32_t* slot;       // (n,), or null
  int32_t* order;      // (n,)
  int32_t* counts;     // (P,)
  uint32_t* state;     // totals[2][kBins]
  int32_t* agg;        // (tiles, P + 1) per-tile counts
  int n, P, capacity, sentinel, tiles, parity, staged;
};

__device__ __forceinline__ int clamp_pid(int32_t v, int P) {
  return v < 0 ? 0 : (v > P ? P : v);
}

// Exclusive scan of v[0, m) in shared memory by one warp: each lane sums
// a contiguous chunk, and the chunk sums are scanned with shuffles.
__device__ void warp_exclusive_scan(int32_t* v, int m) {
  const int lane = threadIdx.x & 31;
  const int per = (m + 31) / 32;
  const int lo = min(lane * per, m), hi = min(lo + per, m);
  int32_t s = 0;
  for (int j = lo; j < hi; ++j) s += v[j];
  int32_t x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  int32_t acc = x - s;
  for (int j = lo; j < hi; ++j) {
    const int32_t c = v[j];
    v[j] = acc;
    acc += c;
  }
}

// Exclusive scan of v[0, m) in shared memory by the whole block: each
// thread sums a contiguous chunk, the chunk sums are scanned with warp
// shuffles, then each thread rewrites its chunk.  sums: 32 ints of shared
// memory.
template <int kThreads>
__device__ void block_exclusive_scan(int32_t* v, int m, int32_t* sums) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(static_cast<int>(threadIdx.x) * per, m);
  const int hi = min(lo + per, m);
  int32_t s = 0;
  for (int j = lo; j < hi; ++j) s += v[j];
  int32_t x = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kAll, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int32_t w = lane < kWarps ? sums[lane] : 0;
    int32_t z = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kAll, z, d);
      if (lane >= d) z += y;
    }
    if (lane < kWarps) sums[lane] = z - w;
  }
  __syncthreads();
  int32_t acc = sums[warp] + x - s;
  for (int j = lo; j < hi; ++j) {
    const int32_t c = v[j];
    v[j] = acc;
    acc += c;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kUpThreads) upsweep_kernel(Args a) {
  extern __shared__ int32_t hist[];
  const int bins = a.P + 1;
  for (int b = threadIdx.x; b < bins; b += kUpThreads) hist[b] = 0;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * kTile;
  int q[kUpItems];
#pragma unroll
  for (int k = 0; k < kUpItems; ++k) {
    const int64_t i = lo + k * kUpThreads + threadIdx.x;
    q[k] = i < a.n ? clamp_pid(__ldg(a.pid + i), a.P) : -1;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kUpItems; ++k)
    if (q[k] >= 0) atomicAdd(hist + q[k], 1);
  __syncthreads();
  uint32_t* totals = a.state + a.parity * kBins;
  int32_t* row = a.agg + static_cast<int64_t>(blockIdx.x) * bins;
  for (int b = threadIdx.x; b < bins; b += kUpThreads) {
    const int32_t c = hist[b];
    row[b] = c;
    if (c) atomicAdd(totals + b, static_cast<uint32_t>(c));
  }
}

// ex[b] += the counts of bin b in the tiles before t: the matrix's first
// t rows, read in row-major order by all the threads, kBatch loads each in
// flight.  Entry e is bin e % bins, which each thread steps along.
template <int kThreads>
__device__ void tile_prefix(const Args& a, int t, int bins, int32_t* ex) {
  const int64_t pairs = static_cast<int64_t>(t) * bins;
  const int step = kThreads % bins;
  int b = threadIdx.x % bins;
  for (int64_t e0 = threadIdx.x; e0 < pairs; e0 += kBatch * kThreads) {
    int32_t v[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int64_t e = e0 + r * kThreads;
      v[r] = e < pairs ? __ldg(a.agg + e) : 0;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      if (v[r]) atomicAdd(ex + b, v[r]);
      b += step;
      if (b >= bins) b -= bins;
    }
  }
}

template <int kItems>
__global__ void __launch_bounds__(kTile / kItems) downsweep_kernel(Args a) {
  constexpr int kThreads = kTile / kItems;
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int32_t smem[];
  __shared__ int32_t sums[32];
  const int bins = a.P + 1;
  const bool single = a.tiles == 1;
  int32_t* start = smem;         // (bins) partition starts
  int32_t* ex = start + bins;    // (bins) the tile's prefix over earlier tiles
  int32_t* local = ex + bins;    // (bins) staged: tile-local start - base
  int32_t* cur = local + (a.staged ? bins : 0);  // (kWarps, bins) cursors
  int32_t* stage_pos = cur + kWarps * bins;      // (kTile) staged
  int32_t* stage_val = stage_pos + kTile;        // (kTile) staged
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lower = (1u << lane) - 1u;
  const int t = blockIdx.x;
  const int64_t tile_lo = static_cast<int64_t>(t) * kTile;
  const int64_t run_lo = tile_lo + static_cast<int64_t>(warp) * 32 * kItems;

  // the warp's run, 32 rows a step; the loads land while the block works
  // out its tile's prefix
  int q[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = run_lo + k * 32 + lane;
    q[k] = i < a.n ? __ldg(a.pid + i) : 0;
  }

  if (!single) {
    // bin totals and this tile's counts, both written by launch 1
    const uint32_t* totals = a.state + a.parity * kBins;
    for (int b = tid; b < bins; b += kThreads) {
      const int32_t total = static_cast<int32_t>(totals[b]);
      start[b] = total;
      if (a.staged) {
        local[b] = __ldg(a.agg + static_cast<int64_t>(t) * bins + b);
      }
      if (t == 0 && b < a.P) a.counts[b] = total;
      ex[b] = 0;
    }
    __syncthreads();
    tile_prefix<kThreads>(a, t, bins, ex);
    // the next call's totals start from zero
    uint32_t* next = a.state + (a.parity ^ 1) * kBins;
    for (int64_t j = static_cast<int64_t>(t) * kThreads + tid; j < kBins;
         j += static_cast<int64_t>(a.tiles) * kThreads)
      next[j] = 0;
  }
  for (int j = tid; j < kWarps * bins; j += kThreads) cur[j] = 0;
  __syncthreads();

  // the walk: each row's rank among its bin's rows of the warp's run, in
  // row order (the run's earlier steps, then the lower peers), and the
  // run's count per bin.  Rows past n take bin `bins` and are skipped.
  int rel[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    q[k] = run_lo + k * 32 + lane < a.n ? clamp_pid(q[k], a.P) : bins;
  }
  int32_t* mine = cur + warp * bins;
  if (bins < 32) {
    // lane b keeps bin b's count in a register: the ballots that give a
    // lane its peers also give it the mask of the lanes in bin `lane`
    int32_t cnt = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      unsigned pe = kAll, mb = kAll;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const unsigned B = __ballot_sync(kAll, (q[k] >> j) & 1);
        pe &= ((q[k] >> j) & 1) ? B : ~B;
        mb &= ((lane >> j) & 1) ? B : ~B;
      }
      rel[k] = __shfl_sync(kAll, cnt, q[k]) + __popc(pe & lower);
      cnt += __popc(mb);
    }
    if (lane < bins) mine[lane] = cnt;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned pe = __match_any_sync(kAll, q[k]);
      const int leader = __ffs(pe) - 1;
      int32_t c = 0;
      if (lane == leader && q[k] < bins) {
        c = mine[q[k]];
        mine[q[k]] = c + __popc(pe);
      }
      __syncwarp();
      rel[k] = __shfl_sync(kAll, c, leader) + __popc(pe & lower);
    }
  }
  __syncthreads();

  if (single) {
    // bin totals are the tile's counts
    for (int b = tid; b < bins; b += kThreads) {
      int32_t here = 0;
      for (int w = 0; w < kWarps; ++w) here += cur[w * bins + b];
      start[b] = here;
      if (a.staged) local[b] = here;
      if (b < a.P) a.counts[b] = here;
    }
    __syncthreads();
  }
  if (bins <= kWarpScanMax) {
    if (warp == 0) warp_exclusive_scan(start, bins);
    if (warp == 1 && a.staged) warp_exclusive_scan(local, bins);
    __syncthreads();
  } else {
    block_exclusive_scan<kThreads>(start, bins, sums);
    if (a.staged) block_exclusive_scan<kThreads>(local, bins, sums);
  }

  // per bin: the tile's base, and the warps' cursors in warp order from it
  for (int b = tid; b < bins; b += kThreads) {
    const int32_t base = start[b] + (single ? 0 : ex[b]);
    int32_t c[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c[w] = cur[w * bins + b];
    int32_t run = base;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      cur[w * bins + b] = run;
      run += c[w];
    }
    if (a.staged) local[b] -= base;
  }
  __syncthreads();

  // each row's position: its warp's cursor plus its rank in the run
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int b = q[k];
    if (b < bins) {
      const int32_t pos = mine[b] + rel[k];
      const int32_t row = static_cast<int32_t>(run_lo + k * 32 + lane);
      const int32_t val = b < a.P ? row : a.sentinel;
      if (a.staged) {
        const int j = pos + local[b];
        stage_pos[j] = pos;
        stage_val[j] = val;
      } else {
        a.order[pos] = val;
      }
      if (a.part != nullptr) {
        const int32_t rank = pos - start[b];
        const bool ok = b < a.P && rank < a.capacity;
        a.part[row] = ok ? b : a.P;
        a.slot[row] = ok ? rank : a.capacity;
      }
    }
  }
  if (a.staged) {
    __syncthreads();
    const int rows =
        static_cast<int>(min(static_cast<int64_t>(kTile), a.n - tile_lo));
    for (int j = tid; j < rows; j += kThreads)
      a.order[stage_pos[j]] = stage_val[j];
  }
}

// Dynamic shared memory of a downsweep block of `threads` threads.
size_t downsweep_smem(int threads, int bins, int staged) {
  return sizeof(int32_t) *
         (static_cast<size_t>(threads / 32 + 2 + staged) * bins +
          (staged ? 2 * kTile : 0));
}

template <int kThreads>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(downsweep_kernel<kTile / kThreads>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemLimit);
}

bool g_ready[kMaxDevices];

cudaError_t allow_large_smem() {
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(
           upsweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
           static_cast<int>(sizeof(int32_t) * kBins))) != cudaSuccess ||
      (err = allow_smem<512>()) != cudaSuccess ||
      (err = allow_smem<256>()) != cudaSuccess ||
      (err = allow_smem<128>()) != cudaSuccess ||
      (err = allow_smem<64>()) != cudaSuccess) {
    return err;
  }
  return cudaSuccess;
}

}  // namespace

// Cells of the uint32 state buffer (zeroed when allocated, then kept
// across calls).
extern "C" long long blaze_radix_state_cells() { return 2ll * kBins; }

// All pointers are device pointers.  pid (n,); order (n,), counts (P,);
// part and slot (n,) both, or both null for the order-only entry.  state:
// blaze_radix_state_cells() cells, zeroed when allocated; agg:
// tiles * (P + 1) int32 cells, with tiles = ceil(n / 4096); both used by
// one stream only.  parity: flips after every multi-tile call on this
// state.  1 <= P <= 12288, n >= 1.  Launches 1 kernel when n <= 4096,
// else 2; returns cudaGetLastError() after the last launch.
extern "C" int blaze_radix_partition(const int32_t* pid, int32_t* part,
                                     int32_t* slot, int32_t* order,
                                     int32_t* counts, uint32_t* state,
                                     int32_t* agg, int n, int P, int capacity,
                                     int sentinel, int parity, void* stream) {
  if (n < 1 || P < 1 || P > kMaxP || (part == nullptr) != (slot == nullptr) ||
      (parity & ~1) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!g_ready[dev]) {
    if ((err = allow_large_smem()) != cudaSuccess) {
      return static_cast<int>(err);
    }
    g_ready[dev] = true;
  }
  const int bins = P + 1;
  const int tiles =
      static_cast<int>((static_cast<int64_t>(n) + kTile - 1) / kTile);
  // the most warps per block whose counts fit, staged where they fit too
  int threads = 0, staged = 0;
  for (int th = kMaxThreads; th >= 64 && threads == 0; th /= 2) {
    for (int s = 1; s >= 0; --s) {
      if (downsweep_smem(th, bins, s) <= static_cast<size_t>(kSmemLimit)) {
        threads = th;
        staged = s;
        break;
      }
    }
  }
  if (threads == 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.pid = pid;
  a.part = part;
  a.slot = slot;
  a.order = order;
  a.counts = counts;
  a.state = state;
  a.agg = agg;
  a.n = n;
  a.P = P;
  a.capacity = capacity;
  a.sentinel = sentinel;
  a.tiles = tiles;
  a.parity = parity;
  a.staged = staged;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles > 1) {
    upsweep_kernel<<<tiles, kUpThreads, sizeof(int32_t) * bins, st>>>(a);
  }
  const size_t smem = downsweep_smem(threads, bins, staged);
  switch (threads) {
    case 512:
      downsweep_kernel<kTile / 512><<<tiles, 512, smem, st>>>(a);
      break;
    case 256:
      downsweep_kernel<kTile / 256><<<tiles, 256, smem, st>>>(a);
      break;
    case 128:
      downsweep_kernel<kTile / 128><<<tiles, 128, smem, st>>>(a);
      break;
    default:
      downsweep_kernel<kTile / 64><<<tiles, 64, smem, st>>>(a);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Rows per tile, for the caller's launch counts.
extern "C" int blaze_radix_tile_rows() { return kTile; }
