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
// order holds n past the last real row.  part/slot are (p, rank), or
// (P, capacity) for parked rows and for ranks at or above capacity.
//
// What bounds it on this card: bytes.  The function reads the pid column
// once (4 B/row) and writes part, slot and order (12 B/row): 16 B/row,
// 8.4 MB at the shuffle writer's 524,288-row bucket, about 2.5 us at
// 3.35 TB/s.  The order store is a scatter.
//
// What the design does about it: the TPU kernel walks rows serially to
// hand out ranks; here the rows are cut into tiles of kTile rows.
//   1. hist: one block per tile counts its rows per partition in shared
//      memory and writes them to a (P x tiles) matrix;
//   2. scan: one block turns the matrix, partition-major, into exclusive
//      bases, so (p, tile) knows where its rows start;
//   3. rank: one warp per tile walks its rows 32 at a time in row order;
//      __match_any_sync groups the lanes of equal pid, __popc of the lower
//      peers gives the rank inside the warp step, and per-partition
//      cursors in shared memory carry it across steps.
// Every pass reads the pid column once; partition cursors never leave
// shared memory.  P is limited by shared memory (48 KB: P <= 12288).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;
constexpr int kHistThreads = 256;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int clamp_pid(int32_t v, int P) {
  return v < 0 ? 0 : (v > P ? P : v);
}

__global__ void hist_kernel(const int32_t* __restrict__ pid,
                            int32_t* __restrict__ order,
                            int32_t* __restrict__ mat, int n, int P,
                            int tiles) {
  extern __shared__ int32_t hist[];
  for (int p = threadIdx.x; p < P; p += blockDim.x) hist[p] = 0;
  __syncthreads();
  const int base = blockIdx.x * kTile;
  const int end = min(base + kTile, n);
  for (int i = base + threadIdx.x; i < end; i += blockDim.x) {
    const int p = clamp_pid(pid[i], P);
    order[i] = n;  // overwritten for every real row by the rank pass
    if (p < P) atomicAdd(&hist[p], 1);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    mat[(int64_t)p * tiles + blockIdx.x] = hist[p];
}

__global__ void scan_kernel(int32_t* __restrict__ mat,
                            int32_t* __restrict__ starts,
                            int32_t* __restrict__ counts, int P,
                            int tiles) {
  __shared__ int32_t part[kScanThreads];
  __shared__ int32_t total;
  const int64_t M = (int64_t)P * tiles;
  const int t = threadIdx.x;
  const int64_t chunk = (M + blockDim.x - 1) / blockDim.x;
  const int64_t lo = min((int64_t)t * chunk, M);
  const int64_t hi = min(lo + chunk, M);
  int32_t sum = 0;
  for (int64_t j = lo; j < hi; ++j) sum += mat[j];
  part[t] = sum;
  __syncthreads();
  if (t == 0) {
    int32_t acc = 0;
    for (int j = 0; j < (int)blockDim.x; ++j) {
      const int32_t v = part[j];
      part[j] = acc;
      acc += v;
    }
    total = acc;
  }
  __syncthreads();
  int32_t acc = part[t];
  for (int64_t j = lo; j < hi; ++j) {
    const int32_t v = mat[j];
    mat[j] = acc;
    acc += v;
  }
  __syncthreads();
  for (int p = t; p < P; p += blockDim.x) {
    const int32_t s = mat[(int64_t)p * tiles];
    const int32_t e = (p + 1 < P) ? mat[(int64_t)(p + 1) * tiles] : total;
    starts[p] = s;
    counts[p] = e - s;
  }
}

__global__ void rank_kernel(const int32_t* __restrict__ pid,
                            const int32_t* __restrict__ mat,
                            const int32_t* __restrict__ starts,
                            int32_t* __restrict__ part,
                            int32_t* __restrict__ slot,
                            int32_t* __restrict__ order, int n, int P,
                            int tiles, int capacity) {
  extern __shared__ int32_t cursor[];
  const int lane = threadIdx.x;
  for (int p = lane; p < P; p += 32)
    cursor[p] = mat[(int64_t)p * tiles + blockIdx.x];
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
  const int base = blockIdx.x * kTile;
  for (int off = 0; off < kTile && base + off < n; off += 32) {
    const int i = base + off + lane;
    const bool live = i < n;
    const int p = live ? clamp_pid(pid[i], P) : P;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int before = __popc(peers & lower);
    const int c = (p < P) ? cursor[p] : 0;
    __syncwarp();
    if (p < P && before == 0) cursor[p] = c + __popc(peers);
    __syncwarp();
    if (!live) continue;
    if (p < P) {
      const int pos = c + before;
      const int rank = pos - starts[p];
      const bool ok = rank < capacity;
      part[i] = ok ? p : P;
      slot[i] = ok ? rank : capacity;
      order[pos] = i;
    } else {
      part[i] = P;
      slot[i] = capacity;
    }
  }
}

}  // namespace

// All pointers are device pointers.  pid (n,); outputs part, slot,
// order (n,), counts (P,); scratch starts (P,), mat (P * tiles,) with
// tiles = ceil(n / 1024).  Requires 1 <= P <= 12288 and n >= 1.
// Returns cudaGetLastError() after the last launch.
extern "C" int blaze_radix_partition(const int32_t* pid, int32_t* part,
                                     int32_t* slot, int32_t* order,
                                     int32_t* counts, int32_t* starts,
                                     int32_t* mat, int n, int P,
                                     int capacity, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const size_t smem = sizeof(int32_t) * (size_t)P;
  hist_kernel<<<tiles, kHistThreads, smem, st>>>(pid, order, mat, n, P,
                                                  tiles);
  scan_kernel<<<1, kScanThreads, 0, st>>>(mat, starts, counts, P, tiles);
  rank_kernel<<<tiles, 32, smem, st>>>(pid, mat, starts, part, slot, order,
                                       n, P, tiles, capacity);
  return static_cast<int>(cudaGetLastError());
}

// Tile size of the partition, for the caller's scratch allocation.
extern "C" int blaze_radix_tile_rows() { return kTile; }
