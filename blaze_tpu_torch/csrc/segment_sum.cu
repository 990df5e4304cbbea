// Row-order float sums over segments (CUDA C++, sm_90a): three forms in
// one source.
//
// Replaces: no Pallas kernel.  It stands behind kernels/sort.py for
// float32 and float64 tensors on the card, where `index_add_` and
// `torch.cumsum` add floats with atomics or in a parallel tree, so the
// last bits of a sum depended on the run:
//   form 0, segment sum from +0.0: `segment_sum`, for the generic
//     aggregation engine (ops/agg/functions.py: sum, avg and their merges)
//     and the dict-device lane's batch tables (parallel/stage.py
//     `dense_partial_agg`);
//   form 1, segment sum into a carry: `segment_sum_into`, for the hash
//     lane's float accumulators (parallel/stage.py `scatter_accumulate`,
//     behind `fold_step`, `hash_agg_step`, `rehash_carry` and the scatter
//     dense lane);
//   form 2, segmented running sum: `segmented_running_sum`, for the
//     window's running float sums (ops/window.py `_segmented_cumsum`).
//
// Contract (the CPU's `index_add_` and sequential `cumsum`, which are the
// JAX package's CPU results for the sums): the rows come grouped, each
// segment one run of equal ids in row order (callers sort their ids
// stably first and pass `order`, the sorted position's row).  Form 0
// writes out[s] = ((+0.0 + x1) + x2) + ... over the rows whose id is s;
// form 1 the same starting from out[s] (the carry), in place; form 2
// writes, for every row, the sum from +0.0 of its run up to and including
// it.  x is the row's value, or +0.0 where its valid byte is 0 (valid may
// be null: every row).  In forms 0 and 1 a row whose id is outside
// [0, S) adds nowhere, and a slot with no rows is +0.0 (form 0) or keeps
// its carry's bits (form 1).  Every add is __dadd_rn / __fadd_rn: one
// dependent chain per segment, never reassociated or contracted.
//
// What bounds it on this card: a segment's adds are one dependent chain,
// so a segment of m rows takes m add latencies however wide the card is;
// the bytes (ids, order, values, valid byte, outputs) move at 3.35 TB/s
// in microseconds.  A row-order sum of one long segment is therefore
// slower than `index_add_`, which reassociates.
//
// What the design does about it.  Two kernels (and one 4-byte memset; a
// memset of the output in form 0) on the caller's stream:
//   heads: one thread a row.  A row whose id differs from the row
//     before opens a segment (no atomics, no memsets, no pass over S).
//     If the row `short_max` rows later still has its id, the segment is
//     long and its head goes to a list (one atomic per long segment);
//     else the thread sums the segment itself, eight rows' loads in
//     flight at a time, so many short chains run side by side on each SM
//     (the hash lane's segments are one or two rows);
//   long: a persistent grid of blocks, one long segment a block at a
//     time.  Eight producer warps stage each tile of 1,024 rows into a
//     two-stage shared-memory ring with cp.async (a row left out is
//     zero-filled by the copy itself: +0.0) and find where the run ends;
//     one consumer thread runs the chain from shared memory, loading the
//     next eight values before it adds the current eight, so only the adds
//     wait on each other.  In form 2 the consumer writes each prefix to
//     shared memory and the producers store the tile coalesced.  A tile's
//     1,024 dependent adds outlast a memory latency, so two stages and
//     one __syncthreads a tile keep the consumer fed.
// `blaze_add_chain` is the probe of the floor: one thread, one chain of
// dependent adds from registers.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kFromZero = 0;
constexpr int kIntoCarry = 1;
constexpr int kRunning = 2;

constexpr int kHeadThreads = 256;
constexpr int kChunk = 8;             // rows a head thread loads at a time
constexpr int kProducers = 256;       // warps 1-8 of a long block
constexpr int kLongThreads = 32 + kProducers;
constexpr int kTile = 1024;           // rows of a ring stage
constexpr int kPerProducer = kTile / kProducers;
constexpr int kPad = 16;              // the consumer reads 16 past a tile
constexpr int kMaxLongBlocks = 132 * 4;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// Sorted position r's row, whether it is taken, and its value (+0.0 when
// it is left out).
template <typename T>
__device__ __forceinline__ T value_at(const int64_t* __restrict__ order,
                                      const T* __restrict__ values,
                                      const uint8_t* __restrict__ valid,
                                      long long r) {
  const long long i = order != nullptr ? order[r] : r;
  const bool take = valid == nullptr || valid[i] != 0;
  return take ? values[i] : T(0);
}

template <typename T, typename I, int F>
__global__ void __launch_bounds__(kHeadThreads)
    heads_kernel(const I* __restrict__ ids, const int64_t* __restrict__ order,
                 const T* __restrict__ values,
                 const uint8_t* __restrict__ valid, T* __restrict__ out,
                 long long n, long long S, int short_max,
                 int* __restrict__ long_count, int* __restrict__ long_heads) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const I s = ids[r];
  if (F != kRunning && (s < 0 || static_cast<long long>(s) >= S)) return;
  if (r > 0 && ids[r - 1] == s) return;  // not the first row of its run
  if (r + short_max < n && ids[r + short_max] == s) {
    long_heads[atomicAdd(long_count, 1)] = static_cast<int>(r);
    return;
  }
  T acc = F == kIntoCarry ? out[s] : T(0);
  for (long long base = r;; base += kChunk) {
    T x[kChunk];
    bool in[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long row = base + j;
      in[j] = row < n && ids[row] == s;
      x[j] = row < n ? value_at(order, values, valid, row) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (!in[j]) {
        if (F != kRunning) out[s] = acc;
        return;
      }
      acc = add(acc, x[j]);
      if (F == kRunning) out[base + j] = acc;
    }
  }
}

template <typename T, typename I, int F>
__global__ void __launch_bounds__(kLongThreads)
    long_kernel(const I* __restrict__ ids, const int64_t* __restrict__ order,
                const T* __restrict__ values,
                const uint8_t* __restrict__ valid, T* __restrict__ out,
                long long n, const int* __restrict__ long_count,
                const int* __restrict__ long_heads) {
  __shared__ __align__(16) T buf[2][kTile + kPad];
  __shared__ __align__(16) T pre[F == kRunning ? 2 : 1][F == kRunning
                                                            ? kTile
                                                            : 1];
  // rows of the run in tile t: lens[t % 4] (a tile's length is read up to
  // two rounds after it is filled, and reset three rounds after)
  __shared__ int lens[4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = threadIdx.x - 32;  // producer index (warps 1-8)
  const int count = *long_count;
  for (int k = blockIdx.x; k < count; k += gridDim.x) {
    const long long h = long_heads[k];
    const I s = ids[h];
    __syncthreads();  // the previous segment's last reads of lens are done
    if (threadIdx.x == 0) lens[0] = kTile;
    __syncthreads();
    T acc = T(0);
    if (F == kIntoCarry && threadIdx.x == 0) acc = out[s];
    int last = INT_MAX;  // the run's last tile, once it is known
    for (int t = 0;; ++t) {
      if (warp != 0) {
        if (t <= last) {
          // tile t into stage t % 2: the run's rows copied (a row left
          // out as +0.0), and the first row past the run into lens
          const long long row0 = h + static_cast<long long>(t) * kTile;
          T* dst = buf[t & 1];
#pragma unroll
          for (int q = 0; q < kPerProducer; ++q) {
            const int j = p + q * kProducers;
            const long long row = row0 + j;
            const bool in = row < n && ids[row] == s;
            if (in) {
              const long long i = order != nullptr ? order[row] : row;
              const bool take = valid == nullptr || valid[i] != 0;
              __pipeline_memcpy_async(dst + j, values + i, sizeof(T),
                                      take ? 0 : sizeof(T));
            }
            const unsigned out_of_run = __ballot_sync(kAll, !in);
            if (lane == 0 && out_of_run != 0) {
              atomicMin(&lens[t & 3], j + __ffs(out_of_run) - 1);
            }
          }
          __pipeline_commit();
        }
        if (p == 0) lens[(t + 1) & 3] = kTile;
        if (F == kRunning && t >= 2 && t - 2 <= last) {
          // tile t - 2's prefixes, coalesced
          const int m = lens[(t - 2) & 3];
          const long long row0 =
              h + static_cast<long long>(t - 2) * kTile;
          const T* src = pre[t & 1];
          for (int j = p; j < m; j += kProducers) out[row0 + j] = src[j];
        }
        __pipeline_wait_prior(0);
      } else if (lane == 0 && t >= 1 && t - 1 <= last) {
        // tile t - 1 from stage (t - 1) % 2: the chain
        const int m = lens[(t - 1) & 3];
        const T* b = buf[(t - 1) & 1];
        T* w = pre[F == kRunning ? ((t - 1) & 1) : 0];
        T cur[8], nxt[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) cur[q] = b[q];
        int j = 0;
        for (; j + 8 <= m; j += 8) {
#pragma unroll
          for (int q = 0; q < 8; ++q) nxt[q] = b[j + 8 + q];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            acc = add(acc, cur[q]);
            if (F == kRunning) w[j + q] = acc;
          }
#pragma unroll
          for (int q = 0; q < 8; ++q) cur[q] = nxt[q];
        }
        for (int q = 0; j + q < m; ++q) {
          acc = add(acc, cur[q]);
          if (F == kRunning) w[j + q] = acc;
        }
        if (F != kRunning && t - 1 == last) out[s] = acc;
      }
      __syncthreads();
      if (t <= last && lens[t & 3] < kTile) last = t;
      if (t == last + (F == kRunning ? 2 : 1)) break;
    }
  }
}

template <typename T>
__global__ void chain_kernel(T* out, T x, T y, long long n) {
  T a = x;
#pragma unroll 16
  for (long long i = 0; i < n; ++i) a = add(a, y);
  out[0] = a;
}

template <typename T, typename I, int F>
cudaError_t launch(const void* ids, const int64_t* order, const void* values,
                   const uint8_t* valid, void* out, int* scratch,
                   long long n, long long S, int short_max,
                   cudaStream_t st) {
  const I* id = static_cast<const I*>(ids);
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  if (F == kFromZero) {
    err = cudaMemsetAsync(o, 0, S * sizeof(T), st);  // +0.0 is all zeros
    if (err != cudaSuccess) return err;
  }
  const long long head_blocks = (n + kHeadThreads - 1) / kHeadThreads;
  heads_kernel<T, I, F><<<static_cast<unsigned>(head_blocks), kHeadThreads,
                          0, st>>>(id, order, v, valid, o, n, S, short_max,
                                   scratch, scratch + 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long long_blocks = n / (short_max + 1) + 1;
  if (long_blocks > kMaxLongBlocks) long_blocks = kMaxLongBlocks;
  long_kernel<T, I, F><<<static_cast<unsigned>(long_blocks), kLongThreads,
                         0, st>>>(id, order, v, valid, o, n, scratch,
                                  scratch + 1);
  return cudaGetLastError();
}

template <typename T, typename I>
cudaError_t launch_form(int form, const void* ids, const int64_t* order,
                        const void* values, const uint8_t* valid, void* out,
                        int* scratch, long long n, long long S,
                        int short_max, cudaStream_t st) {
  switch (form) {
    case kFromZero:
      return launch<T, I, kFromZero>(ids, order, values, valid, out, scratch,
                                     n, S, short_max, st);
    case kIntoCarry:
      return launch<T, I, kIntoCarry>(ids, order, values, valid, out,
                                      scratch, n, S, short_max, st);
    default:
      return launch<T, I, kRunning>(ids, order, values, valid, out, scratch,
                                    n, S, short_max, st);
  }
}

}  // namespace

// All pointers are device pointers.  form 0, 1 or 2 (above).  ids (n,)
// int64 when ids_is64, else int32, each segment one run; order (n,) int64
// or null (row r is values[order[r]]); values (n,) float64 when is_f64,
// else float32; valid (n,) bool or null, indexed like values; out (S,) in
// forms 0 and 1 (read first in form 1), (n,) in sorted positions in form
// 2; scratch 2 + n / (short_max + 1) int32 cells (the long segments'
// count and list).
// 1 <= n < 2^31, S >= 1, short_max >= 1.  Returns cudaGetLastError()
// after the last launch.
extern "C" int blaze_segment_sum(int form, const void* ids, int ids_is64,
                                 const int64_t* order, const void* values,
                                 const uint8_t* valid, void* out,
                                 int* scratch, long long n, long long S,
                                 int short_max, int is_f64, void* stream) {
  if (form < kFromZero || form > kRunning || n < 1 || n > INT_MAX ||
      S < 1 || short_max < 1 || (is_f64 != 0 && is_f64 != 1) ||
      (ids_is64 != 0 && ids_is64 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_f64) {
    err = ids_is64 ? launch_form<double, int64_t>(form, ids, order, values,
                                                  valid, out, scratch, n, S,
                                                  short_max, st)
                   : launch_form<double, int32_t>(form, ids, order, values,
                                                  valid, out, scratch, n, S,
                                                  short_max, st);
  } else {
    err = ids_is64 ? launch_form<float, int64_t>(form, ids, order, values,
                                                 valid, out, scratch, n, S,
                                                 short_max, st)
                   : launch_form<float, int32_t>(form, ids, order, values,
                                                 valid, out, scratch, n, S,
                                                 short_max, st);
  }
  return static_cast<int>(err);
}

// The floor of a row-order sum: one thread adds y to x n times, each add
// waiting on the one before; out[0] gets the sum (float64 when is_f64,
// else float32).  One launch on `stream`.
extern "C" int blaze_add_chain(void* out, double x, double y, long long n,
                               int is_f64, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f64) {
    chain_kernel<double><<<1, 1, 0, st>>>(static_cast<double*>(out), x, y, n);
  } else {
    chain_kernel<float><<<1, 1, 0, st>>>(static_cast<float*>(out),
                                         static_cast<float>(x),
                                         static_cast<float>(y), n);
  }
  return static_cast<int>(cudaGetLastError());
}
