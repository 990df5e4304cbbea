// Row-order segment sums of a float column (CUDA C++, sm_90a).
//
// Replaces: no Pallas kernel.  It stands behind kernels/sort.py
// `segment_sum` for float32 and float64 tensors on the card, which the
// generic aggregation engine (ops/agg/functions.py: sum, avg and their
// merges) and the dense tables of the dict-device lane
// (parallel/stage.py `dense_partial_agg`) call once per float sum and
// batch.  `index_add_` and every other scatter or scan PyTorch offers add
// floats on the card with atomics or in a parallel tree, so a sum's last
// bits depended on the run: two equal groups (q70's ROLLUP sums one
// state's single store at two grouping levels) could sum apart and
// rank() split their tie.
//
// Contract (bit-identical to the CPU's `index_add_`, which is the JAX
// package's CPU result): out[s] is the sequential sum, in row order and
// starting from +0.0, of the values of the rows whose slot is s and whose
// valid byte is nonzero (valid may be null: every row).  A row whose slot
// is outside [0, S) adds nowhere.  A row left out adds nothing, which is
// what the CPU's +0.0 for it does: a sum that starts at +0.0 is never
// -0.0, and x + 0.0 == x for every other x.
//
// What bounds it on this card: the serial walk, not bytes.  The work is
// 17 B a row (slot, value, valid byte) read once and S values written,
// about 5 us per 2^20 rows at 3.35 TB/s; but a segment's adds form one
// dependent chain (IEEE addition does not reassociate), so a segment of
// m rows takes m dependent adds whatever the card's width.
// The engine's segments are short except where a group holds most of a
// batch (a grand total, or q70's ROLLUP level that rolls every row up).
//
// What the design does about it.  Two launches on the caller's stream:
//   launch 1, span: one thread per row; the lanes of a warp that share a
//     slot find each other with __match_any_sync, and the lowest and the
//     highest of them move the segment's first and last row with one
//     64-bit atomicMin / atomicMax each (a run of one slot costs two
//     atomics per warp, not per row);
//   launch 2, walk: one warp per segment walks its rows from first to
//     last and adds those whose slot is its own, in row order: the lanes
//     load 32 consecutive rows at a time (coalesced, four such chunks in
//     flight), then each chunk's 32 values are broadcast in row order
//     (__shfl_sync, a row left out as +0.0) and added, so every lane runs
//     the same chain of adds and lane 0 writes the sum.  The loads and
//     the broadcasts overlap; only the adds chain.  (Earlier designs: one
//     thread per segment, 8 rows a step, waited on memory every step, 73
//     ns a row; broadcasting only the taken rows, each broadcast waiting
//     on the mask of the one before, 44 ns a row.)
// Rows of other slots inside a span (out-of-range rows between a
// segment's rows, or another segment's rows when the ids are not sorted)
// are skipped, so the result is right for any ids; the span is short
// exactly when each segment's rows are contiguous, as the engine's are
// after its stable lexsort.  Other callers sort the ids stably first
// (kernels/sort.py), which keeps each segment's rows in row order.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWalkThreads = 128;  // 4 segments a block, one a warp
constexpr int kDepth = 4;          // chunks of 32 rows in flight a warp
constexpr unsigned kAll = 0xffffffffu;

__global__ void span_kernel(const int64_t* __restrict__ slots, long long n,
                            long long S, unsigned long long* first,
                            unsigned long long* last) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int lane = threadIdx.x & 31;
  long long s = -1;
  if (i < n) {
    const long long v = slots[i];
    if (v >= 0 && v < S) s = v;
  }
  // every lane of the warp takes part (the grid is whole warps)
  const unsigned peers = __match_any_sync(kAll, s);
  if (s < 0) return;
  if (lane == __ffs(peers) - 1) {
    atomicMin(first + s, static_cast<unsigned long long>(i));
  }
  if (lane == 31 - __clz(peers)) {
    atomicMax(last + s, static_cast<unsigned long long>(i));
  }
}

// The row at `r` of segment s, or nothing past the span's end.
template <typename T>
__device__ __forceinline__ void load_row(const int64_t* __restrict__ slots,
                                         const T* __restrict__ values,
                                         const uint8_t* __restrict__ valid,
                                         long long s, unsigned long long r,
                                         unsigned long long end, T& x,
                                         bool& take) {
  x = T(0);
  take = false;
  if (r <= end) {
    x = values[r];
    take = slots[r] == s && (valid == nullptr || valid[r] != 0);
  }
}

template <typename T>
__global__ void walk_kernel(const int64_t* __restrict__ slots,
                            const T* __restrict__ values,
                            const uint8_t* __restrict__ valid,
                            T* __restrict__ out,
                            const unsigned long long* __restrict__ first,
                            const unsigned long long* __restrict__ last,
                            long long S) {
  const long long s =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (s >= S) return;  // whole warps: blockDim is a multiple of 32
  const unsigned long long a = first[s];
  const unsigned long long b = last[s];
  T acc = T(0);
  if (a <= b) {
    // kDepth chunks of 32 rows in flight; chunk d of a round lives in
    // x[d] / take[d] (lane l holds its row l)
    T x[kDepth];
    bool take[kDepth];
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      load_row(slots, values, valid, s, a + 32ull * d + lane, b, x[d],
               take[d]);
    }
    for (unsigned long long base = a; base <= b; base += 32ull * kDepth) {
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const unsigned long long chunk = base + 32ull * d;
        if (chunk > b) break;  // uniform across the warp
        // every lane adds the chunk's 32 rows in row order, a row left
        // out as +0.0 (no change to the sum): the same chain of adds on
        // every lane.  The broadcasts do not depend on the sum, so they
        // issue ahead of it and only the adds chain.
        const T xd = take[d] ? x[d] : T(0);
#pragma unroll
        for (int j = 0; j < 32; ++j) acc += __shfl_sync(kAll, xd, j);
        load_row(slots, values, valid, s, chunk + 32ull * kDepth + lane, b,
                 x[d], take[d]);
      }
    }
  }
  if (lane == 0) out[s] = acc;
}

}  // namespace

// All pointers are device pointers.  slots (n,) int64; values (n,) float64
// when is_f64, else float32; valid (n,) bool or null; out (S,) of the
// values' type; first and last (S,) 8-byte scratch, set here.  n >= 1,
// S >= 1.  Two kernel launches (and two memsets) on `stream`; returns
// cudaGetLastError() after the last launch.
extern "C" int blaze_segment_sum(const int64_t* slots, const void* values,
                                 const uint8_t* valid, void* out,
                                 void* first, void* last, long long n,
                                 long long S, int is_f64, void* stream) {
  if (n < 1 || S < 1 || (is_f64 != 0 && is_f64 != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* f = static_cast<unsigned long long*>(first);
  auto* l = static_cast<unsigned long long*>(last);
  cudaError_t err = cudaMemsetAsync(f, 0xff, S * sizeof(*f), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(l, 0, S * sizeof(*l), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_blocks = (n + kThreads - 1) / kThreads;
  span_kernel<<<static_cast<unsigned>(row_blocks), kThreads, 0, st>>>(
      slots, n, S, f, l);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long seg_blocks = (S * 32 + kWalkThreads - 1) / kWalkThreads;
  if (is_f64) {
    walk_kernel<double><<<static_cast<unsigned>(seg_blocks), kWalkThreads,
                          0, st>>>(slots, static_cast<const double*>(values),
                                   valid, static_cast<double*>(out), f, l, S);
  } else {
    walk_kernel<float><<<static_cast<unsigned>(seg_blocks), kWalkThreads, 0,
                         st>>>(slots, static_cast<const float*>(values),
                               valid, static_cast<float*>(out), f, l, S);
  }
  return static_cast<int>(cudaGetLastError());
}
