// Window table for the dense aggregation lane (CUDA C++, sm_90a).
//
// Replaces: blaze_tpu/kernels/mxu_agg.py `_pallas_window_table` (Pallas
// body `_make_kernel`), the exact grouped table behind plan/fused.py
// `_execute_mxu`.
//
// Contract (bit-identical to the TPU kernel and to the scatter
// formulation `_window_table_ref`): row i with gid[i] < sh * sl adds, into
// slot g = gid[i], 1 to the presence block (when there is one) and limb li
// of value array a, (uint32(arrays[a][i]) >> 8 li) & 255, to that limb's
// block.  Rows with gid >= sh * sl (the sentinel) drop.  The int32 table
// is (sh, sl * nb), block-major: block b of slot hi * sl + lo is
// table[hi * sl * nb + b * sl + lo].  The kernel adds into the table it is
// given; the caller zeroes a fresh one.  sh, sl, nb, k and the limb counts
// are run-time arguments: every map task plans its own layout from its
// file's statistics, and one build serves them all.
//
// What bounds it on this card: bytes in principle (4 B of gid and 4 B per
// value array read per row, the table read and written once: about 0.5 MB
// for a 32,768-row batch with two arrays against the 96 KiB table of the
// TPC-DS store-by-day rollup, some 0.15 us at 3.35 TB/s), but in practice
// atomic contention: date-ordered rows put a whole batch on a few hundred
// slots, so up to nb atomics per row serialise on those cells in L2.
//
// What the design does about it: the TPU kernel turns the histogram into
// bf16 one-hot matmuls because the TPU has no scatter unit.  Hopper has
// integer atomics, which are exact in any order, so this is the plain
// histogram: one thread per row, int32 atomicAdd (red.global.add, the
// result is unused) for each non-zero block value.  Limbs are extracted
// with an unsigned shift, as the Pallas kernel's shift_right_logical.
// Shared-memory privatisation (the 96 KiB SF10 table fits one block's
// shared memory; the 4 MiB largest layout does not) and warp-aggregated
// atomics are left for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxArrays = 16;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond this

struct ValueArrays {
  const int32_t* ptr[kMaxArrays];
  int limbs[kMaxArrays];
};

__global__ void window_table_kernel(const int32_t* __restrict__ gid,
                                    ValueArrays arrays, int k,
                                    int32_t* __restrict__ table, int n,
                                    int sh, int lo_bits, int nb,
                                    int presence) {
  const uint32_t sl = 1u << lo_bits;
  const uint32_t num_slots = static_cast<uint32_t>(sh) << lo_bits;
  const int64_t row_stride = static_cast<int64_t>(sl) * nb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint32_t g = static_cast<uint32_t>(gid[i]);
    if (g >= num_slots) continue;  // sentinel (and any negative id)
    int32_t* cell = table + static_cast<int64_t>(g >> lo_bits) * row_stride +
                    (g & (sl - 1));
    int b = 0;
    if (presence) {
      atomicAdd(cell, 1);
      b = 1;
    }
    for (int a = 0; a < k; ++a) {
      const uint32_t v = static_cast<uint32_t>(__ldg(arrays.ptr[a] + i));
      const int nl = arrays.limbs[a];
      for (int li = 0; li < nl; ++li, ++b) {
        const int32_t w = static_cast<int32_t>((v >> (8 * li)) & 0xFFu);
        if (w != 0) atomicAdd(cell + static_cast<int64_t>(b) * sl, w);
      }
    }
  }
}

}  // namespace

// gid (n,) and arrays[0..k) (each (n,)) are device pointers to int32; the
// `arrays` and `limbs` lists themselves are host memory (copied into the
// kernel's parameters).  table (sh, sl * nb) int32 on the device, added
// into.  sl is a power of two.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments outside the contract.
extern "C" int blaze_window_table(const int32_t* gid,
                                  const void* const* arrays,
                                  const int* limbs, int k, int32_t* table,
                                  int n, int sh, int sl, int nb,
                                  int presence, void* stream) {
  if (k < 0 || k > kMaxArrays || n < 0 || sh <= 0 || sl <= 0 ||
      (sl & (sl - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ValueArrays va = {};
  int total = presence ? 1 : 0;
  for (int a = 0; a < k; ++a) {
    va.ptr[a] = static_cast<const int32_t*>(arrays[a]);
    va.limbs[a] = limbs[a];
    total += limbs[a];
  }
  if (total != nb) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int lo_bits = 0;
  while ((1 << lo_bits) < sl) ++lo_bits;
  int64_t blocks = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  window_table_kernel<<<static_cast<int>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      gid, va, k, table, n, sh, lo_bits, nb, presence);
  return static_cast<int>(cudaGetLastError());
}
