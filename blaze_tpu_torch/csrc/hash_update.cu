// Hash placement for one hash_agg_step batch (CUDA C++, sm_90a).
//
// Replaces: blaze_tpu/kernels/hash_update.py `placement` (Pallas body
// `_make_kernel`), the open-addressing claim/match walk behind
// parallel/stage.py hash_agg_step.
//
// Contract (bit-identical to the TPU kernel and to the scatter
// formulation): round r probes slot (h + r) & (S - 1) for every row still
// pending.  The lowest row index claims a contested empty slot; after the
// claims, a pending row whose L key limbs equal the slot's limbs is
// placed.  Outputs: placed[i] (slot, or S when never placed) and wslot[i]
// (the slot row i claimed as new, or S).
//
// What bounds it on this card: latency, not bytes.  A pending row moves
// about 4 + 8L + 16 bytes per round (its hash, its limbs and the slot's
// limbs, used flag, outputs), scattered over the table: at n = 32768 rows
// and 1-2 rounds that is about 2-4 MB, roughly 1 us of HBM time, while
// the call is 2 + 2*rounds kernel launches.
//
// What the design does about it: the TPU kernel walks rows serially in
// row order, which would be one thread here.  This file computes the same
// contract as round-synchronous passes (the scatter formulation of
// parallel/stage.py run as kernels, one thread per pending row):
//   claim   atomicMin(claim[slot], row) where the slot is empty;
//   commit  the winner sets used[slot], copies its limbs, sets wslot;
//   match   every pending row compares its limbs with the slot's.
// Kernel boundaries are the grid-wide barriers.  The match pass of round
// r also issues round r+1's claims (the used flags they read are final
// once round r has committed) and resets round r's claim cells, so a
// round costs two launches.  A pending count per round lives on the
// device: once it reaches 0 the remaining launches return at once, with
// no host sync.  All launches of a call are issued by one C entry point.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void init_kernel(const int32_t* __restrict__ used0,
                            const int32_t* __restrict__ tab0,
                            const int32_t* __restrict__ npend,
                            int32_t* __restrict__ used,
                            int32_t* __restrict__ tab,
                            int32_t* __restrict__ claim,
                            int32_t* __restrict__ placed,
                            int32_t* __restrict__ wslot,
                            int32_t* __restrict__ cnt,
                            int n, int S, int L, int rounds) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = tid; j < (int64_t)L * S; j += stride) tab[j] = tab0[j];
  for (int64_t j = tid; j < S; j += stride) {
    used[j] = used0[j];
    claim[j] = n;  // no row: every real row index is below n
  }
  for (int64_t j = tid; j < n; j += stride) {
    placed[j] = S;
    wslot[j] = S;
  }
  if (tid <= rounds) cnt[tid] = (tid == 0) ? *npend : 0;
}

__global__ void claim_first(const int32_t* __restrict__ h,
                            const int32_t* __restrict__ pend,
                            const int32_t* __restrict__ npend,
                            const int32_t* __restrict__ used,
                            int32_t* __restrict__ claim, int S) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *npend) return;
  const int i = pend[k];
  const int s = h[i] & (S - 1);
  if (used[s] == 0) atomicMin(&claim[s], i);
}

__global__ void commit(const int32_t* __restrict__ h,
                       const int32_t* __restrict__ limbs,
                       const int32_t* __restrict__ pend,
                       const int32_t* __restrict__ npend,
                       const int32_t* __restrict__ cnt,
                       const int32_t* __restrict__ claim,
                       const int32_t* __restrict__ placed,
                       int32_t* __restrict__ used,
                       int32_t* __restrict__ tab,
                       int32_t* __restrict__ wslot,
                       int n, int S, int L, int r) {
  if (cnt[r] == 0) return;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *npend) return;
  const int i = pend[k];
  if (placed[i] != S) return;
  const int s = (h[i] + r) & (S - 1);
  if (claim[s] != i) return;
  used[s] = 1;
  for (int l = 0; l < L; ++l)
    tab[(int64_t)l * S + s] = limbs[(int64_t)l * n + i];
  wslot[i] = s;
}

__global__ void match_and_claim_next(const int32_t* __restrict__ h,
                                     const int32_t* __restrict__ limbs,
                                     const int32_t* __restrict__ pend,
                                     const int32_t* __restrict__ npend,
                                     const int32_t* __restrict__ used,
                                     const int32_t* __restrict__ tab,
                                     int32_t* __restrict__ claim,
                                     int32_t* __restrict__ placed,
                                     int32_t* __restrict__ cnt,
                                     int n, int S, int L, int r,
                                     int rounds) {
  if (cnt[r] == 0) return;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *npend) return;
  const int i = pend[k];
  if (placed[i] != S) return;
  const int s = (h[i] + r) & (S - 1);
  // A pending row's slot is used by now (it was full at the round start,
  // or the row claimed it and some row won), so no claim of round r+1
  // targets it: resetting it here cannot race with those claims.
  claim[s] = n;
  bool eq = used[s] == 1;
  for (int l = 0; eq && l < L; ++l)
    eq = tab[(int64_t)l * S + s] == limbs[(int64_t)l * n + i];
  if (eq) {
    placed[i] = s;
    return;
  }
  atomicAdd(&cnt[r + 1], 1);
  if (r + 1 < rounds) {
    const int s2 = (h[i] + r + 1) & (S - 1);
    if (used[s2] == 0) atomicMin(&claim[s2], i);
  }
}

}  // namespace

// All pointers are device pointers.  h (n,), limbs (L, n) row-major,
// pend0 (n,) pending rows in row order, npend (1,), used0 (S,),
// tab0 (L, S).  Scratch: used (S,), tab (L, S), claim (S,),
// cnt (rounds + 1,).  Outputs: placed (n,), wslot (n,).  S is a power of
// two.  Returns cudaGetLastError() after the last launch.
extern "C" int blaze_hash_placement(
    const int32_t* h, const int32_t* limbs, const int32_t* pend0,
    const int32_t* npend, const int32_t* used0, const int32_t* tab0,
    int32_t* used, int32_t* tab, int32_t* claim, int32_t* cnt,
    int32_t* placed, int32_t* wslot, int n, int S, int L, int rounds,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_blocks = (n + kThreads - 1) / kThreads;
  int64_t init_work = (int64_t)L * S;
  if (init_work < S) init_work = S;
  if (init_work < n) init_work = n;
  if (init_work < rounds + 1) init_work = rounds + 1;
  int64_t init_blocks = (init_work + kThreads - 1) / kThreads;
  if (init_blocks > 4096) init_blocks = 4096;
  init_kernel<<<(int)init_blocks, kThreads, 0, st>>>(
      used0, tab0, npend, used, tab, claim, placed, wslot, cnt, n, S, L,
      rounds);
  claim_first<<<row_blocks, kThreads, 0, st>>>(h, pend0, npend, used,
                                                claim, S);
  for (int r = 0; r < rounds; ++r) {
    commit<<<row_blocks, kThreads, 0, st>>>(h, limbs, pend0, npend, cnt,
                                             claim, placed, used, tab,
                                             wslot, n, S, L, r);
    match_and_claim_next<<<row_blocks, kThreads, 0, st>>>(
        h, limbs, pend0, npend, used, tab, claim, placed, cnt, n, S, L, r,
        rounds);
  }
  return static_cast<int>(cudaGetLastError());
}
