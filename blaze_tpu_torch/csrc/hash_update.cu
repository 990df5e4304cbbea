// Hash placement for one hash_agg_step batch, in place in the carry's
// table (CUDA C++, sm_90a, one cooperative launch per call; a launch may
// be captured into a CUDA graph and replayed).
//
// Replaces: blaze_tpu/kernels/hash_update.py `placement` (Pallas body
// `_make_kernel`), the open-addressing claim/match walk behind
// parallel/stage.py hash_agg_step.
//
// Contract (bit-identical to the TPU kernel and to the scatter
// formulation): round r probes slot (h + r) & (S - 1) for every row still
// pending (mask set, not yet placed).  The lowest row index claims a
// contested empty slot; after the claims, a pending row whose L key limbs
// equal the slot's limbs is placed.  Outputs: placed[i] (slot, or S when
// never placed), wslot[i] (the slot row i claimed as new, or S) and the
// count of masked rows left unplaced.  The winners' claims are written
// into `used` (bool) and the (L, S) limb table that the caller hands in.
// With `rollback`, a call that leaves a masked row unplaced takes its
// claims back before it returns: every slot claimed in the call gets its
// limbs zeroed again (an unused slot's limbs are zero) and stays unused,
// and every row reads as unplaced (placed and wslot S), so the table is
// as it was before the call (the atomic overflow of hash_agg_step, on a
// table the caller updates in place).
//
// What bounds it on this card: latency, not bytes.  A pending row moves
// about 26 + 8L bytes per round (its hash, mask and limbs, the slot's
// used flag and limbs, its outputs), scattered over the table: at
// n = 32768 rows and a few rounds that is a few MB, about 1 us of HBM
// time.  What costs is the chain of dependent rounds: each is a few
// dependent memory accesses and a barrier (a grid barrier is ~1.1 us on
// an H100).
//
// What the design does about it.  The TPU kernel walks rows serially in
// row order, which would be one thread here.  This kernel runs the same
// contract round-synchronously over all rows, one thread per row, in one
// cooperative launch whose grid barriers (cooperative_groups::this_grid()
// .sync()) stand where kernel boundaries stood, and it needs one barrier
// per round, not two:
//   * Every value the kernel keeps about a round carries the round's tag
//     t(r) = base + r.  `base` is a word in the scratch: every thread
//     reads it at the start, and once the rounds are over (after a grid
//     barrier, so every thread has read it) the first thread advances it
//     by rounds + 1.  So each call's tags lie above every tag of the
//     earlier calls on the same scratch, whether the call was launched
//     eagerly or replayed from a graph, and the scratch is never cleared:
//     values of earlier calls and rounds are smaller, and lose or read as
//     stale.  The host only zeroes the scratch (and sets the word to 1)
//     before the tags would pass 2^32.
//   * Claims are unconditional: a row pending for round r does
//     atomicMax(claim[r & 1][slot], t(r) << 32 | ~row) one phase ahead,
//     so the largest value of a round names its lowest row.  Two claim
//     arrays alternate, so the phase that reads round r's claims writes
//     round r + 1's into the other.
//   * stamp[s] = t(r) when slot s is claimed in round r, so "used at the
//     start of round r" is base <= stamp[s] < t(r), or a stale stamp and
//     the carry's used[s].  `used` is not written until the rounds are
//     over, so that reading holds however a round's commits interleave.
//   * Resolving round r is one phase: a row on a slot used at the round
//     start compares its limbs with the table's; on a slot empty at the
//     round start, the claim's winner commits (stamp, its limbs, wslot)
//     and every other claimant compares its limbs with the winner's, read
//     from the batch's own limbs.  A row left pending claims its next slot
//     in the same phase.  The loads of a phase (stamp, claim, used, both
//     sides' limbs) are issued together.
// The phases: init and the round-0 claims | one phase per round; a round
// only counts the rows it leaves pending, and every block reads that
// count after the grid barrier, so all blocks leave the loop together.
// Where the grid holds one row per thread, a thread keeps its row's hash
// and state in registers.  Once the rounds are over, the winners set
// their slots' `used` flags, or, on a rolled-back overflow, zero their
// slots' limbs; a rolled-back claim's stamp stays, and reads as stale to
// every later call.  The grid spans every SM and is sized to be
// co-resident (at most occupancy x SMs), as a cooperative launch requires.
// The last rounds leave a few hundred rows pending: spread over every SM
// a round then costs little more than its barrier, and measured faster
// than running them in one block with block barriers (one SM then serves
// all their scattered loads: ~4 us a round against ~1.5 us).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// Threads per block: 256 measured faster than 512 and 1024 on an H100
// (fewer idle warps per barrier), and 256-thread blocks still hold one
// row per thread up to ~270,000 rows.
constexpr int kThreads = 256;
// Limbs held in registers for a comparison; keys with more take a loop.
constexpr int kLimbRegs = 8;
constexpr int kMaxDevices = 64;

struct PlaceArgs {
  const void* h;          // (n,) int32 or int64 slot hashes
  const int32_t* limbs;   // (L, n) row key limbs
  const uint8_t* mask;    // (n,) bool: rows to place
  uint8_t* used;          // (S,) bool, claimed into at the end
  int32_t* tab;           // (L, S) stored-key limbs, claimed into
  int32_t* placed;        // (n,)
  int32_t* wslot;         // (n,)
  int32_t* unplaced;      // (1,)
  unsigned long long* claim;  // round r claims in claim[r & 1][0, S)
  uint32_t* stamp;        // (S,) the tag of the round a slot was claimed in
  int32_t* cnt;           // (rounds + 1,) rows pending after each round
  uint32_t* tag;          // the next call's t(0), advanced by the call
  int64_t claim_stride;   // cells between the two claim arrays
  int n, S, L, rounds, h_is64, rollback;
};

__device__ __forceinline__ int64_t hash_of(const PlaceArgs& a, int64_t i) {
  return a.h_is64 ? __ldg(static_cast<const long long*>(a.h) + i)
                  : static_cast<int64_t>(static_cast<uint32_t>(
                        __ldg(static_cast<const int32_t*>(a.h) + i)));
}

__device__ __forceinline__ int slot_of(const PlaceArgs& a, int64_t hv,
                                       int r) {
  return static_cast<int>((static_cast<uint64_t>(hv) +
                           static_cast<uint64_t>(r)) &
                          static_cast<uint64_t>(a.S - 1));
}

__device__ __forceinline__ unsigned long long* claims(const PlaceArgs& a,
                                                      int r) {
  return a.claim + (r & 1) * a.claim_stride;
}

__device__ __forceinline__ void claim(const PlaceArgs& a, uint32_t base,
                                      int row, int64_t hv, int r) {
  atomicMax(claims(a, r) + slot_of(a, hv, r),
            (static_cast<unsigned long long>(base + r) << 32) |
                static_cast<unsigned>(~row));
}

// Do row i's limbs (held in `mine` up to kLimbRegs) equal those at
// `other` + l * ostride?  The loads are issued before any compare.
__device__ __forceinline__ bool limbs_equal(const PlaceArgs& a,
                                            const int32_t* mine, int i,
                                            const int32_t* other,
                                            int64_t ostride) {
  bool eq = true;
#pragma unroll
  for (int l = 0; l < kLimbRegs; ++l)
    if (l < a.L) eq &= mine[l] == __ldcg(other + l * ostride);
  for (int l = kLimbRegs; eq && l < a.L; ++l)
    eq = __ldg(a.limbs + static_cast<int64_t>(l) * a.n + i) ==
         __ldcg(other + l * ostride);
  return eq;
}

// Round r for pending row i on slot s: true when the row is placed.
// Data written during the call is read with __ldcg (from L2).
__device__ bool resolve(const PlaceArgs& a, uint32_t base, int i, int r,
                        int s) {
  const uint32_t t = base + r;
  const uint32_t st = __ldcg(a.stamp + s);
  const unsigned long long c = __ldcg(claims(a, r) + s);
  const bool carry_used = __ldcg(a.used + s) != 0;
  int32_t mine[kLimbRegs];
#pragma unroll
  for (int l = 0; l < kLimbRegs; ++l)
    if (l < a.L) mine[l] = __ldg(a.limbs + static_cast<int64_t>(l) * a.n + i);
  const bool used_at_start =
      st >= base ? st < t : carry_used;  // claimed earlier, or the carry's
  bool eq;
  if (used_at_start) {
    eq = limbs_equal(a, mine, i, a.tab + s, a.S);
  } else {  // empty at the round start: every prober claimed it
    const int w = static_cast<int>(~static_cast<unsigned>(c & 0xffffffffull));
    if (w == i) {
      a.stamp[s] = t;
#pragma unroll
      for (int l = 0; l < kLimbRegs; ++l)
        if (l < a.L) a.tab[static_cast<int64_t>(l) * a.S + s] = mine[l];
      for (int l = kLimbRegs; l < a.L; ++l)
        a.tab[static_cast<int64_t>(l) * a.S + s] =
            __ldg(a.limbs + static_cast<int64_t>(l) * a.n + i);
      a.wslot[i] = s;
      eq = true;
    } else {
      eq = limbs_equal(a, mine, i, a.limbs + w, a.n);
    }
  }
  if (eq) a.placed[i] = s;
  return eq;
}

// One round for pending row i: true when it stays pending (it has then
// claimed its slot of the next round).
__device__ __forceinline__ bool round_row(const PlaceArgs& a, uint32_t base,
                                          int i, int64_t hv, int r) {
  if (resolve(a, base, i, r, slot_of(a, hv, r))) return false;
  if (r + 1 < a.rounds) claim(a, base, i, hv, r + 1);
  return true;
}

// Adds the warp's counts to *c with one atomic; every lane calls it.
__device__ __forceinline__ void count_warp(int32_t* c, int mine) {
  const unsigned sum = __reduce_add_sync(0xffffffffu,
                                         static_cast<unsigned>(mine));
  if ((threadIdx.x & 31) == 0 && sum) atomicAdd(c, static_cast<int>(sum));
}

__global__ void __launch_bounds__(kThreads) place_kernel(PlaceArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int S = a.S;
  // this call's t(0): read by every thread before the first grid barrier;
  // the first thread advances the word after the last one
  const uint32_t base = *static_cast<volatile const uint32_t*>(a.tag);
  // Where the grid holds one row per thread, a thread keeps its row's
  // hash and pending state in registers; else rows are walked grid-stride
  // and a row is pending while mask[i] and placed[i] == S.
  const bool own = a.n <= stride;
  int row = -1;
  int64_t hv = 0;
  for (int64_t i = tid; i < a.n; i += stride) {
    a.placed[i] = S;
    a.wslot[i] = S;
    if (__ldg(a.mask + i)) {
      const int64_t h = hash_of(a, i);
      claim(a, base, static_cast<int>(i), h, 0);
      if (own) {
        row = static_cast<int>(i);
        hv = h;
      }
    }
  }
  for (int64_t r = tid; r <= a.rounds; r += stride) a.cnt[r] = 0;
  grid.sync();
  int left = 0;
  for (int r = 0; r < a.rounds; ++r) {
    int mine = 0;
    if (own) {
      if (row >= 0) {
        if (round_row(a, base, row, hv, r)) {
          mine = 1;
        } else {
          row = -1;
        }
      }
    } else {
      for (int64_t i = tid; i < a.n; i += stride) {
        if (__ldg(a.mask + i) && a.placed[i] == S &&
            round_row(a, base, static_cast<int>(i), hash_of(a, i), r))
          ++mine;
      }
    }
    count_warp(a.cnt + r + 1, mine);
    grid.sync();
    left = *static_cast<volatile int32_t*>(a.cnt + r + 1);
    if (left == 0) break;
  }
  // the claims stand (`used` set), or on a rolled-back overflow go (limbs
  // zeroed, every row unplaced); each thread rewrites only its own rows
  const bool undo = a.rollback && left > 0;
  for (int64_t i = tid; i < a.n; i += stride) {
    const int ws = a.wslot[i];
    if (ws != S) {
      if (undo) {
        for (int l = 0; l < a.L; ++l)
          a.tab[static_cast<int64_t>(l) * S + ws] = 0;
        a.wslot[i] = S;
      } else {
        a.used[ws] = 1;
      }
    }
    if (undo) a.placed[i] = S;
  }
  if (tid == 0) {
    *a.unplaced = left;
    *a.tag = base + static_cast<uint32_t>(a.rounds) + 1u;
  }
}

// Per device: co-resident blocks of place_kernel (0: not computed yet),
// and the SM count.
int g_max_blocks[kMaxDevices];
int g_sms[kMaxDevices];

}  // namespace

// Cells of the int32 scratch buffer that blaze_place_in_carry takes for
// tables of up to `slots` slots and up to `rounds` probe rounds: the tag
// word and a pad cell, claims (4 slots), stamps (slots), counts
// (rounds + 1).  Zeroed with the tag word set to 1 when it is allocated;
// a call leaves it for the next, whatever its table (a stale tag reads as
// stale in any table).
extern "C" long long blaze_place_scratch_cells(int slots, int rounds) {
  return 2ll + 5ll * slots + rounds + 1ll;
}

// All pointers are device pointers.  h (n,) int32 (h_is64 = 0) or int64
// slot hashes, any bits above log2(S) ignored; limbs (L, n) int32
// row-major; mask (n,) bool; used (S,) bool and tab (L, S) int32, both
// claimed into in place; out (2n + 1,) int32: placed, wslot, unplaced.
// scratch: an 8-byte aligned int32 buffer of
// blaze_place_scratch_cells(slots, rounds) cells with slots >= S, used by
// one stream at a time, whose tag word (cell 0) the caller keeps at least
// 1 and below 2^32 - rounds - 1 when the launch runs.  S is a power of
// two, rounds >= 1; rollback != 0 takes an overflowing call's claims back
// (see the top of this file).  The launch may be captured into a CUDA
// graph: it reads nothing from the host after this call.  Returns the
// launch's error code: a cooperative launch the device refuses returns it
// here, and nothing runs.
extern "C" int blaze_place_in_carry(const void* h, const int32_t* limbs,
                                    const uint8_t* mask, uint8_t* used,
                                    int32_t* tab, int32_t* out,
                                    int32_t* scratch, int slots, int n,
                                    int S, int L, int rounds, int h_is64,
                                    int rollback, void* stream) {
  if (n < 0 || S < 1 || (S & (S - 1)) != 0 || slots < S || L < 1 ||
      rounds < 1 || (reinterpret_cast<uintptr_t>(scratch) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_max_blocks[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, place_kernel, kThreads, 0)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (!coop || per_sm < 1) return static_cast<int>(cudaErrorNotSupported);
    g_sms[dev] = sms;
    g_max_blocks[dev] = per_sm * sms;
  }
  // a block on every SM; more where the rows need them, up to what can be
  // co-resident
  int64_t blocks = (static_cast<int64_t>(n) + kThreads - 1) / kThreads;
  if (blocks < g_sms[dev]) blocks = g_sms[dev];
  if (blocks > g_max_blocks[dev]) blocks = g_max_blocks[dev];
  PlaceArgs a;
  a.h = h;
  a.limbs = limbs;
  a.mask = mask;
  a.used = used;
  a.tab = tab;
  a.placed = out;
  a.wslot = out + n;
  a.unplaced = out + 2 * static_cast<int64_t>(n);
  a.tag = reinterpret_cast<uint32_t*>(scratch);
  a.claim = reinterpret_cast<unsigned long long*>(scratch + 2);
  a.stamp = reinterpret_cast<uint32_t*>(scratch + 2 +
                                        4 * static_cast<int64_t>(slots));
  a.cnt = scratch + 2 + 5 * static_cast<int64_t>(slots);
  a.claim_stride = slots;
  a.n = n;
  a.S = S;
  a.L = L;
  a.rounds = rounds;
  a.h_is64 = h_is64;
  a.rollback = rollback;
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(place_kernel),
      dim3(static_cast<unsigned>(blocks)), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
