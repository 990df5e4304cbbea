// One batch of the dense aggregation lane's window table (CUDA C++, sm_90a).
//
// Replaces: blaze_tpu/kernels/mxu_agg.py `_pallas_window_table` (Pallas
// body `_make_kernel`), the exact grouped table behind plan/fused.py
// `_execute_mxu`, together with the rest of the loop body of
// blaze_tpu/plan/fused.py `_mxu_fold_factory` around it (which XLA fuses
// into the same program on the TPU).
//
// Contract of the table (bit-identical to the TPU kernel and to the
// scatter formulation `_window_table_ref`): a row with group id g < sh * sl
// adds, into slot g, 1 to the presence block (when there is one) and limb
// li of value array a, (uint32(value) >> 8 li) & 255, to that limb's block.
// Rows with g >= sh * sl (the sentinel) drop.  The int32 table is (sh,
// sl * nb), block-major: block b of slot hi * sl + lo is
// table[hi * sl * nb + b * sl + lo].  The kernel adds into the table it is
// given.  The layout and the plan are run-time parameters: every map task
// plans its own layout from its file's statistics, and one build serves
// them all.
//
// Entry point blaze_window_step runs one batch of the window-table lane in
// one launch: the dense int32 group ids of up to 17 key columns
// (pack_dense_keys_i32; int8, int16, int32 or int64 keys; the sentinel for
// masked-out rows), each aggregate's validity and limb-domain value (int
// data - off, or rint(float64 * scale) - off with the fixed-point verify,
// which clears a device `ok` flag), the table update, and min/max by int32
// atomicMin/atomicMax into (S + 1,) arrays.  Every layout the lane plans
// has at most 512 * 256 = 2^17 slots and every key takes a factor of at
// least 2 of them, so 17 keys cover every plan.
//
// What bounds it on this card: bytes in principle (the rollup's batch of
// 32,768 rows reads about 0.5 MB of keys and values against its 96 KiB
// table), but launch latency and the host in practice.  The one launch
// exists for that: it replaces the eager PyTorch launches per batch that
// prepared a histogram kernel's operands.
//
// What the design does about it: the TPU kernel turns the histogram into
// bf16 one-hot matmuls because the TPU has no scatter unit.  Hopper has
// integer atomics, which are exact in any order, so this is a histogram,
// one thread per row, with warp-aggregated adds: __match_any_sync on the
// group id finds the lanes of one slot, __reduce_add_sync sums their
// block values, and the lowest of them adds the sum with one atomic
// (red.global.add).  A lane alone on its slot adds its own values:
// divergent peer groups run their reductions one after another, so
// scattered ids would otherwise pay one reduction per lane.  Limbs are
// extracted with an unsigned shift, as the Pallas kernel's
// shift_right_logical.  The float verify is written with explicitly
// rounded operations (__dmul_rn, __dsub_rn, __dadd_rn), so no FMA
// contraction makes a residual exact that PyTorch rounds.  Shared-memory
// privatisation (the 96 KiB rollup table fits one block; the 4 MiB largest
// layout does not) waits until the atomics, not the launch, set the pace.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxKeys = 17;
constexpr int kMaxSpecs = 16;
constexpr int kMaxBlocks = 132 * 16;  // grid-stride beyond this
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool alone(unsigned peers) {
  return (peers & (peers - 1)) == 0;
}

// One block value of a slot's lanes into its cell: the peers sum their
// values and the lowest lane adds the sum.  Called by every lane of the
// peer group, with the same `peers`.  A lane alone on its slot adds its
// own value: divergent groups run their reductions one after another, so
// scattered ids would otherwise pay one reduction per lane.
__device__ __forceinline__ void add_block(int32_t* cell, unsigned peers,
                                          bool leader, unsigned w) {
  const unsigned sum = alone(peers) ? w : __reduce_add_sync(peers, w);
  if (leader && sum != 0) atomicAdd(cell, static_cast<int>(sum));
}

__device__ __forceinline__ int64_t first_row(int lane) {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x +
         (threadIdx.x & ~31u) + lane;
}

// The parameter block: every field is 8 bytes, so the host mirrors this
// layout with ctypes without padding rules.

struct StepKey {          // one key of pack_dense_keys_i32
  const void* data;       // (n,) int of `bytes` bytes
  const uint8_t* valid;   // (n,) bool
  long long lo;           // the key's minimum
  long long span;         // hi - lo; a NULL key takes span + 1
  long long stride;       // its digit's stride in the group id
  long long bytes;        // 1, 2, 4 or 8
};

struct StepSpec {         // one aggregate's validity and limb-domain value
  const void* data;       // (n,) of `dtype`; null for count(*) and count
  const uint8_t* valid;   // (n,) bool; null: every row is valid
  long long off;          // subtracted into the limb domain
  double scale;           // fixed-point scale of a float64 argument
  long long dtype;        // 1, 2, 4, 8: int of that many bytes; 9: float64
};

struct StepArray {        // one value array of the table
  long long spec;         // its aggregate
  long long is_valid;     // 1: the validity (0/1) array; 0: the values
  long long limbs;
};

struct StepMinMax {       // one min/max accumulator
  int32_t* acc;           // (sentinel + 1,) int32
  long long spec;
  long long is_min;
};

struct StepParams {
  const uint8_t* mask;    // (n,) bool: the batch's row mask
  int32_t* table;         // (sh, sl * nb) int32, added into
  uint8_t* ok;            // 0-d bool, cleared by a row failing the verify
  long long n, sh, lo_bits, nb, presence;
  long long sentinel;     // sh * sl: the group id of a masked-out row
  long long n_keys, n_specs, n_arrays, n_mm;
  StepKey keys[kMaxKeys];
  StepSpec specs[kMaxSpecs];
  StepArray arrays[kMaxSpecs];
  StepMinMax mm[kMaxSpecs];
};

__device__ __forceinline__ int32_t dense_gid(const StepParams& p,
                                             int64_t i) {
  uint32_t gid = 0;
  for (int k = 0; k < p.n_keys; ++k) {
    const StepKey& key = p.keys[k];
    int64_t d;
    if (!key.valid[i]) {
      d = key.span + 1;
    } else if (key.bytes == 8) {
      // data - lo wraps in int64, as torch's int64 subtraction
      d = static_cast<int64_t>(
          static_cast<uint64_t>(static_cast<const int64_t*>(key.data)[i]) -
          static_cast<uint64_t>(key.lo));
      d = d < 0 ? 0 : (d > key.span ? key.span : d);
    } else {
      // narrower keys widen to int32 first; data - lo wraps in int32
      const int32_t v =
          key.bytes == 4   ? static_cast<const int32_t*>(key.data)[i]
          : key.bytes == 2 ? static_cast<const int16_t*>(key.data)[i]
                           : static_cast<const int8_t*>(key.data)[i];
      const int32_t d32 = static_cast<int32_t>(static_cast<uint32_t>(v) -
                                               static_cast<uint32_t>(key.lo));
      d = d32 < 0 ? 0 : (d32 > key.span ? key.span : d32);
    }
    gid += static_cast<uint32_t>(d) * static_cast<uint32_t>(key.stride);
  }
  return static_cast<int32_t>(gid);
}

__device__ __forceinline__ bool spec_valid(const StepSpec& s, int64_t i) {
  return s.valid == nullptr || s.valid[i] != 0;
}

__device__ __forceinline__ double scaled(const StepSpec& s, int64_t i) {
  return __dmul_rn(static_cast<const double*>(s.data)[i], s.scale);
}

// (data - off) in the limb domain, truncated to int32 as torch's casts:
// ints subtract in int64; a float64 rounds half to even (rint, as
// torch.round) and subtracts in float64.
__device__ __forceinline__ int32_t spec_value(const StepSpec& s,
                                              int64_t i) {
  int64_t d;
  switch (s.dtype) {
    case 1: d = static_cast<const int8_t*>(s.data)[i]; break;
    case 2: d = static_cast<const int16_t*>(s.data)[i]; break;
    case 4: d = static_cast<const int32_t*>(s.data)[i]; break;
    case 8: d = static_cast<const int64_t*>(s.data)[i]; break;
    default:
      return static_cast<int32_t>(
          __dsub_rn(rint(scaled(s, i)), static_cast<double>(s.off)));
  }
  return static_cast<int32_t>(static_cast<uint32_t>(
      static_cast<uint64_t>(d) - static_cast<uint64_t>(s.off)));
}

// |v * scale - rint(v * scale)| <= (|rint(v * scale)| + 1) * 1e-12, each
// operation rounded (false for NaN and infinities)
__device__ __forceinline__ bool fixed_point_exact(const StepSpec& s,
                                                  int64_t i) {
  const double prod = scaled(s, i);
  const double c = rint(prod);
  return fabs(__dsub_rn(prod, c)) <=
         __dmul_rn(__dadd_rn(fabs(c), 1.0), 1e-12);
}

__global__ void __launch_bounds__(kThreads)
    window_step_kernel(StepParams p) {
  const uint32_t sl = 1u << p.lo_bits;
  const uint32_t num_slots = static_cast<uint32_t>(p.sh) << p.lo_bits;
  const int64_t row_stride = static_cast<int64_t>(sl) * p.nb;
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = first_row(lane); i - lane < p.n; i += stride) {
    const bool m = i < p.n && p.mask[i] != 0;
    const uint32_t g = m ? static_cast<uint32_t>(dense_gid(p, i))
                         : static_cast<uint32_t>(p.sentinel);
    const bool live = g < num_slots;
    const unsigned peers = __match_any_sync(kAll, live ? g : kAll);
    if (!live) continue;
    const bool leader = __ffs(peers) - 1 == lane;
    for (int si = 0; si < p.n_specs; ++si) {
      const StepSpec& s = p.specs[si];
      if (s.dtype == 9 && spec_valid(s, i) && !fixed_point_exact(s, i))
        *p.ok = 0;
    }
    int32_t* cell = p.table +
                    static_cast<int64_t>(g >> p.lo_bits) * row_stride +
                    (g & (sl - 1));
    int b = 0;
    if (p.presence) {
      if (leader) atomicAdd(cell, __popc(peers));
      b = 1;
    }
    for (int a = 0; a < p.n_arrays; ++a) {
      const StepArray& arr = p.arrays[a];
      const StepSpec& s = p.specs[arr.spec];
      const bool valid = spec_valid(s, i);
      const uint32_t v = arr.is_valid
                             ? (valid ? 1u : 0u)
                             : (valid ? static_cast<uint32_t>(
                                            spec_value(s, i))
                                      : 0u);
      for (int li = 0; li < arr.limbs; ++li, ++b)
        add_block(cell + static_cast<int64_t>(b) * sl, peers, leader,
                  (v >> (8 * li)) & 0xFFu);
    }
    for (int j = 0; j < p.n_mm; ++j) {
      const StepMinMax& mm = p.mm[j];
      const StepSpec& s = p.specs[mm.spec];
      const bool valid = spec_valid(s, i);
      const int32_t ident = mm.is_min ? INT32_MAX : INT32_MIN;
      const int32_t v = valid ? spec_value(s, i) : ident;
      const int32_t r = alone(peers) ? v
                        : mm.is_min  ? __reduce_min_sync(peers, v)
                                     : __reduce_max_sync(peers, v);
      if (leader && r != ident) {
        if (mm.is_min) {
          atomicMin(mm.acc + g, r);
        } else {
          atomicMax(mm.acc + g, r);
        }
      }
    }
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks > kMaxBlocks ? kMaxBlocks : blocks);
}

}  // namespace

// params: a StepParams in host memory, copied into the kernel's
// parameters; every pointer in it is a device pointer.  lo_bits is
// log2(sl).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments outside the contract.
extern "C" int blaze_window_step(const void* params, void* stream) {
  const StepParams& p = *static_cast<const StepParams*>(params);
  if (p.n < 0 || p.n >= (1ll << 31) || p.sh <= 0 || p.lo_bits < 0 ||
      p.lo_bits > 10 || p.n_keys < 1 || p.n_keys > kMaxKeys ||
      p.n_specs < 0 || p.n_specs > kMaxSpecs || p.n_arrays < 0 ||
      p.n_arrays > kMaxSpecs || p.n_mm < 0 || p.n_mm > kMaxSpecs ||
      p.sentinel != (p.sh << p.lo_bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < p.n_keys; ++k) {
    const long long w = p.keys[k].bytes;
    if (w != 1 && w != 2 && w != 4 && w != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  long long total = p.presence ? 1 : 0;
  for (int a = 0; a < p.n_arrays; ++a) {
    if (p.arrays[a].spec < 0 || p.arrays[a].spec >= p.n_specs ||
        p.arrays[a].limbs < 1 || p.arrays[a].limbs > 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    total += p.arrays[a].limbs;
  }
  for (int j = 0; j < p.n_mm; ++j) {
    if (p.mm[j].spec < 0 || p.mm[j].spec >= p.n_specs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (total != p.nb) return static_cast<int>(cudaErrorInvalidValue);
  if (p.n == 0) return static_cast<int>(cudaGetLastError());
  window_step_kernel<<<grid_for(p.n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
