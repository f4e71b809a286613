// Grouped aggregation (masked SUM / MIN / MAX by group id) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernels in
// repro/kernels/seg_agg/kernel.py:
//   * seg_agg_kernel        <- _seg_agg_kernel       (explicit row mask)
//   * seg_agg_fused_kernel  <- _seg_agg_fused_kernel (mask built from range
//                                                     bounds inside the kernel)
//
// What bounds it on the card: bytes read.  Each row is read once (values,
// group id, and the mask or the predicate columns) and does a handful of
// adds or compares, so the least time is N*(M+2)*4 bytes (kernel A) or
// N*(M+1+P)*4 bytes (kernel B) over 3.35 TB/s.  The TPU kernel turned the
// reduce into a one-hot matmul because the TPU has no fast scatter; Hopper
// has fast shared-memory atomics, so here each block keeps a partial of its
// group tile in shared memory, every row adds into its group's slot, and the
// block merges the touched slots into the output with one global atomic
// each.  A group space too large for a few shared-memory tiles goes straight
// to global atomics.  Group tiles run over grid.y: that is where the TPU's
// `gb` grid axis went.
//
// Numerics.  Sums accumulate in f32, as on the TPU.  Atomics add in an order
// that changes from run to run, so sums are not bit-reproducible; MIN/MAX
// are.  A NaN stays in its own group (the one-hot matmul spread it over the
// whole tile): SUM propagates it through the add, MIN/MAX keep a per-slot
// NaN flag folded into the ordered-integer key, with no float comparison
// against NaN.  Kernel A has two mask contracts: `select` (masked-out rows
// reach no group) and multiply (SUM adds value*mask, so a masked-out NaN
// still poisons its group, as seg_agg_ref does).
//
// Kernel B evaluates S signatures per row: it loads the row's P predicate
// values once, tests each against every signature's OR of K inclusive
// [lo, hi] ranges (NaN sentinel lo=hi=NaN matches NaN values; the pad range
// lo=+inf, hi=-inf never matches), and adds the row into the (S, G, M)
// output slot of every signature it satisfies.  The shared-scan batch
// therefore never builds the (N, S*M) expansion.
//
// Plain C interface, bound with ctypes.  Every launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOpSum = 0;
constexpr int kOpMin = 1;
constexpr int kOpMax = 2;
// at most this many 32-bit partial slots per block (64 KB of shared memory)
constexpr long long kSmemSlots = 16384;
// above this many group tiles the shared-memory partial is not worth the
// re-reads of the rows: accumulate in global memory instead
constexpr long long kMaxTiles = 8;
constexpr long long kMinRowsPerBlock = 2048;
// NaN flags: below every ordered key of a real float (MIN) or above (MAX)
constexpr int kNanMin = -2147483647 - 1;  // 0x80000000
constexpr int kNanMax = 2147483647;       // 0x7fffffff

// Monotone map from float to int: a < b as floats iff key(a) < key(b).
__device__ __forceinline__ int ordered_key(float f) {
  int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The accumulator's identity as raw bits: 0.0f, key(+inf), key(-inf).
__host__ __device__ constexpr int identity_bits(int op) {
  return op == kOpSum ? 0
       : op == kOpMin ? 0x7f800000        // key(+inf)
                      : -2139095041;      // key(-inf) == 0x807fffff
}

template <int OP>
__device__ __forceinline__ void accumulate(float* slot, float v) {
  if (OP == kOpSum) {
    if (v != 0.0f) atomicAdd(slot, v);  // NaN != 0: a NaN reaches the slot
  } else if (OP == kOpMin) {
    int k = isnan(v) ? kNanMin : ordered_key(v);
    if (k != identity_bits(OP)) atomicMin(reinterpret_cast<int*>(slot), k);
  } else {
    int k = isnan(v) ? kNanMax : ordered_key(v);
    if (k != identity_bits(OP)) atomicMax(reinterpret_cast<int*>(slot), k);
  }
}

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void fill_slots(float* p, long long slots, int bits) {
  for (long long i = threadIdx.x; i < slots; i += blockDim.x) {
    p[i] = __int_as_float(bits);
  }
}

// Merge a block's shared-memory partial into the output; untouched slots
// (still the identity) cost nothing.
template <int OP>
__device__ void merge_partial(float* out, const float* part, long long slots) {
  for (long long i = threadIdx.x; i < slots; i += blockDim.x) {
    float v = part[i];
    if (OP == kOpSum) {
      if (v != 0.0f) atomicAdd(out + i, v);
    } else {
      int k = __float_as_int(v);
      if (k == identity_bits(OP)) continue;
      if (OP == kOpMin) {
        atomicMin(reinterpret_cast<int*>(out) + i, k);
      } else {
        atomicMax(reinterpret_cast<int*>(out) + i, k);
      }
    }
  }
}

__global__ void fill_kernel(float* out, long long total, int bits) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    out[i] = __int_as_float(bits);
  }
}

// MIN/MAX keys back to floats, the NaN flag to NaN.
__global__ void decode_kernel(float* out, long long total, int nan_key) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int k = __float_as_int(out[i]);
    out[i] = k == nan_key ? __int_as_float(0x7fc00000) : key_value(k);
  }
}

// Kernel A: values (N, M) f32, ids (N,) i32, mask (N,) f32 -> out (G, M).
template <int OP, bool SELECT>
__global__ void seg_agg_kernel(const float* __restrict__ values,
                               const int* __restrict__ ids,
                               const float* __restrict__ mask,
                               float* __restrict__ out, long long n, int m,
                               int num_groups, int tile_groups,
                               long long rows_per_block, bool use_smem) {
  extern __shared__ float smem[];
  const int g0 = blockIdx.y * tile_groups;
  const int g1 = min(g0 + tile_groups, num_groups);
  const long long slots = (long long)(g1 - g0) * m;
  float* acc = use_smem ? smem : out + (long long)g0 * m;
  if (use_smem) {
    fill_slots(smem, slots, identity_bits(OP));
    __syncthreads();
  }
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = lmin(r0 + rows_per_block, n);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int g = ids[r];
    if (g < g0 || g >= g1) continue;
    const float w = mask[r];
    const bool multiply = OP == kOpSum && !SELECT;
    if (!multiply && !(w > 0.5f)) continue;
    float* slot = acc + (long long)(g - g0) * m;
    const float* v = values + r * m;
    for (int c = 0; c < m; ++c) {
      accumulate<OP>(slot + c, multiply ? v[c] * w : v[c]);
    }
  }
  if (use_smem) {
    __syncthreads();
    merge_partial<OP>(out + (long long)g0 * m, smem, slots);
  }
}

// Kernel B: values (N, M), ids (N,), pred (N, P), bounds (S, P, K, 2)
// -> out (S, G, M), tiled over the S*G "virtual groups" s*G + g.
template <int OP>
__global__ void seg_agg_fused_kernel(const float* __restrict__ values,
                                     const int* __restrict__ ids,
                                     const float* __restrict__ pred,
                                     const float* __restrict__ bounds,
                                     float* __restrict__ out, long long n,
                                     int m, int p, int k, int s_count,
                                     int num_groups, int tile_groups,
                                     long long rows_per_block, bool use_smem) {
  extern __shared__ float smem[];
  const int nb = s_count * p * k * 2;
  float* sb = smem;
  float* part = smem + nb;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) sb[i] = bounds[i];
  const long long vg_total = (long long)s_count * num_groups;
  const long long vg0 = (long long)blockIdx.y * tile_groups;
  const long long vg1 = lmin(vg0 + tile_groups, vg_total);
  const long long slots = (vg1 - vg0) * m;
  float* acc = use_smem ? part : out + vg0 * m;
  if (use_smem) fill_slots(part, slots, identity_bits(OP));
  __syncthreads();
  const unsigned long long all =
      s_count >= 64 ? ~0ull : ((1ull << s_count) - 1ull);
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = lmin(r0 + rows_per_block, n);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int g = ids[r];
    if (g < 0 || g >= num_groups) continue;
    unsigned long long pass = all;
    for (int j = 0; j < p && pass; ++j) {
      const float x = pred[r * p + j];  // each predicate value read once
      const bool x_nan = isnan(x);
      for (int s = 0; s < s_count; ++s) {
        if (!((pass >> s) & 1ull)) continue;
        const float* b = sb + (s * p + j) * k * 2;
        bool hit = false;
        for (int q = 0; q < k && !hit; ++q) {
          const float lo = b[2 * q];
          const float hi = b[2 * q + 1];
          hit = (x >= lo && x <= hi) || (x_nan && isnan(lo));
        }
        if (!hit) pass &= ~(1ull << s);
      }
    }
    const float* v = values + r * m;
    while (pass) {
      const int s = __ffsll((long long)pass) - 1;
      pass &= pass - 1ull;
      const long long vg = (long long)s * num_groups + g;
      if (vg < vg0 || vg >= vg1) continue;
      float* slot = acc + (vg - vg0) * m;
      for (int c = 0; c < m; ++c) accumulate<OP>(slot + c, v[c]);
    }
  }
  if (use_smem) {
    __syncthreads();
    merge_partial<OP>(out + vg0 * m, part, slots);
  }
}

struct Plan {
  int tile_groups;
  int tiles;
  bool use_smem;
  long long rows_per_block;
  long long blocks;
  size_t smem_bytes;
};

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// Group tiles and row blocks for `groups` (virtual) groups of M slots each.
Plan make_plan(long long n, long long groups, int m, size_t fixed_smem) {
  Plan pl;
  long long tile = kSmemSlots / m;
  if (tile < 1) tile = 1;
  long long tiles = (groups + tile - 1) / tile;
  pl.use_smem = tiles <= kMaxTiles;
  if (pl.use_smem) {
    pl.tiles = (int)tiles;
    pl.tile_groups = (int)((groups + tiles - 1) / tiles);
  } else {
    pl.tiles = 1;
    pl.tile_groups = (int)groups;
  }
  const long long slots = pl.use_smem ? (long long)pl.tile_groups * m : 0;
  // about one wave of blocks at full occupancy, never fewer rows per block
  // than the block's partial has slots to initialise and merge
  long long rpb = (n + sm_count() * 8LL - 1) / (sm_count() * 8LL);
  if (rpb < kMinRowsPerBlock) rpb = kMinRowsPerBlock;
  if (rpb < slots) rpb = slots;
  rpb = (rpb + kThreads - 1) / kThreads * kThreads;
  pl.rows_per_block = rpb;
  pl.blocks = (n + rpb - 1) / rpb;
  pl.smem_bytes = fixed_smem + (size_t)slots * sizeof(float);
  return pl;
}

int grid_for(long long total) {
  long long b = (total + kThreads - 1) / kThreads;
  return (int)(b < 4096 ? b : 4096);
}

void fill_output(float* out, long long total, int op, cudaStream_t stream) {
  if (total > 0) {
    fill_kernel<<<grid_for(total), kThreads, 0, stream>>>(out, total,
                                                          identity_bits(op));
  }
}

void decode_output(float* out, long long total, int op, cudaStream_t stream) {
  if (total > 0 && op != kOpSum) {
    decode_kernel<<<grid_for(total), kThreads, 0, stream>>>(
        out, total, op == kOpMin ? kNanMin : kNanMax);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int OP, bool SELECT>
cudaError_t launch_a(const float* values, const int* ids, const float* mask,
                     float* out, long long n, int m, int num_groups,
                     cudaStream_t stream) {
  Plan pl = make_plan(n, num_groups, m, 0);
  cudaError_t err = allow_smem(seg_agg_kernel<OP, SELECT>, pl.smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)pl.blocks, (unsigned)pl.tiles);
  seg_agg_kernel<OP, SELECT><<<grid, kThreads, pl.smem_bytes, stream>>>(
      values, ids, mask, out, n, m, num_groups, pl.tile_groups,
      pl.rows_per_block, pl.use_smem);
  return cudaSuccess;
}

template <int OP>
cudaError_t launch_b(const float* values, const int* ids, const float* pred,
                     const float* bounds, float* out, long long n, int m,
                     int p, int k, int s_count, int num_groups,
                     cudaStream_t stream) {
  const size_t fixed = (size_t)s_count * p * k * 2 * sizeof(float);
  Plan pl = make_plan(n, (long long)s_count * num_groups, m, fixed);
  cudaError_t err = allow_smem(seg_agg_fused_kernel<OP>, pl.smem_bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)pl.blocks, (unsigned)pl.tiles);
  seg_agg_fused_kernel<OP><<<grid, kThreads, pl.smem_bytes, stream>>>(
      values, ids, pred, bounds, out, n, m, p, k, s_count, num_groups,
      pl.tile_groups, pl.rows_per_block, pl.use_smem);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* seg_agg_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// op: 0 sum, 1 min, 2 max.  select: 1 for the select contract, 0 for the
// multiply contract (SUM only; MIN/MAX always select).
int seg_agg_launch(const float* values, const int* ids, const float* mask,
                   float* out, long long n, int m, int num_groups, int op,
                   int select, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long total = (long long)num_groups * m;
  fill_output(out, total, op, stream);
  cudaError_t err = cudaSuccess;
  if (n > 0 && total > 0) {
    if (op == kOpSum) {
      err = select ? launch_a<kOpSum, true>(values, ids, mask, out, n, m,
                                            num_groups, stream)
                   : launch_a<kOpSum, false>(values, ids, mask, out, n, m,
                                             num_groups, stream);
    } else if (op == kOpMin) {
      err = launch_a<kOpMin, true>(values, ids, mask, out, n, m, num_groups,
                                   stream);
    } else {
      err = launch_a<kOpMax, true>(values, ids, mask, out, n, m, num_groups,
                                   stream);
    }
  }
  if (err != cudaSuccess) return (int)err;
  decode_output(out, total, op, stream);
  return (int)cudaGetLastError();
}

// bounds (S, P, K, 2) f32; out (S, G, M).  1 <= S <= 64.
int seg_agg_fused_launch(const float* values, const int* ids,
                         const float* pred, const float* bounds, float* out,
                         long long n, int m, int p, int k, int s_count,
                         int num_groups, int op, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long total = (long long)s_count * num_groups * m;
  fill_output(out, total, op, stream);
  cudaError_t err = cudaSuccess;
  if (n > 0 && total > 0) {
    if (op == kOpSum) {
      err = launch_b<kOpSum>(values, ids, pred, bounds, out, n, m, p, k,
                             s_count, num_groups, stream);
    } else if (op == kOpMin) {
      err = launch_b<kOpMin>(values, ids, pred, bounds, out, n, m, p, k,
                             s_count, num_groups, stream);
    } else {
      err = launch_b<kOpMax>(values, ids, pred, bounds, out, n, m, p, k,
                             s_count, num_groups, stream);
    }
  }
  if (err != cudaSuccess) return (int)err;
  decode_output(out, total, op, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
