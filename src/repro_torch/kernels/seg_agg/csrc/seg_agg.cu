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
// has fast shared memory, so each block keeps a partial of the output
// there.
//
// Kernel A (PR 11's design): every row adds into its group's slot of the
// block's shared-memory partial of one group tile (grid.y) with an atomic,
// and the block merges the touched slots into the output with one global
// atomic each; a group space too large for a few tiles goes straight to
// global atomics.  Sums are therefore not bit-reproducible; MIN/MAX are.
//
// Kernel B evaluates S signatures per row: it tests the row's P predicate
// values against every signature's OR of K inclusive [lo, hi] ranges (NaN
// sentinel lo=hi=NaN matches NaN values; the pad range lo=+inf, hi=-inf
// never matches) and adds the row into the (S, G, M) output slot of every
// signature it satisfies, so the shared-scan batch never builds the
// (N, S*M) expansion.  PR 11's kernel B walked one row per thread through
// dependent loads (id, then predicate, then values) and contended shared
// atomics; the design here:
//
// * A persistent grid (as many blocks as fit on the SMs at once; each block
//   walks row tiles blockIdx.x, + gridDim.x, ...) stages each tile's ids,
//   values and predicate columns, whole and unconditionally, with 16-byte
//   cp.async, a tile ahead, so every byte the bound counts is read once and
//   the loads never wait on a branch; small tiles (1024 rows) keep blocks
//   small, so several share an SM.  Each thread then tests 4 rows at once
//   without branches (bitwise, not short-circuit, operators), so their
//   chains of shared-memory reads overlap.
// * Privatised slots, picked per call by the slot count S*G*M and S, the
//   first tier that leaves room for two blocks per SM.  Per thread: every
//   thread owns a copy (1 KB a slot per block) and updates it with plain
//   loads and stores.  Per warp (several signatures only): each warp owns
//   a copy and updates it without atomics: the lanes whose rows reach the
//   same slot (__match_any_sync) hand their values to the lowest of them
//   in lane order (shuffles), which adds the sum to the slot; a row that
//   passes several signatures takes a hand-off for each, so many such rows
//   are slow.  Per block: one copy, shared-memory atomics (a float
//   add there is a compare-and-swap loop).  Past what a block holds (~56 k
//   slots less the staging), global atomics.  So one signature over more
//   than ~84 slots (G > 42 for a COUNT, SUM block), or several over more
//   than ~2,000, take atomics and are not bit-reproducible.
// * No global float atomics below that: each block's copies are combined
//   in a fixed order into its partial in a workspace the wrapper
//   owns; after a grid-wide barrier (a cooperative launch, so the blocks
//   are co-resident; the counter resets itself) every block combines a
//   share of the slots over all partials in a fixed order, and writes the
//   output: the identity where no row reached a slot, MIN/MAX keys decoded.
//   One launch, no fill or decode pass.
//
// Numerics.  Sums accumulate in f32, as on the TPU.  With per-thread and
// per-warp slots SUM and MIN/MAX are bit-reproducible by construction:
// every value takes a fixed path.  With per-block slots shared-memory
// atomics add in the hardware's order, and in the global tier also across
// blocks, so sums may differ in their last bits from run to run; MIN/MAX
// are exact everywhere.  A NaN stays in its
// own group: SUM propagates it through the add, MIN/MAX keep a NaN flag
// folded into the ordered-integer key, with no float comparison against
// NaN.  Kernel A has two mask contracts: `select` (masked-out rows reach no
// group) and multiply (SUM adds value*mask, so a masked-out NaN still
// poisons its group, as seg_agg_ref does).
//
// Plain C interface, bound with ctypes.  Every launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "../../csrc/hopper_ptx.cuh"

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

// ---------------------------------------------------------------- kernel B

constexpr int kFusedThreads = 256;
constexpr int kFusedWarps = kFusedThreads / 32;
constexpr int kStages = 2;            // row tiles staged per block: one in flight
constexpr int kRowsPerThread = 4;     // rows a thread tests at once, their chains interleaved
constexpr int kCombineSlots = 64;     // slots per combine step, at most
constexpr size_t kSmemLimit = 232448; // dynamic shared memory a block may use
enum Tier { kPerThread = 0, kPerWarp = 1, kPerBlock = 2, kGlobal = 3 };

__device__ __forceinline__ float combine_op(int op, float a, float b) {
  if (op == kOpSum) return a + b;
  const int x = __float_as_int(a), y = __float_as_int(b);
  return __int_as_float(op == kOpMin ? min(x, y) : max(x, y));
}

// An accumulated slot as the output value: MIN/MAX keys decoded, the NaN
// flag to NaN.
template <int OP>
__device__ __forceinline__ float finish(float v) {
  if (OP == kOpSum) return v;
  const int k = __float_as_int(v);
  return k == (OP == kOpMin ? kNanMin : kNanMax) ? __int_as_float(0x7fc00000) : key_value(k);
}

// A row's M values v into slots base.. of the tier's copy: a thread's own
// (per thread: slot i at i * 256 + thread) with plain loads and stores,
// four columns at a time; one shared with other threads by atomics.
template <int OP, int TIER>
__device__ __forceinline__ void add_row(float* q, const float* v, int m) {
  if (TIER == kPerThread) {
    for (int c0 = 0; c0 < m; c0 += 4) {
      float old[4], add[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u < m) {
          old[u] = q[(c0 + u) * kFusedThreads];
          add[u] = v[c0 + u];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (c0 + u < m) {
          const int key = isnan(add[u]) ? (OP == kOpMin ? kNanMin : kNanMax) : ordered_key(add[u]);
          q[(c0 + u) * kFusedThreads] =
              OP == kOpSum ? old[u] + add[u] : combine_op(OP, old[u], __int_as_float(key));
        }
      }
    }
  } else {
    for (int c = 0; c < m; ++c) accumulate<OP>(q + c, v[c]);
  }
}

// R rows per lane into this warp's own copy, row i's at slot key[i] * M
// (key < 0: no slot).  For each row index, the lanes of one key hand their
// values to the lowest of them, in lane order; it adds the sum to the slot
// with a plain load and store (no other lane of the warp writes that slot
// in this step, and no other warp touches the copy), the rows in order,
// each after the warp's writes for the one before.  The R rows' matches
// and shuffles are independent, so their latencies overlap.  Every lane of
// the warp calls this together.
template <int OP, int R>
__device__ __forceinline__ void add_warp(float* wslots, const int (&key)[R],
                                         const float* const (&v)[R], int m) {
  const int lane = threadIdx.x % 32;
  unsigned peers[R];
  int steps[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned active = __ballot_sync(0xffffffffu, key[i] >= 0);
    peers[i] = 1u << lane;
    if (key[i] >= 0) peers[i] = __match_any_sync(active, key[i]);
    steps[i] = active ? __reduce_max_sync(0xffffffffu, key[i] >= 0 ? __popc(peers[i]) - 1 : 0)
                      : 0;
  }
  for (int c0 = 0; c0 < m; c0 += 4) {  // four columns at a time
    float acc[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mine[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float x = c0 + u < m ? v[i][c0 + u] : 0.0f;
        if (OP != kOpSum)
          x = __int_as_float(isnan(x) ? (OP == kOpMin ? kNanMin : kNanMax) : ordered_key(x));
        mine[u] = acc[i][u] = x;
      }
      unsigned rest = peers[i] & (peers[i] - 1);  // the lanes after the lowest
      for (int t = 0; t < steps[i]; ++t) {
        const int src = rest ? __ffs(rest) - 1 : lane;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c0 + u < m) {
            const float o = __shfl_sync(0xffffffffu, mine[u], src);
            if (rest) acc[i][u] = combine_op(OP, acc[i][u], o);
          }
        }
        rest &= rest - 1;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (key[i] >= 0 && __ffs(peers[i]) - 1 == lane) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c0 + u < m) {
            float* q = wslots + key[i] * m + c0 + u;
            *q = combine_op(OP, *q, acc[i][u]);
          }
        }
      }
      __syncwarp();  // row i's writes land before row i + 1 reads: its lead may differ
    }
  }
}

// Every block of the (co-resident) grid waits here until all have arrived.
// bar[0] counts arrivals and is reset by the last; bar[1] is the generation
// the others wait to see change.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int mine = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      bar[0] = 0;
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == mine) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// Kernel B: values (N, M), ids (N,), pred (N, P), bounds (S, P, K, 2)
// -> out (S, G, M); part: gridDim.x partials of S*G*M slots (not the
// global tier); bar: the grid barrier's two counters.
template <int OP, int TIER>
__global__ void __launch_bounds__(kFusedThreads)
seg_agg_fused_kernel(const float* __restrict__ values, const int* __restrict__ ids,
                     const float* __restrict__ pred, const float* __restrict__ bounds,
                     float* __restrict__ out, float* __restrict__ part,
                     unsigned int* __restrict__ bar, long long n, int m, int p, int k,
                     int s_count, int num_groups, int rows) {
  // slot indices fit an int below the global tier (the slots are in shared memory)
  using Idx = std::conditional_t<TIER == kGlobal, long long, int>;
  extern __shared__ __align__(16) float smem[];
  const int nb = s_count * p * k * 2;
  const int stage_floats = rows * (1 + m + p);
  float* sb = smem;
  float* stages = smem + ((nb + 3) & ~3);
  float* slots = stages + kStages * stage_floats;
  const long long nslots = (long long)s_count * num_groups * m;
  const int tid = threadIdx.x;
  const float ident = __int_as_float(identity_bits(OP));
  for (int i = tid; i < nb; i += kFusedThreads) sb[i] = bounds[i];
  if (TIER != kGlobal) {
    const long long copies = TIER == kPerThread ? kFusedThreads : TIER == kPerWarp ? kFusedWarps : 1;
    for (long long i = tid; i < copies * nslots; i += kFusedThreads) slots[i] = ident;
  }

  // row tile t of this block (tile blockIdx.x + t * gridDim.x) into stage st:
  // ids, then values, then predicate columns, each copied whole
  const long long tiles = (n + rows - 1) / rows;
  const long long mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto copy = [&](float* dst, const float* src, int floats) {
    for (int q = 4 * tid; q < floats; q += 4 * kFusedThreads)
      ptx::cp_async16(dst + q, src + q, min(floats - q, 4) * 4);
  };
  auto stage = [&](long long t, int st) {
    float* dst = stages + st * stage_floats;
    const long long row0 = (blockIdx.x + t * gridDim.x) * rows;
    const int nr = (int)lmin(rows, n - row0);
    copy(dst, reinterpret_cast<const float*>(ids) + row0, nr);
    copy(dst + rows, values + row0 * m, nr * m);
    copy(dst + rows * (1 + m), pred + row0 * p, nr * p);
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < mine) stage(st, st);
    ptx::cp_async_commit();
  }
  __syncthreads();  // bounds and slots initialised

  const unsigned long long all = s_count >= 64 ? ~0ull : ((1ull << s_count) - 1ull);
  for (long long t = 0; t < mine; ++t) {
    ptx::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is staged; every thread is done with tile t - 1
    if (t + kStages - 1 < mine) stage(t + kStages - 1, (int)((t + kStages - 1) % kStages));
    ptx::cp_async_commit();  // the next tile's copies run under this tile's work
    const float* st = stages + (t % kStages) * stage_floats;
    const int* sid = reinterpret_cast<const int*>(st);
    const float* sv = st + rows;
    const float* sp = st + rows * (1 + m);
    const int nr = (int)lmin(rows, n - (blockIdx.x + t * gridDim.x) * rows);
    // kRowsPerThread rows at a time (tid + i * 256): every test is done for
    // all of them, without a branch, so their load and compare chains
    // overlap; a warp runs the loop together (rows past nr reach no slot)
    for (int r0 = tid; r0 - tid % 32 < nr; r0 += kFusedThreads * kRowsPerThread) {
      int g[kRowsPerThread];
      unsigned long long pass[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = r0 + i * kFusedThreads;
        g[i] = r < nr ? sid[r] : -1;
        pass[i] = g[i] >= 0 && g[i] < num_groups ? all : 0ull;
      }
      for (int j = 0; j < p; ++j) {
        float x[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          x[i] = sp[min(r0 + i * kFusedThreads, nr - 1) * p + j];
        // bitwise, not short-circuit, operators: every test without a branch
        for (int s = 0; s < s_count; ++s) {
          const float* b = sb + (s * p + j) * k * 2;
          const unsigned long long miss = ~(1ull << s);
          int hit[kRowsPerThread] = {};
          for (int q = 0; q < k; ++q) {
            const float lo = b[2 * q], hi = b[2 * q + 1];
            const int lo_nan = isnan(lo);
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
              hit[i] |= ((x[i] >= lo) & (x[i] <= hi)) | (lo_nan & isnan(x[i]));
          }
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) pass[i] &= hit[i] ? ~0ull : miss;
        }
      }
      if (TIER == kPerWarp) {
        // the 4 rows together, each row's passing signatures one per call
        float* wslots = slots + (tid / 32) * nslots;
        const float* v[kRowsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          v[i] = sv + min(r0 + i * kFusedThreads, nr - 1) * m;
        for (;;) {
          unsigned long long left = 0;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) left |= pass[i];
          if (!__any_sync(0xffffffffu, left != 0ull)) break;
          int key[kRowsPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            const int s = pass[i] ? __ffsll((long long)pass[i]) - 1 : -1;
            pass[i] &= pass[i] - 1ull;
            key[i] = s < 0 ? -1 : s * num_groups + g[i];
          }
          add_warp<OP, kRowsPerThread>(wslots, key, v, m);
        }
      } else {
        // signature by signature (any row's), the rows unrolled
        unsigned long long any = 0;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) any |= pass[i];
        while (any) {
          const int s = __ffsll((long long)any) - 1;
          any &= any - 1ull;
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            if ((pass[i] >> s) & 1ull) {
              const Idx base = ((Idx)s * num_groups + g[i]) * m;
              add_row<OP, TIER>(TIER == kGlobal      ? out + base
                                : TIER == kPerThread ? slots + base * kFusedThreads + tid
                                                     : slots + base,
                                sv + (r0 + i * kFusedThreads) * m, m);
            }
          }
        }
      }
    }
  }
  ptx::cp_async_wait<0>();
  if (TIER == kGlobal) return;
  __syncthreads();

  // this block's partial, its copies combined in a fixed order: a slot's
  // 256 thread copies over each lane's 8 threads, then across the lanes of
  // the warp; or its 8 warp copies in order
  float* own = part + (long long)blockIdx.x * nslots;
  if (TIER == kPerThread) {
    const int warp = tid / 32, lane = tid % 32;
    for (long long i = warp; i < nslots; i += kFusedWarps) {
      const float* q = slots + i * kFusedThreads + lane;
      float v = q[0];
#pragma unroll
      for (int w = 1; w < kFusedWarps; ++w) v = combine_op(OP, v, q[32 * w]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v = combine_op(OP, v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) own[i] = v;
    }
  } else {
    for (long long i = tid; i < nslots; i += kFusedThreads) {
      float v = slots[i];
      if (TIER == kPerWarp)
        for (int w = 1; w < kFusedWarps; ++w) v = combine_op(OP, v, slots[w * nslots + i]);
      own[i] = v;
    }
  }
  grid_barrier(bar);

  // every block takes steps of cs slots (8 to 64: the fewest that still
  // give every block a step): thread (slot, f) folds the partials of the
  // f-th of 256 / cs ranges of blocks in order, then the ranges are folded
  // in order
  int cs = 8;
  while (cs < kCombineSlots && (long long)cs * gridDim.x < nslots) cs *= 2;
  const int folders = kFusedThreads / cs, jl = tid % cs, f = tid / cs;
  const int b0 = f * (int)gridDim.x / folders, b1 = (f + 1) * (int)gridDim.x / folders;
  float* sq = stages;  // the staging ring is free now
  for (long long base = (long long)blockIdx.x * cs; base < nslots;
       base += (long long)gridDim.x * cs) {
    const long long i = base + jl;
    float v = ident;
    if (i < nslots) {
#pragma unroll 8
      for (int blk = b0; blk < b1; ++blk) v = combine_op(OP, v, __ldcg(part + blk * nslots + i));
    }
    sq[tid] = v;
    __syncthreads();
    if (f == 0 && i < nslots) {
      for (int ff = 1; ff < folders; ++ff) v = combine_op(OP, v, sq[ff * cs + jl]);
      out[i] = finish<OP>(v);
    }
    __syncthreads();
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

template <int OP, bool SELECT>
cudaError_t launch_a(const float* values, const int* ids, const float* mask,
                     float* out, long long n, int m, int num_groups,
                     cudaStream_t stream) {
  Plan pl = make_plan(n, num_groups, m, 0);
  static std::atomic<unsigned long long> smem_ready{0};
  cudaError_t err = ptx::allow_dynamic_smem(
      seg_agg_kernel<OP, SELECT>, (int)(kSmemSlots * sizeof(float)), smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)pl.blocks, (unsigned)pl.tiles);
  seg_agg_kernel<OP, SELECT><<<grid, kThreads, pl.smem_bytes, stream>>>(
      values, ids, mask, out, n, m, num_groups, pl.tile_groups,
      pl.rows_per_block, pl.use_smem);
  return cudaSuccess;
}

// Kernel B's launch at one shape: its slot tier, row tile, shared memory,
// grid and workspace.
struct FusedPlan {
  int tier;
  int rows;
  size_t smem;
  int grid;
  long long workspace;  // floats of block partials (0 in the global tier)
};

template <int OP, int TIER>
cudaError_t fused_grid(size_t smem, long long tiles, int* grid) {
  static std::atomic<unsigned long long> smem_ready{0};
  cudaError_t err = ptx::allow_dynamic_smem(seg_agg_fused_kernel<OP, TIER>, (int)kSmemLimit,
                                            smem_ready);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seg_agg_fused_kernel<OP, TIER>, kFusedThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // at most 4 blocks per SM: enough tiles in flight, few partials to combine
  const long long cap = (long long)(per_sm < 4 ? per_sm : 4) * sm_count();
  *grid = (int)(tiles < 1 ? 1 : (tiles < cap ? tiles : cap));
  return cudaSuccess;
}

template <int OP>
cudaError_t plan_b(long long n, int m, int p, int k, int s_count, int num_groups,
                   FusedPlan* pl) {
  // row tiles of 1024 rows (each thread 4) where they fit in 48 KB, else 256
  const int cols = 1 + m + p;
  const int rows = cols <= 12 ? 1024 : 256;
  const size_t fixed = sizeof(float) * (((size_t)s_count * p * k * 2 + 3) / 4 * 4 +
                                        (size_t)kStages * rows * cols);
  if (fixed > kSmemLimit) return cudaErrorInvalidValue;
  const size_t avail = kSmemLimit - fixed;
  const long long slots = (long long)s_count * num_groups * m;
  const size_t bytes = sizeof(float) * (size_t)slots;
  // the first tier that leaves room for two blocks per SM.  One signature
  // past the per-thread slots takes per-block ones: its rows reach one slot
  // each at most, mostly a distinct one per lane, where the per-warp
  // hand-off costs more than an uncontended atomic.  Several signatures
  // take per-warp slots there.
  if (2 * (fixed + bytes * kFusedThreads) <= kSmemLimit) {
    pl->tier = kPerThread;
    pl->smem = fixed + bytes * kFusedThreads;
  } else if (s_count > 1 && 2 * (fixed + bytes * kFusedWarps) <= kSmemLimit) {
    pl->tier = kPerWarp;
    pl->smem = fixed + bytes * kFusedWarps;
  } else if (bytes <= avail) {
    pl->tier = kPerBlock;
    pl->smem = fixed + bytes;
  } else {
    pl->tier = kGlobal;
    pl->smem = fixed;
  }
  pl->rows = rows;
  const long long tiles = (n + rows - 1) / rows;
  cudaError_t err;
  switch (pl->tier) {
    case kPerThread: err = fused_grid<OP, kPerThread>(pl->smem, tiles, &pl->grid); break;
    case kPerWarp: err = fused_grid<OP, kPerWarp>(pl->smem, tiles, &pl->grid); break;
    case kPerBlock: err = fused_grid<OP, kPerBlock>(pl->smem, tiles, &pl->grid); break;
    default: err = fused_grid<OP, kGlobal>(pl->smem, tiles, &pl->grid); break;
  }
  pl->workspace = pl->tier == kGlobal ? 0 : (long long)pl->grid * slots;
  return err;
}

cudaError_t plan_any(long long n, int m, int p, int k, int s_count, int num_groups, int op,
                     FusedPlan* pl) {
  if (op == kOpSum) return plan_b<kOpSum>(n, m, p, k, s_count, num_groups, pl);
  if (op == kOpMin) return plan_b<kOpMin>(n, m, p, k, s_count, num_groups, pl);
  if (op == kOpMax) return plan_b<kOpMax>(n, m, p, k, s_count, num_groups, pl);
  return cudaErrorInvalidValue;
}

template <int OP, int TIER>
cudaError_t launch_b(const float* values, const int* ids, const float* pred,
                     const float* bounds, float* out, float* part, unsigned int* bar,
                     long long n, int m, int p, int k, int s_count, int num_groups,
                     const FusedPlan& pl, cudaStream_t stream) {
  int rows = pl.rows;
  if (TIER == kGlobal) {  // global atomics: the output filled before, decoded after
    const long long total = (long long)s_count * num_groups * m;
    fill_output(out, total, OP, stream);
    seg_agg_fused_kernel<OP, TIER><<<pl.grid, kFusedThreads, pl.smem, stream>>>(
        values, ids, pred, bounds, out, part, bar, n, m, p, k, s_count, num_groups, rows);
    decode_output(out, total, OP, stream);
    return cudaGetLastError();
  }
  void* args[] = {&values, &ids, &pred, &bounds, &out, &part, &bar, &n, &m, &p, &k,
                  &s_count, &num_groups, &rows};
  return cudaLaunchCooperativeKernel((const void*)seg_agg_fused_kernel<OP, TIER>,
                                     dim3(pl.grid), dim3(kFusedThreads), args, pl.smem,
                                     stream);
}

template <int OP>
cudaError_t launch_b_op(const float* values, const int* ids, const float* pred,
                        const float* bounds, float* out, float* part, unsigned int* bar,
                        long long n, int m, int p, int k, int s_count, int num_groups,
                        const FusedPlan& pl, cudaStream_t stream) {
  switch (pl.tier) {
    case kPerThread:
      return launch_b<OP, kPerThread>(values, ids, pred, bounds, out, part, bar, n, m, p, k,
                                      s_count, num_groups, pl, stream);
    case kPerWarp:
      return launch_b<OP, kPerWarp>(values, ids, pred, bounds, out, part, bar, n, m, p, k,
                                    s_count, num_groups, pl, stream);
    case kPerBlock:
      return launch_b<OP, kPerBlock>(values, ids, pred, bounds, out, part, bar, n, m, p, k,
                                     s_count, num_groups, pl, stream);
    default:
      return launch_b<OP, kGlobal>(values, ids, pred, bounds, out, part, bar, n, m, p, k,
                                   s_count, num_groups, pl, stream);
  }
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

// Kernel B's plan at this shape: returns its slot tier (0 per thread, 1 per
// warp, 2 per block, 3 global atomics; < 0: -(CUDA error)) and writes the
// floats of workspace a launch needs (its block partials).
int seg_agg_fused_plan(long long n, int m, int p, int k, int s_count, int num_groups,
                       int op, long long* workspace) {
  FusedPlan pl;
  const cudaError_t err = plan_any(n, m, p, k, s_count, num_groups, op, &pl);
  if (err != cudaSuccess) return -(int)err;
  *workspace = pl.workspace;
  return pl.tier;
}

// bounds (S, P, K, 2) f32; out (S, G, M).  1 <= S <= 64.  values, ids and
// pred start on 16-byte boundaries.  work: the floats seg_agg_fused_plan
// asks for; bar: two unsigned ints, zero before the first launch (each
// launch leaves them so).  Launches on one stream may share both.
int seg_agg_fused_launch(const float* values, const int* ids,
                         const float* pred, const float* bounds, float* out,
                         long long n, int m, int p, int k, int s_count,
                         int num_groups, int op, void* stream_ptr, float* work,
                         unsigned int* bar) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if ((long long)s_count * num_groups * m <= 0) return (int)cudaSuccess;
  FusedPlan pl;
  cudaError_t err = plan_any(n, m, p, k, s_count, num_groups, op, &pl);
  if (err != cudaSuccess) return (int)err;
  if (op == kOpSum) {
    err = launch_b_op<kOpSum>(values, ids, pred, bounds, out, work, bar, n, m, p, k, s_count,
                              num_groups, pl, stream);
  } else if (op == kOpMin) {
    err = launch_b_op<kOpMin>(values, ids, pred, bounds, out, work, bar, n, m, p, k, s_count,
                              num_groups, pl, stream);
  } else {
    err = launch_b_op<kOpMax>(values, ids, pred, bounds, out, work, bar, n, m, p, k, s_count,
                              num_groups, pl, stream);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
