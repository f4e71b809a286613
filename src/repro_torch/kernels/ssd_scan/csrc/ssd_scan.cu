// Chunked Mamba2 SSD scan (state-space duality), for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_ssd_kernel` in
// repro/kernels/ssd_scan/kernel.py (wrapper `ssd_scan_pallas`).
//
//   x (B, S, H, P) f32 or bf16, dt (B, S, H) f32, A (H,) f32,
//   Bm and Cm (B, S, N) f32 (one state group, shared by the H heads)
//   -> y (B, S, H, P) in x's dtype, and optionally the final state
//      (B, H, P, N) f32.
//
// Per head h with state S (P, N): S_t = exp(A dt_t) S_{t-1} + dt_t x_t B_tᵀ,
// y_t = S_t C_t.  Chunked over kL = 32 time steps, with cum the inclusive
// cumsum of A dt inside the chunk:
//
//   y_t  = exp(cum_t) (S C_t)                      (the carried state)
//          + sum_{s<=t} G[t][s] exp(cum_t - cum_s) dt_s x_s,  G = C Bᵀ
//   S   <- exp(cum_L) S + sum_s (w_s x_s) B_sᵀ,  w_s = dt_s exp(cum_L - cum_s)
//
// What bounds it on this card: bytes (x, y, B, C, dt once, the state out),
// once the products run on the tensor cores; on the CUDA cores (PR 13's
// design, 2 x 4 register tiles fed from shared memory) it ran at a third of
// the f32 FMA rate at best and 13x its bound.  The design:
//
// * Every product runs on the tensor cores (mma.sync) with f32
//   accumulation, each f32 operand split into a hi and a lo half and three
//   products summed (lo hi + hi lo + hi hi), so the numbers stay
//   f32-class: in the bf16 instance (the serving dtype) bf16 halves and
//   m16n8k16, ~16 bits of each operand; in the f32 instance (the check
//   dtype) tf32 halves and m16n8k8 ("3xTF32"), ~20 bits.  A bf16 x is
//   exact in either: M x takes two products.  Each 16-deep step gives a
//   thread the same elements in both (k = 2 t4, 2 t4 + 1, 2 t4 + 8,
//   2 t4 + 9), so one code path drives both.
// * One block per (batch row, group of 192 / P heads): 12 warps, each owning
//   16 rows of one head's state (P, N) in its accumulator registers for the
//   whole sequence.  The state never goes through memory: the carried
//   state's part is computed transposed, yᵀ = S Cᵀ, with the accumulator
//   fragments as the A operand, and the update S += (x w)ᵀ B accumulates
//   into it.  At mamba2's shapes (B 8, H 48, P 64) that is 128 blocks, one
//   wave on 132 SMs.
// * G = C Bᵀ, its causal 16 x 8 tiles only, once per (batch row, chunk) for
//   all the block's heads (12 warps: 6 tiles x 2 halves of N); each head's
//   M = G exp(cum_t - cum_s) dt_s is formed in registers as the B operand
//   of yᵀ += xᵀ Mᵀ.
// * The cumsum is a warp-parallel scan (one warp per head, one step per
//   lane).  Only differences <= 0 are exponentiated: exp(cum_t - cum_s) for
//   s <= t, exp(cum_L - cum_s) and exp(cum_t) inside the chunk; the factored
//   exp(cum_t) exp(-cum_s) never appears (at mamba2's init cum falls by up
//   to ~16 per step and that form overflows).
// * The next chunk's B, C, x and dt are copied into the second of two
//   shared-memory buffers with cp.async while the current chunk computes;
//   two __syncthreads per chunk.
// * A short last chunk is zero-filled in shared memory (dt = 0 and zero B,
//   C, x leave the state unchanged), its empty steps' tiles are skipped, and
//   nothing at or past S is read or written.
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "../../csrc/hopper_ptx.cuh"

namespace {

constexpr int kL = 32;               // time steps per chunk: one per lane in the scan
constexpr int kWarps = 12;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxN = 128;           // state size: a multiple of 16 up to this
constexpr int kNK = kMaxN / 8;       // n-tiles of the state
constexpr int kLDB = kMaxN + 4;      // B rows, floats: 4 (mod 16), conflict-free by step rows
constexpr int kLDC = kMaxN + 8;      // C rows, floats: 8 (mod 32), conflict-free 8-byte pairs
constexpr int kLDG = kL + 8;         // G rows, floats: 8 (mod 32)
constexpr int kTiles = kL / 8;       // n-tiles (t) of a chunk
constexpr int kGTiles = 6;           // causal 16 x 8 tiles of G: m-tile 0 x n 0-1, 1 x 0-3
static_assert(kWarps == 2 * kGTiles, "each warp takes one G tile over half of N");
static_assert(kL == 32, "the scan gives each lane one step");

template <typename T, int P>
struct Shape {
  static constexpr int kWarpsPerHead = P / 16;
  static constexpr int kHeads = kWarps / kWarpsPerHead;  // heads per block
  // x rows, elements: 16-byte rows, conflict-free step fragments
  static constexpr int kLDX = P + 16 / (int)sizeof(T);
};

template <typename T, int P>
constexpr size_t smem_bytes() {
  using S = Shape<T, P>;
  return sizeof(float) * (2 * kL * (kLDB + kLDC) + 2 * kL * kLDG + 2 * kL * S::kHeads +
                          3 * S::kHeads * kL) +
         sizeof(T) * 2 * S::kHeads * kL * S::kLDX;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-deep step of a product, the thread's share in f32: the A rows g and
// g + 8 (a[0], a[1]) and the B column g, each at k = 2 t4, 2 t4 + 1,
// 2 t4 + 8, 2 t4 + 9 (index j: k = 2 t4 + (j & 1) + 8 (j >> 1)).
__device__ __forceinline__ int koff(int j, int t4) { return 2 * t4 + (j & 1) + 8 * (j >> 1); }

// bf16 halves, one m16n8k16 product per term: a = {(g, k 0-1), (g+8, k 0-1),
// (g, k 8-9), (g+8, k 8-9)}, b = {k 0-1, k 8-9}, as ptx::mma_bf16 takes them
struct Bf16Ops {
  struct A {
    uint32_t hi[4], lo[4];
  };
  static __device__ __forceinline__ void pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    hi = ptx::pack_bf16(x0, x1);
    lo = ptx::pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
  }
  static __device__ __forceinline__ A split(const float (&a)[2][4]) {
    A r;
    pair(a[0][0], a[0][1], r.hi[0], r.lo[0]);
    pair(a[1][0], a[1][1], r.hi[1], r.lo[1]);
    pair(a[0][2], a[0][3], r.hi[2], r.lo[2]);
    pair(a[1][2], a[1][3], r.hi[3], r.lo[3]);
    return r;
  }
  // d += a b: lo hi (unless a is exact in its hi half), hi lo, hi hi
  template <bool kAExact>
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const float (&b)[4]) {
    uint32_t h0, l0, h1, l1;
    pair(b[0], b[1], h0, l0);
    pair(b[2], b[3], h1, l1);
    if constexpr (!kAExact) ptx::mma_bf16(d, a.lo, h0, h1);
    ptx::mma_bf16(d, a.hi, l0, l1);
    ptx::mma_bf16(d, a.hi, h0, h1);
  }
};

// tf32 halves, two m16n8k8 products per term: step h takes k 2 t4 + 8h as
// its t4 and 2 t4 + 8h + 1 as its t4 + 4 (a permutation of k that A and B
// share), so a = {(g, j 2h), (g+8, j 2h), (g, j 2h+1), (g+8, j 2h+1)}
struct Tf32Ops {
  struct A {
    uint32_t hi[2][4], lo[2][4];
  };
  static __device__ __forceinline__ A split(const float (&a)[2][4]) {
    A r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {a[0][2 * h], a[1][2 * h], a[0][2 * h + 1], a[1][2 * h + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const ptx::Tf32Pair p = ptx::tf32_split(v[i]);
        r.hi[h][i] = p.hi;
        r.lo[h][i] = p.lo;
      }
    }
    return r;
  }
  template <bool kAExact>
  static __device__ __forceinline__ void mma(float (&d)[4], const A& a, const float (&b)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const ptx::Tf32Pair c0 = ptx::tf32_split(b[2 * h]), c1 = ptx::tf32_split(b[2 * h + 1]);
      if constexpr (!kAExact) ptx::mma_tf32(d, a.lo[h], c0.hi, c1.hi);
      ptx::mma_tf32(d, a.hi[h], c0.lo, c1.lo);
      ptx::mma_tf32(d, a.hi[h], c0.hi, c1.hi);
    }
  }
};

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ final_state, int heads, int seq, int n_state) {
  using Sh = Shape<T, P>;
  using Ops = std::conditional_t<sizeof(T) == 2, Bf16Ops, Tf32Ops>;
  constexpr int HG = Sh::kHeads, LDX = Sh::kLDX;
  constexpr bool kXExact = sizeof(T) == 2;  // a bf16 x is exact in either half format
  constexpr int kXPiece = 16 / (int)sizeof(T);  // x elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sB = reinterpret_cast<float*>(smem_raw);  // [2][kL][kLDB]
  float* sC = sB + 2 * kL * kLDB;                   // [2][kL][kLDC]
  float* sG = sC + 2 * kL * kLDC;                   // [2][kL][kLDG] over the halves of N
  float* sDt = sG + 2 * kL * kLDG;                  // [2][kL][HG]
  float* sCum = sDt + 2 * kL * HG;                  // [HG][kL]
  float* sE = sCum + HG * kL;                       // [HG][kL] exp(cum_t)
  float* sW = sE + HG * kL;                         // [HG][kL] w_s
  T* sX = reinterpret_cast<T*>(sW + HG * kL);       // [2][HG][kL][LDX]

  const int N = n_state, nk16 = N / 16;
  const int groups = (heads + HG - 1) / HG;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x % groups) * HG;
  const int nh = min(HG, heads - h0);  // heads of this block
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int j = warp / Sh::kWarpsPerHead;          // this warp's head in the block
  const int p0 = (warp % Sh::kWarpsPerHead) * 16;  // its 16 rows of the state
  const int h = h0 + j;
  const bool live = j < nh;
  const int nchunks = (seq + kL - 1) / kL;

  // copy chunk c into buffer c % 2, zero-filled past seq and past the
  // block's heads (nothing there is read)
  auto stage = [&](int c) {
    const int buf = c & 1, t0 = c * kL, len = min(kL, seq - t0);
    const long long row0 = (long long)b * seq + t0;
    const int qn = N / 4;
    for (int i = tid; i < kL * qn; i += kThreads) {
      const int r = i / qn, q = i % qn;
      const bool in = r < len;
      const long long off = in ? (row0 + r) * N + 4 * q : 0;
      ptx::cp_async16(sB + (buf * kL + r) * kLDB + 4 * q, Bm + off, in ? 16 : 0);
      ptx::cp_async16(sC + (buf * kL + r) * kLDC + 4 * q, Cm + off, in ? 16 : 0);
    }
    constexpr int qx = P / kXPiece;
    for (int i = tid; i < HG * kL * qx; i += kThreads) {
      const int jj = i / (kL * qx), r = (i / qx) % kL, q = i % qx;
      const bool in = r < len && jj < nh;
      const long long off = in ? ((row0 + r) * heads + h0 + jj) * P + q * kXPiece : 0;
      ptx::cp_async16(sX + ((buf * HG + jj) * kL + r) * LDX + q * kXPiece, x + off,
                      in ? 16 : 0);
    }
    for (int i = tid; i < kL * HG; i += kThreads) {
      const int r = i / HG, jj = i % HG;
      const bool in = r < len && jj < nh;
      ptx::cp_async4(sDt + (buf * kL + r) * HG + jj, dt + (in ? (row0 + r) * heads + h0 + jj : 0),
                     in ? 4 : 0);
    }
  };

  // this warp's 16 rows of its head's state: n-tile k in accS[k], rows
  // p0 + g (elements 0, 1) and p0 + g + 8 (2, 3), columns 8k + 2 t4 (+1)
  float accS[kNK][4];
#pragma unroll
  for (int k = 0; k < kNK; ++k) accS[k][0] = accS[k][1] = accS[k][2] = accS[k][3] = 0.0f;

  if (nchunks > 0) stage(0);
  ptx::cp_async_commit();
  for (int c = 0; c < nchunks; ++c) {
    const int buf = c & 1, t0 = c * kL, len = min(kL, seq - t0);
    ptx::cp_async_wait<0>();
    __syncthreads();  // chunk c is staged; every read of the other buffer is done
    if (c + 1 < nchunks) stage(c + 1);
    ptx::cp_async_commit();  // the next chunk's copies run under this chunk's work
    const float* cB = sB + buf * kL * kLDB;
    const float* cC = sC + buf * kL * kLDC;
    const float* cDt = sDt + buf * kL * HG;
    const T* cX = sX + buf * HG * kL * LDX;

    // per head (one warp each): cum = inclusive scan of A dt, exp(cum_t), w_s
    if (warp < nh) {
      const float d = cDt[lane * HG + warp];
      float v = A[h0 + warp] * d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += o;
      }
      const float last = __shfl_sync(0xffffffffu, v, 31);
      sCum[warp * kL + lane] = v;
      sE[warp * kL + lane] = expf(v);
      sW[warp * kL + lane] = d * expf(last - v);
    }
    // G = C Bᵀ, the causal tiles that reach a step of the chunk, each warp
    // one tile over one half of N (the halves summed where G is read)
    {
      const int i = warp % kGTiles, half = warp / kGTiles;
      const int tr = i < 2 ? 0 : 16, sc = 8 * (i < 2 ? i : i - 2);
      if (tr < len) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int K = half * nk16 / 2; K < (half + 1) * nk16 / 2; ++K) {
          float a[2][4], bb[4];
#pragma unroll
          for (int q = 0; q < 4; q += 2) {
            const int k = 16 * K + koff(q, t4);
            const float2 u = *reinterpret_cast<const float2*>(cC + (tr + g) * kLDC + k);
            const float2 v = *reinterpret_cast<const float2*>(cC + (tr + g + 8) * kLDC + k);
            const float2 w = *reinterpret_cast<const float2*>(cB + (sc + g) * kLDB + k);
            a[0][q] = u.x, a[0][q + 1] = u.y, a[1][q] = v.x, a[1][q + 1] = v.y;
            bb[q] = w.x, bb[q + 1] = w.y;
          }
          Ops::template mma<false>(acc, Ops::split(a), bb);
        }
        float* gr = sG + (half * kL + tr + g) * kLDG + sc + 2 * t4;
        *reinterpret_cast<float2*>(gr) = make_float2(acc[0], acc[1]);
        *reinterpret_cast<float2*>(gr + 8 * kLDG) = make_float2(acc[2], acc[3]);
      }
    }
    __syncthreads();

    if (live) {
      const float* cum = sCum + j * kL;
      const float* E = sE + j * kL;
      const float* W = sW + j * kL;
      const T* xj = cX + j * kL * LDX + p0 + g;
      const int nt_end = (len + 7) / 8;  // tiles of 8 steps that hold a step
      // yᵀ (P, L): rows p0 + g (+8), columns t = 8 nt + 2 t4 (+1)
      float accY[kTiles][4];
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) accY[nt][0] = accY[nt][1] = accY[nt][2] = accY[nt][3] = 0.0f;

      // the carried state's part, yᵀ = S Cᵀ, with the state's accumulator as
      // the A operand (n-tiles 2K and 2K + 1 make step K), then scaled by
      // exp(cum_t)
      if (c > 0) {
#pragma unroll
        for (int K = 0; K < kNK / 2; ++K) {
          if (K < nk16) {
            float a[2][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              a[0][q] = accS[2 * K + (q >> 1)][q & 1];
              a[1][q] = accS[2 * K + (q >> 1)][2 + (q & 1)];
            }
            const typename Ops::A af = Ops::split(a);
#pragma unroll
            for (int nt = 0; nt < kTiles; ++nt) {
              if (nt < nt_end) {
                const float* cr = cC + (8 * nt + g) * kLDC + 16 * K + 2 * t4;
                const float2 u = *reinterpret_cast<const float2*>(cr);
                const float2 v = *reinterpret_cast<const float2*>(cr + 8);
                const float bb[4] = {u.x, u.y, v.x, v.y};
                Ops::template mma<false>(accY[nt], af, bb);
              }
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < kTiles; ++nt) {
          const float e0 = E[8 * nt + 2 * t4], e1 = E[8 * nt + 2 * t4 + 1];
          accY[nt][0] *= e0;
          accY[nt][1] *= e1;
          accY[nt][2] *= e0;
          accY[nt][3] *= e1;
        }
      }

      // xᵀ (rows p, k = s) of the chunk's two steps, used twice
      float xv[kL / 16][2][4];
#pragma unroll
      for (int K = 0; K < kL / 16; ++K)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const T* xr = xj + (16 * K + koff(q, t4)) * LDX;
          xv[K][0][q] = to_f32(xr[0]);
          xv[K][1][q] = to_f32(xr[8]);
        }

      // yᵀ += xᵀ Mᵀ, M[t][s] = G[t][s] exp(cum_t - cum_s) dt_s for s <= t
#pragma unroll
      for (int K = 0; K < kL / 16; ++K) {
        if (16 * K < len) {
          const typename Ops::A af = Ops::split(xv[K]);
          float cs[4], ds[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            cs[q] = cum[16 * K + koff(q, t4)];
            ds[q] = cDt[(16 * K + koff(q, t4)) * HG + j];
          }
#pragma unroll
          for (int nt = 2 * K; nt < kTiles; ++nt) {
            if (nt < nt_end) {
              const int t = 8 * nt + g;
              const float ct = cum[t];
              const float* gt = sG + t * kLDG + 16 * K + 2 * t4;
              float bb[4];
#pragma unroll
              for (int q = 0; q < 4; q += 2) {
                const float2 u = *reinterpret_cast<const float2*>(gt + 4 * q);
                const float2 v = *reinterpret_cast<const float2*>(gt + kL * kLDG + 4 * q);
                const float gq[2] = {u.x + v.x, u.y + v.y};
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  // the bf16 instance's 16-bit halves take the fast exp
                  const float d = ct - cs[q + e];
                  const float ex = kXExact ? __expf(d) : expf(d);
                  const int sq = 16 * K + koff(q + e, t4);
                  bb[q + e] = sq <= t ? gq[e] * ex * ds[q + e] : 0.0f;
                }
              }
              Ops::template mma<kXExact>(accY[nt], af, bb);
            }
          }
        }
      }

      const long long row0 = (long long)b * seq + t0;
#pragma unroll
      for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = 8 * nt + 2 * t4 + e;
          if (t < len) {
            T* yr = y + ((row0 + t) * heads + h) * P + p0 + g;
            yr[0] = from_f32<T>(accY[nt][e]);
            yr[8] = from_f32<T>(accY[nt][2 + e]);
          }
        }
      }

      // S <- exp(cum_L) S + (x w)ᵀ B
      const float total = E[kL - 1];
#pragma unroll
      for (int k = 0; k < kNK; ++k) {
        accS[k][0] *= total;
        accS[k][1] *= total;
        accS[k][2] *= total;
        accS[k][3] *= total;
      }
#pragma unroll
      for (int K = 0; K < kL / 16; ++K) {
        if (16 * K < len) {
          float a[2][4];
          const float* br[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int sq = 16 * K + koff(q, t4);
            a[0][q] = xv[K][0][q] * W[sq];
            a[1][q] = xv[K][1][q] * W[sq];
            br[q] = cB + sq * kLDB + g;
          }
          const typename Ops::A af = Ops::split(a);
#pragma unroll
          for (int nn = 0; nn < kNK; ++nn) {
            if (nn < 2 * nk16) {
              const float bb[4] = {br[0][8 * nn], br[1][8 * nn], br[2][8 * nn], br[3][8 * nn]};
              Ops::template mma<false>(accS[nn], af, bb);
            }
          }
        }
      }
    }
  }
  if (final_state != nullptr && live) {
    float* fs = final_state + ((long long)(b * heads + h) * P + p0 + g) * N + 2 * t4;
#pragma unroll
    for (int k = 0; k < kNK; ++k) {
      if (k < 2 * nk16) {
        *reinterpret_cast<float2*>(fs + 8 * k) = make_float2(accS[k][0], accS[k][1]);
        *reinterpret_cast<float2*>(fs + 8 * N + 8 * k) = make_float2(accS[k][2], accS[k][3]);
      }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, void* y, float* final_state, int batch,
                   int heads, int seq, int n_state, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, P>();
  static std::atomic<unsigned long long> smem_ready{0};
  cudaError_t err = ptx::allow_dynamic_smem(ssd_scan_kernel<T, P>, (int)smem, smem_ready);
  if (err != cudaSuccess) return err;
  const int groups = (heads + Shape<T, P>::kHeads - 1) / Shape<T, P>::kHeads;
  ssd_scan_kernel<T, P><<<(unsigned)(batch * groups), kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, Bm, Cm, static_cast<T*>(y), final_state,
      heads, seq, n_state);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_p(const void* x, const float* dt, const float* A, const float* Bm,
                       const float* Cm, void* y, float* final_state, int batch,
                       int heads, int seq, int head_dim, int n_state,
                       cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch<T, 16>(x, dt, A, Bm, Cm, y, final_state, batch, heads, seq,
                           n_state, stream);
    case 32:
      return launch<T, 32>(x, dt, A, Bm, Cm, y, final_state, batch, heads, seq,
                           n_state, stream);
    case 64:
      return launch<T, 64>(x, dt, A, Bm, Cm, y, final_state, batch, heads, seq,
                           n_state, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype (of x and y): 0 float32, 1 bfloat16.  head_dim: 16, 32 or 64;
// n_state: a multiple of 16 up to 128 (anything else is refused with
// cudaErrorInvalidValue; the Python wrapper checks first).  x, Bm and Cm
// start on 16-byte boundaries.  final_state may be null.
int ssd_scan_launch(const void* x, const float* dt, const float* A, const float* Bm,
                    const float* Cm, void* y, float* final_state, int batch,
                    int heads, int seq, int head_dim, int n_state, int dtype,
                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0 || heads <= 0) return (int)cudaSuccess;
  if (seq < 0 || n_state <= 0 || n_state > kMaxN || n_state % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)dispatch_p<float>(x, dt, A, Bm, Cm, y, final_state, batch, heads,
                                  seq, head_dim, n_state, stream);
  if (dtype == 1)
    return (int)dispatch_p<__nv_bfloat16>(x, dt, A, Bm, Cm, y, final_state, batch,
                                          heads, seq, head_dim, n_state, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
