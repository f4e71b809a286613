// Backward of causal GQA attention for Hopper, sm_90a: dQ, dK and dV from
// q, k, v, the forward's output o and its gradient dO.
//
// No Pallas kernel of the JAX package has a backward: `jax.grad` cannot
// pass `flash_attention_pallas`, and the JAX package trains by
// differentiating its jnp oracle `mha_ref` (repro/kernels/flash_attn/ref.py).
// This kernel computes that gradient (the port's plain version is
// `ref.mha_bwd_ref`) for the port's forward kernel (flash_attn.cu), which it
// leaves as it is: it recomputes the softmax statistics itself.
//
//   q, o, dO (B, H, S, Dh); k, v (B, Hkv, S, Dh); f32 or bf16
//   -> dq (B, H, S, Dh), dk, dv (B, Hkv, S, Dh) in the inputs' dtype.
//   Query head h reads KV head h / (H / Hkv); dk and dv sum over the
//   H / Hkv query heads of a KV head's group.
//
// With P = softmax(scale q k^T) (causal: keys past the row masked):
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - rowsum(dO o O)),
//   dQ = scale dS K,  dK = dS^T (scale q).
//
// Three kernels on the caller's stream, in order:
// - `flash_bwd_prep_kernel`, one block per (batch * head, tile of query
//   rows): each row's logsumexp of its scaled logits (an online max and
//   sum over the K tiles the row sees) and D = rowsum(dO o O), into a
//   float32 scratch of 2 x B x H x S.
// - `flash_bwd_dkdv_kernel`, one block per (batch * KV head, tile of keys):
//   the K and V tiles stay in shared memory while the block walks every
//   query head of the group and every query tile that sees the keys
//   (causal: from the keys' own tile on), recomputes P from the logits and
//   the row's logsumexp, and adds P^T dO and dS^T (scale q) into dV and dK,
//   held in registers across the whole group.
// - `flash_bwd_dq_kernel`, one block per (batch * head, tile of query
//   rows): the Q and dO tiles stay in shared memory while the block walks
//   the K tiles the rows see and adds dS K into dQ in registers.
// Every sum is taken in a fixed order by one thread, with no atomics, so
// two calls give the same bits.
//
// Arithmetic: every product and sum in float32 on the CUDA cores, bf16
// inputs widened to float32 as they are staged in shared memory (exact),
// q staged as q * scale (as mha_ref scales it), exp by expf; dQ, dK and dV
// accumulate in float32 and are rounded once to the inputs' dtype.  So a
// bf16 call differs from the float32 gradient of mha_ref on the same
// values only by the order of sums, the rounding of O in D (the forward's
// bf16 output) and the final rounding.
//
// What bounds it on this card: at the training shape (B 16, H 12 over 4 KV
// heads, S 192, Dh 64) the bytes in and out (q, k, v, o, dO once; dq, dk,
// dv once) take ~0.007 ms at 3.35 TB/s and the five products over the
// valid (causal) pairs take about as long at the bf16 tensor-core rate;
// this design runs them on the CUDA cores (67 TFLOP/s in f32), recomputes
// the logits three times and dP twice, and stages tiles with 2- or 4-byte
// loads.  It is the simple design that is right; tensor cores (mma.sync or
// wgmma), TMA and one pass for dK, dV and dQ are later work.
//
// Tiles: 64 rows up to head dim 128, 32 rows past it (the K, V, Q and dO
// tiles in float32 then fit in shared memory).  256 threads as 16 x 16:
// thread (ty, tx) owns rows ty + 16 i and columns (keys or dims) tx + 16 j;
// shared rows are padded by one float, so the 16 rows a half-warp reads
// fall in distinct banks.  Rows, keys and query rows past S are staged as
// zeros and masked out of P.
//
// Built for the head dims in HEAD_DIMS (those of flash_attn.cu; kernels/
// build.py's ATTN_HEAD_DIMS lists the same).  The source is compiled once
// per head dim with -DHEAD_DIM=<dh>, which defines
// flash_attn_bwd_launch_<dh>, and once without, which defines the
// dispatcher flash_attn_bwd_launch.
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "../../csrc/hopper_ptx.cuh"

#define HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(192) X(256)

#define BWD_ARGS                                                                       \
  const void *q, const void *k, const void *v, const void *o, const void *dout,       \
      void *dq, void *dk, void *dv, float *stats, int batch, int heads, int kv_heads, \
      int seq, int causal, float scale, int dtype, cudaStream_t stream
#define DECLARE_LAUNCH(dh) int flash_attn_bwd_launch_##dh(BWD_ARGS);
extern "C" {
HEAD_DIMS(DECLARE_LAUNCH)
}

#ifdef HEAD_DIM

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

// rows per tile of queries and of keys
template <int DH>
__host__ __device__ constexpr int tile_rows() {
  return DH > 128 ? 32 : 64;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// rows [r0, r0 + ROWS) of a (seq, DH) matrix, widened and times `mul`, into
// a (ROWS, DH + 1) float tile; rows at or past `seq` read as 0
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0,
                                      int seq, float mul) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < ROWS * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * LD + d] = r0 + r < seq ? widen(src[(long long)(r0 + r) * DH + d]) * mul : 0.0f;
  }
}

// s[a][c] += a-tile row (ty + 16 a) . b-tile row (tx + 16 c) over DH, for
// two pairs of tiles at once (Q K^T and dO V^T)
template <int DH, int R>
__device__ __forceinline__ void two_products(float (&s)[R][R], float (&dp)[R][R],
                                             const float* sq, const float* sk,
                                             const float* sdo, const float* sv, int ty,
                                             int tx) {
  constexpr int LD = DH + 1;
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
    for (int a = 0; a < R; ++a) {
      qv[a] = sq[(ty + 16 * a) * LD + d];
      dov[a] = sdo[(ty + 16 * a) * LD + d];
      kv[a] = sk[(tx + 16 * a) * LD + d];
      vv[a] = sv[(tx + 16 * a) * LD + d];
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
        dp[a][c] = fmaf(dov[a], vv[c], dp[a][c]);
      }
  }
}

// ---------------------------------------------------------------- prep

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ lse, float* __restrict__ dsum, int heads,
                      int kv_heads, int seq, float scale, int causal) {
  constexpr int BT = tile_rows<DH>(), LD = DH + 1, R = BT / 16;
  extern __shared__ float smem[];
  float* sq = smem;           // (BT, LD) q * scale
  float* sk = sq + BT * LD;   // (BT, LD) K tile

  const int bh = blockIdx.y;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kvh = b * kv_heads + h / (heads / kv_heads);
  const int q0 = blockIdx.x * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long hs = (long long)seq * DH;
  stage<T, DH, BT>(sq, q + bh * hs, q0, seq, scale);

  float m[R], l[R];
#pragma unroll
  for (int a = 0; a < R; ++a) m[a] = kNegInf, l[a] = 0.0f;
  const int k_end = causal ? min(seq, q0 + BT) : seq;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous K tile is consumed (and Q is staged)
    stage<T, DH, BT>(sk, k + kvh * hs, k0, seq, 1.0f);
    __syncthreads();
    float s[R][R];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < R; ++c) s[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[R], kv[R];
#pragma unroll
      for (int a = 0; a < R; ++a) {
        qv[a] = sq[(ty + 16 * a) * LD + d];
        kv[a] = sk[(tx + 16 * a) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) s[a][c] = fmaf(qv[a], kv[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int row = q0 + ty + 16 * a;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int col = k0 + tx + 16 * c;
        if (col >= seq || (causal && col > row)) s[a][c] = kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
      // a row's 16 threads are the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < R; ++c) rs += expf(s[a][c] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * expf(m[a] - m_new) + rs;
      m[a] = m_new;
    }
  }

  const T* ob = o + bh * hs;
  const T* db = dout + bh * hs;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int row = q0 + ty + 16 * a;
    float part = 0.0f;
    if (row < seq)
      for (int d = tx; d < DH; d += 16)
        part = fmaf(widen(db[(long long)row * DH + d]), widen(ob[(long long)row * DH + d]),
                    part);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
    if (tx == 0 && row < seq) {
      lse[(long long)bh * seq + row] = m[a] + logf(l[a]);
      dsum[(long long)bh * seq + row] = part;
    }
  }
}

// --------------------------------------------------------------- dK, dV

template <int DH>
constexpr int dkdv_smem_bytes() {
  constexpr int BT = tile_rows<DH>();
  return (4 * BT * (DH + 1) + 2 * BT * (BT + 1) + 2 * BT) * 4;  // K V Q dO, P dS, lse D
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dsum,
                      T* __restrict__ dk, T* __restrict__ dv, int heads, int kv_heads,
                      int seq, float scale, int causal) {
  constexpr int BT = tile_rows<DH>(), LD = DH + 1, LDP = BT + 1, R = BT / 16,
                DJ = DH / 16;
  extern __shared__ float smem[];
  float* sk = smem;              // (BT, LD) K tile
  float* sv = sk + BT * LD;      // (BT, LD) V tile
  float* sq = sv + BT * LD;      // (BT, LD) q * scale
  float* sdo = sq + BT * LD;     // (BT, LD) dO
  float* sp = sdo + BT * LD;     // (BT, LDP) P, query rows x keys
  float* sds = sp + BT * LDP;    // (BT, LDP) dS
  float* slse = sds + BT * LDP;  // (BT) logsumexp of the query rows
  float* sdsum = slse + BT;      // (BT) D of the query rows

  const int bk = blockIdx.y;  // b * kv_heads + KV head
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.x * BT;  // causal: tile 0, the most work, starts first
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long hs = (long long)seq * DH;
  stage<T, DH, BT>(sk, k + bk * hs, k0, seq, 1.0f);
  stage<T, DH, BT>(sv, v + bk * hs, k0, seq, 1.0f);

  // key rows ty + 16 i, dims tx + 16 j
  float acc_dk[R][DJ], acc_dv[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.0f;

  for (int g = 0; g < group; ++g) {
    const long long bh = (long long)b * heads + (long long)kvh * group + g;
    for (int q0 = causal ? k0 : 0; q0 < seq; q0 += BT) {
      __syncthreads();  // the previous Q, dO, P and dS tiles are consumed
      stage<T, DH, BT>(sq, q + bh * hs, q0, seq, scale);
      stage<T, DH, BT>(sdo, dout + bh * hs, q0, seq, 1.0f);
      if (threadIdx.x < BT) {
        const int row = q0 + threadIdx.x;
        slse[threadIdx.x] = row < seq ? lse[bh * seq + row] : 0.0f;
        sdsum[threadIdx.x] = row < seq ? dsum[bh * seq + row] : 0.0f;
      }
      __syncthreads();

      // query rows ty + 16 a, keys tx + 16 c
      float s[R][R], dp[R][R];
      two_products<DH, R>(s, dp, sq, sk, sdo, sv, ty, tx);
#pragma unroll
      for (int a = 0; a < R; ++a) {
        const int r = ty + 16 * a, row = q0 + r;
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int col = k0 + tx + 16 * c;
          const bool ok = row < seq && col < seq && !(causal && col > row);
          const float p = ok ? expf(s[a][c] - slse[r]) : 0.0f;
          sp[r * LDP + tx + 16 * c] = p;
          sds[r * LDP + tx + 16 * c] = p * (dp[a][c] - sdsum[r]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R], dov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = sp[r * LDP + ty + 16 * i];
          dsv[i] = sds[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dov[j] = sdo[r * LD + tx + 16 * j];
          qv[j] = sq[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_dv[i][j] = fmaf(pv[i], dov[j], acc_dv[i][j]);
            acc_dk[i][j] = fmaf(dsv[i], qv[j], acc_dk[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= seq) continue;
    T* dkr = dk + bk * hs + (long long)key * DH;
    T* dvr = dv + bk * hs + (long long)key * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkr[tx + 16 * j] = narrow<T>(acc_dk[i][j]);
      dvr[tx + 16 * j] = narrow<T>(acc_dv[i][j]);
    }
  }
}

// ------------------------------------------------------------------- dQ

template <int DH>
constexpr int dq_smem_bytes() {
  constexpr int BT = tile_rows<DH>();
  return (4 * BT * (DH + 1) + BT * (BT + 1) + 2 * BT) * 4;  // Q dO K V, dS, lse D
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dsum,
                    T* __restrict__ dq, int heads, int kv_heads, int seq, float scale,
                    int causal) {
  constexpr int BT = tile_rows<DH>(), LD = DH + 1, LDP = BT + 1, R = BT / 16,
                DJ = DH / 16;
  extern __shared__ float smem[];
  float* sq = smem;              // (BT, LD) q * scale
  float* sdo = sq + BT * LD;     // (BT, LD) dO
  float* sk = sdo + BT * LD;     // (BT, LD) K tile
  float* sv = sk + BT * LD;      // (BT, LD) V tile
  float* sds = sv + BT * LD;     // (BT, LDP) dS, query rows x keys
  float* slse = sds + BT * LDP;  // (BT)
  float* sdsum = slse + BT;      // (BT)

  const int bh = blockIdx.y;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kvh = b * kv_heads + h / (heads / kv_heads);
  // causal: the tiles with the most K tiles start first
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * BT;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long hs = (long long)seq * DH;
  stage<T, DH, BT>(sq, q + bh * hs, q0, seq, scale);
  stage<T, DH, BT>(sdo, dout + bh * hs, q0, seq, 1.0f);
  if (threadIdx.x < BT) {
    const int row = q0 + threadIdx.x;
    slse[threadIdx.x] = row < seq ? lse[(long long)bh * seq + row] : 0.0f;
    sdsum[threadIdx.x] = row < seq ? dsum[(long long)bh * seq + row] : 0.0f;
  }

  // query rows ty + 16 i, dims tx + 16 j
  float acc[R][DJ];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  const int k_end = causal ? min(seq, q0 + BT) : seq;
  for (int k0 = 0; k0 < k_end; k0 += BT) {
    __syncthreads();  // the previous K, V and dS tiles are consumed (Q, dO staged)
    stage<T, DH, BT>(sk, k + kvh * hs, k0, seq, 1.0f);
    stage<T, DH, BT>(sv, v + kvh * hs, k0, seq, 1.0f);
    __syncthreads();

    float s[R][R], dp[R][R];
    two_products<DH, R>(s, dp, sq, sk, sdo, sv, ty, tx);
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const int r = ty + 16 * a, row = q0 + r;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int col = k0 + tx + 16 * c;
        const bool ok = row < seq && col < seq && !(causal && col > row);
        const float p = ok ? expf(s[a][c] - slse[r]) : 0.0f;
        sds[r * LDP + tx + 16 * c] = p * (dp[a][c] - sdsum[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsv[R], kv[DJ];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sds[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = sk[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    T* dqr = dq + bh * hs + (long long)row * DH;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqr[tx + 16 * j] = narrow<T>(acc[i][j] * scale);
  }
}

// ------------------------------------------------------------ launchers

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* stats, int batch,
                   int heads, int kv_heads, int seq, int causal, float scale,
                   cudaStream_t stream) {
  static std::atomic<unsigned long long> prep_ready{0}, dkdv_ready{0}, dq_ready{0};
  constexpr int BT = tile_rows<DH>();
  constexpr int prep_smem = 2 * BT * (DH + 1) * 4;
  constexpr int dkdv_smem = dkdv_smem_bytes<DH>();
  constexpr int dq_smem = dq_smem_bytes<DH>();
  cudaError_t err = ptx::allow_dynamic_smem(flash_bwd_prep_kernel<T, DH>, prep_smem,
                                            prep_ready);
  if (err == cudaSuccess)
    err = ptx::allow_dynamic_smem(flash_bwd_dkdv_kernel<T, DH>, dkdv_smem, dkdv_ready);
  if (err == cudaSuccess)
    err = ptx::allow_dynamic_smem(flash_bwd_dq_kernel<T, DH>, dq_smem, dq_ready);
  if (err != cudaSuccess) return err;
  const long long tiles = (seq + BT - 1) / BT;
  if ((long long)batch * heads > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  float* lse = stats;
  float* dsum = stats + (long long)batch * heads * seq;
  flash_bwd_prep_kernel<T, DH><<<dim3((unsigned)tiles, batch * heads), kThreads, prep_smem,
                                 stream>>>(tq, tk, static_cast<const T*>(o), tdo, lse, dsum,
                                           heads, kv_heads, seq, scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, DH><<<dim3((unsigned)tiles, batch * kv_heads), kThreads,
                                 dkdv_smem, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv), heads,
      kv_heads, seq, scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DH><<<dim3((unsigned)tiles, batch * heads), kThreads, dq_smem,
                               stream>>>(tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dq),
                                         heads, kv_heads, seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

#define CAT_(a, b) a##b
#define CAT(a, b) CAT_(a, b)

extern "C" int CAT(flash_attn_bwd_launch_, HEAD_DIM)(BWD_ARGS) {
  if (dtype == 0)
    return (int)launch<float, HEAD_DIM>(q, k, v, o, dout, dq, dk, dv, stats, batch, heads,
                                        kv_heads, seq, causal, scale, stream);
  return (int)launch<__nv_bfloat16, HEAD_DIM>(q, k, v, o, dout, dq, dk, dv, stats, batch,
                                              heads, kv_heads, seq, causal, scale, stream);
}

#else  // the dispatcher

extern "C" {

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  stats: float32 scratch of 2 * batch *
// heads * seq.  head_dim: one of HEAD_DIMS (anything else is refused with
// cudaErrorInvalidValue; the Python wrapper checks first).
int flash_attn_bwd_launch(const void* q, const void* k, const void* v, const void* o,
                          const void* dout, void* dq, void* dk, void* dv, void* stats,
                          int batch, int heads, int kv_heads, int seq, int head_dim,
                          int causal, float scale, int dtype, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0 || seq <= 0) return (int)cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  float* st = static_cast<float*>(stats);
  switch (head_dim) {
#define CASE(dh)                                                                         \
  case dh:                                                                               \
    return flash_attn_bwd_launch_##dh(q, k, v, o, dout, dq, dk, dv, st, batch, heads,    \
                                      kv_heads, seq, causal, scale, dtype, stream);
    HEAD_DIMS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // HEAD_DIM
