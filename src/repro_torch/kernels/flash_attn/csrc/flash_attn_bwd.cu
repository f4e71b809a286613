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
//   dQ = scale dS K,  dK = scale dS^T q.
//
// What bounds it on this card: at the training shape (B 16, H 12 over 4 KV
// heads, S 192, Dh 64) the bytes in and out (q, k, v, o, dO once; dq, dk,
// dv once) take ~0.0075 ms at 3.35 TB/s, the five products over the valid
// (causal) pairs ~0.0023 ms at the bf16 tensor-core rate.  At so short a
// sequence a call is mostly latency: a few dependent trips to device
// memory and the longest block's chain of tile steps.
//
// bf16 (the training dtype): two kernels on the tensor cores, no atomics.
// - `flash_bwd_dq_bf16_kernel`, one block of 4 warps per (batch * head,
//   64 query rows; causal: the tiles with the most keys first), each warp
//   16 rows.  Q and dO stay in shared memory; K (and V) tiles of 64 keys
//   are double-buffered with 16-byte cp.async.  Pass 1 over the K tiles
//   the rows see: S = Q K^T by mma.sync m16n8k16 (bf16 x bf16 -> f32),
//   scaled after the product by scale * log2(e), masked, and each row's
//   online max and sum of exp2, as the forward's tile step does; so each
//   row's logsumexp (log2 units) is computed once, here.  With it
//   D = rowsum(dO o O), from the forward's output in f32, a byte pass.
//   Both go to a float32 scratch for the second kernel.  Pass 2 over the
//   same tiles: S again and dP = dO V^T, P = exp2(S - lse),
//   dS = P (dP - D) in f32, and dQ += dS K with dS split into
//   hi = bf16(dS) and lo = bf16(dS - hi), both through mma into the f32
//   accumulator (K fragments by ldmatrix.trans).  dQ is scaled once at
//   the end and rounded to bf16.
// - `flash_bwd_dkdv_bf16_kernel`, one block of 4 warps per (batch * KV
//   head, 64 keys; causal: the keys with the most queries first), each
//   warp 16 keys.  K and V stay in shared memory; the block walks every
//   query head of the group and every tile of query rows that sees its
//   keys (64 rows up to head dim 64, 32 past it), each tile's Q, dO and
//   row statistics double-buffered with cp.async.  Per tile the products
//   run transposed, keys as rows: S^T = K Q^T and dP^T = V dO^T, then
//   P^T and dS^T from the rows' logsumexp and D, and dV += P^T dO,
//   dK += dS^T Q, each with P or dS split into bf16 hi + lo (Q and dO
//   fragments by ldmatrix.trans).  dK is scaled once at the end; dK and
//   dV are summed over the group in registers, in a fixed order.
// - Tiles are bf16 in shared memory, rows padded by 16 bytes so that the
//   eight rows an ldmatrix reads fall in distinct banks; rows past S are
//   zero-filled by the copy and masked out of P.  Every product is a
//   tensor-core product: bf16 operands exact, f32 accumulation.  Keeping
//   P and dS at ~16 bits by the hi + lo split is what holds the gradient
//   to the f32 one at the tolerance (hi alone lies up to 0.025 off at
//   qwen3-moe's head dim 128 and group 16; `ref.flash_bwd_tiled_ref`
//   rehearses this arithmetic on the CPU).
// - Head dims 192 and 256: two column groups of 4 warps; each group owns
//   half of dQ's (dK's, dV's) columns and both compute the same logits,
//   so the accumulators fit a thread's 255 registers.
// - Every sum is taken in a fixed order, so two calls give the same bits.
//
// f32 (the check dtype): three kernels on the CUDA cores, every product
// and sum in f32 (tf32 would not hold 1e-3):
// - `flash_bwd_prep_kernel`, one block per (batch * head, tile of query
//   rows): each row's logsumexp of its scaled logits and D = rowsum(dO o
//   O), into a float32 scratch of 2 x B x H x S;
// - `flash_bwd_dkdv_kernel`, one block per (batch * KV head, tile of
//   keys): K and V in shared memory, every query head of the group and
//   every query tile that sees the keys, dK and dV in registers;
// - `flash_bwd_dq_kernel`, one block per (batch * head, tile of query
//   rows): dS K into dQ in registers.
// Tiles of 64 rows up to head dim 128, 32 past it; 256 threads as 16 x 16,
// thread (ty, tx) owning rows ty + 16 i and columns tx + 16 j; shared rows
// padded by one float; q staged as q * scale, exp by expf.
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

// ------------------------------------------------------------------ f32

constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

// rows per tile of queries and of keys
template <int DH>
__host__ __device__ constexpr int tile_rows() {
  return DH > 128 ? 32 : 64;
}

__device__ __forceinline__ float widen(float x) { return x; }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
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


// ----------------------------------------------------------------- bf16

constexpr int kWarps = 4;           // warps of a column group
constexpr int kRows = kWarps * 16;  // query rows (dQ) or keys (dK, dV) per block
constexpr int kBK = 64;             // keys per tile of the dQ kernel

// column groups: two past head dim 128, where one warp's accumulators over
// every column would take more registers than a thread has
template <int DH>
__host__ __device__ constexpr int column_groups() {
  return DH > 128 ? 2 : 1;
}

// query rows per tile of the dK/dV kernel: its S^T and dP^T tiles take
// 2 x rows / 8 x 4 registers beside the 2 x DH / 2 of dK and dV
template <int DH>
__host__ __device__ constexpr int dkdv_query_rows() {
  return DH > 64 ? 32 : 64;
}

// rows [r0, r0 + ROWS) of a (seq, DH) bf16 matrix into a (ROWS, DH + 8)
// shared tile by 16-byte cp.async, by the block's NT threads; rows at or
// past `seq` are zero-filled, never read
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int r0, int seq) {
  constexpr int CH = DH / 8, LDS = DH + 8;
  for (int c = threadIdx.x; c < ROWS * CH; c += NT) {
    const int r = c / CH, cc = c % CH * 8;
    const bool ok = r0 + r < seq;
    ptx::cp_async16(dst + r * LDS + cc, ok ? src + (long long)(r0 + r) * DH + cc : src,
                    ok ? 16 : 0);
  }
}

// acc (16 x N, accumulator layout: n-tile j, lane (g, t4) holds rows g and
// g + 8, columns 8 j + 2 t4 and + 1) = A B^T over DH, A the 16 rows at `a`
// and B the N rows at `b` (row stride DH + 8); A fragments by ldmatrix,
// B fragments by ldmatrix as the forward's K
template <int DH, int N>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[N / 8][4], const __nv_bfloat16* a,
                                              const __nv_bfloat16* b, int lane) {
  constexpr int LDS = DH + 8;
  static_assert(N % 16 == 0, "two n-tiles per ldmatrix");
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t af[4];
    ptx::ldmatrix_x4(af, a + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t bf[4];  // b0, b1 of rows np*16 + 0..7, then of + 8..15
      ptx::ldmatrix_x4(bf, b + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS + ks * 16 +
                               ((lane >> 3) & 1) * 8);
      ptx::mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      ptx::mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x 8 NO) += X M: X (16 x K) f32 in the accumulator layout of K / 8
// n-tiles, entering as bf16 hi = bf16(x) and lo = bf16(x - hi), both
// through mma; M the K rows at `m` (row stride LDS), its first 8 NO
// columns, fragments by ldmatrix.trans (as the forward's V)
template <int K, int NO, int LDS>
__device__ __forceinline__ void split_times_rows(float (&acc)[NO][4], const float (&x)[K / 8][4],
                                                 const __nv_bfloat16* m, int lane) {
  static_assert(K % 16 == 0 && NO % 2 == 0, "whole k-steps, n-tiles in pairs");
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      // the accumulator layout of n-tiles 2 kk and 2 kk + 1 is the A layout
      const float x0 = x[2 * kk + (h >> 1)][(h & 1) * 2];
      const float x1 = x[2 * kk + (h >> 1)][(h & 1) * 2 + 1];
      hi[h] = ptx::pack_bf16(x0, x1);
      const float h0 = __uint_as_float(hi[h] << 16);
      const float h1 = __uint_as_float(hi[h] & 0xffff0000u);
      lo[h] = ptx::pack_bf16(x0 - h0, x1 - h1);
    }
    const __nv_bfloat16* mr = m + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS;
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t mf[4];  // b0, b1 of n-tile n, then of n-tile n + 1
      ptx::ldmatrix_x4_trans(mf, mr + n * 8 + (lane >> 4) * 8);
      ptx::mma_bf16(acc[n], hi, mf[0], mf[1]);
      ptx::mma_bf16(acc[n + 1], hi, mf[2], mf[3]);
      ptx::mma_bf16(acc[n], lo, mf[0], mf[1]);
      ptx::mma_bf16(acc[n + 1], lo, mf[2], mf[3]);
    }
  }
}

// rows g and g + 8 of a warp's accumulator (NO n-tiles) times `mul`, as bf16,
// to `row0` and `row1` (each at the first column; nullptr: not written)
template <int NO>
__device__ __forceinline__ void store_rows(const float (&acc)[NO][4], float mul,
                                           __nv_bfloat16* row0, __nv_bfloat16* row1, int lane) {
  const int c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (row0)
      *reinterpret_cast<uint32_t*>(row0 + j * 8 + c) =
          ptx::pack_bf16(acc[j][0] * mul, acc[j][1] * mul);
    if (row1)
      *reinterpret_cast<uint32_t*>(row1 + j * 8 + c) =
          ptx::pack_bf16(acc[j][2] * mul, acc[j][3] * mul);
  }
}

template <int DH>
constexpr int dq_bf16_smem_bytes() {
  return (2 * kRows + 4 * kBK) * (DH + 8) * 2;  // Q, dO, 2 x K, 2 x V
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32 * column_groups<DH>())
flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ o,
                         const __nv_bfloat16* __restrict__ dout,
                         __nv_bfloat16* __restrict__ dq, float* __restrict__ lse,
                         float* __restrict__ dsum, int heads, int kv_heads, int seq,
                         float scale, int causal) {
  constexpr int LDS = DH + 8;
  constexpr int NCG = column_groups<DH>();
  constexpr int NO = DH / 8 / NCG;  // dQ n-tiles of one warp
  constexpr int NT = kWarps * 32 * NCG;
  constexpr int NS = kBK / 8;       // n-tiles of a tile's logits
  static_assert(DH % 16 == 0 && (DH / 8) % NCG == 0, "head dim: a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kRows, LDS)
  __nv_bfloat16* sdo = sq + kRows * LDS;                          // (kRows, LDS)
  __nv_bfloat16* sk = sdo + kRows * LDS;                          // 2 x (kBK, LDS)
  __nv_bfloat16* sv = sk + 2 * kBK * LDS;                         // 2 x (kBK, LDS)

  const int bh = blockIdx.y;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kvh = b * kv_heads + h / (heads / kv_heads);
  const int q0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32 % kWarps, lane = threadIdx.x % 32;
  const int col0 = threadIdx.x / (kWarps * 32) * NO * 8;  // the warp's first dQ column
  const long long hs = (long long)seq * DH;
  const __nv_bfloat16* kb = k + kvh * hs;
  const __nv_bfloat16* vb = v + kvh * hs;

  // pass 1 (K tiles) then pass 2 (K and V tiles) over the keys the rows see
  const int k_end = causal ? min(seq, q0 + kRows) : seq;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  auto fetch = [&](int step, int buf) {
    const int t0 = step % n_tiles * kBK;
    copy_rows<DH, kBK, NT>(sk + buf * kBK * LDS, kb, t0, seq);
    if (step >= n_tiles) copy_rows<DH, kBK, NT>(sv + buf * kBK * LDS, vb, t0, seq);
  };
  copy_rows<DH, kRows, NT>(sq, q + bh * hs, q0, seq);
  copy_rows<DH, kRows, NT>(sdo, dout + bh * hs, q0, seq);
  fetch(0, 0);
  ptx::cp_async_commit();

  // this thread's rows of the warp's 16: g and g + 8; a row sees keys
  // [0, kmax) (causal: up to its own position)
  const int g = lane / 4, t4 = lane % 4;
  const int wr0 = q0 + warp * 16;
  const int row0 = wr0 + g, row1 = row0 + 8;
  const bool warp_live = wr0 < seq;
  const int kmax0 = causal ? min(seq, row0 + 1) : seq;
  const int kmax1 = causal ? min(seq, row1 + 1) : seq;
  const int warp_kmin = causal ? min(seq, wr0 + 1) : seq;   // the fewest keys of its rows
  const int warp_kmax = causal ? min(seq, wr0 + 16) : seq;  // the most
  const float scale2 = scale * 1.4426950408889634f;  // logits in log2 units

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;  // pass 1's online state
  float d0 = 0.0f, d1 = 0.0f;                               // D of rows g, g + 8
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;

  for (int step = 0; step < 2 * n_tiles; ++step) {
    const int buf = step & 1, t0 = step % n_tiles * kBK;
    const bool pass2 = step >= n_tiles;
    if (step + 1 < 2 * n_tiles) fetch(step + 1, buf ^ 1);
    ptx::cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    ptx::cp_async_wait<1>();
    __syncthreads();  // this step's tiles (and Q, dO) visible to every warp

    if (warp_live && step == 0) {
      // D = rowsum(dO o O): lane t4 of a quad takes columns 8 j + 2 t4, + 1
      const __nv_bfloat16* ob = o + bh * hs;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const int c = j * 8 + 2 * t4;
        const __nv_bfloat162 do0 = *reinterpret_cast<const __nv_bfloat162*>(
            sdo + (warp * 16 + g) * LDS + c);
        const __nv_bfloat162 do1 = *reinterpret_cast<const __nv_bfloat162*>(
            sdo + (warp * 16 + g + 8) * LDS + c);
        if (row0 < seq) {
          const __nv_bfloat162 o0 =
              *reinterpret_cast<const __nv_bfloat162*>(ob + (long long)row0 * DH + c);
          d0 = fmaf(__low2float(do0), __low2float(o0), d0);
          d0 = fmaf(__high2float(do0), __high2float(o0), d0);
        }
        if (row1 < seq) {
          const __nv_bfloat162 o1 =
              *reinterpret_cast<const __nv_bfloat162*>(ob + (long long)row1 * DH + c);
          d1 = fmaf(__low2float(do1), __low2float(o1), d1);
          d1 = fmaf(__high2float(do1), __high2float(o1), d1);
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
      }
    }
    if (warp_live && step == n_tiles) {
      // between the passes: each row's logsumexp in log2 units, to the scratch
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      m0 += log2f(l0);
      m1 += log2f(l1);
      if (threadIdx.x < kWarps * 32 && t4 == 0) {  // column group 0 writes
        if (row0 < seq) {
          lse[(long long)bh * seq + row0] = m0;
          dsum[(long long)bh * seq + row0] = d0;
        }
        if (row1 < seq) {
          lse[(long long)bh * seq + row1] = m1;
          dsum[(long long)bh * seq + row1] = d1;
        }
      }
    }

    if (warp_live && t0 < warp_kmax) {  // else every key of the tile is masked
      const __nv_bfloat16* kt = sk + buf * kBK * LDS;
      float s[NS][4];
      rows_dot_rows<DH, kBK>(s, sq + warp * 16 * LDS, kt, lane);
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
      if (t0 + kBK > warp_kmin) {
        // element (j, e) is key t0 + 8 j + 2 t4 + (e & 1) of row g (e < 2) or g + 8
        const int lim0 = kmax0 - t0 - 2 * t4, lim1 = kmax1 - t0 - 2 * t4;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (j * 8 + (e & 1) >= (e < 2 ? lim0 : lim1)) s[j][e] = kNegInf;
      }
      if (!pass2) {
        float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
          mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          rs0 += ptx::exp2_approx(s[j][0] - mn0) + ptx::exp2_approx(s[j][1] - mn0);
          rs1 += ptx::exp2_approx(s[j][2] - mn1) + ptx::exp2_approx(s[j][3] - mn1);
        }
        l0 = fmaf(l0, ptx::exp2_approx(m0 - mn0), rs0);
        l1 = fmaf(l1, ptx::exp2_approx(m1 - mn1), rs1);
        m0 = mn0;
        m1 = mn1;
      } else {
        float dp[NS][4];
        rows_dot_rows<DH, kBK>(dp, sdo + warp * 16 * LDS, sv + buf * kBK * LDS, lane);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ptx::exp2_approx(s[j][e] - (e < 2 ? m0 : m1));
            s[j][e] = p * (dp[j][e] - (e < 2 ? d0 : d1));  // dS
          }
        split_times_rows<kBK, NO, LDS>(acc, s, kt + col0, lane);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }
  ptx::cp_async_wait<0>();

  if (!warp_live) return;
  __nv_bfloat16* qb = dq + bh * hs;
  store_rows(acc, scale, row0 < seq ? qb + (long long)row0 * DH + col0 : nullptr,
             row1 < seq ? qb + (long long)row1 * DH + col0 : nullptr, lane);
}

template <int DH>
constexpr int dkdv_bf16_smem_bytes() {
  constexpr int BQ = dkdv_query_rows<DH>();
  return (2 * kRows + 4 * BQ) * (DH + 8) * 2 + 4 * BQ * 4;  // K, V, 2 x Q, 2 x dO; lse, D
}

template <int DH>
__global__ void __launch_bounds__(kWarps * 32 * column_groups<DH>())
flash_bwd_dkdv_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse, const float* __restrict__ dsum,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int heads, int kv_heads, int seq, float scale, int causal) {
  constexpr int LDS = DH + 8;
  constexpr int NCG = column_groups<DH>();
  constexpr int NO = DH / 8 / NCG;  // dK, dV n-tiles of one warp
  constexpr int NT = kWarps * 32 * NCG;
  constexpr int BQ = dkdv_query_rows<DH>();
  constexpr int NS = BQ / 8;        // n-tiles of S^T
  static_assert(DH % 16 == 0 && (DH / 8) % NCG == 0, "head dim: a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kRows, LDS)
  __nv_bfloat16* sv = sk + kRows * LDS;                           // (kRows, LDS)
  __nv_bfloat16* sq = sv + kRows * LDS;                           // 2 x (BQ, LDS)
  __nv_bfloat16* sdo = sq + 2 * BQ * LDS;                         // 2 x (BQ, LDS)
  float* slse = reinterpret_cast<float*>(sdo + 2 * BQ * LDS);    // 2 x BQ
  float* sd = slse + 2 * BQ;                                      // 2 x BQ

  const int bk = blockIdx.y;  // b * kv_heads + KV head
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const int group = heads / kv_heads;
  const int k0 = blockIdx.x * kRows;  // causal: tile 0, the most work, starts first
  const int warp = threadIdx.x / 32 % kWarps, lane = threadIdx.x % 32;
  const int col0 = threadIdx.x / (kWarps * 32) * NO * 8;  // the warp's first dK, dV column
  const long long hs = (long long)seq * DH;

  // query tiles: from the keys' own tile on (causal), for each head of the group
  const int q_first = causal ? k0 / BQ * BQ : 0;
  const int nq = (seq - q_first + BQ - 1) / BQ;
  const int steps = group * nq;
  auto fetch = [&](int step, int buf) {
    const long long bh = (long long)b * heads + (long long)kvh * group + step / nq;
    const int qt0 = q_first + step % nq * BQ;
    copy_rows<DH, BQ, NT>(sq + buf * BQ * LDS, q + bh * hs, qt0, seq);
    copy_rows<DH, BQ, NT>(sdo + buf * BQ * LDS, dout + bh * hs, qt0, seq);
    for (int i = threadIdx.x; i < BQ; i += NT) {
      const bool ok = qt0 + i < seq;
      const long long at = bh * seq + qt0 + i;
      ptx::cp_async4(slse + buf * BQ + i, ok ? lse + at : lse, ok ? 4 : 0);
      ptx::cp_async4(sd + buf * BQ + i, ok ? dsum + at : dsum, ok ? 4 : 0);
    }
  };
  copy_rows<DH, kRows, NT>(sk, k + bk * hs, k0, seq);
  copy_rows<DH, kRows, NT>(sv, v + bk * hs, k0, seq);
  fetch(0, 0);
  ptx::cp_async_commit();

  // this thread's keys of the warp's 16: g and g + 8
  const int g = lane / 4, t4 = lane % 4;
  const int wk0 = k0 + warp * 16;
  const int key0 = wk0 + g, key1 = key0 + 8;
  const bool warp_live = wk0 < seq;
  const float scale2 = scale * 1.4426950408889634f;

  float acc_dk[NO][4], acc_dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.0f;

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1, qt0 = q_first + step % nq * BQ;
    if (step + 1 < steps) fetch(step + 1, buf ^ 1);
    ptx::cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    ptx::cp_async_wait<1>();
    __syncthreads();  // this step's tiles (and K, V) visible to every warp

    // causal: a tile whose last query precedes the warp's first key adds nothing
    if (warp_live && !(causal && qt0 + BQ <= wk0)) {
      const __nv_bfloat16* qt = sq + buf * BQ * LDS;
      const __nv_bfloat16* dot = sdo + buf * BQ * LDS;
      const float* tl = slse + buf * BQ;
      const float* td = sd + buf * BQ;
      float s[NS][4], dp[NS][4];  // keys x queries
      rows_dot_rows<DH, BQ>(s, sk + warp * 16 * LDS, qt, lane);
      rows_dot_rows<DH, BQ>(dp, sv + warp * 16 * LDS, dot, lane);
      // masked: queries past S, and (causal) keys past the query
      const bool mask = (causal && qt0 < wk0 + 16) || qt0 + BQ > seq;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // element (j, e) is query qt0 + c of key g (e < 2) or g + 8
          const int c = j * 8 + 2 * t4 + (e & 1);
          const bool dead =
              mask && (qt0 + c >= seq || (causal && (e < 2 ? key0 : key1) > qt0 + c));
          const float p = dead ? 0.0f : ptx::exp2_approx(fmaf(s[j][e], scale2, -tl[c]));
          s[j][e] = p;                      // P^T
          dp[j][e] = p * (dp[j][e] - td[c]);  // dS^T
        }
      split_times_rows<BQ, NO, LDS>(acc_dv, s, dot + col0, lane);
      split_times_rows<BQ, NO, LDS>(acc_dk, dp, qt + col0, lane);
    }
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }
  ptx::cp_async_wait<0>();

  if (!warp_live) return;
  __nv_bfloat16* kr = dk + bk * hs;
  __nv_bfloat16* vr = dv + bk * hs;
  store_rows(acc_dk, scale, key0 < seq ? kr + (long long)key0 * DH + col0 : nullptr,
             key1 < seq ? kr + (long long)key1 * DH + col0 : nullptr, lane);
  store_rows(acc_dv, 1.0f, key0 < seq ? vr + (long long)key0 * DH + col0 : nullptr,
             key1 < seq ? vr + (long long)key1 * DH + col0 : nullptr, lane);
}

// ------------------------------------------------------------ launchers

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* stats,
                       int batch, int heads, int kv_heads, int seq, int causal, float scale,
                       cudaStream_t stream) {
  using T = float;
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

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* dq, void* dk, void* dv, float* stats,
                        int batch, int heads, int kv_heads, int seq, int causal, float scale,
                        cudaStream_t stream) {
  static std::atomic<unsigned long long> dq_ready{0}, dkdv_ready{0};
  constexpr int dq_smem = dq_bf16_smem_bytes<DH>();
  constexpr int dkdv_smem = dkdv_bf16_smem_bytes<DH>();
  constexpr int threads = kWarps * 32 * column_groups<DH>();
  cudaError_t err = ptx::allow_dynamic_smem(flash_bwd_dq_bf16_kernel<DH>, dq_smem, dq_ready);
  if (err == cudaSuccess)
    err = ptx::allow_dynamic_smem(flash_bwd_dkdv_bf16_kernel<DH>, dkdv_smem, dkdv_ready);
  if (err != cudaSuccess) return err;
  const long long tiles = (seq + kRows - 1) / kRows;
  if ((long long)batch * heads > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const bf* tq = static_cast<const bf*>(q);
  const bf* tk = static_cast<const bf*>(k);
  const bf* tv = static_cast<const bf*>(v);
  const bf* tdo = static_cast<const bf*>(dout);
  float* lse = stats;
  float* dsum = stats + (long long)batch * heads * seq;
  flash_bwd_dq_bf16_kernel<DH><<<dim3((unsigned)tiles, batch * heads), threads, dq_smem,
                                 stream>>>(tq, tk, tv, static_cast<const bf*>(o), tdo,
                                           static_cast<bf*>(dq), lse, dsum, heads, kv_heads,
                                           seq, scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  flash_bwd_dkdv_bf16_kernel<DH><<<dim3((unsigned)tiles, batch * kv_heads), threads,
                                   dkdv_smem, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<bf*>(dk), static_cast<bf*>(dv), heads,
      kv_heads, seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

#define CAT_(a, b) a##b
#define CAT(a, b) CAT_(a, b)

extern "C" int CAT(flash_attn_bwd_launch_, HEAD_DIM)(BWD_ARGS) {
  if (dtype == 0)
    return (int)launch_f32<HEAD_DIM>(q, k, v, o, dout, dq, dk, dv, stats, batch, heads,
                                     kv_heads, seq, causal, scale, stream);
  return (int)launch_bf16<HEAD_DIM>(q, k, v, o, dout, dq, dk, dv, stats, batch, heads,
                                    kv_heads, seq, causal, scale, stream);
}

#else  // the dispatcher

extern "C" {

const char* flash_attn_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  stats: float32 scratch of 2 * batch *
// heads * seq (each row's logsumexp, then D).  head_dim: one of HEAD_DIMS
// (anything else is refused with cudaErrorInvalidValue; the Python wrapper
// checks first).
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
