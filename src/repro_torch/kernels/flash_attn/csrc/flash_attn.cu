// Causal GQA prefill attention (blockwise online softmax) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_flash_kernel` in
// repro/kernels/flash_attn/kernel.py (wrapper `flash_attention_pallas`).
//
//   q (B, H, S, Dh), k and v (B, Hkv, S, Dh), f32 or bf16 -> out (B, H, S, Dh)
//   in q's dtype.  Query head h reads KV head h / (H / Hkv).
//
// Grid: one block per (batch * head, tile of kBQ query rows).  The TPU grid
// ran its KV axis in order and carried (m, l, acc) in VMEM scratch from one
// grid step to the next; here that axis is a loop inside the block, and the
// running max, denominator and f32 accumulator live in registers.  The Q
// tile (scaled in f32, as the Pallas kernel does) stays in shared memory for
// the whole loop; each K tile and then the V tile of the same keys are
// staged through one shared-memory buffer, converted to f32 on the way in.
// With `causal`, tiles whose first key lies past the block's last query row
// are never visited (the Pallas kernel's `pl.when` skip); keys at or past S
// are masked with -1e30, so any S works, not only tile multiples.
//
// What bounds it on this card: operations at long S (4*B*H*sum(valid keys)*Dh
// FLOPs against the tensor cores' 989 TFLOP/s), bytes at the short prompts
// the serving engine sends (q, K/V and out once over 3.35 TB/s); at those
// sizes a launch is mostly fixed cost.  This first version multiplies on the
// CUDA cores in f32 (a 16 x 16 thread grid, each thread 4 x 4 logits and
// 4 x Dh/16 outputs, padded shared-memory rows so no two lanes of a warp hit
// one bank); wgmma and TMA are later work.
//
// Numerics follow the Pallas kernel: logits, the online softmax, p and the
// accumulator are f32, the output is acc / max(l, 1e-30) cast to q's dtype.
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns rows ty + 16 i, tx keys / dims tx + 16 j
constexpr float kNegInf = -1e30f;

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

// rows [r0, r0 + ROWS) of a (seq, DH) matrix, times `mul`, into a
// (ROWS, DH + 1) f32 tile; rows at or past `valid` read as 0
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           int r0, int valid, float mul) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < ROWS * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * LD + d] =
        r0 + r < valid ? to_f32(src[(long long)(r0 + r) * DH + d]) * mul : 0.0f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int heads,
                  int kv_heads, int seq, float scale, int causal) {
  constexpr int LD = DH + 1;    // padded row stride of the Q and K/V tiles
  constexpr int LDP = kBK + 1;  // padded row stride of the P tile
  constexpr int RI = kBQ / 16;  // query rows per thread
  constexpr int CJ = kBK / 16;  // keys per thread
  constexpr int DJ = DH / 16;   // output dims per thread
  extern __shared__ float smem[];
  float* sq = smem;            // (kBQ, LD)  q * scale
  float* skv = sq + kBQ * LD;  // (kBK, LD)  K tile, then V tile
  float* sp = skv + kBK * LD;  // (kBQ, LDP) p

  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const int kvh = b * kv_heads + h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* qb = q + (long long)bh * seq * DH;
  const T* kb = k + (long long)kvh * seq * DH;
  const T* vb = v + (long long)kvh * seq * DH;

  stage_tile<T, DH, kBQ>(sq, qb, q0, seq, scale);

  float m[RI], l[RI], acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // causal: K tiles starting past this block's last query row are skipped
  const int k_end = causal ? min(seq, q0 + kBQ) : seq;
  for (int t0 = 0; t0 < k_end; t0 += kBK) {
    __syncthreads();  // the previous V tile is consumed (and Q is staged)
    stage_tile<T, DH, kBK>(skv, kb, t0, seq, 1.0f);
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = sq[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = skv[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int col = t0 + tx + 16 * j;
        if (col >= seq || (causal && col > row)) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // a row's 16 threads are the 16 lanes of one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
#pragma unroll
      for (int j = 0; j < CJ; ++j) sp[(ty + 16 * i) * LDP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();  // p is written and every read of the K tile is done
    stage_tile<T, DH, kBK>(skv, vb, t0, seq, 1.0f);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = sp[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = skv[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + (long long)bh * seq * DH;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[(long long)row * DH + tx + 16 * j] = from_f32<T>(acc[i][j] / den);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int batch, int heads, int kv_heads, int seq, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int LD = DH + 1;
  const size_t smem = (size_t)(2 * kBQ * LD + kBQ * (kBK + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(batch * heads), (unsigned)((seq + kBQ - 1) / kBQ));
  flash_attn_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), heads, kv_heads, seq, scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  head_dim: 64 or 128 (anything else is
// refused with cudaErrorInvalidValue; the Python wrapper checks first).
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int batch, int heads, int kv_heads, int seq, int head_dim,
                      int causal, float scale, int dtype, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0 || seq <= 0) return (int)cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k, v, out, batch, heads, kv_heads, seq,
                                  scale, causal, stream);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k, v, out, batch, heads, kv_heads, seq,
                                   scale, causal, stream);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, out, batch, heads, kv_heads,
                                          seq, scale, causal, stream);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, out, batch, heads, kv_heads,
                                           seq, scale, causal, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
