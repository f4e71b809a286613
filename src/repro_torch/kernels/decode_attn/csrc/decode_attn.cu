// One-token GQA attention over a KV cache, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_decode_kernel` in
// repro/kernels/decode_attn/kernel.py (wrapper `decode_attention_pallas`).
//
//   q (B, H, Dh), k and v (B, Hkv, S, Dh), f32 or bf16, pos (B,) int32
//   -> out (B, H, Dh) in q's dtype: row b attends to cache slots [0, pos[b]).
//
// Grid: one block per (batch, KV head).  The G = H / Hkv query heads of the
// group sit together in shared memory (scaled by Dh**-0.5 in f32, as the
// Pallas kernel does), so each K/V tile is read from device memory once for
// all of them.  The TPU grid's sequential KV axis is a loop inside the
// block; its bound is min(pos[b], S), so the block reads and computes
// nothing at or past pos (the Pallas kernel's tile skip, down to the key).
// Per tile: logits (G, kTK) from the staged K tile, one warp per query row
// for the online softmax (running max, denominator, rescale factor), then
// the V tile of the same keys through the same buffer into the f32
// accumulator.
//
// What bounds it on this card: bytes.  Every cached key and value up to pos
// is read once and used for 2*G multiply-adds per element, far below the
// ~295 FLOP/byte at which the tensor cores would become the limit; the
// least time is (q + 2*B*Hkv*pos*Dh elements + out) over 3.35 TB/s.  At the
// serving engine's sizes (B*Hkv = 32 blocks, pos ~ 100) a launch is mostly
// fixed cost; splitting the sequence over more blocks (flash-decode) is
// later work.
//
// Numerics follow the Pallas kernel: f32 logits, online softmax, p and
// accumulator; the output is acc / max(l, 1e-30) cast to q's dtype.
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTK = 64;        // cache slots per tile
constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;
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

// cache slots [t0, t0 + kTK) of one (S, DH) head into a (kTK, DH + 1) f32
// tile; slots at or past `n` are never read and stage as 0
template <typename T, int DH>
__device__ __forceinline__ void stage_tile(float* dst, const T* __restrict__ src,
                                           int t0, int n) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < kTK * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    dst[r * LD + d] = t0 + r < n ? to_f32(src[(long long)(t0 + r) * DH + d]) : 0.0f;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ pos,
                   T* __restrict__ out, int kv_heads, int group, int seq,
                   float scale) {
  constexpr int LD = DH + 1;
  extern __shared__ float smem[];
  float* sq = smem;                  // (G, DH) q * scale
  float* sacc = sq + group * DH;     // (G, DH) accumulator
  float* sp = sacc + group * DH;     // (G, kTK) logits, then p
  float* sm = sp + group * kTK;      // (G,) running max
  float* sl = sm + group;            // (G,) running denominator
  float* salpha = sl + group;        // (G,) this tile's rescale factor
  float* skv = salpha + group;       // (kTK, LD) K tile, then V tile

  const int bk = blockIdx.x;  // b * kv_heads + kv head
  const int b = bk / kv_heads;
  const int n = min(pos[b], seq);  // cache slots this row attends to
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the group's G query heads are contiguous in (B, H, Dh)
  const T* qb = q + (long long)bk * group * DH;
  const T* kb = k + (long long)bk * seq * DH;
  const T* vb = v + (long long)bk * seq * DH;

  for (int i = tid; i < group * DH; i += kThreads) {
    sq[i] = to_f32(qb[i]) * scale;
    sacc[i] = 0.0f;
  }
  for (int g = tid; g < group; g += kThreads) {
    sm[g] = kNegInf;
    sl[g] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += kTK) {
    __syncthreads();  // state initialised / the previous V tile consumed
    stage_tile<T, DH>(skv, kb, t0, n);
    __syncthreads();
    for (int i = tid; i < group * kTK; i += kThreads) {
      const int g = i / kTK, c = i % kTK;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < DH; ++d) s = fmaf(sq[g * DH + d], skv[c * LD + d], s);
      sp[i] = t0 + c < n ? s : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < group; g += kWarps) {
      const float m_prev = sm[g];
      float mx = kNegInf;
      for (int c = lane; c < kTK; c += 32) mx = fmaxf(mx, sp[g * kTK + c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      float rs = 0.0f;
      for (int c = lane; c < kTK; c += 32) {
        const float p = expf(sp[g * kTK + c] - m_new);
        sp[g * kTK + c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        salpha[g] = alpha;
        sl[g] = sl[g] * alpha + rs;
        sm[g] = m_new;
      }
    }
    __syncthreads();  // p and alpha are written; every read of K is done
    stage_tile<T, DH>(skv, vb, t0, n);
    __syncthreads();
    // each thread owns the same (g, d) accumulator slots on every tile
    for (int i = tid; i < group * DH; i += kThreads) {
      const int g = i / DH, d = i % DH;
      float a = sacc[i] * salpha[g];
#pragma unroll 8
      for (int c = 0; c < kTK; ++c) a = fmaf(sp[g * kTK + c], skv[c * LD + d], a);
      sacc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + (long long)bk * group * DH;
  for (int i = tid; i < group * DH; i += kThreads) {
    ob[i] = from_f32<T>(sacc[i] / fmaxf(sl[i / DH], 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* pos,
                   void* out, int batch, int kv_heads, int group, int seq,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      (size_t)(2 * group * DH + group * kTK + 3 * group + kTK * (DH + 1)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_attn_kernel<T, DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  decode_attn_kernel<T, DH><<<(unsigned)(batch * kv_heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      pos, static_cast<T*>(out), kv_heads, group, seq, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  head_dim: 64 or 128 (anything else is
// refused with cudaErrorInvalidValue; the Python wrapper checks first).
int decode_attn_launch(const void* q, const void* k, const void* v,
                       const int* pos, void* out, int batch, int heads,
                       int kv_heads, int seq, int head_dim, float scale,
                       int dtype, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0) return (int)cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0) return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  if (dtype == 0 && head_dim == 64)
    return (int)launch<float, 64>(q, k, v, pos, out, batch, kv_heads, group,
                                  seq, scale, stream);
  if (dtype == 0 && head_dim == 128)
    return (int)launch<float, 128>(q, k, v, pos, out, batch, kv_heads, group,
                                   seq, scale, stream);
  if (dtype == 1 && head_dim == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, pos, out, batch, kv_heads,
                                          group, seq, scale, stream);
  if (dtype == 1 && head_dim == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, pos, out, batch, kv_heads,
                                           group, seq, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
