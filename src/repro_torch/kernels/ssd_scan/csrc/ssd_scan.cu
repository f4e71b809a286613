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
// y_t = S_t C_t.  Chunked over kL time steps, with cum the inclusive cumsum
// of A dt inside the chunk:
//
//   y_t  = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s
//          + exp(cum_t) (S C_t)                    (the carried state)
//   S   <- exp(cum_L) S + sum_s exp(cum_L - cum_s) dt_s x_s B_sᵀ
//
// Grid: one block per (batch, head).  The TPU grid's sequential chunk axis,
// which carried the state in VMEM scratch, is a loop inside the block, with
// the state in shared memory for the whole sequence: nothing goes through
// device memory between chunks.  Per chunk the block stages B, C, x and dt
// in shared memory, computes cum, the masked (kL, kL) decay matrix M, then
// y = M x + exp(cum) (C S) and the state update, each as a register-tiled
// product of 16 x 16 threads.  A chunk of 32 keeps a block at ~79 KB of
// shared memory for N = 128, P = 64, so two blocks share an SM (a chunk of
// 128 as on the TPU would need ~260 KB); chunking an exact recurrence
// changes only the rounding.
//
// Exponents are always differences that are <= 0: exp(cum_t - cum_s) is
// evaluated only for s <= t, exp(cum_L - cum_s) and exp(cum_t) only for
// steps inside the chunk; the factored exp(cum_t) exp(-cum_s) never appears
// (at mamba2's init cum falls by up to ~16 per step and that form
// overflows).  A short last chunk is padded in shared memory with dt = 0
// and zero B, C, x, which leaves the state unchanged; nothing at or past S
// is read and no row past S is written.
//
// What bounds it on this card: operations.  Everything is f32 on the CUDA
// cores (67 TFLOP/s); per step the work is O(kL (N + P) + N P), against
// O((N + P + H P) / H) bytes.  C Bᵀ is recomputed per head, as on the TPU;
// sharing it across heads, tensor cores (wgmma) and TMA are later work.
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kL = 32;         // time steps per chunk
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxN = 128;     // state size: a multiple of 16 up to this
constexpr int kTL = kL / 16;   // chunk rows (and columns) per thread

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

template <typename T, int P>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                const float* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ final_state, int heads, int seq, int n_state) {
  constexpr int kTP = P / 16;  // state columns (p) per thread
  constexpr int kTN = kMaxN / 16;
  constexpr int LDM = kL + 1;
  const int N = n_state;
  const int LDN = N + 1;  // odd row pitch: row-strided reads hit distinct banks
  extern __shared__ float smem[];
  float* sB = smem;              // (kL, LDN)
  float* sC = sB + kL * LDN;     // (kL, LDN)
  float* sx = sC + kL * LDN;     // (kL, P)
  float* sM = sx + kL * P;       // (kL, LDM) masked decay matrix
  float* sS = sM + kL * LDM;     // (P, LDN) the carried state
  float* sdt = sS + P * LDN;     // (kL,)
  float* scum = sdt + kL;        // (kL,) inclusive cumsum of A dt
  float* sw = scum + kL;         // (kL,) dt_s exp(cum_L - cum_s)

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float a = A[h];
  const int tn = N / 16;

  for (int i = tid; i < P * LDN; i += kThreads) sS[i] = 0.0f;

  for (int t0 = 0; t0 < seq; t0 += kL) {
    const int len = min(kL, seq - t0);
    __syncthreads();  // the previous chunk's reads of the staged tiles are done
    const long long row0 = (long long)b * seq + t0;  // first row of the chunk
    for (int i = tid; i < kL * N; i += kThreads) {
      const int r = i / N, c = i % N;
      const bool in = r < len;
      sB[r * LDN + c] = in ? Bm[(row0 + r) * N + c] : 0.0f;
      sC[r * LDN + c] = in ? Cm[(row0 + r) * N + c] : 0.0f;
    }
    for (int i = tid; i < kL * P; i += kThreads) {
      const int r = i / P, c = i % P;
      sx[i] = r < len ? to_f32(x[((row0 + r) * heads + h) * P + c]) : 0.0f;
    }
    if (tid < kL) sdt[tid] = tid < len ? dt[(row0 + tid) * heads + h] : 0.0f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.0f;
      for (int r = 0; r < kL; ++r) {
        c += a * sdt[r];
        scum[r] = c;
      }
    }
    __syncthreads();
    if (tid < kL) sw[tid] = sdt[tid] * expf(scum[kL - 1] - scum[tid]);

    // M[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
    {
      float g[kTL][kTL] = {};
      for (int k = 0; k < N; ++k) {
        float cv[kTL], bv[kTL];
#pragma unroll
        for (int i = 0; i < kTL; ++i) cv[i] = sC[(ty + 16 * i) * LDN + k];
#pragma unroll
        for (int j = 0; j < kTL; ++j) bv[j] = sB[(tx + 16 * j) * LDN + k];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTL; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < kTL; ++j) {
          const int s = tx + 16 * j;
          sM[t * LDM + s] = s <= t ? g[i][j] * expf(scum[t] - scum[s]) * sdt[s] : 0.0f;
        }
      }
    }
    __syncthreads();

    // y[t][p] = sum_s M[t][s] x[s][p] + exp(cum_t) sum_n C[t][n] S[p][n]
    {
      float intra[kTL][kTP] = {}, inter[kTL][kTP] = {};
      for (int k = 0; k < N; ++k) {
        float cv[kTL], sv[kTP];
#pragma unroll
        for (int i = 0; i < kTL; ++i) cv[i] = sC[(ty + 16 * i) * LDN + k];
#pragma unroll
        for (int j = 0; j < kTP; ++j) sv[j] = sS[(tx + 16 * j) * LDN + k];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTP; ++j) inter[i][j] = fmaf(cv[i], sv[j], inter[i][j]);
      }
#pragma unroll 4
      for (int s = 0; s < kL; ++s) {
        float mv[kTL], xv[kTP];
#pragma unroll
        for (int i = 0; i < kTL; ++i) mv[i] = sM[(ty + 16 * i) * LDM + s];
#pragma unroll
        for (int j = 0; j < kTP; ++j) xv[j] = sx[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTL; ++i)
#pragma unroll
          for (int j = 0; j < kTP; ++j) intra[i][j] = fmaf(mv[i], xv[j], intra[i][j]);
      }
#pragma unroll
      for (int i = 0; i < kTL; ++i) {
        const int t = ty + 16 * i;
        if (t < len) {
          const float e = expf(scum[t]);
          T* yt = y + ((row0 + t) * heads + h) * P;
#pragma unroll
          for (int j = 0; j < kTP; ++j)
            yt[tx + 16 * j] = from_f32<T>(fmaf(e, inter[i][j], intra[i][j]));
        }
      }
    }
    __syncthreads();  // every read of the old state is done

    // S[p][n] <- exp(cum_L) S[p][n] + sum_s B[s][n] w_s x[s][p]; each thread
    // owns the same (p, n) entries throughout
    {
      const float total = expf(scum[kL - 1]);
      float acc[kTN][kTP];
#pragma unroll
      for (int i = 0; i < kTN; ++i)
#pragma unroll
        for (int j = 0; j < kTP; ++j)
          acc[i][j] = i < tn ? total * sS[(tx + 16 * j) * LDN + ty + 16 * i] : 0.0f;
#pragma unroll 2
      for (int s = 0; s < kL; ++s) {
        const float ws = sw[s];
        float xv[kTP];
#pragma unroll
        for (int j = 0; j < kTP; ++j) xv[j] = sx[s * P + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kTN; ++i) {
          if (i < tn) {
            const float bw = sB[s * LDN + ty + 16 * i] * ws;
#pragma unroll
            for (int j = 0; j < kTP; ++j) acc[i][j] = fmaf(bw, xv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kTN; ++i)
        if (i < tn)
#pragma unroll
          for (int j = 0; j < kTP; ++j) sS[(tx + 16 * j) * LDN + ty + 16 * i] = acc[i][j];
    }
  }
  if (final_state != nullptr) {
    __syncthreads();
    float* fs = final_state + (long long)bh * P * N;  // (P, N) of this head
    for (int i = tid; i < P * N; i += kThreads) fs[i] = sS[(i / N) * LDN + i % N];
  }
}

template <typename T, int P>
cudaError_t launch(const void* x, const float* dt, const float* A, const float* Bm,
                   const float* Cm, void* y, float* final_state, int batch,
                   int heads, int seq, int n_state, cudaStream_t stream) {
  const int ldn = n_state + 1;
  const size_t smem =
      (size_t)(2 * kL * ldn + kL * P + kL * (kL + 1) + P * ldn + 3 * kL) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, P><<<(unsigned)(batch * heads), kThreads, smem, stream>>>(
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
// cudaErrorInvalidValue; the Python wrapper checks first).  final_state may
// be null.
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
