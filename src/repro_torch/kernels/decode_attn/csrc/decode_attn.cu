// One-token GQA attention over a KV cache, for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_decode_kernel` in
// repro/kernels/decode_attn/kernel.py (wrapper `decode_attention_pallas`).
//
//   q (B, H, Dh), k and v (B, Hkv, S, Dh), f32 or bf16, pos (B,) int32
//   -> out (B, H, Dh) in q's dtype: row b attends to cache slots [0, pos[b]).
//
// What bounds it on this card: bytes.  Every cached key and value up to pos
// is read once and used for 2*G multiply-adds per element (about 3 FLOP per
// byte at G = 3, against the ~295 at which the tensor cores would matter),
// so the least time is (q + 2*B*Hkv*pos*Dh elements + out) over 3.35 TB/s.
// At the serving engine's sizes (B*Hkv = 32, pos ~ 100) that is well under
// a microsecond, and what a launch costs is latency: how many blocks run at
// once, how many bytes each has in flight, and how long its chain of
// dependent steps is.  Both instances are sized from the cache length S,
// never from pos (reading pos on the host would sync every decode step),
// copy K and V with 16-byte cp.async, and never read a slot at or past pos
// (zero-filled by the copy, masked with -1e30).
//
// bf16 (the serving dtype), `decode_bf16_kernel`: one warp per (batch * KV
// head, 16 of its G query heads, 8 of the Dh output columns), so the
// engine's batch (B*Hkv = 32, G = 3, Dh = 64) launches 256 blocks.  Each
// block runs the prefill kernel's own tile step (`kernels/csrc/
// attn_tile.cuh`) over 64-key tiles of the cache, double-buffered: Q K^T
// and P V on the tensor cores, the online softmax in registers, p split
// into bf16 hi + lo.  The split is over output columns, not over the
// cache, so a decode step's output is bit for bit the prefill kernel's
// output for the same token's row: in bf16 a model amplifies any
// difference in rounding layer by layer, and the serving engine's decode
// steps then agree exactly with a forward pass over the same tokens.
// Every block recomputes the row's softmax (K is read once per column
// slice, from L2) and reads only its 8 columns of V.
//
// f32 (the check dtype), `decode_f32_kernel`, flash-decode: one block of 4
// warps per (batch * KV head, chunk of kChunk = 32 cache slots); a block
// whose chunk starts at or past min(pos[b], S) exits at once.  A live block
// issues its chunk's copies at once, scales the group's G query rows into
// shared memory (as the Pallas kernel does) while they fly, and computes
// with two block-wide barriers: warp w takes query rows w, w + 4, ...,
// lane = cache slot, for the G logits per slot, the chunk's max m, p =
// exp(s - m) and l = sum p by warp shuffles; then acc[G, Dh] = sum p v.
// It writes its partial (acc, m, l) to scratch and takes a ticket for its
// (b, KV head); the block that draws the last ticket of the live chunks
// resets the ticket to 0 for the next launch and combines: m* = max m_i
// and l = sum l_i exp(m_i - m*) with lanes over the chunks, then out =
// sum acc_i exp(m_i - m*) / max(l, 1e-30) in chunk order.  The order of
// every sum is fixed (no float atomics), so two calls on the same inputs
// give bit-identical outputs, and empty chunks never enter the combine.
// The wrapper owns the scratch and the tickets (zeroed once).
//
// pos <= 0 gives zeros, as the Pallas kernel's acc / max(l, 1e-30) does.
// Numerics follow the Pallas kernel: f32 logits, softmax, p and
// accumulator; the output is cast to q's dtype once.
//
// Built for the head dims in HEAD_DIMS below (those the reference's registry
// and kernel tests use; kernels/build.py's ATTN_HEAD_DIMS lists the same).
// The source is compiled once per head dim with -DHEAD_DIM=<dh>, which
// defines decode_attn_launch_<dh> (that dim's f32 and bf16 instances), and
// once without, which defines the dispatcher decode_attn_launch
// (kernels/build.py links the units into one library).
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/attn_tile.cuh"
#include "../../csrc/hopper_ptx.cuh"

#define HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(192) X(256)

#define DECODE_ARGS                                                                    \
  const void *q, const void *k, const void *v, const int *pos, void *out, int batch,  \
      int kv_heads, int group, int seq, float scale, int dtype, float *part,          \
      unsigned int *tickets, cudaStream_t stream
#define DECLARE_LAUNCH(dh) int decode_attn_launch_##dh(DECODE_ARGS);
extern "C" {
HEAD_DIMS(DECLARE_LAUNCH)
}

constexpr int kChunk = 32;      // cache slots per f32 block: one per lane
constexpr int kMaxGroup = 128;  // query heads per KV head

#ifdef HEAD_DIM

namespace {

using attn::kBK;      // keys per tile (bf16)
using attn::kNegInf;  // the logit of a masked slot

// ---------------------------------------------------------------- bf16

constexpr int kCols = 8;  // output columns per bf16 block: one mma n-tile

template <int DH>
constexpr int bf16_smem_bytes() {
  return (16 + 2 * kBK) * (DH + 8) * 2 + 2 * kBK * kCols * 2;  // Q, 2 x K, 2 x V slice
}

template <int DH>
__global__ void __launch_bounds__(32)
decode_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int* __restrict__ pos,
                   __nv_bfloat16* __restrict__ out, int kv_heads, int group, int seq,
                   float scale) {
  constexpr int LDS = DH + 8;  // padded row stride of Q and K (elements)
  constexpr int CH = DH / 8;   // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (16, LDS)
  __nv_bfloat16* sk = sq + 16 * LDS;                               // 2 x (64, LDS)
  __nv_bfloat16* sv = sk + 2 * kBK * LDS;                          // 2 x (64, kCols)

  const int blocks16 = (group + 15) / 16;
  const int bk = blockIdx.x / blocks16;               // b * kv_heads + KV head
  const int h0 = (blockIdx.x % blocks16) * 16;        // first query head of the block
  const int c0 = blockIdx.y * kCols;                  // first output column
  const int lane = threadIdx.x, g = lane / 4;
  const int n = min(pos[bk / kv_heads], seq);  // cache slots the row attends to
  const long long row0 = (long long)bk * group + h0;  // (B * H) row of head h0
  __nv_bfloat16* o0 = h0 + g < group ? out + (row0 + g) * DH + c0 : nullptr;
  __nv_bfloat16* o1 = h0 + g + 8 < group ? out + (row0 + g + 8) * DH + c0 : nullptr;
  if (n <= 0) {
    const int c = (lane % 4) * 2;
    if (o0) *reinterpret_cast<uint32_t*>(o0 + c) = 0u;
    if (o1) *reinterpret_cast<uint32_t*>(o1 + c) = 0u;
    return;
  }
  const __nv_bfloat16* kb = k + (long long)bk * seq * DH;
  const __nv_bfloat16* vb = v + (long long)bk * seq * DH + c0;
  for (int i = lane; i < 16 * CH; i += 32) {  // query heads h0.., past G zero-filled
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = h0 + r < group;
    ptx::cp_async16(sq + r * LDS + c, ok ? q + (row0 + r) * DH + c : q, ok ? 16 : 0);
  }
  auto copy_kv = [&](int t0, int buf) {
#pragma unroll 4
    for (int i = lane; i < kBK * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = t0 + r < n;
      ptx::cp_async16(sk + (buf * kBK + r) * LDS + c,
                      ok ? kb + (long long)(t0 + r) * DH + c : kb, ok ? 16 : 0);
    }
    for (int r = lane; r < kBK; r += 32) {
      const bool ok = t0 + r < n;
      ptx::cp_async16(sv + (buf * kBK + r) * kCols, ok ? vb + (long long)(t0 + r) * DH : vb,
                      ok ? 16 : 0);
    }
  };
  copy_kv(0, 0);
  ptx::cp_async_commit();

  const float scale2 = scale * 1.4426950408889634f;  // as the prefill kernel's
  const int n_tiles = (n + kBK - 1) / kBK;
  uint32_t qf[DH / 16][4];
  attn::Rows<1> st;
  st.init();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, t0 = t * kBK;
    if (t + 1 < n_tiles) copy_kv(t0 + kBK, buf ^ 1);
    ptx::cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    ptx::cp_async_wait<1>();
    __syncthreads();
    if (t == 0) attn::load_q<DH, LDS>(qf, sq, lane);
    attn::tile<DH, LDS, 1, kCols>(st, qf, sk + buf * kBK * LDS, sv + buf * kBK * kCols,
                                  t0 + kBK > n, n - t0, n - t0, scale2, lane);
    __syncthreads();  // buffer `buf` is consumed before it is refilled
  }
  ptx::cp_async_wait<0>();
  attn::store(st, o0, o1, lane);
}

// ----------------------------------------------------------------- f32

constexpr int kThreads = 128;  // four warps
constexpr int kWarps = kThreads / 32;

// sum of a[d] * b[d] over 4 floats, a the scaled query in shared memory
__device__ __forceinline__ float dot_vec(const float* a, const float* b) {
  const float4 x = *reinterpret_cast<const float4*>(b);
  const float4 y = *reinterpret_cast<const float4*>(a);
  return y.x * x.x + y.y * x.y + y.z * x.z + y.w * x.w;
}

template <int DH>
size_t f32_smem_bytes(int group) {
  return (size_t)(2 * kChunk * (DH + 4) + group * (DH + kChunk)) * sizeof(float);
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ pos,
                  float* __restrict__ out, float* __restrict__ part,
                  unsigned int* __restrict__ tickets, int kv_heads, int group,
                  int seq, float scale) {
  constexpr int VEC = 4;         // floats per 16-byte copy
  constexpr int LDS = DH + VEC;  // padded row stride
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sk = reinterpret_cast<float*>(smem_raw);  // (kChunk, LDS)
  float* sv = sk + kChunk * LDS;                   // (kChunk, LDS)
  float* sq = sv + kChunk * LDS;                   // (G, DH) q * scale
  float* sp = sq + group * DH;                     // (G, kChunk) p
  __shared__ bool last;

  const int bk = blockIdx.x;  // b * kv_heads + KV head
  const int n = min(pos[bk / kv_heads], seq);  // cache slots this row attends to
  const int chunk = blockIdx.y, c0 = chunk * kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float* ob = out + (long long)bk * group * DH;  // the group's G heads are contiguous
  if (n <= 0) {
    if (chunk == 0)
      for (int i = tid; i < group * DH; i += kThreads) ob[i] = 0.0f;
    return;
  }
  if (c0 >= n) return;
  const int live = (n + kChunk - 1) / kChunk;  // live chunks of this (b, KV head)

  const float* kb = k + (long long)bk * seq * DH;
  const float* vb = v + (long long)bk * seq * DH;
  for (int i = tid; i < kChunk * (DH / VEC); i += kThreads) {
    const int r = i / (DH / VEC), c = (i % (DH / VEC)) * VEC;
    const bool in = c0 + r < n;
    const long long off = (long long)(in ? c0 + r : 0) * DH + c;
    ptx::cp_async16(sk + r * LDS + c, kb + off, in ? 16 : 0);
    ptx::cp_async16(sv + r * LDS + c, vb + off, in ? 16 : 0);
  }
  ptx::cp_async_commit();
  const float* qb = q + (long long)bk * group * DH;
  for (int i = tid; i < group * DH; i += kThreads) sq[i] = qb[i] * scale;
  ptx::cp_async_wait<0>();
  __syncthreads();

  // per-block partial: acc (G, DH), then m (G), then l (G)
  float* pb = part + ((long long)bk * gridDim.y + chunk) * group * (DH + 2);
  for (int g = warp; g < group; g += kWarps) {
    float s = 0.0f;
    const float* qg = sq + g * DH;
    const float* kr = sk + lane * LDS;
#pragma unroll
    for (int d = 0; d < DH; d += VEC) s += dot_vec(qg + d, kr + d);
    s = c0 + lane < n ? s : kNegInf;
    float m = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    const float p = expf(s - m);
    float l = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    sp[g * kChunk + lane] = p;
    if (lane == 0) {
      pb[group * DH + g] = m;
      pb[group * DH + group + g] = l;
    }
  }
  __syncthreads();

  // thread i owns dims (2i mod DH, +1) of query row 2i / DH
  for (int i = tid; i < group * DH / 2; i += kThreads) {
    const int g = (2 * i) / DH, d = (2 * i) % DH;
    const float* pg = sp + g * kChunk;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      const float2 vv = *reinterpret_cast<const float2*>(sv + c * LDS + d);
      a0 = fmaf(pg[c], vv.x, a0);
      a1 = fmaf(pg[c], vv.y, a1);
    }
    *reinterpret_cast<float2*>(pb + g * DH + d) = make_float2(a0, a1);
  }

  // the last live block of this (b, KV head) combines the partials
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    last = atomicAdd(tickets + bk, 1u) == (unsigned)(live - 1);
    if (last) tickets[bk] = 0;  // every other live block has taken its ticket
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* p0 = part + (long long)bk * gridDim.y * group * (DH + 2);
  const long long stride = (long long)group * (DH + 2);  // floats per partial
  // m* and the denominator of query row g: warp w takes rows w, w + 4, ...,
  // lane j the chunks j, j + 32, ... (one round trip for up to 32 chunks),
  // then a fixed shuffle tree
  for (int g = warp; g < group; g += kWarps) {
    float mx = kNegInf;
    for (int j = lane; j < live; j += 32)
      mx = fmaxf(mx, __ldcg(p0 + j * stride + group * DH + g));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float l = 0.0f;
    for (int j = lane; j < live; j += 32) {
      const float* pj = p0 + j * stride + group * DH;
      l = fmaf(__ldcg(pj + group + g), expf(__ldcg(pj + g) - mx), l);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      sp[g] = mx;
      sp[group + g] = fmaxf(l, 1e-30f);
    }
  }
  __syncthreads();
  for (int i = tid; i < group * DH; i += kThreads) {
    const int g = i / DH;
    const float mx = sp[g];
    float a = 0.0f;
#pragma unroll 4
    for (int j = 0; j < live; ++j) {
      const float* pj = p0 + j * stride;
      a = fmaf(__ldcg(pj + i), expf(__ldcg(pj + group * DH + g) - mx), a);
    }
    ob[i] = a / sp[group + g];
  }
}

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const int* pos,
                        void* out, int batch, int kv_heads, int group, int seq,
                        float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_ready{0};  // past 48 KB from head dim 192
  cudaError_t err =
      ptx::allow_dynamic_smem(decode_bf16_kernel<DH>, bf16_smem_bytes<DH>(), smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(batch * kv_heads * ((group + 15) / 16)), (unsigned)(DH / kCols));
  decode_bf16_kernel<DH><<<grid, 32, bf16_smem_bytes<DH>(), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, static_cast<__nv_bfloat16*>(out),
      kv_heads, group, seq, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* pos,
                       void* out, float* part, unsigned int* tickets, int batch,
                       int kv_heads, int group, int seq, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_ready{0};
  cudaError_t err = ptx::allow_dynamic_smem(decode_f32_kernel<DH>,
                                            (int)f32_smem_bytes<DH>(kMaxGroup), smem_ready);
  if (err != cudaSuccess) return err;
  const int chunks = seq > 0 ? (seq + kChunk - 1) / kChunk : 1;  // pos <= 0 writes zeros
  if (chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(batch * kv_heads), (unsigned)chunks);
  decode_f32_kernel<DH><<<grid, kThreads, f32_smem_bytes<DH>(group), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), pos, static_cast<float*>(out), part, tickets,
      kv_heads, group, seq, scale);
  return cudaGetLastError();
}

}  // namespace

#define CAT_(a, b) a##b
#define CAT(a, b) CAT_(a, b)

extern "C" int CAT(decode_attn_launch_, HEAD_DIM)(DECODE_ARGS) {
  if (dtype == 0)
    return (int)launch_f32<HEAD_DIM>(q, k, v, pos, out, part, tickets, batch, kv_heads,
                                     group, seq, scale, stream);
  return (int)launch_bf16<HEAD_DIM>(q, k, v, pos, out, batch, kv_heads, group, seq, scale,
                                    stream);
}

#else  // the dispatcher

extern "C" {

const char* decode_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Cache slots per f32 block; the wrapper sizes the f32 instance's scratch
// with it: B * Hkv * max(1, ceil(S / chunk)) * G * (head_dim + 2) floats,
// and B * Hkv tickets, zero before the first launch (each launch leaves
// them zero).  The bf16 instance takes no scratch.
int decode_attn_chunk(void) { return kChunk; }

// dtype: 0 float32, 1 bfloat16.  head_dim: one of HEAD_DIMS, at most
// kMaxGroup query heads per KV head (anything else is refused with
// cudaErrorInvalidValue; the Python wrapper checks first).  `part` and
// `tickets` are the f32 instance's scratch described at decode_attn_chunk.
int decode_attn_launch(const void* q, const void* k, const void* v,
                       const int* pos, void* out, int batch, int heads,
                       int kv_heads, int seq, int head_dim, float scale,
                       int dtype, void* stream_ptr, void* part, void* tickets) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0) return (int)cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const int group = heads / kv_heads;
  if (group > kMaxGroup) return (int)cudaErrorInvalidValue;
  float* pf = static_cast<float*>(part);
  unsigned int* tk = static_cast<unsigned int*>(tickets);
  switch (head_dim) {
#define CASE(dh)                                                                         \
  case dh:                                                                               \
    return decode_attn_launch_##dh(q, k, v, pos, out, batch, kv_heads, group, seq, scale, \
                                   dtype, pf, tk, stream);
    HEAD_DIMS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // HEAD_DIM
