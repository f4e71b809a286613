// Causal GQA prefill attention (blockwise online softmax) for Hopper, sm_90a.
//
// Replaces the JAX package's Pallas TPU kernel `_flash_kernel` in
// repro/kernels/flash_attn/kernel.py (wrapper `flash_attention_pallas`).
//
//   q (B, H, S, Dh), k and v (B, Hkv, S, Dh), f32 or bf16 -> out (B, H, S, Dh)
//   in q's dtype.  Query head h reads KV head h / (H / Hkv).
//
// What bounds it on this card: bytes while S is short (q, K/V and out once
// over 3.35 TB/s; the serving engine's prompts of ~77 tokens and its
// max_len of 512 both sit there), operations beyond (4*B*H*sum(valid
// keys)*Dh FLOPs against the tensor cores' 989 TFLOP/s in bf16).  At the
// serving sizes a launch is mostly fixed cost plus a few dependent trips to
// device memory, so the design cuts bytes and round trips, and keeps the
// products on the tensor cores.
//
// bf16 (the serving dtype), `flash_attn_bf16_kernel`:
// - Grid: one block of 4 warps per (batch * KV head, tile of 64 packed
//   query rows).  A tile packs the G = H / Hkv query heads of one KV head,
//   interleaved by position: packed row r is (position r / G, head r % G).
//   So each K/V tile goes through shared memory once for the whole GQA
//   group, and a tile spans only 64 / G positions, which keeps the causal
//   skip tight: K tiles past the tile's last position are never loaded, and
//   a warp skips a K tile that lies wholly past its own 16 rows.
// - Memory: Q, K and V stay bf16 in shared memory.  The Q tile and the
//   first K/V tile are fetched with 16-byte cp.async; K/V tiles of 64 keys
//   are double-buffered, the next tile's copy in flight while the current
//   one is multiplied.  Rows are padded by 16 bytes, so the eight rows an
//   ldmatrix reads fall in distinct banks.  Keys, values and query rows
//   past S are zero-filled by the copy, never read.
// - Products: S = Q K^T with mma.sync m16n8k16 (bf16 x bf16 -> f32, exact
//   per product), Q fragments loaded once into registers, K fragments with
//   ldmatrix; the f32 logits are scaled after the product (for head dims
//   16, 64 and 256, whose scale is a power of two, that is the Pallas
//   kernel's q * scale exactly; for the others it differs by one f32
//   rounding), and by log2(e) with it, so that p = exp2(s' - m')
//   (ex2.approx: relative error ~2^-22, far inside the tolerance).
//   Masking (keys >= S, causal; only on tiles that reach past some row's
//   last key) and the online softmax stay in registers, row max and sum
//   across the four lanes of a quad; the tile loop's body is straight-line
//   code apart from those two tests.  Under causal masking the tiles with
//   the most K tiles start first.  P V keeps p at f32 precision: p is
//   split into hi = bf16(p) and lo = bf16(p - hi), and both go through mma
//   into the same f32 accumulator (about 16 significant bits of p), with V
//   fragments from ldmatrix.trans.
// - Head dims 16 to 128: each warp holds its 16 rows' Q fragments and all
//   DH / 8 output n-tiles in registers.  At 192 and 256 that is more than
//   a thread's 255 registers (the output alone is DH / 2 floats per lane),
//   so the block has two column groups of 4 warps: warp w owns rows
//   16 (w % 4).. and output columns (w / 4) DH / 2.., and both groups
//   compute the same logits (the same instructions on the same rows), so
//   the outputs are bit for bit those of one warp over all columns, and
//   the decode kernel's, which splits the columns 8 at a time.
//
// f32 (the check dtype), `flash_attn_f32_kernel`: one block of 256 threads
// per (batch * head, 64 query rows), f32 products on the CUDA cores (TF32
// would not hold the 2e-3 tolerance), padded shared-memory rows.
//
// Numerics of both follow the Pallas kernel: logits, the online softmax, p
// and the accumulator are f32; the output is acc / max(l, 1e-30) cast to
// q's dtype.  Keys at or past S are masked with -1e30, so any S works.
//
// Built for the head dims in HEAD_DIMS below (those the reference's registry
// and kernel tests use; kernels/build.py's ATTN_HEAD_DIMS lists the same).  The source is compiled once per head dim with
// -DHEAD_DIM=<dh>, which defines flash_attn_launch_<dh> (that dim's f32 and
// bf16 instances), and once without, which defines the dispatcher
// flash_attn_launch (kernels/build.py links the units into one library).
//
// Plain C interface, bound with ctypes.  The launcher runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/attn_tile.cuh"
#include "../../csrc/hopper_ptx.cuh"

#define HEAD_DIMS(X) X(16) X(32) X(64) X(112) X(128) X(192) X(256)

#define FLASH_ARGS                                                                 \
  const void *q, const void *k, const void *v, void *out, int batch, int heads,   \
      int kv_heads, int seq, int causal, float scale, int dtype, cudaStream_t stream
#define DECLARE_LAUNCH(dh) int flash_attn_launch_##dh(FLASH_ARGS);
extern "C" {
HEAD_DIMS(DECLARE_LAUNCH)
}

#ifdef HEAD_DIM

namespace {

using attn::kBK;      // keys per tile
using attn::kNegInf;  // the logit of a masked key
constexpr int kBQ = 64;  // query rows per block (f32)

// ---------------------------------------------------------------- bf16

constexpr int kWarpsBf16 = 4;              // each warp owns 16 packed query rows
constexpr int kBQ16 = kWarpsBf16 * 16;      // packed query rows per block

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery's round-up method); the GQA group size is fixed for a launch,
// and a packed row's (position, head) costs no integer division
struct FastDiv {
  int d;
  uint32_t magic;
  int shift;
  explicit FastDiv(int divisor) : d(divisor), shift(0) {
    while ((1ll << shift) < d) ++shift;
    magic = (uint32_t)((((1ull << 32) * ((1ull << shift) - d)) / d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return (int)(((unsigned long long)__umulhi((uint32_t)n, magic) + (uint32_t)n) >> shift);
  }
};

// column groups of the output: two past 128, where one warp's 16 rows over
// every column would take more registers than a thread has
template <int DH>
__host__ __device__ constexpr int column_groups() {
  return DH > 128 ? 2 : 1;
}

template <int DH>
constexpr int bf16_smem_bytes() {
  return (kBQ16 + 4 * kBK) * (DH + 8) * 2;  // Q, 2 x K, 2 x V
}

template <int DH>
__global__ void __launch_bounds__(kWarpsBf16 * 32 * column_groups<DH>())
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int heads, int kv_heads,
                       int seq, float scale, int causal, FastDiv group) {
  constexpr int LDS = DH + 8;     // padded row stride (elements)
  constexpr int KS = DH / 16;     // k-steps of Q K^T
  constexpr int NCG = column_groups<DH>();
  constexpr int NO = DH / 8 / NCG;  // output n-tiles of one warp
  constexpr int CH = DH / 8;      // 16-byte chunks per row
  constexpr int NT = kWarpsBf16 * 32 * NCG;  // threads
  static_assert(DH % 16 == 0 && (DH / 8) % NCG == 0 && (kBK * CH) % NT == 0,
                "head dim: a multiple of 16 whose row tiles the block copies evenly");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (kBQ16, LDS)
  __nv_bfloat16* sk = sq + kBQ16 * LDS;                           // 2 x (64, LDS)
  __nv_bfloat16* sv = sk + 2 * kBK * LDS;                         // 2 x (64, LDS)

  const int bk = blockIdx.y;  // b * kv_heads + KV head
  const int b = bk / kv_heads, kvh = bk % kv_heads;
  const int rows = seq * group.d;  // packed rows of this (b, KV head)
  // causal: the tiles with the most K tiles start first
  const int r0 = (causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kBQ16;
  const int warp = threadIdx.x / 32 % kWarpsBf16, lane = threadIdx.x % 32;
  const int col0 = threadIdx.x / (kWarpsBf16 * 32) * NO * 8;  // the warp's first output column
  const long long hs = (long long)seq * DH;  // elements per head
  // head kvh * group + j of batch b starts at qh + j * hs
  const __nv_bfloat16* qh = q + ((long long)b * heads + (long long)kvh * group.d) * hs;
  __nv_bfloat16* oh = out + ((long long)b * heads + (long long)kvh * group.d) * hs;
  // packed row r is position r / G of head r % G
  auto row_at = [&](auto* base, int r) {
    const int pos = group.div(r);
    return base + (r - pos * group.d) * hs + (long long)pos * DH;
  };
  const __nv_bfloat16* kb = k + (long long)bk * hs;
  const __nv_bfloat16* vb = v + (long long)bk * hs;

  // keys this tile needs: causal stops at its last row's position
  const int last_row = min(r0 + kBQ16, rows) - 1;
  const int k_end = causal ? group.div(last_row) + 1 : seq;
  const int n_tiles = (k_end + kBK - 1) / kBK;

  // copies: pass i moves 16-byte chunk c % CH of row c / CH, c = tid + NT i;
  // rows past S (or past the packed rows) are zero-filled, never read
#pragma unroll
  for (int i = 0; i < kBQ16 * CH / NT; ++i) {
    const int c = threadIdx.x + NT * i, r = c / CH, cc = c % CH * 8;
    const int pr = r0 + r;
    const bool ok = pr < rows;
    ptx::cp_async16(sq + r * LDS + cc, ok ? row_at(qh, pr) + cc : qh, ok ? 16 : 0);
  }
  auto copy_kv = [&](int t0, int buf) {
#pragma unroll
    for (int i = 0; i < kBK * CH / NT; ++i) {
      const int c = threadIdx.x + NT * i, r = c / CH, cc = c % CH * 8;
      const int key = t0 + r;
      const bool ok = key < seq;
      const long long off = (long long)key * DH + cc;
      ptx::cp_async16(sk + (buf * kBK + r) * LDS + cc, ok ? kb + off : kb, ok ? 16 : 0);
      ptx::cp_async16(sv + (buf * kBK + r) * LDS + cc, ok ? vb + off : vb, ok ? 16 : 0);
    }
  };
  copy_kv(0, 0);
  ptx::cp_async_commit();

  // this thread's two rows of the warp's 16: g and g + 8; a row attends to
  // keys [0, kmax) (causal: up to its own position)
  const int g = lane / 4;
  const int wr0 = r0 + warp * 16;
  const bool warp_live = wr0 < rows;
  const int kmax0 = causal ? min(seq, group.div(wr0 + g) + 1) : seq;
  const int kmax1 = causal ? min(seq, group.div(wr0 + g + 8) + 1) : seq;
  // the fewest and the most keys any of the warp's live rows attends to
  const int warp_kmin = causal ? min(seq, group.div(wr0) + 1) : seq;
  const int warp_kmax = causal ? min(seq, group.div(min(wr0 + 15, rows - 1)) + 1) : seq;
  const float scale2 = scale * 1.4426950408889634f;  // logits in log2 units: p = 2^(s' - m')

  uint32_t qf[KS][4];
  attn::Rows<NO> st;
  st.init();

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1, t0 = t * kBK;
    if (t + 1 < n_tiles) copy_kv(t0 + kBK, buf ^ 1);
    ptx::cp_async_commit();  // possibly empty: keeps wait_group<1> exact
    ptx::cp_async_wait<1>();
    __syncthreads();  // tile t (and Q) visible to every warp

    if (t == 0) attn::load_q<DH, LDS>(qf, sq + warp * 16 * LDS, lane);
    if (warp_live && t0 < warp_kmax)  // else every key of the tile is masked
      attn::tile<DH, LDS, NO, LDS>(st, qf, sk + buf * kBK * LDS,
                                   sv + buf * kBK * LDS + col0, t0 + kBK > warp_kmin,
                                   kmax0 - t0, kmax1 - t0, scale2, lane);
    __syncthreads();  // every warp is done with buffer `buf` before it is refilled
  }
  ptx::cp_async_wait<0>();

  if (!warp_live) return;
  const int pr0 = wr0 + g, pr1 = wr0 + g + 8;
  attn::store(st, pr0 < rows ? row_at(oh, pr0) + col0 : nullptr,
              pr1 < rows ? row_at(oh, pr1) + col0 : nullptr, lane);
}

// ----------------------------------------------------------------- f32

constexpr int kThreadsF32 = 256;  // 16 x 16: ty owns rows ty + 16 i, tx keys / dims tx + 16 j

template <int DH>
constexpr int f32_smem_bytes() {
  return (2 * kBQ * (DH + 1) + kBQ * (kBK + 1)) * 4;  // Q, K/V, P
}

// rows [r0, r0 + ROWS) of a (seq, DH) matrix, times `mul`, into a
// (ROWS, DH + 1) tile; rows at or past `valid` read as 0
template <int DH, int ROWS>
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src,
                                          int r0, int valid, float mul) {
  constexpr int LD = DH + 1;
  for (int i = threadIdx.x; i < ROWS * DH; i += kThreadsF32) {
    const int r = i / DH, d = i % DH;
    dst[r * LD + d] = r0 + r < valid ? src[(long long)(r0 + r) * DH + d] * mul : 0.0f;
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsF32)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ out, int heads,
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
  const float* qb = q + (long long)bh * seq * DH;
  const float* kb = k + (long long)kvh * seq * DH;
  const float* vb = v + (long long)kvh * seq * DH;

  stage_f32<DH, kBQ>(sq, qb, q0, seq, scale);

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
    stage_f32<DH, kBK>(skv, kb, t0, seq, 1.0f);
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
    stage_f32<DH, kBK>(skv, vb, t0, seq, 1.0f);
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

  float* ob = out + (long long)bh * seq * DH;
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= seq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[(long long)row * DH + tx + 16 * j] = acc[i][j] / den;
  }
}

// ------------------------------------------------------------ launchers

template <int DH>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* out,
                        int batch, int heads, int kv_heads, int seq, float scale,
                        int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_ready{0};
  constexpr int smem = bf16_smem_bytes<DH>();
  cudaError_t err =
      ptx::allow_dynamic_smem(flash_attn_bf16_kernel<DH>, smem, smem_ready);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)seq * (heads / kv_heads);
  const long long tiles = (rows + kBQ16 - 1) / kBQ16;
  if (rows > 0x7fffffffLL || (long long)batch * kv_heads > 65535)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)(batch * kv_heads));
  flash_attn_bf16_kernel<DH><<<grid, kWarpsBf16 * 32 * column_groups<DH>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), heads,
      kv_heads, seq, scale, causal, FastDiv(heads / kv_heads));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int batch, int heads, int kv_heads, int seq, float scale,
                       int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_ready{0};
  constexpr int smem = f32_smem_bytes<DH>();
  cudaError_t err =
      ptx::allow_dynamic_smem(flash_attn_f32_kernel<DH>, smem, smem_ready);
  if (err != cudaSuccess) return err;
  if ((seq + kBQ - 1) / kBQ > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)(batch * heads), (unsigned)((seq + kBQ - 1) / kBQ));
  flash_attn_f32_kernel<DH><<<grid, kThreadsF32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), heads, kv_heads, seq,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

#define CAT_(a, b) a##b
#define CAT(a, b) CAT_(a, b)

extern "C" int CAT(flash_attn_launch_, HEAD_DIM)(FLASH_ARGS) {
  if (dtype == 0)
    return (int)launch_f32<HEAD_DIM>(q, k, v, out, batch, heads, kv_heads, seq, scale,
                                     causal, stream);
  return (int)launch_bf16<HEAD_DIM>(q, k, v, out, batch, heads, kv_heads, seq, scale,
                                    causal, stream);
}

#else  // the dispatcher

extern "C" {

const char* flash_attn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dtype: 0 float32, 1 bfloat16.  head_dim: one of HEAD_DIMS (anything else
// is refused with cudaErrorInvalidValue; the Python wrapper checks first).
int flash_attn_launch(const void* q, const void* k, const void* v, void* out,
                      int batch, int heads, int kv_heads, int seq, int head_dim,
                      int causal, float scale, int dtype, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (batch <= 0 || seq <= 0) return (int)cudaSuccess;
  if (kv_heads <= 0 || heads % kv_heads != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
#define CASE(dh)                                                                      \
  case dh:                                                                            \
    return flash_attn_launch_##dh(q, k, v, out, batch, heads, kv_heads, seq, causal, \
                                  scale, dtype, stream);
    HEAD_DIMS(CASE)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

#endif  // HEAD_DIM
