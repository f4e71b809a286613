// One warp's step of bf16 attention over a tile of 64 keys on the tensor
// cores, shared by the prefill kernel (flash_attn.cu: every query row) and
// the bf16 decode kernel (decode_attn.cu: the newest token's row of each
// head).  Both run these same instructions on a row, so a decode step's
// output for a token is bit for bit the prefill kernel's output for that
// token's row, and a decode step over a cache agrees exactly with a
// forward pass over the same tokens (in bf16 a single differently rounded
// attention output is amplified layer by layer).
//
// Per tile: S = Q K^T with mma.sync m16n8k16 (bf16 x bf16 -> f32, Q
// fragments in registers, K fragments by ldmatrix), the f32 logits scaled
// by scale * log2(e), keys masked with -1e30 where asked, the online
// softmax in log2 units (row max and sum across the four lanes of a quad,
// p = exp2 by ex2.approx), and P V with p split into hi = bf16(p) and
// lo = bf16(p - hi), both through mma into the f32 accumulator, V
// fragments by ldmatrix.trans.
#pragma once

#include "hopper_ptx.cuh"

namespace attn {

constexpr int kBK = 64;  // keys per tile
constexpr float kNegInf = -1e30f;

// The online-softmax state of a warp's 16 query rows held by this thread
// (g = lane / 4): row g in m0, l0, o[.][0..1] and row g + 8 in m1, l1,
// o[.][2..3], over NO output n-tiles of 8 columns (this thread's columns
// 2 (lane % 4) and +1 of each); l is this thread's share of the row sum.
template <int NO>
struct Rows {
  float m0, m1, l0, l1;
  float o[NO][4];

  __device__ __forceinline__ void init() {
    m0 = m1 = kNegInf;
    l0 = l1 = 0.0f;
#pragma unroll
    for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  }
};

// A fragments of the 16 rows of a bf16 Q tile at `sq` (row stride LDS).
template <int DH, int LDS>
__device__ __forceinline__ void load_q(uint32_t (&qf)[DH / 16][4],
                                       const __nv_bfloat16* sq, int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ptx::ldmatrix_x4(qf[ks], sq + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
}

// One tile of kBK keys.  kt: the K tile (kBK rows of DH, row stride LDS);
// vt: the V tile at the first of the NO output n-tiles' columns (row
// stride VLDS).  With `mask`, key t0 + c of row g (g + 8) is masked where
// c >= lim0 (lim1).
template <int DH, int LDS, int NO, int VLDS>
__device__ __forceinline__ void tile(Rows<NO>& r, const uint32_t (&qf)[DH / 16][4],
                                     const __nv_bfloat16* kt, const __nv_bfloat16* vt,
                                     bool mask, int lim0, int lim1, float scale2,
                                     int lane) {
  constexpr int NT = kBK / 8;  // n-tiles of the logits
  const int t4 = lane % 4;
  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t kf[4];  // b0, b1 of keys np*16 + 0..7, then of + 8..15
      ptx::ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                               ks * 16 + ((lane >> 3) & 1) * 8);
      ptx::mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
      ptx::mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
    }
  }
  // scale, then mask: element (j, e) is key j*8 + 2 t4 + (e & 1) of the
  // tile in row g (e < 2) or g + 8
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
  if (mask) {
    lim0 -= t4 * 2;
    lim1 -= t4 * 2;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j * 8 + (e & 1) >= (e < 2 ? lim0 : lim1)) s[j][e] = kNegInf;
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(r.m0, mx0), mn1 = fmaxf(r.m1, mx1);
  const float a0 = ptx::exp2_approx(r.m0 - mn0), a1 = ptx::exp2_approx(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ptx::exp2_approx(s[j][0] - mn0);
    s[j][1] = ptx::exp2_approx(s[j][1] - mn0);
    s[j][2] = ptx::exp2_approx(s[j][2] - mn1);
    s[j][3] = ptx::exp2_approx(s[j][3] - mn1);
    rs0 += s[j][0] + s[j][1];
    rs1 += s[j][2] + s[j][3];
  }
  r.l0 = fmaf(r.l0, a0, rs0);
  r.l1 = fmaf(r.l1, a1, rs1);
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    r.o[j][0] *= a0;
    r.o[j][1] *= a0;
    r.o[j][2] *= a1;
    r.o[j][3] *= a1;
  }
  // P V over 16 keys per step: the logits' accumulator layout of two
  // n-tiles is the A operand's layout; p = hi + lo, both bf16
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      // a0: (g, 2t..) = s[2kk][0..1]; a1: (g+8) = s[2kk][2..3];
      // a2, a3: the same of n-tile 2kk + 1
      const float p0 = s[2 * kk + (h >> 1)][(h & 1) * 2];
      const float p1 = s[2 * kk + (h >> 1)][(h & 1) * 2 + 1];
      hi[h] = ptx::pack_bf16(p0, p1);
      const float h0 = __uint_as_float(hi[h] << 16);
      const float h1 = __uint_as_float(hi[h] & 0xffff0000u);
      lo[h] = ptx::pack_bf16(p0 - h0, p1 - h1);
    }
    // V rows kk*16 + 0..7 and + 8..15 of each n-tile; each n-tile takes
    // hi, then lo
    const __nv_bfloat16* vr = vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * VLDS;
#pragma unroll
    for (int n = 0; n + 1 < NO; n += 2) {
      uint32_t vf[4];  // b0, b1 of n-tile n, then of n-tile n + 1
      ptx::ldmatrix_x4_trans(vf, vr + n * 8 + (lane >> 4) * 8);
      ptx::mma_bf16(r.o[n], hi, vf[0], vf[1]);
      ptx::mma_bf16(r.o[n + 1], hi, vf[2], vf[3]);
      ptx::mma_bf16(r.o[n], lo, vf[0], vf[1]);
      ptx::mma_bf16(r.o[n + 1], lo, vf[2], vf[3]);
    }
    if constexpr (NO % 2) {
      uint32_t vf[2];
      ptx::ldmatrix_x2_trans(vf, vr + (NO - 1) * 8);
      ptx::mma_bf16(r.o[NO - 1], hi, vf[0], vf[1]);
      ptx::mma_bf16(r.o[NO - 1], lo, vf[0], vf[1]);
    }
  }
}

// The rows' outputs, o / max(l, 1e-30) in bf16: row g to `row0`, row g + 8
// to `row1` (each at the first output column; nullptr: not written).
template <int NO>
__device__ __forceinline__ void store(Rows<NO>& r, __nv_bfloat16* row0,
                                      __nv_bfloat16* row1, int lane) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    r.l0 += __shfl_xor_sync(0xffffffffu, r.l0, off);
    r.l1 += __shfl_xor_sync(0xffffffffu, r.l1, off);
  }
  const float inv0 = 1.0f / fmaxf(r.l0, 1e-30f), inv1 = 1.0f / fmaxf(r.l1, 1e-30f);
  const int c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    if (row0)
      *reinterpret_cast<uint32_t*>(row0 + j * 8 + c) =
          ptx::pack_bf16(r.o[j][0] * inv0, r.o[j][1] * inv0);
    if (row1)
      *reinterpret_cast<uint32_t*>(row1 + j * 8 + c) =
          ptx::pack_bf16(r.o[j][2] * inv1, r.o[j][3] * inv1);
  }
}

}  // namespace attn
