// Shared pieces of the heads-in-lanes (token-major) attention kernels,
// hil_attention_fwd.cu and hil_attention_bwd.cu: the operand layout, the
// CUDA-core helpers of their f32 kernels, and the relative logits as a
// tensor-core product that the bf16 forward and backward both build.
//
// The packed operand P (B, hw, nh*slot) holds, per token and head, one slot
// [q * dkh^-0.5 (dkh) ; k (dkh) ; v (dvh) ; 0-pad]: it is the output of the
// 1x1 qkv projection as it stands, so no head-split copy exists. Rw
// (W*dkh, W) and Rh (H*dkh, H) are the block operands of the relative
// logits, f32: RC_w[t, m] = sum_d q[t, d] * Rw[(col(t), d), m] and the same
// over rows with Rh. The logit of query t and key j is
//   q_t . k_j + RC_w[t, col(j)] + RC_h[t, row(j)],  col = j % W, row = j / W.
// The slot stride is an argument: the kernels read single elements, so any
// stride >= 2*dkh + dvh works (the model takes the next multiple of 8, which
// keeps every slot 16-byte aligned in bf16 for a later vectorized load). In a
// slot, k starts at element dkh and v at 2*dkh: rows of q or k go by 8-byte
// cp.async only where dkh is a multiple of 4 (slots_aligned).
//
// Head widths: dkh <= KW and dvh <= VW of the width class this library is
// built for (attention_bwd_mma.cuh); wider heads take attention_wide.cuh in
// the largest class's library. The CUDA-core kernels hold q and k DK wide,
// zero past dkh (DK = KW; DK = dkh = 20, a constant, for the model zoo's
// width, which keeps its code).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "attention_bwd_mma.cuh"

namespace hil {

using amma::allow_smem;
constexpr int DVMAX = amma::VW;    // largest dvh (v columns staged VW wide)
using amma::DK_ZOO;
constexpr float NEG_BIG = -1e30f;  // finite "minus infinity": exp(NEG_BIG - m) == 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// a . b over DK (zero past dkh) with four partial sums (a shorter dependency chain)
template <int DK>
__device__ __forceinline__ float dot_dk(const float* a, const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < DK; d += 4) {
    s0 = fmaf(a[d], b[d], s0);
    s1 = fmaf(a[d + 1], b[d + 1], s1);
    s2 = fmaf(a[d + 2], b[d + 2], s2);
    s3 = fmaf(a[d + 3], b[d + 3], s3);
  }
  return (s0 + s1) + (s2 + s3);
}

__device__ __forceinline__ float dot_dv(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) s = fmaf(a[e], b[e], s);
  return s;
}

// The compact relative logits of the query rows q0 .. q0+rows-1 of one
// (batch, head), into shared memory: rel_s[r * rel_stride + c] holds
// RC_w[q0+r, c] for c < W and RC_h[q0+r, c-W] above. q_s is the rows' q,
// (rows, DK) f32 in shared memory. Rw / Rh are read from device memory by
// index (threads of consecutive c read consecutive addresses; the operands
// are at most a few hundred KB and stay in L2). Rows past hw, and every row
// when Rw is null (attention without relative logits), get zeros.
template <int DK>
__device__ __forceinline__ void rel_tile(const float* q_s, const float* __restrict__ Rw,
                                         const float* __restrict__ Rh, int q0, int rows,
                                         int hw, int H, int W, int dkh, float* rel_s,
                                         int rel_stride, int tid, int nthreads) {
  const int WH = W + H;
  for (int e = tid; e < rows * WH; e += nthreads) {
    const int r = e / WH, c = e - r * WH;
    const int i = q0 + r;
    float s = 0.f;
    if (Rw != nullptr && i < hw) {
      const float* base;
      int stride;
      if (c < W) {
        base = Rw + static_cast<size_t>(i % W) * dkh * W + c;
        stride = W;
      } else {
        base = Rh + static_cast<size_t>(i / W) * dkh * H + (c - W);
        stride = H;
      }
      const float* qi = q_s + r * DK;
#pragma unroll
      for (int d = 0; d < DK; ++d)
        if (d < dkh) s = fmaf(qi[d], __ldg(base + d * stride), s);
    }
    rel_s[r * rel_stride + c] = s;
  }
}

inline bool bad_shape(int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh) {
  return dkh < 1 || dkh > amma::KW || dvh < 1 || dvh > DVMAX || slot < 2 * dkh + dvh ||
         hw != H * W || hw < 1 || B < 1 || B > 65535 || nh < 1 || nh > 65535;
}

// Whether the q / k rows of P (dkh lanes from slot elements 0 and dkh) can be
// copied 8 bytes at a time.
inline int slots_aligned(const void* P, int slot, int dkh) {
  return slot % 4 == 0 && dkh % 4 == 0 && reinterpret_cast<uintptr_t>(P) % 8 == 0;
}

// ---------------------------------------------------------------------------
// The relative logits as products, for the bf16 tensor-core kernels. With
// E_w[x][d] = rel_w[d, x] the (dkh, 2W-1) embedding that the block operand was
// built from (Rw[(j, d), m] = rel_w[d, m - j + W - 1]), a query at image
// column c has
//   RC_w[t, m] = G[t, m - c + W - 1],  G = q E_w^T,
// one product for the whole tile and a skewed store; its backward is
//   dq[t, d] += sum_x dG[t, x] E_w[x][d],  dG[t, x] = dRC_w[t, x + c - (W - 1)],
// a product of the skewed bins with E_w. The same over rows with E_h.
// E is staged once per block as bf16 rows of stride KS, KW columns (x rows:
// the W part padded to a multiple of 16 rows, then the H part), split into hi + lo so
// that RC keeps f32 accuracy; rows and columns of padding are zero. The
// forward (B5) and the backward's dq pass (B6) build RC by the same code, so
// the backward's p = exp(S - lse) sees the forward's S.
__host__ __device__ inline int emb_rows(int n) { return (2 * n - 1 + 15) / 16 * 16; }

__device__ __forceinline__ void stage_emb(amma::bf16* e_hi, amma::bf16* e_lo,
                                          const float* __restrict__ R, int n, int rows, int dkh,
                                          int tid, int nthreads) {
  using amma::KS;
  using amma::KW;
  for (int e = tid; e < rows * KW; e += nthreads) {
    const int x = e / KW, d = e - x * KW;
    float val = 0.f;
    if (x < 2 * n - 1 && d < dkh)
      val = x >= n - 1 ? __ldg(R + static_cast<size_t>(d) * n + (x - (n - 1)))
                       : __ldg(R + (static_cast<size_t>(n - 1 - x) * dkh + d) * n);
    const amma::bf16 hi = __float2bfloat16(val);
    e_hi[x * KS + d] = hi;
    e_lo[x * KS + d] = __float2bfloat16(val - __bfloat162float(hi));
  }
}

// RC rows of the warp's 16 queries (A fragments qa of its q rows) for one
// image axis: n = W (pos = the query's column) or H (its row); the n lanes at
// off. Rows that are not ok are not written.
__device__ __forceinline__ void rc_axis(const uint32_t (&qa)[amma::KK][4], const amma::bf16* e_hi,
                                        const amma::bf16* e_lo, int n, int rows,
                                        const int (&pos)[2], const bool (&ok)[2],
                                        float* rel_rows, int rel_stride, int off, int lane) {
  using amma::KS;
  using amma::lds32;
  using amma::mma16816;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int nt = 0; nt < rows / 8; ++nt) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const amma::bf16* hi = e_hi + (nt * 8 + g) * KS + 2 * t;
    const amma::bf16* lo = e_lo + (nt * 8 + g) * KS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < amma::KK; ++ks) {
      mma16816(acc, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], lds32(hi + ks * 16),
               lds32(hi + ks * 16 + 8));
      mma16816(acc, qa[ks][0], qa[ks][1], qa[ks][2], qa[ks][3], lds32(lo + ks * 16),
               lds32(lo + ks * 16 + 8));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = i >> 1;  // row g (0) or g + 8 (1)
      const int m = nt * 8 + 2 * t + (i & 1) - (n - 1) + pos[rr];
      if (ok[rr] && m >= 0 && m < n) rel_rows[(g + 8 * rr) * rel_stride + off + m] = acc[i];
    }
  }
}

}  // namespace hil
