// Shared pieces of the heads-in-lanes (token-major) attention kernels,
// hil_attention_fwd.cu and hil_attention_bwd.cu.
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
// keeps every slot 16-byte aligned in bf16 for a later vectorized load).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace hil {

constexpr int DKH = 20;            // the AAConv head width (min_dk_per_head)
constexpr int DVMAX = 8;           // largest dvh (v columns staged 8 wide)
constexpr float NEG_BIG = -1e30f;  // finite "minus infinity": exp(NEG_BIG - m) == 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// a . b over DKH with four partial sums (a shorter dependency chain)
__device__ __forceinline__ float dot_dk(const float* a, const float* b) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d = 0; d < DKH; d += 4) {
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
// (rows, DKH) f32 in shared memory. Rw / Rh are read from device memory by
// index (threads of consecutive c read consecutive addresses; the operands
// are at most a few hundred KB and stay in L2). Rows past hw, and every row
// when Rw is null (attention without relative logits), get zeros.
__device__ __forceinline__ void rel_tile(const float* q_s, const float* __restrict__ Rw,
                                         const float* __restrict__ Rh, int q0, int rows,
                                         int hw, int H, int W, float* rel_s,
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
        base = Rw + static_cast<size_t>(i % W) * DKH * W + c;
        stride = W;
      } else {
        base = Rh + static_cast<size_t>(i / W) * DKH * H + (c - W);
        stride = H;
      }
      const float* qi = q_s + r * DKH;
#pragma unroll
      for (int d = 0; d < DKH; ++d) s = fmaf(qi[d], __ldg(base + d * stride), s);
    }
    rel_s[r * rel_stride + c] = s;
  }
}

inline bool bad_shape(int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh) {
  return dkh != DKH || dvh < 1 || dvh > DVMAX || slot < 2 * DKH + dvh || hw != H * W ||
         hw < 1 || B < 1 || B > 65535 || nh < 1 || nh > 65535;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace hil
