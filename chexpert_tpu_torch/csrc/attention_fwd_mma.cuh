// The tensor-core tile arithmetic of the two attention forward kernels,
// rel_attention_fwd.cu (head-major operands, B1) and hil_attention_fwd.cu
// (heads-in-lanes operands, B5), bf16 in and f32 sums, for sm_90a.
//
// Both compute, per (batch, head) and query row t,
//   S[t, j] = q_t . k_j + RC_w[t, col(j)] + RC_h[t, row(j)]
//   out_t = sum_j p[t, j] v_j / l_t,  p = exp(S - m_t),  l_t = sum_j p[t, j]
//   lse_t = m_t + log l_t
// by an online softmax over tiles of TN keys, and differ in where the
// operands live (each .cu stages its own tiles and writes its own outputs).
// This header holds the warp's part, on the fragment helpers of
// attention_bwd_mma.cuh. A warp owns 16 query rows, FWD_WARPS warps a block:
//   - S = q k^T over a key tile: dkh is padded to the width class's KW in
//     shared memory only (one side of the padded columns is zero), KW / 16
//     k16 steps x TN/8 n8 tiles of mma.sync.m16n8k16, f32 accumulators.
//   - The relative logits are added per accumulator element from the
//     queries' RC rows in shared memory (f32 rows computed in the block for
//     B5; the bf16 RW / RH lanes of the staged qr rows for B1), at the key's
//     image column and row read from the key table (KeyTable::kpos), as pass
//     dq of the backward does.
//   - Ragged key tails get S = -inf by index; the tile's row max is taken
//     across the quad of lanes that holds a row (__shfl_xor_sync), and
//     p = ex2(S log2e - m log2e) is one FMA and one ex2.
//   - l is summed from the f32 p; p is rounded to bf16 once, where the
//     accumulators of two neighbouring n8 tiles become the A fragment
//     (16 queries x 16 keys) of p v, with no trip through shared memory. v is
//     read as [key][dv] through ldmatrix.trans, dvh padded to VW columns (VW /
//     8 n8 tiles); a column past dvh only reaches an accumulator column that
//     is not written.
//   - lse = m + log l in f32. The backward (B2 / B6) recomputes p = exp(S -
//     lse) from the same bf16 products summed in f32 and the same RC rows.
// Padded query rows (past hw) compute finite rows that are never written.

#pragma once

#include <cmath>

#include "attention_bwd_mma.cuh"

namespace amma {

constexpr int FWD_WARPS = 4;                 // a block: 64 queries
constexpr int FWD_ROWS = FWD_WARPS * 16;
constexpr int FWD_NT = TN / 8;               // n8 tiles of S per key tile

struct FwdWarp {
  uint32_t qa[KK][4];  // A fragments of q
  float m[2];          // running max of rows g and g+8
  float l[2];          // this lane's share of their row sums (its columns)
  float o[NV][4];      // p v: rows g, g+8 x dv columns 8 nv + 2t, 8 nv + 2t + 1
};

__device__ __forceinline__ void fwd_init(FwdWarp& st, const bf16* q_s, int qs, int warp,
                                         int lane) {
  const int r0 = warp * 16 + (lane >> 2);
  load_a_frags(st.qa, q_s, qs, r0, r0 + 8, lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.o[nv][i] = 0.f;
}

// The relative logits and the mask of the ragged key tail for the n8 tile of
// keys n0 .. n0 + 7: c holds its products q . k^T (rows g, g + 8 x keys n0 +
// 2t, n0 + 2t + 1), s gets its logits (-inf past kn) and mx0 / mx1 take the
// rows' maxima over this lane's keys. rel0 / rel1: the RC rows of rows g and
// g + 8; paired: rc_paired of the RC tile.
template <typename RelT>
__device__ __forceinline__ void fwd_logits(float (&c)[4], float (&s)[4], float& mx0, float& mx1,
                                           int n0, const int* kpos, const RelT* rel0,
                                           const RelT* rel1, bool paired, int W, int kn, int t) {
  const int2 kp = *reinterpret_cast<const int2*>(kpos + n0 + 2 * t);
  const int ca = kp.x & 0xffff, ra = kp.x >> 16;
  const int cb = kp.y & 0xffff, rb = kp.y >> 16;
  if (paired) {
    float c0a, c0b, c1a, c1b;
    load_pair(rel0 + ca, c0a, c0b);
    load_pair(rel1 + ca, c1a, c1b);
    const float r0r = to_f(rel0[W + ra]), r1r = to_f(rel1[W + ra]);
    c[0] += c0a + r0r;
    c[1] += c0b + r0r;
    c[2] += c1a + r1r;
    c[3] += c1b + r1r;
  } else {
    c[0] += to_f(rel0[ca]) + to_f(rel0[W + ra]);
    c[1] += to_f(rel0[cb]) + to_f(rel0[W + rb]);
    c[2] += to_f(rel1[ca]) + to_f(rel1[W + ra]);
    c[3] += to_f(rel1[cb]) + to_f(rel1[W + rb]);
  }
  const bool va = n0 + 2 * t < kn, vb = n0 + 2 * t + 1 < kn;
  s[0] = va ? c[0] : -INFINITY;
  s[1] = vb ? c[1] : -INFINITY;
  s[2] = va ? c[2] : -INFINITY;
  s[3] = vb ? c[3] : -INFINITY;
  mx0 = fmaxf(mx0, fmaxf(s[0], s[1]));
  mx1 = fmaxf(mx1, fmaxf(s[2], s[3]));
}

// The online softmax and p v of a key tile from its logits s (fwd_logits of
// every n8 tile) and this lane's row maxima mx0 / mx1; v as fwd_step takes it.
__device__ __forceinline__ void fwd_softmax(FwdWarp& st, const float (&s)[FWD_NT][4], float mx0,
                                            float mx1, const bf16* v_s, int vs, int lane) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the quad of lanes 4g .. 4g+3 holds the row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // every tile holds a key (kn >= 1), so the new maxima are finite; the first
  // tile's rescale is exp(-inf) = 0
  const float m0 = fmaxf(st.m[0], mx0), m1 = fmaxf(st.m[1], mx1);
  const float m0l = m0 * LOG2E, m1l = m1 * LOG2E;
  const float a0 = exp_shifted(st.m[0], m0l), a1 = exp_shifted(st.m[1], m1l);
  st.m[0] = m0;
  st.m[1] = m1;
  float l0 = st.l[0] * a0, l1 = st.l[1] * a1;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    st.o[nv][0] *= a0;
    st.o[nv][1] *= a0;
    st.o[nv][2] *= a1;
    st.o[nv][3] *= a1;
  }
#pragma unroll
  for (int kc = 0; kc < TN / 16; ++kc) {
    uint32_t pa[4];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const float* c = s[2 * kc + half];
      const float p0 = exp_shifted(c[0], m0l), p1 = exp_shifted(c[1], m0l);
      const float p2 = exp_shifted(c[2], m1l), p3 = exp_shifted(c[3], m1l);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[2 * half] = pack_bf16(p0, p1);
      pa[2 * half + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, v_s + (kc * 16 + (lane & 15)) * vs + nv * 8);
      mma16816(st.o[nv], pa[0], pa[1], pa[2], pa[3], b0, b1);
    }
  }
  st.l[0] = l0;
  st.l[1] = l1;
}

// One key tile: k (TN rows of stride ks, dkh columns then columns up to KW
// that only have to be finite), v (TN rows of stride vs, 16-byte aligned, VW
// columns), kpos (TN key positions, column | row << 16), of which kn keys
// exist; rel_s holds the RC rows of the block's queries (rows and even lanes
// aligned to a pair).
template <typename RelT>
__device__ __forceinline__ void fwd_step(FwdWarp& st, const bf16* k_s, int ks, const bf16* v_s,
                                         int vs, const int* kpos, const RelT* rel_s,
                                         int rel_stride, int W, int kn, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const RelT* rel0 = rel_s + (warp * 16 + g) * rel_stride;
  const RelT* rel1 = rel0 + 8 * rel_stride;
  const bool paired = rc_paired(rel_s, W);  // keys 2t and 2t+1 share an image row
  float s[FWD_NT][4];
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < FWD_NT; ++nt) {
    const int n0 = nt * 8;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    mma_k(c, st.qa, k_s + (n0 + g) * ks + 2 * t);
    fwd_logits(c, s[nt], mx0, mx1, n0, kpos, rel0, rel1, paired, W, kn, t);
  }
  fwd_softmax(st, s, mx0, mx1, v_s, vs, lane);
}

// The warp's results: out[nv][i] (rows g, g+8 at dv columns 8 nv + 2t,
// 8 nv + 2t + 1, as st.o) and lse[r] of rows g and g+8.
__device__ __forceinline__ void fwd_finish(const FwdWarp& st, float (&out)[NV][4],
                                           float (&lse)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      out[nv][2 * r] = st.o[nv][2 * r] * inv;
      out[nv][2 * r + 1] = st.o[nv][2 * r + 1] * inv;
    }
    lse[r] = st.m[r] + logf(l);
  }
}

// The warp's out and lse rows: rows i0 and i0 + 8 (the warp's g and g + 8)
// below hw, of out (row stride o_stride, dvh wide) and lse (none where lse is
// null), both at the (batch, head)'s first token.
__device__ __forceinline__ void fwd_store(const float (&o)[NV][4], const float (&l)[2],
                                          bf16* out, size_t o_stride, float* lse, int i0,
                                          int hw, int dvh, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = i0 + 8 * rr;
    if (i >= hw) continue;
    bf16* o_i = out + static_cast<size_t>(i) * o_stride;
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int c = nv * 8 + 2 * t;
      if (c < dvh) o_i[c] = __float2bfloat16(o[nv][2 * rr]);
      if (c + 1 < dvh) o_i[c + 1] = __float2bfloat16(o[nv][2 * rr + 1]);
    }
    if (t == 0 && lse != nullptr) lse[i] = l[rr];
  }
}

// Positions of the TN keys of key tile `tile` (the kpos words at the end of
// the tile's key-table row) into kpos_s by 16-byte cp.async, complete after
// cp_async_wait; both 16-byte aligned.
__device__ __forceinline__ void stage_kpos(int* kpos_s, const int* __restrict__ tab, int tile,
                                           int nbt, int tid, int nthreads) {
  const int words = key_table_words(nbt);
  const int* src = tab + static_cast<size_t>(tile) * words + (words - TN);
  for (int e = tid * 4; e < TN; e += nthreads * 4) cp_async<16>(kpos_s + e, src + e);
}

}  // namespace amma
