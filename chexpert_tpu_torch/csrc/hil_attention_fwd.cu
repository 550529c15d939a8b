// Heads-in-lanes (token-major) relative-position attention, forward, for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_attention.py::_hil_fwd_kernel
// (host side _hil_forward, pl.pallas_call at :1040). Same contract:
//   P   (B, hw, nh*slot)  per token and head one slot [q*dkh^-0.5 ; k ; v ; 0-pad],
//                         the 1x1 qkv projection's output as it stands
//   Rw  (W*dkh, W), Rh (H*dkh, H)  f32 block operands of the relative logits
//                         (null: attention without relative logits)
//   out (B, hw, nh*dvh)   operand dtype, lane order (head, dvh): out_proj's
//                         channel order, so no head-merge copy follows
//   lse (B, nh, hw)       f32, m + log(l) per (batch, head, token)
// The TPU body makes its matrix unit broadcast and select: q . [I .. I], an
// iota mask, a dot with the block-diagonal operand for RC, and a one-hot of
// the key's column and row inside the q.k product. Here RC[t, m] is a plain
// sum over d with Rw read by index, and a key's two relative terms are two
// reads of the query row's RC in shared memory: no mask, no one-hot, no
// tiled identity. Its per-tile row layouts of lse (ROW_SUB) and its tiling
// search are VMEM matters and have no counterpart.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 tensor, 67 TFLOP/s
// f32 non-tensor), bf16, slot 48, batch 4 x 8 heads, counting 2*dkh + 2 + 3 +
// 2*dvh operations per (query, key) pair and 2*dkh per RC entry:
//   40x40 dvh 1: 5.5 MB -> 1.6 us;  4.0 GFLOP -> 4.1 us  (operations)
//   20x20 dvh 3: 1.3 MB -> 0.4 us;  0.27 GFLOP -> 0.3 us (bytes)
//   10x10 dvh 6: 0.3 MB -> 0.1 us                         (bytes)
// P is 3x smaller per token than the head-major operands of
// rel_attention_fwd.cu (no W+H rel lanes per head), so the byte floor drops
// and the largest geometry is bound by operations. This first version
// computes on the f32 CUDA cores (67 TFLOP/s: a floor of ~60 us at 40x40):
// what it keeps is the layout's point, that nothing data-sized is copied
// around the kernel and the (hw, hw) logits never reach device memory. Moving
// q.k^T and p.v onto mma.sync / wgmma is a later change.
//
// Design: one block per (batch, head, 64-query tile); the tile's q is staged
// in shared memory, its RC rows (W+H wide) are computed there once, then 4
// threads per query row each take every 4th key of a 64-key tile staged in
// shared memory, with their own online-softmax state, merged by warp
// shuffles at the end (the blocking of rel_attention_fwd.cu). A head's slice
// of a token is 2*dkh+dvh contiguous elements at a stride of nh*slot, so a
// tile load touches 2-3 32-byte sectors per token; the other heads' blocks
// read the neighbouring bytes and P (20 MB at batch 16) stays in L2. Staging
// whole token rows for all heads in one block is the coalesced alternative
// and is left to the change that moves the dots to the tensor cores.

#include "hil_attention_common.cuh"

namespace {

using namespace hil;

constexpr int TQ = 64;               // query rows per block
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = TQ * SPLIT;  // 256
constexpr int TK = 64;               // keys per shared-memory tile
constexpr int KPT = TK / SPLIT;      // keys per thread per tile

template <typename T>
__global__ void __launch_bounds__(THREADS)
hil_attention_fwd_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                         const float* __restrict__ Rh, T* __restrict__ out,
                         float* __restrict__ lse, int hw, int H, int W, int nh, int slot,
                         int dvh, int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                       // TQ x rel_stride: [RC_w | RC_h] rows
  float* q_s = rel_s + TQ * rel_stride;      // TQ x DKH
  float* k_s = q_s + TQ * DKH;               // TK x DKH
  float* v_s = k_s + TK * DKH;               // TK x DVMAX (zero beyond dvh)
  int* kcol = reinterpret_cast<int*>(v_s + TK * DVMAX);  // TK
  int* krow = kcol + TK;                                  // TK

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int r = tid / SPLIT;
  const int sub = tid % SPLIT;
  const int i = q0 + r;
  const bool row_ok = i < hw;
  const size_t row = static_cast<size_t>(nh) * slot;  // elements per token
  const T* P_bh = P + static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;

  for (int e = tid; e < TQ * DKH; e += THREADS) {
    const int rr = e / DKH, d = e - rr * DKH;
    const int ii = q0 + rr;
    q_s[e] = ii < hw ? to_f32(P_bh[ii * row + d]) : 0.f;
  }
  __syncthreads();
  rel_tile(q_s, Rw, Rh, q0, TQ, hw, H, W, rel_s, rel_stride, tid, THREADS);
  float q[DKH];
#pragma unroll
  for (int d = 0; d < DKH; ++d) q[d] = q_s[r * DKH + d];

  float m = NEG_BIG, l = 0.f;
  float acc[DVMAX];
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) acc[e] = 0.f;
  const float* rw = rel_s + r * rel_stride;
  const float* rh = rw + W;

  for (int j0 = 0; j0 < hw; j0 += TK) {
    const int kn = min(TK, hw - j0);
    __syncthreads();  // the previous tile is consumed (and rel_s is staged)
    for (int e = tid; e < TK * (DKH + DVMAX); e += THREADS) {
      const int jj = e / (DKH + DVMAX), c = e - jj * (DKH + DVMAX);
      const T* kv = P_bh + (j0 + jj) * row + DKH;  // [k ; v] of key j0 + jj
      if (c < DKH)
        k_s[jj * DKH + c] = jj < kn ? to_f32(kv[c]) : 0.f;
      else
        v_s[jj * DVMAX + c - DKH] = (jj < kn && c - DKH < dvh) ? to_f32(kv[c]) : 0.f;
    }
    if (tid < TK) {
      const int j = j0 + tid;
      kcol[tid] = j % W;
      krow[tid] = j / W;
    }
    __syncthreads();

    float s[KPT];
    float tmax = NEG_BIG;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + SPLIT * t;
      float x = NEG_BIG;
      if (jj < kn) {
        const float* kj = k_s + jj * DKH;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DKH; ++d) dot = fmaf(q[d], kj[d], dot);
        x = dot + rw[kcol[jj]] + rh[krow[jj]];
      }
      s[t] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e) acc[e] *= alpha;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int jj = sub + SPLIT * t;
      if (jj < kn) {
        const float p = expf(s[t] - m_new);
        l += p;
        const float* vj = v_s + jj * DVMAX;
#pragma unroll
        for (int e = 0; e < DVMAX; ++e)
          if (e < dvh) acc[e] = fmaf(p, vj[e], acc[e]);
      }
    }
    m = m_new;
  }

  // merge the SPLIT partial softmax states of this row (adjacent lanes)
#pragma unroll
  for (int off = 1; off < SPLIT; off <<= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o);
    const float a = expf(m - m_n), a_o = expf(m_o - m_n);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e) {
      const float acc_o = __shfl_xor_sync(0xffffffffu, acc[e], off);
      acc[e] = acc[e] * a + acc_o * a_o;
    }
    m = m_n;
  }
  if (row_ok && sub == 0) {
    const float inv = 1.f / l;
    T* o = out + (static_cast<size_t>(b) * hw + i) * nh * dvh + static_cast<size_t>(h) * dvh;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(o + e, acc[e] * inv);
    lse[(static_cast<size_t>(b) * nh + h) * hw + i] = m + logf(l);
  }
}

template <typename T>
int launch(const void* P, const void* Rw, const void* Rh, void* out, void* lse, int B,
           int hw, int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ * rel_stride + TQ * DKH + TK * DKH + TK * DVMAX) * sizeof(float) +
      2 * TK * sizeof(int);
  auto kern = hil_attention_fwd_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + TQ - 1) / TQ, nh, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<T*>(out), static_cast<float*>(lse), hw, H, W, nh, slot, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hil_attention_fwd_f32(const void* P, const void* Rw, const void* Rh, void* out,
                                     void* lse, int B, int hw, int H, int W, int nh, int slot,
                                     int dkh, int dvh, void* stream) {
  return launch<float>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}

extern "C" int hil_attention_fwd_bf16(const void* P, const void* Rw, const void* Rh, void* out,
                                      void* lse, int B, int hw, int H, int W, int nh, int slot,
                                      int dkh, int dvh, void* stream) {
  return launch<__nv_bfloat16>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}
