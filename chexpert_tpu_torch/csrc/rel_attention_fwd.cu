// Fused 2-D relative-position attention, forward (AAConv2d), for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_attention.py::_fwd_kernel
// (host side _flash_forward, pl.pallas_call at :493). Same contract:
//   qr  (bn, hw, dkh+W+H)  packed [q * dkh^-0.5 ; RW ; RH] per query token
//   k   (bn, hw, dkh),  v (bn, hw, dvh)
//   S[i, j] = q_i . k_j + RW[i, col(j)] + RH[i, row(j)],  col = j % W, row = j / W
//   out = softmax_j(S) . v   (operand dtype),   lse = m + log(l)   (f32)
// The TPU forms S as ONE MXU pass qr . [k ; onehot(col) ; onehot(row)]^T; here
// RW/RH are read by index from shared memory and no one-hot exists.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 tensor, 67 TFLOP/s
// f32 non-tensor), per launch at the aadensenet121 320x320 geometries with
// bn = 32 (batch 4 x 8 heads), bf16 operands; operations counted per (query,
// key) pair as 2*dkh (q.k) + 2 (rel adds) + 3 (max, exp, sum) + 2*dvh (p.v):
//   HW=1600 (40x40, dvh 1): 12.70 MB -> 3.79 us;  3.85 GFLOP -> 3.89 us (bf16 rate)
//   HW= 400 (20x20, dvh 3):  2.25 MB -> 0.67 us;  0.26 GFLOP -> 0.26 us
//   HW= 100 (10x10, dvh 6):  0.41 MB -> 0.12 us;  0.02 GFLOP -> 0.02 us
// So the work sits at the card's ridge at HW=1600 and is bytes-bound below.
// This first version computes on the f32 CUDA cores, whose 67 TFLOP/s puts
// its floor at ~57 us for HW=1600: the design keeps the (hw, hw) logits out
// of device memory (the point of the TPU kernel too), reads every input
// once per query tile, and leaves the move of q.k^T and p.v onto the tensor
// cores (mma.sync / wgmma) to a later change.
//
// Design: one block per (bn slice, 64-query tile); 4 threads per query row,
// each owning every 4th key of a 64-key tile staged in shared memory, with
// its own online-softmax state; the 4 partial states merge by warp shuffles
// at the end. The ragged key tail is skipped by index (no padding in device
// memory) and padded query rows are never written. Nothing carries across
// blocks. dvh 1..8 shares one code path (the TPU's dv1 layout branch is a
// lane-layout trick with no GPU counterpart).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TQ = 64;               // query rows per block
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = TQ * SPLIT;  // 256
constexpr int TK = 64;               // keys per shared-memory tile
constexpr int KPT = TK / SPLIT;      // keys per thread per tile
constexpr int DVMAX = 8;             // largest dvh (v columns staged as 8)
constexpr int DKH = 20;              // the AAConv head width (min_dk_per_head)
constexpr float NEG_BIG = -1e30f;    // finite "minus infinity": exp(NEG_BIG - m) == 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DK>
__global__ void __launch_bounds__(THREADS)
rel_attention_fwd_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int hw, int H, int W, int dvh,
                         int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                       // TQ x rel_stride: [RW | RH] rows
  float* k_s = rel_s + TQ * rel_stride;      // TK x DK
  float* v_s = k_s + TK * DK;                // TK x DVMAX (zero beyond dvh)
  int* kcol = reinterpret_cast<int*>(v_s + TK * DVMAX);  // TK
  int* krow = kcol + TK;                                  // TK

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * TQ;
  const int tid = threadIdx.x;
  const int r = tid / SPLIT;
  const int sub = tid % SPLIT;
  const int i = q0 + r;
  const bool row_ok = i < hw;
  const int WH = W + H;
  const int L = DK + WH;

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* k_b = k + static_cast<size_t>(b) * hw * DK;
  const T* v_b = v + static_cast<size_t>(b) * hw * dvh;

  for (int e = tid; e < TQ * WH; e += THREADS) {
    const int rr = e / WH, c = e - rr * WH;
    const int ii = q0 + rr;
    rel_s[rr * rel_stride + c] =
        ii < hw ? to_f32(qr_b[static_cast<size_t>(ii) * L + DK + c]) : 0.f;
  }
  float q[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    q[d] = row_ok ? to_f32(qr_b[static_cast<size_t>(i) * L + d]) : 0.f;

  float m = NEG_BIG, l = 0.f;
  float acc[DVMAX];
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) acc[e] = 0.f;
  const float* rw = rel_s + r * rel_stride;
  const float* rh = rw + W;

  for (int j0 = 0; j0 < hw; j0 += TK) {
    const int kn = min(TK, hw - j0);
    __syncthreads();  // the previous tile is consumed (and rel_s is staged)
    for (int e = tid; e < TK * DK; e += THREADS)
      k_s[e] = e < kn * DK ? to_f32(k_b[static_cast<size_t>(j0) * DK + e]) : 0.f;
    for (int e = tid; e < TK * DVMAX; e += THREADS) {
      const int jj = e / DVMAX, c = e - jj * DVMAX;
      v_s[e] = (jj < kn && c < dvh)
                   ? to_f32(v_b[static_cast<size_t>(j0 + jj) * dvh + c]) : 0.f;
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
        const float* kj = k_s + jj * DK;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) dot = fmaf(q[d], kj[d], dot);
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
    T* o = out + (static_cast<size_t>(b) * hw + i) * dvh;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(o + e, acc[e] * inv);
    lse[static_cast<size_t>(b) * hw + i] = m + logf(l);
  }
}

template <typename T>
int launch(const void* qr, const void* k, const void* v, void* out, void* lse, int bn,
           int hw, int H, int W, int dkh, int dvh, void* stream) {
  if (dkh != DKH || dvh < 1 || dvh > DVMAX || hw != H * W || hw < 1 || bn < 1 ||
      bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem = static_cast<size_t>(TQ * rel_stride + TK * DKH + TK * DVMAX) *
                          sizeof(float) + 2 * TK * sizeof(int);
  auto kern = rel_attention_fwd_kernel<T, DKH>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((hw + TQ - 1) / TQ, bn);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), hw, H, W, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rel_attention_fwd_f32(const void* qr, const void* k, const void* v,
                                     void* out, void* lse, int bn, int hw, int H,
                                     int W, int dkh, int dvh, void* stream) {
  return launch<float>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
}

extern "C" int rel_attention_fwd_bf16(const void* qr, const void* k, const void* v,
                                      void* out, void* lse, int bn, int hw, int H,
                                      int W, int dkh, int dvh, void* stream) {
  return launch<__nv_bfloat16>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
}
