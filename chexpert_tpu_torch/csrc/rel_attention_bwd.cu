// Fused 2-D relative-position attention, backward (AAConv2d), for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_attention.py::_bwd_kernel
// (host side _flash_bwd_rule, pl.pallas_call at :560). Same contract:
//   qr (bn, hw, dkh+W+H) packed [q ; RW ; RH],  k (bn, hw, dkh),  v (bn, hw, dvh)
//   dout (bn, hw, dvh),  lse (bn, hw) f32 from the forward,
//   delta (bn, hw) f32 = rowsum(dout * out) (a plain torch op in the wrapper)
//   S[i, j] = q_i . k_j + RW[i, col(j)] + RH[i, row(j)],  p = exp(S - lse)
//   dv = p^T dout,  dp = dout v^T,  ds = p (dp - delta),  dk = ds^T q
//   dqr = [ds k ; dRW ; dRH],  dRW[i, c] = sum_{col(j)=c} ds[i, j],
//                              dRH[i, r] = sum_{row(j)=r} ds[i, j]
// Outputs are in the operand dtype; all arithmetic is f32.
//
// The TPU kernel accumulates dqr across key-block programs into one block
// that stays resident in VMEM, relying on its sequential grid (:283-299).
// Blocks on the GPU run concurrently and see no partial sums of others, so
// the work is split into two passes, each owning its outputs outright
// (FlashAttention-2 style; deterministic, no atomics):
//   pass 1 (dkdv): one thread per key, a block per (bn, 128-key tile); the
//     thread loops over every query, staged 64 at a time in shared memory,
//     and writes its key's dk and dv once;
//   pass 2 (dq):   one thread per query, a block per (bn, 64-query tile);
//     the thread loops over every key, staged 64 at a time, and accumulates
//     dq in registers and its own row of W+H bins (dRW by key column, dRH
//     by key row) in shared memory, which no other thread touches; dRH is
//     summed in a register along a key row and flushed when the row ends.
// Both passes recompute S and p. The ragged key/query tails are skipped by
// index and padded rows are never written; no padded copy exists. dvh 1..8
// share one path (the TPU's dv1 row layout is a lane trick with no GPU
// counterpart). No one-hot operand exists: RW/RH are read by index.
//
// Bound on the H100 (SXM: 3.35 TB/s, 989 TFLOP/s bf16 tensor, 67 TFLOP/s f32
// non-tensor) at the aadensenet121 320x320 training geometries, bn = 128
// (batch 16 x 8 heads), bf16, counting 6*dkh + 4*dvh + 8 operations per
// (query, key) pair for the whole backward: 40x40 dvh 1 -> 43 GFLOP, 0.044 ms
// at the bf16 rate against ~0.020 ms of bytes (bound by operations); 20x20
// and 10x10 are bound by bytes. This first version computes on the f32 CUDA
// cores (floor ~0.65 ms at 40x40); moving the dots onto mma.sync / wgmma is
// a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int DKH = 20;      // the AAConv head width (min_dk_per_head)
constexpr int DVMAX = 8;     // largest dvh (staged 8 wide, zero beyond dvh)
constexpr int T1 = 128;      // pass 1: keys per block, one thread each
constexpr int TQ1 = 64;      // pass 1: queries per shared-memory tile
constexpr int T2 = 64;       // pass 2: queries per block, one thread each
constexpr int TK2 = 64;      // pass 2: keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// q . k over DKH with four partial sums (a shorter dependency chain)
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

template <typename T>
__global__ void __launch_bounds__(T1)
rel_attention_bwd_dkdv_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dk,
                              T* __restrict__ dv, int hw, int H, int W, int dvh,
                              int rel_stride) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // TQ1 x DKH
  float* do_s = q_s + TQ1 * DKH;       // TQ1 x DVMAX (zero beyond dvh)
  float* ld_s = do_s + TQ1 * DVMAX;    // TQ1 x 2: (lse, delta)
  float* rel_s = ld_s + TQ1 * 2;       // TQ1 x rel_stride: [RW | RH] rows

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * T1 + tid;
  const bool key_ok = j < hw;
  const int WH = W + H;
  const int L = DKH + WH;
  const int cj = key_ok ? j % W : 0;
  const int rj = key_ok ? W + j / W : W;  // offset of RH[., row(j)] in a rel row

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* do_b = dout + static_cast<size_t>(b) * hw * dvh;
  const float* lse_b = lse + static_cast<size_t>(b) * hw;
  const float* delta_b = delta + static_cast<size_t>(b) * hw;

  float kj[DKH], vj[DVMAX], dkj[DKH], dvj[DVMAX];
#pragma unroll
  for (int d = 0; d < DKH; ++d) {
    kj[d] = key_ok ? to_f32(k[(static_cast<size_t>(b) * hw + j) * DKH + d]) : 0.f;
    dkj[d] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) {
    vj[e] = (key_ok && e < dvh) ? to_f32(v[(static_cast<size_t>(b) * hw + j) * dvh + e]) : 0.f;
    dvj[e] = 0.f;
  }

  for (int i0 = 0; i0 < hw; i0 += TQ1) {
    const int qn = min(TQ1, hw - i0);
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < TQ1 * DKH; e += T1) {
      const int r = e / DKH, d = e - r * DKH;
      q_s[e] = r < qn ? to_f32(qr_b[static_cast<size_t>(i0 + r) * L + d]) : 0.f;
    }
    for (int e = tid; e < TQ1 * DVMAX; e += T1) {
      const int r = e / DVMAX, c = e - r * DVMAX;
      do_s[e] = (r < qn && c < dvh) ? to_f32(do_b[static_cast<size_t>(i0 + r) * dvh + c]) : 0.f;
    }
    if (tid < TQ1) {
      ld_s[2 * tid] = tid < qn ? lse_b[i0 + tid] : 0.f;
      ld_s[2 * tid + 1] = tid < qn ? delta_b[i0 + tid] : 0.f;
    }
    for (int e = tid; e < TQ1 * WH; e += T1) {
      const int r = e / WH, c = e - r * WH;
      rel_s[r * rel_stride + c] =
          r < qn ? to_f32(qr_b[static_cast<size_t>(i0 + r) * L + DKH + c]) : 0.f;
    }
    __syncthreads();
    if (key_ok) {
#pragma unroll 2
      for (int r = 0; r < qn; ++r) {
        const float* qi = q_s + r * DKH;
        const float* doi = do_s + r * DVMAX;
        const float* rel = rel_s + r * rel_stride;
        const float s = dot_dk(qi, kj) + rel[cj] + rel[rj];
        const float p = expf(s - ld_s[2 * r]);
        const float ds = p * (dot_dv(doi, vj) - ld_s[2 * r + 1]);
#pragma unroll
        for (int e = 0; e < DVMAX; ++e) dvj[e] = fmaf(p, doi[e], dvj[e]);
#pragma unroll
        for (int d = 0; d < DKH; ++d) dkj[d] = fmaf(ds, qi[d], dkj[d]);
      }
    }
  }
  if (key_ok) {
    T* dk_j = dk + (static_cast<size_t>(b) * hw + j) * DKH;
#pragma unroll
    for (int d = 0; d < DKH; ++d) store(dk_j + d, dkj[d]);
    T* dv_j = dv + (static_cast<size_t>(b) * hw + j) * dvh;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(dv_j + e, dvj[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(T2)
rel_attention_bwd_dq_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dqr,
                            int hw, int H, int W, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                      // T2 x rel_stride: [RW | RH] rows
  float* bin_s = rel_s + T2 * rel_stride;   // T2 x rel_stride: [dRW | dRH] sums
  float* k_s = bin_s + T2 * rel_stride;     // TK2 x DKH
  float* v_s = k_s + TK2 * DKH;             // TK2 x DVMAX (zero beyond dvh)

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T2;
  const int tid = threadIdx.x;
  const int i = q0 + tid;
  const bool row_ok = i < hw;
  const int WH = W + H;
  const int L = DKH + WH;

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* k_b = k + static_cast<size_t>(b) * hw * DKH;
  const T* v_b = v + static_cast<size_t>(b) * hw * dvh;
  T* dqr_b = dqr + static_cast<size_t>(b) * hw * L;

  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    const int ii = q0 + r;
    rel_s[r * rel_stride + c] = ii < hw ? to_f32(qr_b[static_cast<size_t>(ii) * L + DKH + c]) : 0.f;
    bin_s[r * rel_stride + c] = 0.f;
  }
  float q[DKH], dq[DKH], doi[DVMAX];
#pragma unroll
  for (int d = 0; d < DKH; ++d) {
    q[d] = row_ok ? to_f32(qr_b[static_cast<size_t>(i) * L + d]) : 0.f;
    dq[d] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DVMAX; ++e)
    doi[e] = (row_ok && e < dvh)
                 ? to_f32(dout[(static_cast<size_t>(b) * hw + i) * dvh + e]) : 0.f;
  const float lse_i = row_ok ? lse[static_cast<size_t>(b) * hw + i] : 0.f;
  const float delta_i = row_ok ? delta[static_cast<size_t>(b) * hw + i] : 0.f;
  const float* rel = rel_s + tid * rel_stride;
  float* bin = bin_s + tid * rel_stride;
  int cur_row = -1;  // key row whose dRH sum is held in rh_acc
  float rh_val = 0.f, rh_acc = 0.f;

  for (int j0 = 0; j0 < hw; j0 += TK2) {
    const int kn = min(TK2, hw - j0);
    __syncthreads();  // the previous key tile is consumed (and rel_s is staged)
    for (int e = tid; e < TK2 * DKH; e += T2)
      k_s[e] = e < kn * DKH ? to_f32(k_b[static_cast<size_t>(j0) * DKH + e]) : 0.f;
    for (int e = tid; e < TK2 * DVMAX; e += T2) {
      const int jj = e / DVMAX, c = e - jj * DVMAX;
      v_s[e] = (jj < kn && c < dvh) ? to_f32(v_b[static_cast<size_t>(j0 + jj) * dvh + c]) : 0.f;
    }
    __syncthreads();
    if (row_ok) {
      int c = j0 % W, row = j0 / W;  // column and row of key j0 + jj
      for (int jj = 0; jj < kn; ++jj) {
        if (row != cur_row) {  // uniform across the block: every thread walks the same keys
          if (cur_row >= 0) bin[W + cur_row] += rh_acc;
          rh_acc = 0.f;
          cur_row = row;
          rh_val = rel[W + row];
        }
        const float* kj = k_s + jj * DKH;
        const float s = dot_dk(q, kj) + rel[c] + rh_val;
        const float p = expf(s - lse_i);
        const float ds = p * (dot_dv(doi, v_s + jj * DVMAX) - delta_i);
#pragma unroll
        for (int d = 0; d < DKH; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
        bin[c] += ds;
        rh_acc += ds;
        if (++c == W) {
          c = 0;
          ++row;
        }
      }
    }
  }
  if (row_ok) {
    if (cur_row >= 0) bin[W + cur_row] += rh_acc;
    T* dq_i = dqr_b + static_cast<size_t>(i) * L;
#pragma unroll
    for (int d = 0; d < DKH; ++d) store(dq_i + d, dq[d]);
  }
  __syncthreads();  // every row's bins are final
  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    const int ii = q0 + r;
    if (ii < hw) store(dqr_b + static_cast<size_t>(ii) * L + DKH + c, bin_s[r * rel_stride + c]);
  }
}

bool bad_shape(int bn, int hw, int H, int W, int dkh, int dvh) {
  return dkh != DKH || dvh < 1 || dvh > DVMAX || hw != H * W || hw < 1 || bn < 1 ||
         bn > 65535;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
int launch_dkdv(const void* qr, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int bn, int hw,
                int H, int W, int dkh, int dvh, void* stream) {
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ1 * (DKH + DVMAX + 2) + TQ1 * rel_stride) * sizeof(float);
  auto kern = rel_attention_bwd_dkdv_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T1 - 1) / T1, bn);
  kern<<<grid, T1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), hw, H,
      W, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* qr, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dqr, int bn, int hw, int H, int W,
              int dkh, int dvh, void* stream) {
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;
  const size_t smem =
      static_cast<size_t>(2 * T2 * rel_stride + TK2 * (DKH + DVMAX)) * sizeof(float);
  auto kern = rel_attention_bwd_dq_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T2 - 1) / T2, bn);
  kern<<<grid, T2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqr), hw, H, W, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DKDV_ENTRY(NAME, T)                                                               \
  extern "C" int NAME(const void* qr, const void* k, const void* v, const void* dout,     \
                      const void* lse, const void* delta, void* dk, void* dv, int bn,     \
                      int hw, int H, int W, int dkh, int dvh, void* stream) {             \
    return launch_dkdv<T>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh,     \
                          stream);                                                        \
  }
#define DQ_ENTRY(NAME, T)                                                                 \
  extern "C" int NAME(const void* qr, const void* k, const void* v, const void* dout,     \
                      const void* lse, const void* delta, void* dqr, int bn, int hw,      \
                      int H, int W, int dkh, int dvh, void* stream) {                     \
    return launch_dq<T>(qr, k, v, dout, lse, delta, dqr, bn, hw, H, W, dkh, dvh, stream); \
  }

DKDV_ENTRY(rel_attention_bwd_dkdv_f32, float)
DKDV_ENTRY(rel_attention_bwd_dkdv_bf16, __nv_bfloat16)
DQ_ENTRY(rel_attention_bwd_dq_f32, float)
DQ_ENTRY(rel_attention_bwd_dq_bf16, __nv_bfloat16)
