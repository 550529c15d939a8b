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
// Two kernels, chosen by the operand dtype:
//   bf16 (what autocast hands over): the tensor-core kernel of
//     attention_fwd_mma.cuh, a block per (bn slice, 64-query tile) of 4 warps.
//     Its queries are staged as whole qr rows (200 / 120 / 80 bytes at
//     40x40 / 20x20 / 10x10) by 8-byte cp.async where L is a multiple of 4, so
//     q and the bf16 RW / RH lanes are read from the same tile, as B2's dq
//     pass reads them; key tiles are k rows (8-byte cp.async where dkh is a
//     multiple of 4, else 2-byte loads) and v rows padded to VW columns. A map
//     past amma::mma_fits (past 64x64) takes the CUDA-core kernel below in
//     bf16.
//   f32 (the card's own reference route, held to 1e-4): the CUDA-core kernel,
//     all arithmetic f32.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 tensor; exp on the
// special function units, 16 per SM and clock: ~4.2 T/s at 1.98 GHz), per
// launch at the aadensenet121 320x320 geometries with bn = 32 (batch 4 x 8
// heads), bf16 operands, one exp per (query, key) pair:
//   HW=1600 (40x40, dvh 1): 12.70 MB -> 3.79 us;  82 M exp -> 19.6 us
//   HW= 400 (20x20, dvh 3):  2.25 MB -> 0.67 us;  5.1 M exp -> 1.2 us
//   HW= 100 (10x10, dvh 6):  0.41 MB -> 0.12 us;  0.3 M exp -> 0.08 us
// (the products, 2*dkh + 2*dvh + 4 operations per pair, take 3.7 / 0.2 /
// 0.02 us at the bf16 rate), so the softmax's exps set the floor. The design
// keeps the (hw, hw) logits out of device memory (the point of the TPU kernel
// too) and reads every input once per query tile. The CUDA-core kernel took
// 0.58 / 0.050 / 0.014 ms there; the tensor-core kernel takes 0.11 / 0.018 /
// 0.008 ms (72 registers, 20 KB of shared memory at 40x40; its key-tile loop
// compiles to about 1440 SASS instructions, staging and both paths of the
// relative logits included, of which 20 are MMAs and 34 MUFU: the
// instruction issue, not the tensor pipe or the exps, bounds it;
// scripts/bench_attention_fwd_torch.py, NVIDIA H100 80GB HBM3 at 700 W).
//
// Design of the CUDA-core kernel: one block per (bn slice, 64-query tile); 4
// threads per query row, each owning every 4th key of a 64-key tile staged in
// shared memory, with its own online-softmax state; the 4 partial states
// merge by warp shuffles at the end. The ragged key tail is skipped by index
// (no padding in device memory) and padded query rows are never written.
// Nothing carries across blocks. Every dvh of the width class shares one code
// path (the TPU's dv1 layout branch is a lane-layout trick with no GPU
// counterpart); q and k are held DK wide, zero past dkh (DK = KW; DK = dkh =
// 20, a constant, for the model zoo's width, which keeps its code).
//
// Head widths: this file is built once per width class (KW, VW) of
// ops/fused_attention.py::width_plan (-DATTN_KW, -DATTN_VW; see
// attention_bwd_mma.cuh), whose kernels above take dkh <= KW, dvh <= VW. The
// largest class's library also takes any wider head (nk = ceil(dkh / KW) and
// nv = ceil(dvh / VW) chunks that the entries receive and check), in the
// kernels of attention_wide.cuh: in bf16 up to amma::mma_fits its
// tensor-core forward, where a block stages its 64 queries' rows whole once,
// takes the key and value rows of each tile by cp.async into two buffers,
// forms S and p once per tile pair over all of dkh and feeds every column of
// out from them (tiny maps several (batch, head) pairs a tile), on the plan
// of ops/fused_attention.py::wide_fwd_plan; in f32 and on larger maps the
// CUDA-core kernel in chunks of 32 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "attention_wide.cuh"

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (attention_fwd_mma.cuh).

namespace {
namespace mma_fwd {

using namespace amma;

// A block owns FWD_ROWS queries of one (batch, head): whole qr rows, q and
// the RC lanes read from the same tile; it walks the keys TN at a time and
// writes its out and lse rows. vecq / veck: the qr rows / the k rows are
// 8-byte aligned (cp.async).
template <int DKC>
__global__ void __launch_bounds__(FWD_WARPS * 32)
rel_attention_fwd_mma_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const int* __restrict__ tab,
                             bf16* __restrict__ out, float* __restrict__ lse, int hw, int H,
                             int W, int dkh, int dvh, int LP, int vecq, int veck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DKC > 0) dkh = DKC;
  bf16* qr_s = reinterpret_cast<bf16*>(smem_raw);    // FWD_ROWS x LP
  bf16* k_s = qr_s + FWD_ROWS * LP;                   // TN x KS
  bf16* v_s = k_s + TN * KS;                          // TN x VS
  int* kpos_s = reinterpret_cast<int*>(v_s + TN * VS);  // TN

  constexpr int NT = FWD_WARPS * 32;
  const int L = dkh + W + H, nbt = bin_tiles(W, H);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * FWD_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qn = min(FWD_ROWS, hw - q0);
  const size_t tok = static_cast<size_t>(b) * hw;  // first token row of this (batch, head)
  const bf16* k_b = k + tok * dkh;
  const bf16* v_b = v + tok * dvh;

  zero_tile(qr_s, FWD_ROWS * LP, tid, NT);  // the rows past hw and the columns past L
  zero_tile(k_s, TN * KS, tid, NT);         // the columns past dkh stay zero
  __syncthreads();
  stage_rows(qr_s, LP, qr + (tok + q0) * L, L, qn, L, vecq, tid, NT);
  cp_async_wait();
  __syncthreads();

  FwdWarp st;
  fwd_init(st, qr_s, LP, warp, lane);
  for (int j0 = 0; j0 < hw; j0 += TN) {
    const int kn = min(TN, hw - j0);
    __syncthreads();  // the previous key tile is consumed
    stage_rows(k_s, KS, k_b + static_cast<size_t>(j0) * dkh, dkh, kn, dkh, veck, tid, NT);
    stage_dv(v_s, v_b + static_cast<size_t>(j0) * dvh, dvh, dvh, kn, TN, tid, NT);
    stage_kpos(kpos_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    fwd_step(st, k_s, KS, v_s, VS, kpos_s, qr_s + dkh, LP, W, kn, warp, lane);
  }

  float o[NV][4], l[2];
  fwd_finish(st, o, l);
  fwd_store(o, l, out + tok * dvh, dvh, lse + tok, q0 + warp * 16 + (lane >> 2), hw, dvh, lane);
}

template <int DKC>
int launch_dkc(const void* qr, const void* k, const void* v, const void* tab, void* out,
               void* lse, int bn, int hw, int H, int W, int dkh, int dvh, void* stream) {
  const int L = dkh + W + H, LP = qr_stride_of(L);
  const size_t smem = static_cast<size_t>(FWD_ROWS * LP + TN * (KS + VS)) * sizeof(bf16) +
                      TN * sizeof(int);
  auto kern = rel_attention_fwd_mma_kernel<DKC>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + FWD_ROWS - 1) / FWD_ROWS, bn);
  kern<<<grid, FWD_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qr), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(tab), static_cast<bf16*>(out), static_cast<float*>(lse), hw, H, W,
      dkh, dvh, LP, L % 4 == 0 && aligned8(qr), dkh % 4 == 0 && aligned8(k));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* qr, const void* k, const void* v, const void* tab, void* out, void* lse,
           int bn, int hw, int H, int W, int dkh, int dvh, void* stream) {
  if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dkc<DK_ZOO>(qr, k, v, tab, out, lse, bn, hw, H, W, dkh, dvh, stream);
  }
  return launch_dkc<0>(qr, k, v, tab, out, lse, bn, hw, H, W, dkh, dvh, stream);
}

}  // namespace mma_fwd
}  // namespace

// ---------------------------------------------------------------------------
// The CUDA-core kernel: the f32 entry, and bf16 maps past amma::mma_fits.

namespace {

constexpr int TQ = 64;               // query rows per block
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = TQ * SPLIT;  // 256
constexpr int TK = 64;               // keys per shared-memory tile
constexpr int KPT = TK / SPLIT;      // keys per thread per tile
constexpr int DVMAX = amma::VW;      // largest dvh (v columns staged VW wide)
using amma::DK_ZOO;
constexpr float NEG_BIG = -1e30f;    // finite "minus infinity": exp(NEG_BIG - m) == 0

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int DK>
__global__ void __launch_bounds__(THREADS)
rel_attention_fwd_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ out,
                         float* __restrict__ lse, int hw, int H, int W, int dkh, int dvh,
                         int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* rel_s = smem;                       // TQ x rel_stride: [RW | RH] rows
  float* k_s = rel_s + TQ * rel_stride;      // TK x DK (zero beyond dkh)
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
  const int L = dkh + WH;

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* k_b = k + static_cast<size_t>(b) * hw * dkh;
  const T* v_b = v + static_cast<size_t>(b) * hw * dvh;

  for (int e = tid; e < TQ * WH; e += THREADS) {
    const int rr = e / WH, c = e - rr * WH;
    const int ii = q0 + rr;
    rel_s[rr * rel_stride + c] =
        ii < hw ? to_f32(qr_b[static_cast<size_t>(ii) * L + dkh + c]) : 0.f;
  }
  float q[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d)
    q[d] = (row_ok && d < dkh) ? to_f32(qr_b[static_cast<size_t>(i) * L + d]) : 0.f;

  float m = NEG_BIG, l = 0.f;
  float acc[DVMAX];
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) acc[e] = 0.f;
  const float* rw = rel_s + r * rel_stride;
  const float* rh = rw + W;

  for (int j0 = 0; j0 < hw; j0 += TK) {
    const int kn = min(TK, hw - j0);
    __syncthreads();  // the previous tile is consumed (and rel_s is staged)
    if constexpr (DK == DK_ZOO) {  // rows of exactly DK lanes: one run of kn * DK
      for (int e = tid; e < TK * DK; e += THREADS)
        k_s[e] = e < kn * DK ? to_f32(k_b[static_cast<size_t>(j0) * DK + e]) : 0.f;
    } else {
      for (int e = tid; e < TK * DK; e += THREADS) {
        const int jj = e / DK, d = e - jj * DK;
        k_s[e] = (jj < kn && d < dkh) ? to_f32(k_b[static_cast<size_t>(j0 + jj) * dkh + d])
                                      : 0.f;
      }
    }
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

bool bad_shape(int bn, int hw, int H, int W, int dkh, int dvh) {
  return dkh < 1 || dkh > amma::KW || dvh < 1 || dvh > DVMAX || hw != H * W || hw < 1 ||
         bn < 1 || bn > 65535;
}

template <typename T, int DK>
int launch_dk(const void* qr, const void* k, const void* v, void* out, void* lse, int bn,
              int hw, int H, int W, int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem = static_cast<size_t>(TQ * rel_stride + TK * DK + TK * DVMAX) *
                          sizeof(float) + 2 * TK * sizeof(int);
  auto kern = rel_attention_fwd_kernel<T, DK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((hw + TQ - 1) / TQ, bn);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), hw, H, W, dkh, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* qr, const void* k, const void* v, void* out, void* lse, int bn,
           int hw, int H, int W, int dkh, int dvh, void* stream) {
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dk<T, DK_ZOO>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
  }
  return launch_dk<T, amma::KW>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
}

// A head past the largest width class (attention_wide.cuh): head-major rows;
// wp, the host's plan of the forward.
template <typename T>
int launch_wide(const void* qr, const void* k, const void* v, const void* tab, void* out,
                void* lse, int bn, int hw, int H, int W, int dkh, int dvh, int nk, int nv,
                const attention_wide::WidePlan& wp, void* stream) {
  using attention_wide::Rows;
  if (hw != H * W || hw < 1 || bn < 1 || bn > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = hw, L = dkh + W + H;
  const T* q = static_cast<const T*>(qr);
  return attention_wide::fwd<T>(Rows<const T>{q, 0, n * L, L},
                      Rows<const T>{static_cast<const T*>(k), 0, n * dkh, dkh},
                      Rows<const T>{static_cast<const T*>(v), 0, n * dvh, dvh},
                      attention_wide::Rel<T>{{q + dkh, 0, n * L, L}, nullptr, nullptr},
                      static_cast<const int*>(tab), Rows<T>{static_cast<T*>(out), 0, n * dvh, dvh},
                      Rows<float>{static_cast<float*>(lse), 0, n, 1},
                      attention_wide::Geo{hw, H, W, dkh, dvh, nk, nv}, bn, 1, wp, stream);
}

}  // namespace

// tab: the key table of the map (ops/fused_attention.py::key_table, with the
// plan's pack), read by the tensor-core kernels alone. nk, nv: the head's
// chunk counts (ops/fused_attention.py::width_plan), 1 and 1 for a head its
// class holds; a wider head takes attention_wide.cuh, in the plan pack,
// groups, wg, tk, smem of ops/fused_attention.py::fwd_plan_args
// (attention_wide::WidePlan; all 0 for a head its class holds, for f32 and
// for a map past amma::mma_fits).
extern "C" int rel_attention_fwd_f32(const void* qr, const void* k, const void* v,
                                     const void* tab, void* out, void* lse, int bn, int hw,
                                     int H, int W, int dkh, int dvh, int nk, int nv, int pack,
                                     int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return launch_wide<float>(qr, k, v, tab, out, lse, bn, hw, H, W, dkh, dvh, nk, nv,
                              {pack, groups, wg, tk, smem}, stream);
  }
  return launch<float>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
}

extern "C" int rel_attention_fwd_bf16(const void* qr, const void* k, const void* v,
                                      const void* tab, void* out, void* lse, int bn, int hw,
                                      int H, int W, int dkh, int dvh, int nk, int nv, int pack,
                                      int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return launch_wide<__nv_bfloat16>(qr, k, v, tab, out, lse, bn, hw, H, W, dkh, dvh, nk, nv,
                                        {pack, groups, wg, tk, smem}, stream);
  }
  if (!amma::mma_fits(W, H))
    return launch<__nv_bfloat16>(qr, k, v, out, lse, bn, hw, H, W, dkh, dvh, stream);
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  return mma_fwd::launch(qr, k, v, tab, out, lse, bn, hw, H, W, dkh, dvh, stream);
}
