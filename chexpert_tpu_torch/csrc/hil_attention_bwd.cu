// Heads-in-lanes (token-major) relative-position attention, backward, for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_attention.py::_hil_bwd_kernel
// (host side _hil_bwd_rule, pl.pallas_call at :1129). Same contract, with
// P, Rw, Rh as in hil_attention_fwd.cu:
//   dout (B, hw, nh*dvh)  operand dtype;  lse, delta (B, nh, hw) f32, delta =
//                         sum_dvh dout * out (a plain torch op in the wrapper)
//   S[t, j] = q_t . k_j + RC_w[t, col(j)] + RC_h[t, row(j)],  p = exp(S - lse)
//   dv = p^T dout,  dp = dout v^T,  ds = p (dp - delta),  dk = ds^T q
//   dRC_w[t, c] = sum_{col(j)=c} ds[t, j],  dRC_h[t, r] = sum_{row(j)=r} ds[t, j]
//   dq[t] = ds[t] k + sum_m dRC_w[t, m] Rw[(col(t), .), m]
//                   + sum_m dRC_h[t, m] Rh[(row(t), .), m]
//   dP  (B, hw, nh*slot)  operand dtype, the projection's packed layout:
//                         [dq ; dk ; dv ; 0] per head, every lane written
//   dRw[(c, d), m] = sum over (batch, head, tokens t of column c) q[t, d] dRC_w[t, m]
//   dRh likewise over rows;  both f32
// All arithmetic is f32, each output is rounded once.
//
// The TPU kernel keeps ONE dP block per batch element resident in VMEM:
// every query program adds its dk / dv into all key rows and its dq into
// its own rows, and dRw / dRh accumulate across the whole grid, zeroed by
// the first program (:861-865, :951, :968-981). That rests on its grid
// running in order on one core. Blocks on the GPU run concurrently, so the
// work is three passes that each own what they write (deterministic, no
// atomics), as rel_attention_bwd.cu splits its own:
//   pass 1 (dkdv): a thread per key, a block per (batch, head, 128-key
//     tile); loops over every query, 64 at a time in shared memory, whose RC
//     rows are recomputed there; writes the k, v and pad lanes of its dP row;
//   pass 2 (dq):   a thread per query, a block per (batch, head, 64-query
//     tile); loops over every key, bins ds by key column and key row in its
//     own shared-memory row (dRC), adds the relative part of dq from those
//     bins, writes the q lanes of its dP row and its dRC row to a scratch
//     (B, nh, hw, W+H) f32;
//   pass 3 (drel): a thread per entry of dRw / dRh and batch element; sums
//     q[t, d] * dRC[t, m] over the heads and the H (or W) tokens of its
//     column (or row) in a fixed order into a per-batch partial; one torch
//     sum over the batch follows.
// Why a scratch and not per-block partials of dRw / dRh: a token adds an
// outer product q (x) dRC_w to the block of its own column, so a partial
// shrinks only by the number of tokens of one column that a block holds. A
// 64-token tile of a 40-wide map holds at most two: its partial is the
// whole 128 KB operand, 410 MB over batch 16 x 8 heads x 25 tiles. The dRC
// rows are 65 MB there (f32), written once and read once (~40 us of memory
// time beside milliseconds of arithmetic), and pass 3's partials 4 MB.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 tensor), bf16, slot 48, batch
// 16 x 8 heads, counting 6*dkh + 4*dvh + 8 operations per (query, key) pair
// for the whole backward: 40x40 dvh 1 -> 43 GFLOP, 0.044 ms, against 41 MB,
// 0.012 ms (operations); 20x20 and 10x10 are bound by bytes. This first
// version computes on the f32 CUDA cores (floor ~0.65 ms at 40x40) and
// recomputes S in both passes; moving the dots onto mma.sync / wgmma is a
// later change.

#include "hil_attention_common.cuh"

namespace {

using namespace hil;

constexpr int T1 = 128;   // pass 1: keys per block, one thread each
constexpr int TQ1 = 64;   // pass 1: queries per shared-memory tile
constexpr int T2 = 64;    // pass 2: queries per block, one thread each
constexpr int TK2 = 64;   // pass 2: keys per shared-memory tile
constexpr int T3 = 256;   // pass 3: entries of dRw / dRh per block

template <typename T>
__global__ void __launch_bounds__(T1)
hil_attention_bwd_dkdv_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                              const float* __restrict__ Rh, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dP, int hw, int H, int W, int nh, int slot,
                              int dvh, int rel_stride) {
  extern __shared__ float smem[];
  float* q_s = smem;                   // TQ1 x DKH
  float* do_s = q_s + TQ1 * DKH;       // TQ1 x DVMAX (zero beyond dvh)
  float* ld_s = do_s + TQ1 * DVMAX;    // TQ1 x 2: (lse, delta)
  float* rel_s = ld_s + TQ1 * 2;       // TQ1 x rel_stride: [RC_w | RC_h] rows

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * T1 + tid;
  const bool key_ok = j < hw;
  const int cj = key_ok ? j % W : 0;
  const int rj = key_ok ? W + j / W : W;  // offset of RC_h[., row(j)] in a rel row
  const size_t row = static_cast<size_t>(nh) * slot;  // elements per token
  const size_t bh = static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;
  const T* P_bh = P + bh;
  const T* do_bh = dout + static_cast<size_t>(b) * hw * nh * dvh + static_cast<size_t>(h) * dvh;
  const float* lse_bh = lse + (static_cast<size_t>(b) * nh + h) * hw;
  const float* delta_bh = delta + (static_cast<size_t>(b) * nh + h) * hw;

  float kj[DKH], vj[DVMAX], dkj[DKH], dvj[DVMAX];
#pragma unroll
  for (int d = 0; d < DKH; ++d) {
    kj[d] = key_ok ? to_f32(P_bh[j * row + DKH + d]) : 0.f;
    dkj[d] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) {
    vj[e] = (key_ok && e < dvh) ? to_f32(P_bh[j * row + 2 * DKH + e]) : 0.f;
    dvj[e] = 0.f;
  }

  for (int i0 = 0; i0 < hw; i0 += TQ1) {
    const int qn = min(TQ1, hw - i0);
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < TQ1 * DKH; e += T1) {
      const int r = e / DKH, d = e - r * DKH;
      q_s[e] = r < qn ? to_f32(P_bh[(i0 + r) * row + d]) : 0.f;
    }
    for (int e = tid; e < TQ1 * DVMAX; e += T1) {
      const int r = e / DVMAX, c = e - r * DVMAX;
      do_s[e] = (r < qn && c < dvh)
                    ? to_f32(do_bh[static_cast<size_t>(i0 + r) * nh * dvh + c]) : 0.f;
    }
    if (tid < TQ1) {
      ld_s[2 * tid] = tid < qn ? lse_bh[i0 + tid] : 0.f;
      ld_s[2 * tid + 1] = tid < qn ? delta_bh[i0 + tid] : 0.f;
    }
    __syncthreads();  // q_s is staged: the RC rows are computed from it
    rel_tile(q_s, Rw, Rh, i0, TQ1, hw, H, W, rel_s, rel_stride, tid, T1);
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
    T* dkv = dP + bh + j * row + DKH;  // [dk ; dv ; 0-pad] of key j
#pragma unroll
    for (int d = 0; d < DKH; ++d) store(dkv + d, dkj[d]);
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(dkv + DKH + e, dvj[e]);
    // the pad lanes meet zero weight rows in the projection's backward:
    // they are written, as zeros, so that nothing uninitialized reaches it
    for (int e = DKH + dvh; e < slot - DKH; ++e) store(dkv + e, 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(T2)
hil_attention_bwd_dq_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                            const float* __restrict__ Rh, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dP, float* __restrict__ drc, int hw, int H,
                            int W, int nh, int slot, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                      // T2 x rel_stride: [RC_w | RC_h] rows
  float* bin_s = rel_s + T2 * rel_stride;   // T2 x rel_stride: [dRC_w | dRC_h] sums
  float* q_s = bin_s + T2 * rel_stride;     // T2 x DKH
  float* k_s = q_s + T2 * DKH;              // TK2 x DKH
  float* v_s = k_s + TK2 * DKH;             // TK2 x DVMAX (zero beyond dvh)

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * T2;
  const int tid = threadIdx.x;
  const int i = q0 + tid;
  const bool row_ok = i < hw;
  const bool relative = Rw != nullptr;
  const int WH = W + H;
  const size_t row = static_cast<size_t>(nh) * slot;  // elements per token
  const size_t bh = static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;
  const T* P_bh = P + bh;
  const size_t bh_tok = (static_cast<size_t>(b) * nh + h) * hw;  // offset in lse / delta / drc rows

  for (int e = tid; e < T2 * DKH; e += T2) {
    const int r = e / DKH, d = e - r * DKH;
    const int ii = q0 + r;
    q_s[e] = ii < hw ? to_f32(P_bh[ii * row + d]) : 0.f;
  }
  for (int e = tid; e < T2 * rel_stride; e += T2) bin_s[e] = 0.f;
  __syncthreads();
  rel_tile(q_s, Rw, Rh, q0, T2, hw, H, W, rel_s, rel_stride, tid, T2);

  float q[DKH], dq[DKH], doi[DVMAX];
#pragma unroll
  for (int d = 0; d < DKH; ++d) {
    q[d] = q_s[tid * DKH + d];
    dq[d] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DVMAX; ++e)
    doi[e] = (row_ok && e < dvh)
                 ? to_f32(dout[(static_cast<size_t>(b) * hw + i) * nh * dvh +
                               static_cast<size_t>(h) * dvh + e]) : 0.f;
  const float lse_i = row_ok ? lse[bh_tok + i] : 0.f;
  const float delta_i = row_ok ? delta[bh_tok + i] : 0.f;
  const float* rel = rel_s + tid * rel_stride;
  float* bin = bin_s + tid * rel_stride;
  int cur_row = -1;  // key row whose dRC_h sum is held in rh_acc
  float rh_val = 0.f, rh_acc = 0.f;

  for (int j0 = 0; j0 < hw; j0 += TK2) {
    const int kn = min(TK2, hw - j0);
    __syncthreads();  // the previous key tile is consumed (and rel_s is staged)
    for (int e = tid; e < TK2 * (DKH + DVMAX); e += T2) {
      const int jj = e / (DKH + DVMAX), c = e - jj * (DKH + DVMAX);
      const T* kv = P_bh + (j0 + jj) * row + DKH;  // [k ; v] of key j0 + jj
      if (c < DKH)
        k_s[jj * DKH + c] = jj < kn ? to_f32(kv[c]) : 0.f;
      else
        v_s[jj * DVMAX + c - DKH] = (jj < kn && c - DKH < dvh) ? to_f32(kv[c]) : 0.f;
    }
    __syncthreads();
    if (row_ok) {
      int c = j0 % W, krow = j0 / W;  // column and row of key j0 + jj
      for (int jj = 0; jj < kn; ++jj) {
        if (krow != cur_row) {  // uniform across the block: every thread walks the same keys
          if (cur_row >= 0) bin[W + cur_row] += rh_acc;
          rh_acc = 0.f;
          cur_row = krow;
          rh_val = rel[W + krow];
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
          ++krow;
        }
      }
    }
  }
  if (row_ok) {
    if (cur_row >= 0) bin[W + cur_row] += rh_acc;
    if (relative) {
      // the relative logits' part of dq, from this row's own bins
      const float* rw = Rw + static_cast<size_t>(i % W) * DKH * W;
      const float* rh = Rh + static_cast<size_t>(i / W) * DKH * H;
#pragma unroll
      for (int d = 0; d < DKH; ++d) {
        float s = 0.f;
        for (int m = 0; m < W; ++m) s = fmaf(bin[m], __ldg(rw + d * W + m), s);
        for (int m = 0; m < H; ++m) s = fmaf(bin[W + m], __ldg(rh + d * H + m), s);
        dq[d] += s;
      }
    }
    T* dq_i = dP + bh + i * row;
#pragma unroll
    for (int d = 0; d < DKH; ++d) store(dq_i + d, dq[d]);
  }
  if (!relative) return;  // uniform across the block
  __syncthreads();  // every row's bins are final
  float* drc_b = drc + (bh_tok + q0) * WH;
  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    if (q0 + r < hw) drc_b[e] = bin_s[r * rel_stride + c];
  }
}

// One entry of dRw (blockIdx.y < W: the block of column blockIdx.y) or of dRh
// (above: the block of row blockIdx.y - W) for one batch element.
template <typename T>
__global__ void __launch_bounds__(T3)
hil_attention_bwd_drel_kernel(const T* __restrict__ P, const float* __restrict__ drc,
                              float* __restrict__ part, int hw, int H, int W, int nh,
                              int slot) {
  const int b = blockIdx.z;
  const bool is_w = static_cast<int>(blockIdx.y) < W;
  const int n = is_w ? W : H;                      // width of the block's rows
  const int idx = is_w ? blockIdx.y : blockIdx.y - W;
  const int e = blockIdx.x * T3 + threadIdx.x;
  if (e >= DKH * n) return;
  const int d = e / n, m = e - d * n;
  const int WH = W + H;
  const int ntok = is_w ? H : W;                   // tokens of one column / row
  const int t0 = is_w ? idx : idx * W;
  const int tstep = is_w ? W : 1;
  const int lane = is_w ? m : W + m;               // this entry's dRC lane
  const size_t row = static_cast<size_t>(nh) * slot;
  float acc = 0.f;
  for (int h = 0; h < nh; ++h) {
    const T* q = P + static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot + d;
    const float* g = drc + (static_cast<size_t>(b) * nh + h) * hw * WH + lane;
#pragma unroll 4
    for (int u = 0; u < ntok; ++u) {
      const size_t t = t0 + u * tstep;
      acc = fmaf(to_f32(q[t * row]), g[t * WH], acc);
    }
  }
  const size_t per_b = static_cast<size_t>(DKH) * (W * W + H * H);
  const size_t off = is_w ? static_cast<size_t>(idx * DKH + d) * W + m
                          : static_cast<size_t>(DKH) * W * W +
                                static_cast<size_t>(idx * DKH + d) * H + m;
  part[b * per_b + off] = acc;
}

template <typename T>
int launch_dkdv(const void* P, const void* Rw, const void* Rh, const void* dout,
                const void* lse, const void* delta, void* dP, int B, int hw, int H, int W,
                int nh, int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ1 * (DKH + DVMAX + 2) + TQ1 * rel_stride) * sizeof(float);
  auto kern = hil_attention_bwd_dkdv_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T1 - 1) / T1, nh, B);
  kern<<<grid, T1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dP), hw, H, W, nh, slot, dvh,
      rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
              const void* delta, void* dP, void* drc, int B, int hw, int H, int W, int nh,
              int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr) ||
      (Rw == nullptr) != (drc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rel_stride = (W + H) | 1;
  const size_t smem =
      static_cast<size_t>(2 * T2 * rel_stride + T2 * DKH + TK2 * (DKH + DVMAX)) * sizeof(float);
  auto kern = hil_attention_bwd_dq_kernel<T>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T2 - 1) / T2, nh, B);
  kern<<<grid, T2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dP), static_cast<float*>(drc), hw, H,
      W, nh, slot, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_drel(const void* P, const void* drc, void* part, int B, int hw, int H, int W,
                int nh, int slot, int dkh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, 1) || W + H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = W > H ? W : H;
  const dim3 grid((DKH * n + T3 - 1) / T3, W + H, B);
  hil_attention_bwd_drel_kernel<T><<<grid, T3, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(drc), static_cast<float*>(part), hw,
      H, W, nh, slot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DKDV_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* P, const void* Rw, const void* Rh, const void* dout,       \
                      const void* lse, const void* delta, void* dP, int B, int hw, int H,    \
                      int W, int nh, int slot, int dkh, int dvh, void* stream) {             \
    return launch_dkdv<T>(P, Rw, Rh, dout, lse, delta, dP, B, hw, H, W, nh, slot, dkh, dvh,  \
                          stream);                                                           \
  }
#define DQ_ENTRY(NAME, T)                                                                    \
  extern "C" int NAME(const void* P, const void* Rw, const void* Rh, const void* dout,       \
                      const void* lse, const void* delta, void* dP, void* drc, int B, int hw, \
                      int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {      \
    return launch_dq<T>(P, Rw, Rh, dout, lse, delta, dP, drc, B, hw, H, W, nh, slot, dkh,    \
                        dvh, stream);                                                        \
  }
#define DREL_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* P, const void* drc, void* part, int B, int hw, int H,      \
                      int W, int nh, int slot, int dkh, void* stream) {                      \
    return launch_drel<T>(P, drc, part, B, hw, H, W, nh, slot, dkh, stream);                 \
  }

DKDV_ENTRY(hil_attention_bwd_dkdv_f32, float)
DKDV_ENTRY(hil_attention_bwd_dkdv_bf16, __nv_bfloat16)
DQ_ENTRY(hil_attention_bwd_dq_f32, float)
DQ_ENTRY(hil_attention_bwd_dq_bf16, __nv_bfloat16)
DREL_ENTRY(hil_attention_bwd_drel_f32, float)
DREL_ENTRY(hil_attention_bwd_drel_bf16, __nv_bfloat16)
