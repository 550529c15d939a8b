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
// the key's column and row inside the q.k product. Here RC[t, m] is computed
// once per query row into shared memory (a plain sum over d with Rw read by
// index on the CUDA cores, a product with the embedding on the tensor cores),
// and a key's two relative terms are two reads of the query row's RC: no
// mask, no one-hot, no tiled identity. Its per-tile row layouts of lse (ROW_SUB) and its tiling
// search are VMEM matters and have no counterpart.
//
// Two kernels, chosen by the operand dtype:
//   bf16 (what autocast hands over): the tensor-core kernel of
//     attention_fwd_mma.cuh, a block per (batch, head, 64-query tile) of 4
//     warps. What is this file's own:
//     - the queries' RC rows (f32, W+H wide) as the product q E^T and the
//       skewed store of hil_attention_common.cuh, the code B6's dq pass runs,
//       so the backward recomputes the forward's S;
//     - the key tiles as whole key rows of the head's slot where [k ; v] fit
//       one row of KS lanes: at the model's dkh 20 and dvh <= 8, slot
//       elements 16..47 of each key ([q tail ; k ; v ; pad], 64 bytes) by
//       16-byte cp.async (the slot a multiple of 8 lanes, as the model's 48
//       is, dkh a multiple of 4), so k sits at column 4 and v at column 24 (48
//       bytes, 16-byte aligned for ldmatrix) of a row of stride KS; wider
//       heads, ragged dkh and other slots take k rows into a KS-wide tile
//       (8-byte cp.async where dkh and the slot are multiples of 4) and v
//       rows into a VS-wide tile by 2-byte loads. The queries' q lanes come
//       by 8-byte cp.async (slot and dkh multiples of 4) or 2-byte loads.
//     A map past amma::mma_fits (past 64x64) takes the CUDA-core kernel below
//     in bf16.
//   f32 (the card's own reference route, held to 1e-4): the CUDA-core kernel,
//     all arithmetic f32.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 989 TFLOP/s bf16 tensor; exp on the
// special function units, 16 per SM and clock: ~4.2 T/s at 1.98 GHz), bf16,
// slot 48, batch 4 x 8 heads, one exp per (query, key) pair:
//   40x40 dvh 1: 5.5 MB -> 1.6 us;  4.0 GFLOP -> 4.1 us;  82 M exp -> 19.6 us
//   20x20 dvh 3: 1.3 MB -> 0.4 us;  5.1 M exp -> 1.2 us
//   10x10 dvh 6: 0.3 MB -> 0.1 us;  0.3 M exp -> 0.08 us
// so the softmax's exps, not the products or the bytes, set the floor. The
// CUDA-core kernel takes 0.74 / 0.066 / 0.019 ms there, the tensor-core
// kernel 0.137 / 0.023 / 0.010 ms (71 registers; 52 KB of shared memory at
// 40x40, so 4 blocks per SM; its key-tile loop compiles to about 1220 SASS
// instructions, staging and both paths of the relative logits included, of
// which 20 are MMAs and 37 MUFU: the scalar work
// around the MMAs, the RC reads and their addresses, the max, the FMA and ex2
// per element, the pack, is in the instruction issue, as in the backward
// passes; scripts/bench_attention_fwd_torch.py, NVIDIA H100 80GB HBM3 at
// 700 W).
//
// Design of the CUDA-core kernel: one block per (batch, head, 64-query tile);
// the tile's q is staged in shared memory, its RC rows (W+H wide) are
// computed there once, then 4 threads per query row each take every 4th key
// of a 64-key tile staged in shared memory, with their own online-softmax
// state, merged by warp shuffles at the end (the blocking of
// rel_attention_fwd.cu's CUDA-core kernel).
//
// Head widths: this file is built once per width class (KW, VW) of
// ops/fused_attention.py::width_plan (-DATTN_KW, -DATTN_VW; see
// attention_bwd_mma.cuh), whose kernels above take dkh <= KW, dvh <= VW. The
// largest class's library also takes any wider head, in the nk / nv chunks
// the entries receive: attention_wide.cuh's forward, whose RC rows are f32
// sums over all of dkh (rc_rows, the code its dq pass runs), computed once
// per 64-query tile; in bf16 up to amma::mma_fits on the tensor cores, S and
// p once per tile pair for every column of out, the slots' k and v rows by
// cp.async into two buffers, tiny maps several (batch, head) pairs a tile
// (ops/fused_attention.py::wide_fwd_plan); in f32 and on larger maps the
// CUDA-core kernel in chunks of 32 lanes.

#include "attention_wide.cuh"
#include "hil_attention_common.cuh"

// ---------------------------------------------------------------------------
// The bf16 forward on the tensor cores (attention_fwd_mma.cuh).

namespace {
namespace mma_fwd {

using namespace amma;
using hil::emb_rows;
using hil::rc_axis;
using hil::slots_aligned;
using hil::stage_emb;

// The zoo's key rows (DKC = DK_ZOO): slot elements KV_FIRST .. KV_FIRST +
// KV_COLS - 1, [q tail ; k ; v ; pad], k at column 4 and v at column 24 of a
// row of stride KS (16-byte aligned for ldmatrix).
constexpr int KV_FIRST = 16;
constexpr int KV_COLS = 24 + VW;
// Blocks of 128 threads per SM that the narrowest class is built for: 7 (72
// registers, no spill). Left to itself the compiler took 92 registers, 5
// blocks, and the latency-bound small maps (20x20, 8x8) ran 15 % slower.
constexpr int FWD_MIN_BLOCKS = KW == 32 && VW == 8 ? 7 : 1;

// A block owns FWD_ROWS queries of one (batch, head): it computes their RC
// rows, walks the keys TN at a time and writes its out and lse rows. vecq: q
// rows by 8-byte cp.async. Key tiles: at DKC = DK_ZOO whole key rows of the
// head's slot (KV_COLS lanes by 16-byte cp.async; the host has checked that
// the slot holds them); else k rows into kv_s (stride KS; 8-byte cp.async
// where vecq) and v rows into a tile of stride VS after it, by 2-byte loads.
template <int DKC>
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_MIN_BLOCKS)
hil_attention_fwd_mma_kernel(const bf16* __restrict__ P, const float* __restrict__ Rw,
                             const float* __restrict__ Rh, const int* __restrict__ tab,
                             bf16* __restrict__ out, float* __restrict__ lse, int hw, int H,
                             int W, int nh, int slot, int dkh, int dvh, int rel_stride,
                             int vecq) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr bool WHOLE = DKC > 0;
  if constexpr (WHOLE) dkh = DKC;
  const int xw = emb_rows(W), xh = emb_rows(H), nbt = bin_tiles(W, H);
  float* rel_s = reinterpret_cast<float*>(smem_raw);  // FWD_ROWS x rel_stride: RC rows
  // until the RC rows are made: the queries' tile and E (hi, lo); then the key tiles
  bf16* q_s = reinterpret_cast<bf16*>(rel_s + FWD_ROWS * rel_stride);  // FWD_ROWS x KS
  bf16* e_hi = q_s + FWD_ROWS * KS;                   // (xw + xh) x KS
  bf16* e_lo = e_hi + (xw + xh) * KS;                 // (xw + xh) x KS
  bf16* kv_s = q_s;                                   // TN x KS: key rows, or k rows
  bf16* vt_s = kv_s + TN * KS;                        // TN x VS: v rows (kv_chunks == 0)
  int* kpos_s = reinterpret_cast<int*>(vt_s + TN * VS);  // TN

  constexpr int NT = FWD_WARPS * 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * FWD_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qn = min(FWD_ROWS, hw - q0);
  const bool relative = Rw != nullptr;
  const size_t row = static_cast<size_t>(nh) * slot;  // elements per token
  const bf16* P_bh = P + static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;

  zero_tile(q_s, FWD_ROWS * KS, tid, NT);  // the columns past dkh and the rows past hw
  for (int e = tid; e < FWD_ROWS * rel_stride; e += NT) rel_s[e] = 0.f;
  __syncthreads();
  stage_rows(q_s, KS, P_bh + q0 * row, row, qn, dkh, vecq, tid, NT);
  if (relative) {
    stage_emb(e_hi, e_lo, Rw, W, xw, dkh, tid, NT);
    stage_emb(e_hi + xw * KS, e_lo + xw * KS, Rh, H, xh, dkh, tid, NT);
  }
  cp_async_wait();
  __syncthreads();

  FwdWarp st;
  fwd_init(st, q_s, KS, warp, lane);
  const int i0 = q0 + warp * 16 + (lane >> 2);  // the warp's query rows g and g + 8
  const bool row_ok[2] = {i0 < hw, i0 + 8 < hw};
  if (relative) {
    const int pos_w[2] = {i0 % W, (i0 + 8) % W}, pos_h[2] = {i0 / W, (i0 + 8) / W};
    float* rel_rows = rel_s + warp * 16 * rel_stride;
    rc_axis(st.qa, e_hi, e_lo, W, xw, pos_w, row_ok, rel_rows, rel_stride, 0, lane);
    rc_axis(st.qa, e_hi + xw * KS, e_lo + xw * KS, H, xh, pos_h, row_ok, rel_rows, rel_stride,
            W, lane);
  }
  __syncthreads();  // the queries' tile and E are consumed: their memory holds the key tiles
  zero_tile(kv_s, TN * (KS + VS), tid, NT);  // the columns that are not staged stay zero
  for (int j0 = 0; j0 < hw; j0 += TN) {
    const int kn = min(TN, hw - j0);
    __syncthreads();  // the previous key tile is consumed
    const bf16* src = P_bh + j0 * row;
    if constexpr (WHOLE) {
      cp_rows<16>(kv_s, KS * 2, src + KV_FIRST, row * 2, kn, KV_COLS / 8, tid, NT);
    } else {
      stage_rows(kv_s, KS, src + dkh, row, kn, dkh, vecq, tid, NT);
      stage_dv(vt_s, src + 2 * dkh, row, dvh, kn, TN, tid, NT);
    }
    stage_kpos(kpos_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    if constexpr (WHOLE)
      fwd_step(st, kv_s + DKC - KV_FIRST, KS, kv_s + 2 * DKC - KV_FIRST, KS, kpos_s, rel_s,
               rel_stride, W, kn, warp, lane);
    else
      fwd_step(st, kv_s, KS, vt_s, VS, kpos_s, rel_s, rel_stride, W, kn, warp, lane);
  }

  float o[NV][4], l[2];
  fwd_finish(st, o, l);
  fwd_store(o, l, out + static_cast<size_t>(b) * hw * nh * dvh + static_cast<size_t>(h) * dvh,
            static_cast<size_t>(nh) * dvh, lse + (static_cast<size_t>(b) * nh + h) * hw, i0, hw,
            dvh, lane);
}

inline size_t fwd_smem(int rel_stride, int W, int H) {
  const size_t queries =
      static_cast<size_t>(FWD_ROWS + 2 * (emb_rows(W) + emb_rows(H))) * KS * sizeof(bf16);
  const size_t keys = static_cast<size_t>(TN) * (KS + VS) * sizeof(bf16) + TN * sizeof(int);
  return static_cast<size_t>(FWD_ROWS) * rel_stride * sizeof(float) +
         (queries > keys ? queries : keys);
}

template <int DKC>
int launch_dkc(const void* P, const void* Rw, const void* Rh, const void* tab, void* out,
               void* lse, int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh,
               void* stream) {
  const int rel_stride = rel_stride_of(W, H);
  const size_t smem = fwd_smem(rel_stride, W, H);
  auto kern = hil_attention_fwd_mma_kernel<DKC>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + FWD_ROWS - 1) / FWD_ROWS, nh, B);
  kern<<<grid, FWD_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const int*>(tab), static_cast<bf16*>(out), static_cast<float*>(lse), hw, H, W,
      nh, slot, dkh, dvh, rel_stride, slots_aligned(P, slot, dkh));
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* P, const void* Rw, const void* Rh, const void* tab, void* out, void* lse,
           int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {
  if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // the zoo's whole key rows where the slot is a multiple of 8 lanes that
  // holds them (the model's 48 does at dvh <= 8)
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO && slot % 8 == 0 && slot >= KV_FIRST + KV_COLS &&
        reinterpret_cast<uintptr_t>(P) % 16 == 0)
      return launch_dkc<DK_ZOO>(P, Rw, Rh, tab, out, lse, B, hw, H, W, nh, slot, dkh, dvh,
                                stream);
  }
  return launch_dkc<0>(P, Rw, Rh, tab, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}

}  // namespace mma_fwd
}  // namespace

// ---------------------------------------------------------------------------
// The CUDA-core kernel: the f32 entry, and bf16 maps past amma::mma_fits.

namespace {

using namespace hil;

constexpr int TQ = 64;               // query rows per block
constexpr int SPLIT = 4;             // threads per query row
constexpr int THREADS = TQ * SPLIT;  // 256
constexpr int TK = 64;               // keys per shared-memory tile
constexpr int KPT = TK / SPLIT;      // keys per thread per tile

template <typename T, int DK>
__global__ void __launch_bounds__(THREADS)
hil_attention_fwd_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                         const float* __restrict__ Rh, T* __restrict__ out,
                         float* __restrict__ lse, int hw, int H, int W, int nh, int slot,
                         int dkh, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* rel_s = smem;                       // TQ x rel_stride: [RC_w | RC_h] rows
  float* q_s = rel_s + TQ * rel_stride;      // TQ x DK (zero beyond dkh)
  float* k_s = q_s + TQ * DK;                // TK x DK (zero beyond dkh)
  float* v_s = k_s + TK * DK;                // TK x DVMAX (zero beyond dvh)
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

  for (int e = tid; e < TQ * DK; e += THREADS) {
    const int rr = e / DK, d = e - rr * DK;
    const int ii = q0 + rr;
    q_s[e] = (ii < hw && d < dkh) ? to_f32(P_bh[ii * row + d]) : 0.f;
  }
  __syncthreads();
  rel_tile<DK>(q_s, Rw, Rh, q0, TQ, hw, H, W, dkh, rel_s, rel_stride, tid, THREADS);
  float q[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) q[d] = q_s[r * DK + d];

  float m = NEG_BIG, l = 0.f;
  float acc[DVMAX];
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) acc[e] = 0.f;
  const float* rw = rel_s + r * rel_stride;
  const float* rh = rw + W;

  for (int j0 = 0; j0 < hw; j0 += TK) {
    const int kn = min(TK, hw - j0);
    __syncthreads();  // the previous tile is consumed (and rel_s is staged)
    for (int e = tid; e < TK * (DK + DVMAX); e += THREADS) {
      const int jj = e / (DK + DVMAX), c = e - jj * (DK + DVMAX);
      const T* kv = P_bh + (j0 + jj) * row + dkh;  // [k ; v] of key j0 + jj
      if (c < DK)
        k_s[jj * DK + c] = (jj < kn && c < dkh) ? to_f32(kv[c]) : 0.f;
      else
        v_s[jj * DVMAX + c - DK] = (jj < kn && c - DK < dvh) ? to_f32(kv[dkh + c - DK]) : 0.f;
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
    T* o = out + (static_cast<size_t>(b) * hw + i) * nh * dvh + static_cast<size_t>(h) * dvh;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(o + e, acc[e] * inv);
    lse[(static_cast<size_t>(b) * nh + h) * hw + i] = m + logf(l);
  }
}

template <typename T, int DK>
int launch_dk(const void* P, const void* Rw, const void* Rh, void* out, void* lse, int B,
              int hw, int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ * rel_stride + TQ * DK + TK * DK + TK * DVMAX) * sizeof(float) +
      2 * TK * sizeof(int);
  auto kern = hil_attention_fwd_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + TQ - 1) / TQ, nh, B);
  kern<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<T*>(out), static_cast<float*>(lse), hw, H, W, nh, slot, dkh, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* P, const void* Rw, const void* Rh, void* out, void* lse, int B,
           int hw, int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dk<T, DK_ZOO>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
  }
  return launch_dk<T, amma::KW>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}

// A head past the largest width class (attention_wide.cuh): the slots' rows;
// wp, the host's plan of the forward.
template <typename T>
int launch_wide(const void* P, const void* Rw, const void* Rh, const void* tab, void* out,
                void* lse, int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh,
                int nk, int nv, const attention_wide::WidePlan& wp, void* stream) {
  using attention_wide::Rows;
  if (B < 1 || B > 65535 || nh < 1 || nh > 65535 || slot < 2 * dkh + dvh || hw != H * W ||
      hw < 1 || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n = hw, row = static_cast<long long>(nh) * slot;
  const long long orow = static_cast<long long>(nh) * dvh;
  const T* p = static_cast<const T*>(P);
  return attention_wide::fwd<T>(
      Rows<const T>{p, n * row, slot, row}, Rows<const T>{p + dkh, n * row, slot, row},
      Rows<const T>{p + 2 * dkh, n * row, slot, row},
      attention_wide::Rel<T>{{}, static_cast<const float*>(Rw), static_cast<const float*>(Rh)},
      static_cast<const int*>(tab), Rows<T>{static_cast<T*>(out), n * orow, dvh, orow},
      Rows<float>{static_cast<float*>(lse), nh * n, n, 1},
      attention_wide::Geo{hw, H, W, dkh, dvh, nk, nv}, nh, B, wp, stream);
}

}  // namespace

// tab: the key table of the map (ops/fused_attention.py::key_table, with the
// plan's pack), read by the tensor-core kernels alone. nk, nv: the head's
// chunk counts (ops/fused_attention.py::width_plan), 1 and 1 for a head its
// class holds; a wider head takes attention_wide.cuh, in the plan pack,
// groups, wg, tk, smem of ops/fused_attention.py::fwd_plan_args
// (attention_wide::WidePlan; all 0 for a head its class holds, for f32 and
// for a map past amma::mma_fits).
extern "C" int hil_attention_fwd_f32(const void* P, const void* Rw, const void* Rh,
                                     const void* tab, void* out, void* lse, int B, int hw, int H,
                                     int W, int nh, int slot, int dkh, int dvh, int nk, int nv,
                                     int pack, int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return launch_wide<float>(P, Rw, Rh, tab, out, lse, B, hw, H, W, nh, slot, dkh, dvh, nk,
                                nv, {pack, groups, wg, tk, smem}, stream);
  }
  return launch<float>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}

extern "C" int hil_attention_fwd_bf16(const void* P, const void* Rw, const void* Rh,
                                      const void* tab, void* out, void* lse, int B, int hw, int H,
                                      int W, int nh, int slot, int dkh, int dvh, int nk, int nv,
                                      int pack, int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return launch_wide<__nv_bfloat16>(P, Rw, Rh, tab, out, lse, B, hw, H, W, nh, slot, dkh, dvh,
                                        nk, nv, {pack, groups, wg, tk, smem}, stream);
  }
  if (!amma::mma_fits(W, H))
    return launch<__nv_bfloat16>(P, Rw, Rh, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_fwd::launch(P, Rw, Rh, tab, out, lse, B, hw, H, W, nh, slot, dkh, dvh, stream);
}
