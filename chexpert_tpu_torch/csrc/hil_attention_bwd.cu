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
// Every sum is f32, each output is rounded once.
//
// The TPU kernel keeps ONE dP block per batch element resident in VMEM:
// every query program adds its dk / dv into all key rows and its dq into
// its own rows, and dRw / dRh accumulate across the whole grid, zeroed by
// the first program (:861-865, :951, :968-981). That rests on its grid
// running in order on one core. Blocks on the GPU run concurrently, so the
// work is three passes that each own what they write (deterministic, no
// atomics), as rel_attention_bwd.cu splits its own:
//   pass dq:   a block per (batch, head, 64-query tile) walks every key, sums
//     ds over the keys of one image column / row into its rows' bins (dRC),
//     adds the relative part of dq from those bins, writes the q lanes of its
//     dP rows and its dRC rows to a scratch (B, nh, hw, W+H) f32;
//   pass dkdv: a block per (batch, head, 128-key tile) walks every query and
//     writes the k, v and pad lanes of its dP rows;
//   pass drel: a block per image column (or row) and group of bsplit batch
//     elements, a thread per lane m of its dRC rows, share of the heads and
//     batch element; sums q[t, d] * dRC[t, m] over the heads, batch elements
//     and the H (or W) tokens of the column (or row) in a fixed order into a
//     partial per group; one torch sum over the groups follows.
// Why a scratch and not per-block partials of dRw / dRh: a token adds an
// outer product q (x) dRC_w to the block of its own column, so a partial
// shrinks only by the number of tokens of one column that a block holds. A
// 64-token tile of a 40-wide map holds at most two: its partial is the
// whole 128 KB operand, 410 MB over batch 16 x 8 heads x 25 tiles. The dRC
// rows are 65 MB there (f32), written once and read once.
//
// Two sets of dq / dkdv kernels, chosen by the operand dtype:
//   bf16 (what autocast training hands over): the tensor-core passes of
//     attention_bwd_mma.cuh (see there), 4 warps / 64 queries (dq) and 8
//     warps / 128 keys (dkdv) a block. What is this file's own:
//     - RC as a product: with E_w[x][d] = rel_w[d, x], read back out of the
//       block operand Rw, RC_w[t, m] = (q E_w^T)[t, m - col(t) + W - 1]: one
//       product per tile and a skewed store, E split into hi + lo bf16 so RC
//       keeps f32 accuracy (hil_attention_common.cuh, shared with the bf16
//       forward); dq's relative part is the skewed bins (hi + lo) times E.
//       Pass dq computes each query's RC rows exactly once and
//       leaves them in a second f32 scratch rc (B, nh, hw, W+H), which pass
//       dkdv reads back (16-byte cp.async): so dq runs first. (The CUDA-core
//       dkdv recomputed every tile's RC in every key block.)
//     - q / k rows of a slot are staged by 8-byte cp.async where the slot and
//       dkh are multiples of 4 lanes (the model's 48 and 20 are), else by
//       2-byte loads: any slot >= 2*dkh + dvh works. One head per block: a
//       row's q or k lanes are 2*dkh contiguous bytes.
//     A map with ceil(W/8) + ceil(H/8) > 16 (past 64x64) takes the CUDA-core
//     kernels below, which need no rc.
//   f32 (the card's own reference route, held to 1e-4): the CUDA-core passes,
//     a thread per key (dkdv) or per query (dq), all arithmetic f32.
// Pass drel is one CUDA-core kernel for both dtypes.
//
// Bound on the H100 (3.35 TB/s, 989 TFLOP/s bf16 tensor), bf16, slot 48, batch
// 16 x 8 heads, counting 6*dkh + 4*dvh + 8 operations per (query, key) pair
// for the whole backward: 40x40 dvh 1 -> 43 GFLOP, 0.044 ms, against 41 MB,
// 0.012 ms (operations); 20x20 and 10x10 are bound by bytes. The CUDA-core
// bf16 passes took 3.50 (dkdv) and 4.77 ms (dq) at 40x40; the tensor-core
// passes take about 0.55 and 0.70 ms (0.053 / 0.069 at 20x20, 0.011 / 0.016
// at 10x10; scripts/bench_attention_bwd_torch.py, NVIDIA H100 80GB HBM3 at
// 700 W). As in rel_attention_bwd.cu the scalar work around the MMAs
// bounds them; dq pays 0.1 ms more than the head-major dq for E's staging,
// the RC and dq products with E, the two scratch rows it writes and its f32
// RC reads (two-way bank conflicts). -Xptxas -v: dq 120 / 124 / 156
// registers (<= 4 / 10 / 16 bin tiles), 53 KB of shared memory at 40x40 (the
// queries' tiles and E's lo parts share theirs with the key tiles: 4 blocks
// of 128 threads per SM); dkdv 128 registers under __launch_bounds__(256,
// 2), 67 KB for its two query-tile buffers; drel 56.
//
// Head widths: this file is built once per width class (KW, VW) of
// ops/fused_attention.py::width_plan (-DATTN_KW, -DATTN_VW; see
// attention_bwd_mma.cuh), whose dq / dkdv passes below take dkh <= KW, dvh <=
// VW, as rel_attention_bwd.cu does: the tensor-core passes are instantiated
// for nd_tiles(dkh) n8 tiles of dq / dk, the CUDA-core passes and drel hold
// their dkh-wide rows DK wide in registers. The largest class's library also
// takes any wider head, in the nk / nv chunks the entries receive:
// attention_wide.cuh's dq and dkdv passes (both routes hand the RC rows on
// through the rc scratch; on the tensor cores a block forms p and ds once
// per tile pair for every output column of its group), and drel in
// chunks of DREL_LANES lanes on the grid's z axis.

#include <type_traits>

#include "attention_wide.cuh"
#include "hil_attention_common.cuh"

// ---------------------------------------------------------------------------
// The bf16 passes dq and dkdv on the tensor cores (attention_bwd_mma.cuh).

namespace {
namespace mma_passes {

using namespace amma;
using hil::emb_rows;
using hil::rc_axis;
using hil::slots_aligned;
using hil::stage_emb;

// dq += dG E for one image axis, dG the skewed bins of the warp's rows
// (bin_rows: f32, the axis' n lanes at off), split into hi + lo bf16.
template <int ND>
__device__ __forceinline__ void dq_rel_axis(float (&dq)[ND][4], const bf16* e_hi, int n,
                                            int rows, const int (&pos)[2],
                                            const float* bin_rows, int rel_stride, int off,
                                            int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int kx = 0; kx < rows / 16; ++kx) {
    uint32_t ahi[4], alo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = i & 1;  // a0, a2: row g; a1, a3: row g + 8
      const int x = kx * 16 + 2 * t + (i >> 1) * 8;
      const int m = x - (n - 1) + pos[rr];
      const float* bin = bin_rows + (g + 8 * rr) * rel_stride + off;
      const float v0 = (m >= 0 && m < n) ? bin[m] : 0.f;
      const float v1 = (m + 1 >= 0 && m + 1 < n) ? bin[m + 1] : 0.f;
      const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
      ahi[i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
      alo[i] = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, e_hi + (kx * 16 + (lane & 15)) * KS + nd * 8);
      mma16816(dq[nd], ahi[0], ahi[1], ahi[2], ahi[3], b0, b1);
      mma16816(dq[nd], alo[0], alo[1], alo[2], alo[3], b0, b1);
    }
  }
}

// Pass dq. A block owns DQ_ROWS queries of one (batch, head): it computes
// their RC rows once (and leaves them in the rc scratch for pass dkdv), walks
// the keys TN at a time, then adds the relative logits' part of dq from its
// own bins and writes the q lanes of dP and its dRC rows. vec: the slots are
// 8-byte aligned, so q and k rows are staged by cp.async.
template <int NBT, int ND, int DKC>
__global__ void __launch_bounds__(DQ_WARPS * 32)
hil_attention_bwd_dq_mma_kernel(const bf16* __restrict__ P, const float* __restrict__ Rw,
                                const float* __restrict__ Rh, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int* __restrict__ tab, bf16* __restrict__ dP,
                                float* __restrict__ drc, float* __restrict__ rc, int hw, int H,
                                int W, int nh, int slot, int dkh, int dvh, int rel_stride,
                                int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DKC > 0) dkh = DKC;
  float* rel_s = reinterpret_cast<float*>(smem_raw);  // DQ_ROWS x rel_stride: RC, then the bins
  float* ld_s = rel_s + DQ_ROWS * rel_stride;         // DQ_ROWS x 2
  const int nbw = (W + 7) / 8, nbt = nbw + (H + 7) / 8;
  const int xw = emb_rows(W), xh = emb_rows(H);
  bf16* e_hi = reinterpret_cast<bf16*>(ld_s + DQ_ROWS * 2);  // (xw + xh) x KS: [E_w ; E_h], hi
  // what follows holds the queries' tiles and E's lo parts until the RC rows
  // are made, then the key tiles
  bf16* q_s = e_hi + (xw + xh) * KS;                  // DQ_ROWS x KS
  bf16* do_s = q_s + DQ_ROWS * KS;                    // DQ_ROWS x VS
  bf16* e_lo = do_s + DQ_ROWS * VS;                   // (xw + xh) x KS
  int* tab_s = reinterpret_cast<int*>(q_s);           // one row of the key table
  bf16* k_s = reinterpret_cast<bf16*>(tab_s + key_table_words(nbt));  // TN x KS
  bf16* v_s = k_s + TN * KS;                          // TN x VS

  constexpr int NT = DQ_WARPS * 32;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * DQ_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qn = min(DQ_ROWS, hw - q0);
  const bool relative = Rw != nullptr;
  const int WH = W + H;
  const size_t row = static_cast<size_t>(nh) * slot;  // elements per token
  const size_t bh = static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;
  const bf16* P_bh = P + bh;
  const size_t do_row = static_cast<size_t>(nh) * dvh;
  const bf16* do_bh = dout + static_cast<size_t>(b) * hw * do_row + static_cast<size_t>(h) * dvh;
  const size_t bh_tok = (static_cast<size_t>(b) * nh + h) * hw;  // offset in lse / delta rows

  zero_tile(q_s, DQ_ROWS * KS, tid, NT);  // the columns past dkh and the rows past hw stay zero
  __syncthreads();
  stage_rows(q_s, KS, P_bh + q0 * row, row, qn, dkh, vec, tid, NT);
  stage_dv(do_s, do_bh + q0 * do_row, do_row, dvh, qn, DQ_ROWS, tid, NT);
  stage_ld(ld_s, lse + bh_tok + q0, delta + bh_tok + q0, qn, DQ_ROWS, tid, NT);
  for (int e = tid; e < DQ_ROWS * rel_stride; e += NT) rel_s[e] = 0.f;
  if (relative) {
    stage_emb(e_hi, e_lo, Rw, W, xw, dkh, tid, NT);
    stage_emb(e_hi + xw * KS, e_lo + xw * KS, Rh, H, xh, dkh, tid, NT);
  }
  cp_async_wait();
  __syncthreads();

  DqWarp<NBT, ND> st;
  dq_init(st, q_s, KS, do_s, ld_s, warp, lane);
  // image column and row of the warp's query rows g and g + 8
  const int i0 = q0 + warp * 16 + (lane >> 2);
  const int pos_w[2] = {i0 % W, (i0 + 8) % W}, pos_h[2] = {i0 / W, (i0 + 8) / W};
  const bool row_ok[2] = {i0 < hw, i0 + 8 < hw};
  float* rel_rows = rel_s + warp * 16 * rel_stride;
  if (relative) {
    rc_axis(st.qa, e_hi, e_lo, W, xw, pos_w, row_ok, rel_rows, rel_stride, 0, lane);
    rc_axis(st.qa, e_hi + xw * KS, e_lo + xw * KS, H, xh, pos_h, row_ok, rel_rows, rel_stride,
            W, lane);
    __syncthreads();
    float* rc_b = rc + (bh_tok + q0) * WH;
    for (int e = tid; e < qn * WH; e += NT) {
      const int r = e / WH, c = e - r * WH;
      rc_b[e] = rel_s[r * rel_stride + c];
    }
  }

  __syncthreads();  // the queries' tiles and E's lo parts are consumed
  zero_tile(k_s, TN * KS, tid, NT);  // the columns past dkh stay zero
  for (int j0 = 0; j0 < hw; j0 += TN) {
    const int kn = min(TN, hw - j0);
    __syncthreads();  // the previous key tile is consumed
    stage_rows(k_s, KS, P_bh + j0 * row + dkh, row, kn, dkh, vec, tid, NT);
    if (kn < TN) zero_rows(k_s, KS, kn, TN, dkh, tid, NT);
    stage_dv(v_s, P_bh + j0 * row + 2 * dkh, row, dvh, kn, TN, tid, NT);
    stage_key_table(tab_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    dq_step(st, k_s, v_s, key_table_at(tab_s, nbt), rel_s, rel_stride, W, nbt, kn, warp, lane);
  }
  __syncthreads();  // every warp has read its last RC row: rel_s becomes the bins
  float* bin_s = rel_s;
  bins_dump(st, bin_s, rel_stride, W, H, nbw, warp, lane);
  __syncthreads();

  // dq = ds k + the relative logits' part, from the warp's own bins
  if (relative) {
    dq_rel_axis(st.dq, e_hi, W, xw, pos_w, rel_rows, rel_stride, 0, lane);
    dq_rel_axis(st.dq, e_hi + xw * KS, H, xh, pos_h, rel_rows, rel_stride, W, lane);
  }
  {
    const int t = lane & 3;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (row_ok[rr]) {
        bf16* dq_i = dP + bh + (i0 + 8 * rr) * row;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
          const int d = nd * 8 + 2 * t;
          if (d < dkh) dq_i[d] = __float2bfloat16(st.dq[nd][2 * rr]);
          if (d + 1 < dkh) dq_i[d + 1] = __float2bfloat16(st.dq[nd][2 * rr + 1]);
        }
      }
    }
  }
  if (!relative) return;
  float* drc_b = drc + (bh_tok + q0) * WH;
  for (int e = tid; e < qn * WH; e += NT) {
    const int r = e / WH, c = e - r * WH;
    drc_b[e] = bin_s[r * rel_stride + c];
  }
}

// Pass dkdv. A block owns DKDV_ROWS keys of one (batch, head) and walks the
// queries TN at a time; their RC rows come from the rc scratch that pass dq
// left (each row was computed once there), by 16-byte cp.async where W + H is
// a multiple of 4 (rc16). Writes the k, v and pad lanes of its dP rows.
template <int ND, int DKC>
__global__ void __launch_bounds__(DKDV_WARPS * 32, DKDV_MIN_BLOCKS)
hil_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ P, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  const float* __restrict__ rc, bf16* __restrict__ dP, int hw,
                                  int H, int W, int nh, int slot, int dkh, int dvh, int rel_stride,
                                  int vec, int rc16) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DKC > 0) dkh = DKC;
  // two buffers of a query tile: RC (TN x rel_stride f32), ld (TN x 2 f32),
  // q (TN x KS), dout (TN x VS)
  const int tile_words = TN * rel_stride + TN * 2 + (TN * (KS + VS)) / 2;
  float* tile_s = reinterpret_cast<float*>(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(tile_s + 2 * tile_words);  // DKDV_ROWS x KS
  bf16* v_s = k_s + DKDV_ROWS * KS;                   // DKDV_ROWS x VS

  constexpr int NT = DKDV_WARPS * 32;
  constexpr int NDV = TN * VS / NT;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * DKDV_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kn = min(DKDV_ROWS, hw - key0);
  const bool relative = rc != nullptr;
  const int WH = W + H;
  const size_t row = static_cast<size_t>(nh) * slot;
  const size_t bh = static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot;
  const bf16* P_bh = P + bh;
  const size_t do_row = static_cast<size_t>(nh) * dvh;
  const bf16* do_bh = dout + static_cast<size_t>(b) * hw * do_row + static_cast<size_t>(h) * dvh;
  const size_t bh_tok = (static_cast<size_t>(b) * nh + h) * hw;

  // zeros: RC without relative logits and past hw, q's columns past dkh and rows past hw
  for (int e = tid; e < 2 * tile_words; e += NT) tile_s[e] = 0.f;
  zero_tile(k_s, DKDV_ROWS * KS, tid, NT);
  __syncthreads();
  stage_rows(k_s, KS, P_bh + key0 * row + dkh, row, kn, dkh, vec, tid, NT);
  stage_dv(v_s, P_bh + key0 * row + 2 * dkh, row, dvh, kn, DKDV_ROWS, tid, NT);

  // the cp.async part of query tile i0 into buffer buf
  auto stage_async = [&](int i0, int buf) {
    float* rel_s = tile_s + buf * tile_words;
    float* ld_s = rel_s + TN * rel_stride;
    bf16* q_s = reinterpret_cast<bf16*>(ld_s + TN * 2);
    const int qn = min(TN, hw - i0);
    stage_rows(q_s, KS, P_bh + i0 * row, row, qn, dkh, vec, tid, NT);
    if (qn < TN) zero_rows(q_s, KS, qn, TN, dkh, tid, NT);
    stage_ld(ld_s, lse + bh_tok + i0, delta + bh_tok + i0, qn, TN, tid, NT);
    if (relative) {  // rows past hw keep finite values (zeros, or an earlier tile's): their p is 0
      const float* rc_b = rc + (bh_tok + i0) * WH;
      if (rc16)
        cp_rows<16>(rel_s, rel_stride * 4, rc_b, static_cast<size_t>(WH) * 4, qn, WH >> 2, tid,
                    NT);
      else
        cp_rows<4>(rel_s, rel_stride * 4, rc_b, static_cast<size_t>(WH) * 4, qn, WH, tid, NT);
    }
  };
  auto dout_of = [&](int buf) {
    return reinterpret_cast<bf16*>(tile_s + buf * tile_words + TN * rel_stride + TN * 2) +
           TN * KS;
  };
  bf16 dv_regs[NDV];
  stage_async(0, 0);
  load_dv(dv_regs, do_bh, do_row, dvh, min(TN, hw), tid, NT);
  store_dv(dout_of(0), dv_regs, tid, NT);
  cp_async_wait();
  __syncthreads();
  DkdvWarp<ND> st;
  dkdv_init(st, k_s, v_s, key0, hw, W, warp, lane);

  int buf = 0;
  for (int i0 = 0; i0 < hw; i0 += TN, buf ^= 1) {
    cp_async_wait();
    __syncthreads();  // tile i0 has landed; the other buffer's tile is consumed
    const int next = i0 + TN;
    if (next < hw) {
      stage_async(next, buf ^ 1);
      load_dv(dv_regs, do_bh + next * do_row, do_row, dvh, min(TN, hw - next), tid, NT);
    }
    const float* rel_s = tile_s + buf * tile_words;
    const float* ld_s = rel_s + TN * rel_stride;
    const bf16* q_s = reinterpret_cast<const bf16*>(ld_s + TN * 2);
    dkdv_step(st, q_s, KS, dout_of(buf), ld_s, rel_s, rel_stride, W, min(TN, hw - i0), lane);
    if (next < hw) store_dv(dout_of(buf ^ 1), dv_regs, tid, NT);
  }

  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + dkdv_key(warp, lane, i);
    if (j < hw) {
      bf16* dkv = dP + bh + j * row + dkh;  // [dk ; dv ; 0-pad] of key j
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int d = nd * 8 + 2 * t;
        if (d < dkh) dkv[d] = __float2bfloat16(st.dk[nd][2 * i]);
        if (d + 1 < dkh) dkv[d + 1] = __float2bfloat16(st.dk[nd][2 * i + 1]);
      }
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const int c = nv * 8 + 2 * t;
        if (c < dvh) dkv[dkh + c] = __float2bfloat16(st.dv[nv][2 * i]);
        if (c + 1 < dvh) dkv[dkh + c + 1] = __float2bfloat16(st.dv[nv][2 * i + 1]);
      }
      // the pad lanes meet zero weight rows in the projection's backward:
      // they are written, as zeros, so that nothing uninitialized reaches it
      for (int e = dkh + dvh + t; e < slot - dkh; e += 4) dkv[e] = __float2bfloat16(0.f);
    }
  }
}

inline size_t dq_smem(int rel_stride, int W, int H) {
  const size_t emb = static_cast<size_t>(emb_rows(W) + emb_rows(H)) * KS * sizeof(bf16);
  const size_t queries = static_cast<size_t>(DQ_ROWS * (KS + VS)) * sizeof(bf16) + emb;
  const size_t keys = key_table_words(bin_tiles(W, H)) * sizeof(int) +
                      static_cast<size_t>(TN * (KS + VS)) * sizeof(bf16);
  return static_cast<size_t>(DQ_ROWS * rel_stride + DQ_ROWS * 2) * sizeof(float) + emb +
         (queries > keys ? queries : keys);
}

inline size_t dkdv_smem(int rel_stride) {
  return 2 * (static_cast<size_t>(TN * rel_stride + TN * 2) * sizeof(float) +
              static_cast<size_t>(TN * (KS + VS)) * sizeof(bf16)) +
         static_cast<size_t>(DKDV_ROWS * (KS + VS)) * sizeof(bf16);
}

template <int NBT, int ND, int DKC>
int launch_dq_nbt(const void* P, const void* Rw, const void* Rh, const void* dout,
                  const void* lse, const void* delta, const void* tab, void* dP, void* drc,
                  void* rc, int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh,
                  void* stream) {
  const int rel_stride = rel_stride_of(W, H);
  const size_t smem = dq_smem(rel_stride, W, H);
  auto kern = hil_attention_bwd_dq_mma_kernel<NBT, ND, DKC>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + DQ_ROWS - 1) / DQ_ROWS, nh, B);
  kern<<<grid, DQ_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(tab), static_cast<bf16*>(dP),
      static_cast<float*>(drc), static_cast<float*>(rc), hw, H, W, nh, slot, dkh, dvh,
      rel_stride, slots_aligned(P, slot, dkh));
  return static_cast<int>(cudaGetLastError());
}

template <int ND, int DKC>
int launch_dq_nd(const void* P, const void* Rw, const void* Rh, const void* dout,
                 const void* lse, const void* delta, const void* tab, void* dP, void* drc,
                 void* rc, int B, int hw, int H, int W, int nh, int slot, int dkh, int dvh,
                 void* stream) {
  const int nb = bin_tiles(W, H);
  if (nb <= 4)
    return launch_dq_nbt<4, ND, DKC>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W,
                                     nh, slot, dkh, dvh, stream);
  if (nb <= 10)
    return launch_dq_nbt<10, ND, DKC>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W,
                                      nh, slot, dkh, dvh, stream);
  return launch_dq_nbt<MAX_BIN_TILES, ND, DKC>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B,
                                               hw, H, W, nh, slot, dkh, dvh, stream);
}

int launch_dq(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
              const void* delta, const void* tab, void* dP, void* drc, void* rc, int B, int hw,
              int H, int W, int nh, int slot, int dkh, int dvh, void* stream) {
  if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dq_nd<ND_SMALL, DK_ZOO>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw,
                                            H, W, nh, slot, dkh, dvh, stream);
  }
  if (nd_tiles(dkh) == ND_SMALL)
    return launch_dq_nd<ND_SMALL, 0>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W,
                                     nh, slot, dkh, dvh, stream);
  return launch_dq_nd<KW / 8, 0>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W,
                                 nh, slot, dkh, dvh, stream);
}

template <int ND, int DKC>
int launch_dkdv_nd(const void* P, const void* dout, const void* lse, const void* delta,
                   const void* rc, void* dP, int B, int hw, int H, int W, int nh, int slot,
                   int dkh, int dvh, void* stream) {
  const int rel_stride = rel_stride_of(W, H);
  const size_t smem = dkdv_smem(rel_stride);
  auto kern = hil_attention_bwd_dkdv_mma_kernel<ND, DKC>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + DKDV_ROWS - 1) / DKDV_ROWS, nh, B);
  const int rc16 = (W + H) % 4 == 0 && reinterpret_cast<uintptr_t>(rc) % 16 == 0;
  kern<<<grid, DKDV_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(P), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(rc), static_cast<bf16*>(dP), hw, H, W, nh, slot, dkh, dvh,
      rel_stride, slots_aligned(P, slot, dkh), rc16);
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv(const void* P, const void* dout, const void* lse, const void* delta,
                const void* rc, void* dP, int B, int hw, int H, int W, int nh, int slot,
                int dkh, int dvh, void* stream) {
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dkdv_nd<ND_SMALL, DK_ZOO>(P, dout, lse, delta, rc, dP, B, hw, H, W, nh, slot,
                                              dkh, dvh, stream);
  }
  if (nd_tiles(dkh) == ND_SMALL)
    return launch_dkdv_nd<ND_SMALL, 0>(P, dout, lse, delta, rc, dP, B, hw, H, W, nh, slot, dkh,
                                       dvh, stream);
  return launch_dkdv_nd<KW / 8, 0>(P, dout, lse, delta, rc, dP, B, hw, H, W, nh, slot, dkh,
                                   dvh, stream);
}

}  // namespace mma_passes
}  // namespace

namespace {

using namespace hil;

constexpr int T1 = 128;   // pass 1: keys per block, one thread each
constexpr int TQ1 = 64;   // pass 1: queries per shared-memory tile
constexpr int T2 = 64;    // pass 2: queries per block, one thread each
constexpr int TK2 = 64;   // pass 2: keys per shared-memory tile

template <typename T, int DK>
__global__ void __launch_bounds__(T1)
hil_attention_bwd_dkdv_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                              const float* __restrict__ Rh, const T* __restrict__ dout,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              T* __restrict__ dP, int hw, int H, int W, int nh, int slot,
                              int dkh, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* q_s = smem;                   // TQ1 x DK (zero beyond dkh)
  float* do_s = q_s + TQ1 * DK;        // TQ1 x DVMAX (zero beyond dvh)
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

  float kj[DK], vj[DVMAX], dkj[DK], dvj[DVMAX];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    kj[d] = (key_ok && d < dkh) ? to_f32(P_bh[j * row + dkh + d]) : 0.f;
    dkj[d] = 0.f;
  }
#pragma unroll
  for (int e = 0; e < DVMAX; ++e) {
    vj[e] = (key_ok && e < dvh) ? to_f32(P_bh[j * row + 2 * dkh + e]) : 0.f;
    dvj[e] = 0.f;
  }

  for (int i0 = 0; i0 < hw; i0 += TQ1) {
    const int qn = min(TQ1, hw - i0);
    __syncthreads();  // the previous query tile is consumed
    for (int e = tid; e < TQ1 * DK; e += T1) {
      const int r = e / DK, d = e - r * DK;
      q_s[e] = (r < qn && d < dkh) ? to_f32(P_bh[(i0 + r) * row + d]) : 0.f;
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
    rel_tile<DK>(q_s, Rw, Rh, i0, TQ1, hw, H, W, dkh, rel_s, rel_stride, tid, T1);
    __syncthreads();
    if (key_ok) {
#pragma unroll 2
      for (int r = 0; r < qn; ++r) {
        const float* qi = q_s + r * DK;
        const float* doi = do_s + r * DVMAX;
        const float* rel = rel_s + r * rel_stride;
        const float s = dot_dk<DK>(qi, kj) + rel[cj] + rel[rj];
        const float p = expf(s - ld_s[2 * r]);
        const float ds = p * (dot_dv(doi, vj) - ld_s[2 * r + 1]);
#pragma unroll
        for (int e = 0; e < DVMAX; ++e) dvj[e] = fmaf(p, doi[e], dvj[e]);
#pragma unroll
        for (int d = 0; d < DK; ++d) dkj[d] = fmaf(ds, qi[d], dkj[d]);
      }
    }
  }
  if (key_ok) {
    T* dkv = dP + bh + j * row + dkh;  // [dk ; dv ; 0-pad] of key j
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < dkh) store(dkv + d, dkj[d]);
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(dkv + dkh + e, dvj[e]);
    // the pad lanes meet zero weight rows in the projection's backward:
    // they are written, as zeros, so that nothing uninitialized reaches it
    for (int e = dkh + dvh; e < slot - dkh; ++e) store(dkv + e, 0.f);
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(T2)
hil_attention_bwd_dq_kernel(const T* __restrict__ P, const float* __restrict__ Rw,
                            const float* __restrict__ Rh, const T* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            T* __restrict__ dP, float* __restrict__ drc, int hw, int H,
                            int W, int nh, int slot, int dkh, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* rel_s = smem;                      // T2 x rel_stride: [RC_w | RC_h] rows
  float* bin_s = rel_s + T2 * rel_stride;   // T2 x rel_stride: [dRC_w | dRC_h] sums
  float* q_s = bin_s + T2 * rel_stride;     // T2 x DK (zero beyond dkh)
  float* k_s = q_s + T2 * DK;               // TK2 x DK (zero beyond dkh)
  float* v_s = k_s + TK2 * DK;              // TK2 x DVMAX (zero beyond dvh)

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

  for (int e = tid; e < T2 * DK; e += T2) {
    const int r = e / DK, d = e - r * DK;
    const int ii = q0 + r;
    q_s[e] = (ii < hw && d < dkh) ? to_f32(P_bh[ii * row + d]) : 0.f;
  }
  for (int e = tid; e < T2 * rel_stride; e += T2) bin_s[e] = 0.f;
  __syncthreads();
  rel_tile<DK>(q_s, Rw, Rh, q0, T2, hw, H, W, dkh, rel_s, rel_stride, tid, T2);

  float q[DK], dq[DK], doi[DVMAX];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    q[d] = q_s[tid * DK + d];
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
    for (int e = tid; e < TK2 * (DK + DVMAX); e += T2) {
      const int jj = e / (DK + DVMAX), c = e - jj * (DK + DVMAX);
      const T* kv = P_bh + (j0 + jj) * row + dkh;  // [k ; v] of key j0 + jj
      if (c < DK)
        k_s[jj * DK + c] = (jj < kn && c < dkh) ? to_f32(kv[c]) : 0.f;
      else
        v_s[jj * DVMAX + c - DK] = (jj < kn && c - DK < dvh) ? to_f32(kv[dkh + c - DK]) : 0.f;
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
        const float* kj = k_s + jj * DK;
        const float s = dot_dk<DK>(q, kj) + rel[c] + rh_val;
        const float p = expf(s - lse_i);
        const float ds = p * (dot_dv(doi, v_s + jj * DVMAX) - delta_i);
#pragma unroll
        for (int d = 0; d < DK; ++d) dq[d] = fmaf(ds, kj[d], dq[d]);
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
      const float* rw = Rw + static_cast<size_t>(i % W) * dkh * W;
      const float* rh = Rh + static_cast<size_t>(i / W) * dkh * H;
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        if (d < dkh) {
          float s = 0.f;
          for (int m = 0; m < W; ++m) s = fmaf(bin[m], __ldg(rw + d * W + m), s);
          for (int m = 0; m < H; ++m) s = fmaf(bin[W + m], __ldg(rh + d * H + m), s);
          dq[d] += s;
        }
      }
    }
    T* dq_i = dP + bh + i * row;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < dkh) store(dq_i + d, dq[d]);
  }
  if (!relative) return;  // uniform across the block
  __syncthreads();  // every row's bins are final
  float* drc_b = drc + (bh_tok + q0) * WH;
  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    if (q0 + r < hw) drc_b[e] = bin_s[r * rel_stride + c];
  }
}

constexpr size_t DREL_SMEM_MAX = 64 * 1024;  // pass drel's partial sums in a block
constexpr int DREL_LANES = 32;  // lanes of dkh a thread of pass drel holds (DK), but the zoo's

// Lanes a q load of pass drel takes: 16 bytes where DK holds whole ones,
// else 4 lanes, else 1.
template <int DK, typename T>
__host__ __device__ constexpr int drel_vec() {
  constexpr int w = 16 / static_cast<int>(sizeof(T));
  return DK % w == 0 ? w : DK % 4 == 0 ? 4 : 1;
}

// acc[d] += q[t, d0 + d] * gv for d < dc (lanes past dc take what lies
// beyond, inside the slot, and are never written): drel_vec lanes a load
// where vec (every token's lanes start on that many elements), else one.
template <int DK, typename T>
__device__ __forceinline__ void q_fma(float (&acc)[DK], const T* qt, float gv, int dc, bool vec) {
  constexpr int VEC = drel_vec<DK, T>();
  if constexpr (VEC > 1) {
    if (vec) {
      using V = typename std::conditional<VEC * sizeof(T) == 16, uint4, uint2>::type;
#pragma unroll
      for (int d = 0; d < DK; d += VEC) {
        if (d < dc) {
          const V raw = __ldg(reinterpret_cast<const V*>(qt + d));
          const T* w = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int i = 0; i < VEC; ++i) acc[d + i] = fmaf(to_f32(w[i]), gv, acc[d + i]);
        }
      }
      return;
    }
  }
#pragma unroll
  for (int d = 0; d < DK; ++d)
    if (d < dc) acc[d] = fmaf(to_f32(qt[d]), gv, acc[d]);
}

// The (dkh, n) block of dRw (blockIdx.x < W: image column blockIdx.x, n = W)
// or of dRh (above: image row blockIdx.x - W, n = H) for bsplit batch
// elements (group blockIdx.y), its lanes d0 .. d0 + dc - 1 of dkh (d0 =
// blockIdx.z * DK: a head wider than DK, DREL_LANES or the zoo's 20, takes
// ceil(dkh / DK) chunks on the grid's z axis, so a thread holds 32 sums and
// not a width class's 128). A thread owns one lane m of the block's dRC rows, a
// share of the heads (hsplit) and one batch element of the group (bsplit),
// and holds the chunk's dc sums of that lane (DK wide, zero past
// dc): each dRC entry is read once per chunk, the q lanes of a token are the
// same address for every thread of a head (16-byte loads where the slots
// allow). The partial sums of the heads and batch elements meet in shared
// memory and are added in a fixed order (batch element, then head), one
// partial per group. hil_attention.py::drel_plan picks hsplit and bsplit so
// that a block has at least 128 threads where the batch allows (at 8x8 with
// two heads a block had 16 before batch elements shared one); the large maps
// keep one batch element a block (bsplit 1).
template <typename T, int DK>
__global__ void hil_attention_bwd_drel_kernel(const T* __restrict__ P,
                                              const float* __restrict__ drc,
                                              float* __restrict__ part, int B, int hw, int H,
                                              int W, int nh, int slot, int dkh, int hsplit,
                                              int bsplit, int vec) {
  extern __shared__ float red_s[];  // bsplit x hsplit x dc x n
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  const int d0 = DK == DK_ZOO ? 0 : static_cast<int>(blockIdx.z) * DK;
  const int dc = min(DK, dkh - d0);
  const bool is_w = static_cast<int>(blockIdx.x) < W;
  const int n = is_w ? W : H;                      // width of the block's rows
  const int idx = is_w ? blockIdx.x : blockIdx.x - W;
  // a lane of max(W, H) threads per (batch element, head share)
  const int nl = W > H ? W : H;
  const int m = threadIdx.x % nl, hb = threadIdx.x / nl;
  const int hy = hb % hsplit, bb = hb / hsplit;
  const int b = static_cast<int>(blockIdx.y) * bsplit + bb;
  const int WH = W + H;
  const int ntok = is_w ? H : W;                   // tokens of one column / row
  const int t0 = is_w ? idx : idx * W;
  const int tstep = is_w ? W : 1;
  const int lane = is_w ? m : W + m;               // this thread's dRC lane
  const size_t row = static_cast<size_t>(nh) * slot;
  float acc[DK];
#pragma unroll
  for (int d = 0; d < DK; ++d) acc[d] = 0.f;
  // spare threads: a lane past n, a batch slot past B
  const bool active = m < n && b < B;
  for (int h = active ? hy : nh; h < nh; h += hsplit) {
    const T* q = P + static_cast<size_t>(b) * hw * row + static_cast<size_t>(h) * slot + d0;
    const float* g = drc + (static_cast<size_t>(b) * nh + h) * hw * WH + lane;
#pragma unroll 4
    for (int u = 0; u < ntok; ++u) {
      const size_t t = t0 + u * tstep;
      q_fma<DK>(acc, q + t * row, g[t * WH], dc, vec);
    }
  }
  if (m < n) {
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < dc) red_s[((bb * hsplit + hy) * dc + d) * n + m] = acc[d];
  }
  __syncthreads();
  const size_t per_b = static_cast<size_t>(dkh) * (W * W + H * H);
  const size_t off =
      (is_w ? static_cast<size_t>(idx) * dkh * W
            : static_cast<size_t>(dkh) * W * W + static_cast<size_t>(idx) * dkh * H) +
      static_cast<size_t>(d0) * n;
  const int nb = min(bsplit, B - static_cast<int>(blockIdx.y) * bsplit);
  for (int e = threadIdx.x; e < dc * n; e += blockDim.x) {  // e = d * n + m
    float sum = 0.f;
    for (int y = 0; y < nb * hsplit; ++y) sum += red_s[y * dc * n + e];
    part[blockIdx.y * per_b + off + e] = sum;
  }
}

template <typename T, int DK>
int launch_dkdv_dk(const void* P, const void* Rw, const void* Rh, const void* dout,
                   const void* lse, const void* delta, void* dP, int B, int hw, int H, int W,
                   int nh, int slot, int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ1 * (DK + DVMAX + 2) + TQ1 * rel_stride) * sizeof(float);
  auto kern = hil_attention_bwd_dkdv_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T1 - 1) / T1, nh, B);
  kern<<<grid, T1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dP), hw, H, W, nh, slot, dkh, dvh,
      rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* P, const void* Rw, const void* Rh, const void* dout,
                const void* lse, const void* delta, void* dP, int B, int hw, int H, int W,
                int nh, int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dkdv_dk<T, DK_ZOO>(P, Rw, Rh, dout, lse, delta, dP, B, hw, H, W, nh, slot,
                                       dkh, dvh, stream);
  }
  return launch_dkdv_dk<T, amma::KW>(P, Rw, Rh, dout, lse, delta, dP, B, hw, H, W, nh, slot,
                                     dkh, dvh, stream);
}

template <typename T, int DK>
int launch_dq_dk(const void* P, const void* Rw, const void* Rh, const void* dout,
                 const void* lse, const void* delta, void* dP, void* drc, int B, int hw, int H,
                 int W, int nh, int slot, int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;
  const size_t smem =
      static_cast<size_t>(2 * T2 * rel_stride + T2 * DK + TK2 * (DK + DVMAX)) * sizeof(float);
  auto kern = hil_attention_bwd_dq_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T2 - 1) / T2, nh, B);
  kern<<<grid, T2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(Rw), static_cast<const float*>(Rh),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dP), static_cast<float*>(drc), hw, H,
      W, nh, slot, dkh, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
              const void* delta, void* dP, void* drc, int B, int hw, int H, int W, int nh,
              int slot, int dkh, int dvh, void* stream) {
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr) ||
      (Rw == nullptr) != (drc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dq_dk<T, DK_ZOO>(P, Rw, Rh, dout, lse, delta, dP, drc, B, hw, H, W, nh,
                                     slot, dkh, dvh, stream);
  }
  return launch_dq_dk<T, amma::KW>(P, Rw, Rh, dout, lse, delta, dP, drc, B, hw, H, W, nh, slot,
                                   dkh, dvh, stream);
}

template <typename T, int DK>
int launch_drel_dk(const void* P, const void* drc, void* part, int B, int hw, int H, int W,
                   int nh, int slot, int dkh, int hsplit, int bsplit, void* stream) {
  const int n = W > H ? W : H, dc = dkh < DK ? dkh : DK;
  const size_t smem = static_cast<size_t>(bsplit) * hsplit * dc * n * sizeof(float);
  if (hsplit < 1 || hsplit > nh || bsplit < 1 || bsplit > B ||
      static_cast<long long>(n) * hsplit * bsplit > 1024 || smem > DREL_SMEM_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = hil_attention_bwd_drel_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int VEC = drel_vec<DK, T>();
  const int vec = reinterpret_cast<uintptr_t>(P) % (VEC * sizeof(T)) == 0 && slot % VEC == 0;
  const dim3 grid(W + H, (B + bsplit - 1) / bsplit, (dkh + DK - 1) / DK);
  kern<<<grid, n * hsplit * bsplit, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(P), static_cast<const float*>(drc), static_cast<float*>(part), B,
      hw, H, W, nh, slot, dkh, hsplit, bsplit, vec);
  return static_cast<int>(cudaGetLastError());
}

// hsplit, bsplit: hil_attention.py::drel_plan; part holds ceil(B / bsplit)
// partials.
template <typename T>
int launch_drel(const void* P, const void* drc, void* part, int B, int hw, int H, int W,
                int nh, int slot, int dkh, int nk, int hsplit, int bsplit, void* stream) {
  const int route = attention_wide::route(dkh, 1, nk, 1);
  if (route < 0 || bad_shape(B, hw, H, W, nh, slot, route > 0 ? 1 : dkh, 1) ||
      slot < 2 * dkh + 1 || W + H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_drel_dk<T, DK_ZOO>(P, drc, part, B, hw, H, W, nh, slot, dkh, hsplit, bsplit,
                                       stream);
  }
  return launch_drel_dk<T, DREL_LANES>(P, drc, part, B, hw, H, W, nh, slot, dkh, hsplit, bsplit,
                                       stream);
}

// A head past the largest width class (attention_wide.cuh): the slots' rows,
// grid (tiles x chunks, nh, B); wp, the host's plan of the pass. The RC rows
// reach pass dkdv through the rc scratch of pass dq on both routes.
struct Slots {
  long long n, row, orow, rcs;
  int B, nh, slot, dkh, dvh;
  attention_wide::Geo g;
  attention_wide::WidePlan wp;
  Slots(int B_, int hw, int H, int W, int nh_, int slot_, int dkh_, int dvh_, int nk, int nv,
        attention_wide::WidePlan wp_)
      : n(hw), row(static_cast<long long>(nh_) * slot_), orow(static_cast<long long>(nh_) * dvh_),
        rcs(W + H), B(B_), nh(nh_), slot(slot_), dkh(dkh_), dvh(dvh_),
        g{hw, H, W, dkh_, dvh_, nk, nv}, wp(wp_) {}
  bool bad() const {
    return B < 1 || B > 65535 || nh < 1 || nh > 65535 || slot < 2 * dkh + dvh ||
           g.hw != g.H * g.W || g.hw < 1;
  }
  template <typename T>  // the lanes of each slot from p on
  attention_wide::Rows<T> lanes(T* p) const { return {p, n * row, slot, row}; }
  template <typename T>  // (B, nh, hw, width) rows from p; a null p: none
  attention_wide::Rows<T> heads(T* p, long long width) const {
    if (p == nullptr) return {};
    return {p, nh * n * width, n * width, width};
  }
};

template <typename T>
int dkdv_wide(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
              const void* delta, void* dP, const void* rc, const Slots& sl, void* stream) {
  if (sl.bad() || (Rw == nullptr) != (Rh == nullptr) || (Rw == nullptr) != (rc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(P);
  T* d = static_cast<T*>(dP);
  return attention_wide::dkdv<T, float>(
      sl.lanes(p), sl.lanes(p + sl.dkh), sl.lanes(p + 2 * sl.dkh),
      attention_wide::Rows<const T>{static_cast<const T*>(dout), sl.n * sl.orow, sl.dvh, sl.orow},
      sl.heads(static_cast<const float*>(lse), 1), sl.heads(static_cast<const float*>(delta), 1),
      sl.heads(static_cast<const float*>(rc), sl.rcs),
      attention_wide::DkdvOut<T>{sl.lanes(d + sl.dkh), sl.lanes(d + 2 * sl.dkh),
                       sl.lanes(d + 2 * sl.dkh + sl.dvh), sl.slot - 2 * sl.dkh - sl.dvh},
      sl.g, sl.nh, sl.B, sl.wp, stream);
}

template <typename T>
int dq_wide(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
            const void* delta, const void* tab, void* dP, void* drc, void* rc, const Slots& sl,
            void* stream) {
  if (sl.bad() || (Rw == nullptr) != (Rh == nullptr) || (Rw == nullptr) != (drc == nullptr) ||
      (Rw == nullptr) != (rc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* p = static_cast<const T*>(P);
  return attention_wide::dq<T>(
      sl.lanes(p), sl.lanes(p + sl.dkh), sl.lanes(p + 2 * sl.dkh),
      attention_wide::Rows<const T>{static_cast<const T*>(dout), sl.n * sl.orow, sl.dvh, sl.orow},
      sl.heads(static_cast<const float*>(lse), 1), sl.heads(static_cast<const float*>(delta), 1),
      attention_wide::Rel<T>{{}, static_cast<const float*>(Rw), static_cast<const float*>(Rh)},
      static_cast<const int*>(tab),
      attention_wide::DqOut<T>{sl.lanes(static_cast<T*>(dP)), {},
                               sl.heads(static_cast<float*>(drc), sl.rcs),
                               sl.heads(static_cast<float*>(rc), sl.rcs)},
      sl.g, sl.nh, sl.B, sl.wp, stream);
}

// The bf16 entries take the tensor-core passes wherever amma::mma_fits (every
// map up to 64x64); a larger map takes the CUDA-core kernels above. rc is the
// RC scratch (B, nh, hw, W+H) f32 that the tensor-core dq leaves and the
// tensor-core dkdv reads, tab the key table of the map
// (ops/fused_attention.py::key_table) that the tensor-core dq reads; the
// class's CUDA-core kernels ignore both. nk, nv: the head's chunk counts
// (ops/fused_attention.py::width_plan), 1 and 1 for a head its class holds; a
// wider head takes attention_wide.cuh, whose passes use rc on both routes, in
// the plan pack, groups, wg, tk, smem of ops/fused_attention.py::bwd_plan_args
// (attention_wide::WidePlan; all 0 for a head its class holds, and for f32).

int dkdv_bf16(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
              const void* delta, void* dP, const void* rc, int B, int hw, int H, int W, int nh,
              int slot, int dkh, int dvh, int nk, int nv, attention_wide::WidePlan wp,
              void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dkdv_wide<__nv_bfloat16>(P, Rw, Rh, dout, lse, delta, dP, rc,
                                      Slots(B, hw, H, W, nh, slot, dkh, dvh, nk, nv, wp), stream);
  }
  if (!amma::mma_fits(W, H))
    return launch_dkdv<__nv_bfloat16>(P, Rw, Rh, dout, lse, delta, dP, B, hw, H, W, nh, slot,
                                      dkh, dvh, stream);
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr) ||
      (Rw == nullptr) != (rc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_passes::launch_dkdv(P, dout, lse, delta, rc, dP, B, hw, H, W, nh, slot, dkh, dvh,
                                 stream);
}

int dq_bf16(const void* P, const void* Rw, const void* Rh, const void* dout, const void* lse,
            const void* delta, const void* tab, void* dP, void* drc, void* rc, int B, int hw,
            int H, int W, int nh, int slot, int dkh, int dvh, int nk, int nv,
            attention_wide::WidePlan wp, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dq_wide<__nv_bfloat16>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc,
                                    Slots(B, hw, H, W, nh, slot, dkh, dvh, nk, nv, wp), stream);
  }
  if (!amma::mma_fits(W, H))
    return launch_dq<__nv_bfloat16>(P, Rw, Rh, dout, lse, delta, dP, drc, B, hw, H, W, nh, slot,
                                    dkh, dvh, stream);
  if (bad_shape(B, hw, H, W, nh, slot, dkh, dvh) || (Rw == nullptr) != (Rh == nullptr) ||
      (Rw == nullptr) != (drc == nullptr) || (Rw == nullptr) != (rc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_passes::launch_dq(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W, nh,
                               slot, dkh, dvh, stream);
}

}  // namespace

extern "C" int hil_attention_bwd_dkdv_f32(const void* P, const void* Rw, const void* Rh,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dP, const void* rc, int B, int hw, int H, int W,
                                          int nh, int slot, int dkh, int dvh, int nk, int nv,
                                          int pack, int groups, int wg, int tk, int smem,
                                          void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dkdv_wide<float>(P, Rw, Rh, dout, lse, delta, dP, rc,
                              Slots(B, hw, H, W, nh, slot, dkh, dvh, nk, nv,
                                    {pack, groups, wg, tk, smem}),
                              stream);
  }
  return launch_dkdv<float>(P, Rw, Rh, dout, lse, delta, dP, B, hw, H, W, nh, slot, dkh, dvh,
                            stream);
}

extern "C" int hil_attention_bwd_dkdv_bf16(const void* P, const void* Rw, const void* Rh,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dP, const void* rc, int B, int hw, int H, int W,
                                           int nh, int slot, int dkh, int dvh, int nk, int nv,
                                           int pack, int groups, int wg, int tk, int smem,
                                           void* stream) {
  return dkdv_bf16(P, Rw, Rh, dout, lse, delta, dP, rc, B, hw, H, W, nh, slot, dkh, dvh, nk, nv,
                   {pack, groups, wg, tk, smem}, stream);
}

extern "C" int hil_attention_bwd_dq_f32(const void* P, const void* Rw, const void* Rh,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* tab, void* dP, void* drc, void* rc, int B,
                                        int hw, int H, int W, int nh, int slot, int dkh,
                                        int dvh, int nk, int nv, int pack, int groups, int wg,
                                        int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dq_wide<float>(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc,
                            Slots(B, hw, H, W, nh, slot, dkh, dvh, nk, nv,
                                  {pack, groups, wg, tk, smem}),
                            stream);
  }
  return launch_dq<float>(P, Rw, Rh, dout, lse, delta, dP, drc, B, hw, H, W, nh, slot, dkh, dvh,
                          stream);
}

extern "C" int hil_attention_bwd_dq_bf16(const void* P, const void* Rw, const void* Rh,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* tab, void* dP, void* drc, void* rc, int B,
                                         int hw, int H, int W, int nh, int slot, int dkh,
                                         int dvh, int nk, int nv, int pack, int groups, int wg,
                                         int tk, int smem, void* stream) {
  return dq_bf16(P, Rw, Rh, dout, lse, delta, tab, dP, drc, rc, B, hw, H, W, nh, slot, dkh, dvh,
                 nk, nv, {pack, groups, wg, tk, smem}, stream);
}

// nk: the chunk count of dkh (ops/fused_attention.py::width_plan), 1 for a
// head its class holds; hsplit, bsplit: hil_attention.py::drel_plan.
#define DREL_ENTRY(NAME, T)                                                                  \
  extern "C" int NAME(const void* P, const void* drc, void* part, int B, int hw, int H,      \
                      int W, int nh, int slot, int dkh, int nk, int hsplit, int bsplit,      \
                      void* stream) {                                                        \
    return launch_drel<T>(P, drc, part, B, hw, H, W, nh, slot, dkh, nk, hsplit, bsplit,      \
                          stream);                                                           \
  }

DREL_ENTRY(hil_attention_bwd_drel_f32, float)
DREL_ENTRY(hil_attention_bwd_drel_bf16, __nv_bfloat16)
