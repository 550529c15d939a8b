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
// Outputs are in the operand dtype; every sum is f32.
//
// The TPU kernel accumulates dqr across key-block programs into one block
// that stays resident in VMEM, relying on its sequential grid (:283-299).
// Blocks on the GPU run concurrently and see no partial sums of others, so
// the work is split into two passes, each owning its outputs outright
// (FlashAttention-2 style; deterministic, no atomics): pass dkdv owns a tile
// of keys and walks every query, pass dq owns a tile of queries and walks
// every key; both recompute S and p. The ragged tails are masked and padded
// rows are never written; no padded copy exists. Every dvh of the width class
// shares one path.
//
// Head widths: this file is built once per width class (KW, VW) of
// ops/fused_attention.py::width_plan (-DATTN_KW, -DATTN_VW; see
// attention_bwd_mma.cuh), whose passes below take dkh <= KW, dvh <= VW. The
// tensor-core passes are instantiated for ND = nd_tiles(dkh) n8 tiles of dk /
// dq; the CUDA-core passes hold q, k, dq, dk DK wide in registers, zero past
// dkh (DK = KW; DK = dkh = 20, a constant, for the model zoo's width, which
// keeps its code). In the widest classes those register rows spill to local
// memory: right, and slow (PERF.md records their times). The largest class's
// library also takes any wider head, in the nk / nv chunks the entries
// receive: attention_wide.cuh's passes (on the tensor cores a block forms S,
// p and ds once per tile pair over the whole head and feeds every output
// column of its group; on the CUDA cores they sum S and dp over chunks and
// split dk, dv and dq by chunks over the grid).
//
// Two sets of kernels, chosen by the operand dtype:
//   bf16 (what autocast training hands over): the tensor-core passes of
//     attention_bwd_mma.cuh. dkdv: 8 warps own 128 keys, S^T = k q^T with the
//     keys as fragment rows; dq: 4 warps own 64 queries, S = q k^T; p and ds
//     stay in registers as A fragments of the next products; the dRW / dRH
//     bins are ds times a one-hot of the keys' image column and row, whose B
//     fragments come ready-made from a table of the map (KeyTable). A tile of
//     queries is staged as whole qr rows (8-byte cp.async where L is a
//     multiple of 4): q and the bf16 RC lanes are read from the same rows. A
//     map with ceil(W/8) + ceil(H/8) > 16 (past 64x64) takes the CUDA-core
//     kernels below.
//   f32 (the card's own reference route, held to 1e-4): the CUDA-core passes,
//     one thread per key (dkdv, 128-key blocks) or per query (dq, 64-query
//     blocks, its own row of W+H bins in shared memory), all arithmetic f32.
//
// Bound on the H100 (SXM: 3.35 TB/s, 989 TFLOP/s bf16 tensor) at bn = 128
// (batch 16 x 8 heads), bf16, counting 6*dkh + 4*dvh + 8 operations per
// (query, key) pair for the whole backward: 40x40 dvh 1 -> 43 GFLOP, 0.044 ms
// against ~0.020 ms of bytes (operations); 20x20 and 10x10 are bound by
// bytes. The CUDA-core bf16 passes took 1.84 (dkdv) and 2.53 ms (dq) at 40x40;
// the tensor-core passes take about 0.54 and 0.58 ms (0.050 / 0.053 at 20x20,
// 0.010 / 0.010 at 10x10; scripts/bench_attention_bwd_torch.py, NVIDIA H100
// 80GB HBM3 at 700 W). What bounds them now is the scalar work around
// the MMAs, not the tensor pipe (the padded products, dkh 20 -> 32, dvh ->
// 16, the 8-wide bin tiles, are ~400 tensor operations per pair, 0.13 ms at
// the card's peak): per 16 x 8 piece of S a warp runs 3 MMAs, 5 fragment
// reads, 6-8 reads and conversions of RC lanes, 4 ex2 and the pack to bf16,
// about 80 operations, then per 16 keys 3-4 ldmatrix and MMAs (dq or dk,
// dv) and in dq 4-5 table reads with their bin MMAs; the SMs start about 2
// of the 4 operations a clock they could, at 16 warps each. -Xptxas -v: dq
// 94 / 124 / 141 registers (for <= 4 / 10 / 16 bin tiles), 32 KB of shared
// memory at 40x40 (4 blocks of 128 threads per SM, by registers); dkdv 128
// registers under __launch_bounds__(256, 2), 42 KB (tighter bounds spill and
// lose).
// dkdv double-buffers its query tiles (0.605 -> 0.541 ms at 40x40) and gives
// a thread two neighbouring keys, whose RC lanes come in one load (-> 0.537).

#include "attention_wide.cuh"

// ---------------------------------------------------------------------------
// The bf16 passes dq and dkdv on the tensor cores (attention_bwd_mma.cuh).

namespace {
namespace mma_passes {

using namespace amma;

// Pass dq. A block owns DQ_ROWS queries of one (batch, head), walks the keys
// TN at a time and writes its dqr rows [ds k ; dRW ; dRH] once. Its qr rows
// are staged whole: q and the RC lanes (bf16) are read from the same tile.
// vecq / veck: the qr rows / the k rows are 8-byte aligned (cp.async).
template <int NBT, int ND, int DKC>
__global__ void __launch_bounds__(DQ_WARPS * 32)
rel_attention_bwd_dq_mma_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                const int* __restrict__ tab, bf16* __restrict__ dqr, int hw, int H,
                                int W, int dkh, int dvh, int LP, int vecq, int veck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DKC > 0) dkh = DKC;
  constexpr int DQS = dq_stride<ND>();
  const int WH = W + H, L = dkh + WH, nbw = (W + 7) / 8, nbt = nbw + (H + 7) / 8;
  float* ld_s = reinterpret_cast<float*>(smem_raw);   // DQ_ROWS x 2
  int* tab_s = reinterpret_cast<int*>(ld_s + DQ_ROWS * 2);  // one row of the key table
  bf16* qr_s = reinterpret_cast<bf16*>(tab_s + key_table_words(nbt));  // DQ_ROWS x LP
  bf16* do_s = qr_s + DQ_ROWS * LP;                   // DQ_ROWS x VS
  bf16* k_s = do_s + DQ_ROWS * VS;                    // TN x KS
  bf16* v_s = k_s + TN * KS;                          // TN x VS
  // after the loop the same memory holds the block's sums
  float* bin_s = reinterpret_cast<float*>(smem_raw);  // DQ_ROWS x WH
  float* dq_s = bin_s + DQ_ROWS * WH;                 // DQ_ROWS x DQS

  constexpr int NT = DQ_WARPS * 32;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * DQ_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qn = min(DQ_ROWS, hw - q0);
  const size_t tok = static_cast<size_t>(b) * hw;  // first token row of this (batch, head)
  const bf16* k_b = k + tok * dkh;
  const bf16* v_b = v + tok * dvh;

  zero_tile(qr_s, DQ_ROWS * LP, tid, NT);  // the rows past hw and the columns past L
  zero_tile(k_s, TN * KS, tid, NT);        // the columns past dkh stay zero
  __syncthreads();
  stage_rows(qr_s, LP, qr + (tok + q0) * L, L, qn, L, vecq, tid, NT);
  stage_dv(do_s, dout + (tok + q0) * dvh, dvh, dvh, qn, DQ_ROWS, tid, NT);
  stage_ld(ld_s, lse + tok + q0, delta + tok + q0, qn, DQ_ROWS, tid, NT);
  cp_async_wait();
  __syncthreads();

  DqWarp<NBT, ND> st;
  dq_init(st, qr_s, LP, do_s, ld_s, warp, lane);
  for (int j0 = 0; j0 < hw; j0 += TN) {
    const int kn = min(TN, hw - j0);
    __syncthreads();  // the previous key tile is consumed
    stage_rows(k_s, KS, k_b + static_cast<size_t>(j0) * dkh, dkh, kn, dkh, veck, tid, NT);
    if (kn < TN) zero_rows(k_s, KS, kn, TN, dkh, tid, NT);
    stage_dv(v_s, v_b + static_cast<size_t>(j0) * dvh, dvh, dvh, kn, TN, tid, NT);
    stage_key_table(tab_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    dq_step(st, k_s, v_s, key_table_at(tab_s, nbt), qr_s + dkh, LP, W, nbt, kn, warp, lane);
  }
  __syncthreads();  // every warp is done with the tiles: their memory becomes the sums
  dq_dump(st, dq_s, warp, lane);
  bins_dump(st, bin_s, WH, W, H, nbw, warp, lane);
  __syncthreads();

  bf16* dqr_q = dqr + (tok + q0) * L;
  for (int e = tid; e < qn * L; e += NT) {
    const int r = e / L, c = e - r * L;
    const float x = c < dkh ? dq_s[r * DQS + c] : bin_s[r * WH + c - dkh];
    dqr_q[e] = __float2bfloat16(x);
  }
}

// Pass dkdv. A block owns DKDV_ROWS keys of one (batch, head), walks the
// queries TN at a time (whole qr rows, as in pass dq) and writes its keys' dk
// and dv once.
template <int ND, int DKC>
__global__ void __launch_bounds__(DKDV_WARPS * 32, DKDV_MIN_BLOCKS)
rel_attention_bwd_dkdv_mma_kernel(const bf16* __restrict__ qr, const bf16* __restrict__ k,
                                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                  const float* __restrict__ lse, const float* __restrict__ delta,
                                  bf16* __restrict__ dk, bf16* __restrict__ dv, int hw, int H,
                                  int W, int dkh, int dvh, int LP, int vecq, int veck) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (DKC > 0) dkh = DKC;
  // two buffers of a query tile: ld (TN x 2 f32), qr (TN x LP), dout (TN x VS)
  const int tile_words = TN * 2 + (TN * (LP + VS)) / 2;
  float* tile_s = reinterpret_cast<float*>(smem_raw);
  bf16* k_s = reinterpret_cast<bf16*>(tile_s + 2 * tile_words);  // DKDV_ROWS x KS
  bf16* v_s = k_s + DKDV_ROWS * KS;                   // DKDV_ROWS x VS

  constexpr int NT = DKDV_WARPS * 32;
  constexpr int NDV = TN * VS / NT;
  const int b = blockIdx.y;
  const int key0 = blockIdx.x * DKDV_ROWS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kn = min(DKDV_ROWS, hw - key0);
  const int L = dkh + W + H;
  const size_t tok = static_cast<size_t>(b) * hw;
  const bf16* qr_b = qr + tok * L;
  const bf16* do_b = dout + tok * dvh;

  for (int e = tid; e < 2 * tile_words; e += NT) tile_s[e] = 0.f;  // rows past hw, columns past L
  zero_tile(k_s, DKDV_ROWS * KS, tid, NT);   // the columns past dkh and the rows past hw
  __syncthreads();
  stage_rows(k_s, KS, k + (tok + key0) * dkh, dkh, kn, dkh, veck, tid, NT);
  stage_dv(v_s, v + (tok + key0) * dvh, dvh, dvh, kn, DKDV_ROWS, tid, NT);

  // the cp.async part of query tile i0 into buffer buf
  auto stage_async = [&](int i0, int buf) {
    float* ld_s = tile_s + buf * tile_words;
    bf16* qr_s = reinterpret_cast<bf16*>(ld_s + TN * 2);
    const int qn = min(TN, hw - i0);
    stage_rows(qr_s, LP, qr_b + static_cast<size_t>(i0) * L, L, qn, L, vecq, tid, NT);
    if (qn < TN) zero_rows(qr_s, LP, qn, TN, L, tid, NT);
    stage_ld(ld_s, lse + tok + i0, delta + tok + i0, qn, TN, tid, NT);
  };
  auto dout_of = [&](int buf) {
    return reinterpret_cast<bf16*>(tile_s + buf * tile_words + TN * 2) + TN * LP;
  };
  bf16 dv_regs[NDV];
  stage_async(0, 0);
  load_dv(dv_regs, do_b, dvh, dvh, min(TN, hw), tid, NT);
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
      load_dv(dv_regs, do_b + static_cast<size_t>(next) * dvh, dvh, dvh, min(TN, hw - next), tid,
              NT);
    }
    const float* ld_s = tile_s + buf * tile_words;
    const bf16* qr_s = reinterpret_cast<const bf16*>(ld_s + TN * 2);
    dkdv_step(st, qr_s, LP, dout_of(buf), ld_s, qr_s + dkh, LP, W, min(TN, hw - i0), lane);
    if (next < hw) store_dv(dout_of(buf ^ 1), dv_regs, tid, NT);
  }

  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + dkdv_key(warp, lane, i);
    if (j < hw) {
      bf16* dk_j = dk + (tok + j) * dkh;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int d = nd * 8 + 2 * t;
        if (d < dkh) dk_j[d] = __float2bfloat16(st.dk[nd][2 * i]);
        if (d + 1 < dkh) dk_j[d + 1] = __float2bfloat16(st.dk[nd][2 * i + 1]);
      }
      bf16* dv_j = dv + (tok + j) * dvh;
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const int c = nv * 8 + 2 * t;
        if (c < dvh) dv_j[c] = __float2bfloat16(st.dv[nv][2 * i]);
        if (c + 1 < dvh) dv_j[c + 1] = __float2bfloat16(st.dv[nv][2 * i + 1]);
      }
    }
  }
}

template <int NBT, int ND, int DKC>
int launch_dq_nbt(const void* qr, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, const void* tab, void* dqr, int bn, int hw,
                  int H, int W, int dkh, int dvh, void* stream) {
  const int L = dkh + W + H, LP = qr_stride_of(L);
  const size_t loop_bytes =
      static_cast<size_t>(DQ_ROWS * 2) * sizeof(float) +
      key_table_words(bin_tiles(W, H)) * sizeof(int) +
      static_cast<size_t>(DQ_ROWS * (LP + VS) + TN * (KS + VS)) * sizeof(bf16);
  const size_t sums_bytes =
      static_cast<size_t>(DQ_ROWS * (W + H + dq_stride<ND>())) * sizeof(float);
  const size_t smem = loop_bytes > sums_bytes ? loop_bytes : sums_bytes;
  auto kern = rel_attention_bwd_dq_mma_kernel<NBT, ND, DKC>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + DQ_ROWS - 1) / DQ_ROWS, bn);
  kern<<<grid, DQ_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qr), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(tab), static_cast<bf16*>(dqr),
      hw, H, W, dkh, dvh, LP, L % 4 == 0 && aligned8(qr), dkh % 4 == 0 && aligned8(k));
  return static_cast<int>(cudaGetLastError());
}

template <int ND, int DKC>
int launch_dq_nd(const void* qr, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* tab, void* dqr, int bn, int hw, int H, int W,
                 int dkh, int dvh, void* stream) {
  const int nb = bin_tiles(W, H);
  if (nb <= 4)
    return launch_dq_nbt<4, ND, DKC>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W, dkh, dvh,
                                     stream);
  if (nb <= 10)
    return launch_dq_nbt<10, ND, DKC>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W, dkh,
                                      dvh, stream);
  return launch_dq_nbt<MAX_BIN_TILES, ND, DKC>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H,
                                               W, dkh, dvh, stream);
}

int launch_dq(const void* qr, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* tab, void* dqr, int bn, int hw, int H, int W,
              int dkh, int dvh, void* stream) {
  if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dq_nd<ND_SMALL, DK_ZOO>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W,
                                            dkh, dvh, stream);
  }
  if (nd_tiles(dkh) == ND_SMALL)
    return launch_dq_nd<ND_SMALL, 0>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W, dkh,
                                     dvh, stream);
  return launch_dq_nd<KW / 8, 0>(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W, dkh, dvh,
                                 stream);
}

template <int ND, int DKC>
int launch_dkdv_nd(const void* qr, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bn, int hw, int H,
                   int W, int dkh, int dvh, void* stream) {
  const int L = dkh + W + H, LP = qr_stride_of(L);
  const size_t smem =
      2 * (static_cast<size_t>(TN * 2) * sizeof(float) +
           static_cast<size_t>(TN * (LP + VS)) * sizeof(bf16)) +
      static_cast<size_t>(DKDV_ROWS * (KS + VS)) * sizeof(bf16);
  auto kern = rel_attention_bwd_dkdv_mma_kernel<ND, DKC>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + DKDV_ROWS - 1) / DKDV_ROWS, bn);
  kern<<<grid, DKDV_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qr), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), hw, H,
      W, dkh, dvh, LP, L % 4 == 0 && aligned8(qr), dkh % 4 == 0 && aligned8(k));
  return static_cast<int>(cudaGetLastError());
}

int launch_dkdv(const void* qr, const void* k, const void* v, const void* dout, const void* lse,
                const void* delta, void* dk, void* dv, int bn, int hw, int H, int W, int dkh,
                int dvh, void* stream) {
  if constexpr (KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dkdv_nd<ND_SMALL, DK_ZOO>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W,
                                              dkh, dvh, stream);
  }
  if (nd_tiles(dkh) == ND_SMALL)
    return launch_dkdv_nd<ND_SMALL, 0>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh,
                                       dvh, stream);
  return launch_dkdv_nd<KW / 8, 0>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh,
                                   stream);
}

}  // namespace mma_passes
}  // namespace

// ---------------------------------------------------------------------------
// The CUDA-core passes: the f32 entries, and bf16 maps too large for the
// instantiations above.

namespace {

constexpr int DVMAX = amma::VW;  // largest dvh (staged VW wide, zero beyond dvh)
using amma::DK_ZOO;
constexpr int T1 = 128;      // pass 1: keys per block, one thread each
constexpr int TQ1 = 64;      // pass 1: queries per shared-memory tile
constexpr int T2 = 64;       // pass 2: queries per block, one thread each
constexpr int TK2 = 64;      // pass 2: keys per shared-memory tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// q . k over DK (zero past dkh) with four partial sums (a shorter dependency chain)
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

template <typename T, int DK>
__global__ void __launch_bounds__(T1)
rel_attention_bwd_dkdv_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta, T* __restrict__ dk,
                              T* __restrict__ dv, int hw, int H, int W, int dkh, int dvh,
                              int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* q_s = smem;                   // TQ1 x DK (zero beyond dkh)
  float* do_s = q_s + TQ1 * DK;        // TQ1 x DVMAX (zero beyond dvh)
  float* ld_s = do_s + TQ1 * DVMAX;    // TQ1 x 2: (lse, delta)
  float* rel_s = ld_s + TQ1 * 2;       // TQ1 x rel_stride: [RW | RH] rows

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * T1 + tid;
  const bool key_ok = j < hw;
  const int WH = W + H;
  const int L = dkh + WH;
  const int cj = key_ok ? j % W : 0;
  const int rj = key_ok ? W + j / W : W;  // offset of RH[., row(j)] in a rel row

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* do_b = dout + static_cast<size_t>(b) * hw * dvh;
  const float* lse_b = lse + static_cast<size_t>(b) * hw;
  const float* delta_b = delta + static_cast<size_t>(b) * hw;

  float kj[DK], vj[DVMAX], dkj[DK], dvj[DVMAX];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    kj[d] = (key_ok && d < dkh) ? to_f32(k[(static_cast<size_t>(b) * hw + j) * dkh + d]) : 0.f;
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
    for (int e = tid; e < TQ1 * DK; e += T1) {
      const int r = e / DK, d = e - r * DK;
      q_s[e] = (r < qn && d < dkh) ? to_f32(qr_b[static_cast<size_t>(i0 + r) * L + d]) : 0.f;
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
          r < qn ? to_f32(qr_b[static_cast<size_t>(i0 + r) * L + dkh + c]) : 0.f;
    }
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
    T* dk_j = dk + (static_cast<size_t>(b) * hw + j) * dkh;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < dkh) store(dk_j + d, dkj[d]);
    T* dv_j = dv + (static_cast<size_t>(b) * hw + j) * dvh;
#pragma unroll
    for (int e = 0; e < DVMAX; ++e)
      if (e < dvh) store(dv_j + e, dvj[e]);
  }
}

template <typename T, int DK>
__global__ void __launch_bounds__(T2)
rel_attention_bwd_dq_kernel(const T* __restrict__ qr, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dqr,
                            int hw, int H, int W, int dkh, int dvh, int rel_stride) {
  extern __shared__ float smem[];
  dkh = DK == DK_ZOO ? DK_ZOO : dkh;  // the zoo's width as a constant, as it was tuned
  float* rel_s = smem;                      // T2 x rel_stride: [RW | RH] rows
  float* bin_s = rel_s + T2 * rel_stride;   // T2 x rel_stride: [dRW | dRH] sums
  float* k_s = bin_s + T2 * rel_stride;     // TK2 x DK (zero beyond dkh)
  float* v_s = k_s + TK2 * DK;              // TK2 x DVMAX (zero beyond dvh)

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * T2;
  const int tid = threadIdx.x;
  const int i = q0 + tid;
  const bool row_ok = i < hw;
  const int WH = W + H;
  const int L = dkh + WH;

  const T* qr_b = qr + static_cast<size_t>(b) * hw * L;
  const T* k_b = k + static_cast<size_t>(b) * hw * dkh;
  const T* v_b = v + static_cast<size_t>(b) * hw * dvh;
  T* dqr_b = dqr + static_cast<size_t>(b) * hw * L;

  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    const int ii = q0 + r;
    rel_s[r * rel_stride + c] = ii < hw ? to_f32(qr_b[static_cast<size_t>(ii) * L + dkh + c]) : 0.f;
    bin_s[r * rel_stride + c] = 0.f;
  }
  float q[DK], dq[DK], doi[DVMAX];
#pragma unroll
  for (int d = 0; d < DK; ++d) {
    q[d] = (row_ok && d < dkh) ? to_f32(qr_b[static_cast<size_t>(i) * L + d]) : 0.f;
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
    if constexpr (DK == DK_ZOO) {  // rows of exactly DK lanes: one run of kn * DK
      for (int e = tid; e < TK2 * DK; e += T2)
        k_s[e] = e < kn * DK ? to_f32(k_b[static_cast<size_t>(j0) * DK + e]) : 0.f;
    } else {
      for (int e = tid; e < TK2 * DK; e += T2) {
        const int jj = e / DK, d = e - jj * DK;
        k_s[e] = (jj < kn && d < dkh) ? to_f32(k_b[static_cast<size_t>(j0 + jj) * dkh + d])
                                      : 0.f;
      }
    }
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
          ++row;
        }
      }
    }
  }
  if (row_ok) {
    if (cur_row >= 0) bin[W + cur_row] += rh_acc;
    T* dq_i = dqr_b + static_cast<size_t>(i) * L;
#pragma unroll
    for (int d = 0; d < DK; ++d)
      if (d < dkh) store(dq_i + d, dq[d]);
  }
  __syncthreads();  // every row's bins are final
  for (int e = tid; e < T2 * WH; e += T2) {
    const int r = e / WH, c = e - r * WH;
    const int ii = q0 + r;
    if (ii < hw) store(dqr_b + static_cast<size_t>(ii) * L + dkh + c, bin_s[r * rel_stride + c]);
  }
}

bool bad_shape(int bn, int hw, int H, int W, int dkh, int dvh) {
  return dkh < 1 || dkh > amma::KW || dvh < 1 || dvh > DVMAX || hw != H * W || hw < 1 ||
         bn < 1 || bn > 65535;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int DK>
int launch_dkdv_dk(const void* qr, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int bn, int hw,
                   int H, int W, int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(TQ1 * (DK + DVMAX + 2) + TQ1 * rel_stride) * sizeof(float);
  auto kern = rel_attention_bwd_dkdv_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T1 - 1) / T1, bn);
  kern<<<grid, T1, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), hw, H,
      W, dkh, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkdv(const void* qr, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int bn, int hw,
                int H, int W, int dkh, int dvh, void* stream) {
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dkdv_dk<T, DK_ZOO>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh,
                                       dvh, stream);
  }
  return launch_dkdv_dk<T, amma::KW>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh,
                                     stream);
}

template <typename T, int DK>
int launch_dq_dk(const void* qr, const void* k, const void* v, const void* dout,
                 const void* lse, const void* delta, void* dqr, int bn, int hw, int H, int W,
                 int dkh, int dvh, void* stream) {
  const int rel_stride = (W + H) | 1;
  const size_t smem =
      static_cast<size_t>(2 * T2 * rel_stride + TK2 * (DK + DVMAX)) * sizeof(float);
  auto kern = rel_attention_bwd_dq_kernel<T, DK>;
  const cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((hw + T2 - 1) / T2, bn);
  kern<<<grid, T2, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qr), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dqr), hw, H, W, dkh, dvh, rel_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* qr, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dqr, int bn, int hw, int H, int W,
              int dkh, int dvh, void* stream) {
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (amma::KW == 32) {
    if (dkh == DK_ZOO)
      return launch_dq_dk<T, DK_ZOO>(qr, k, v, dout, lse, delta, dqr, bn, hw, H, W, dkh, dvh,
                                     stream);
  }
  return launch_dq_dk<T, amma::KW>(qr, k, v, dout, lse, delta, dqr, bn, hw, H, W, dkh, dvh,
                                   stream);
}

// A head past the largest width class (attention_wide.cuh): head-major rows,
// grid (tiles x chunks, bn); wp, the host's plan of the pass.
struct HeadMajor {
  long long n, L;
  int bn, dkh, dvh;
  attention_wide::Geo g;
  attention_wide::WidePlan wp;
  HeadMajor(int bn_, int hw, int H, int W, int dkh_, int dvh_, int nk, int nv,
            attention_wide::WidePlan wp_)
      : n(hw), L(dkh_ + W + H), bn(bn_), dkh(dkh_), dvh(dvh_), g{hw, H, W, dkh_, dvh_, nk, nv},
        wp(wp_) {}
  bool bad() const { return g.hw != g.H * g.W || g.hw < 1 || bn < 1 || bn > 65535; }
  template <typename T>
  attention_wide::Rows<T> rows(T* p, long long width) const { return {p, 0, n * width, width}; }
};

template <typename T>
int dkdv_wide(const void* qr, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, const HeadMajor& hm, void* stream) {
  if (hm.bad()) return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(qr);
  return attention_wide::dkdv<T, T>(
      hm.rows(q, hm.L), hm.rows(static_cast<const T*>(k), hm.dkh),
      hm.rows(static_cast<const T*>(v), hm.dvh), hm.rows(static_cast<const T*>(dout), hm.dvh),
      hm.rows(static_cast<const float*>(lse), 1), hm.rows(static_cast<const float*>(delta), 1),
      hm.rows(q + hm.dkh, hm.L),
      attention_wide::DkdvOut<T>{hm.rows(static_cast<T*>(dk), hm.dkh),
                                 hm.rows(static_cast<T*>(dv), hm.dvh), {}, 0},
      hm.g, hm.bn, 1, hm.wp, stream);
}

template <typename T>
int dq_wide(const void* qr, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, const void* tab, void* dqr, const HeadMajor& hm, void* stream) {
  if (hm.bad()) return static_cast<int>(cudaErrorInvalidValue);
  const T* q = static_cast<const T*>(qr);
  T* d = static_cast<T*>(dqr);
  return attention_wide::dq<T>(
      hm.rows(q, hm.L), hm.rows(static_cast<const T*>(k), hm.dkh),
      hm.rows(static_cast<const T*>(v), hm.dvh), hm.rows(static_cast<const T*>(dout), hm.dvh),
      hm.rows(static_cast<const float*>(lse), 1), hm.rows(static_cast<const float*>(delta), 1),
      attention_wide::Rel<T>{hm.rows(q + hm.dkh, hm.L), nullptr, nullptr},
      static_cast<const int*>(tab),
      attention_wide::DqOut<T>{hm.rows(d, hm.L), hm.rows(d + hm.dkh, hm.L), {}, {}}, hm.g, hm.bn,
      1, hm.wp, stream);
}

}  // namespace

// The bf16 entries take the tensor-core passes wherever amma::mma_fits (every
// map up to 64x64); a larger map takes the CUDA-core kernels above. nk, nv:
// the head's chunk counts (ops/fused_attention.py::width_plan), 1 and 1 for a
// head its class holds; a wider head takes attention_wide.cuh, in the plan
// pack, groups, wg, tk, smem of ops/fused_attention.py::bwd_plan_args
// (attention_wide::WidePlan; all 0 for a head its class holds, and for f32).

extern "C" int rel_attention_bwd_dkdv_f32(const void* qr, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int bn, int hw, int H, int W,
                                          int dkh, int dvh, int nk, int nv, int pack, int groups,
                                          int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dkdv_wide<float>(qr, k, v, dout, lse, delta, dk, dv,
                              HeadMajor(bn, hw, H, W, dkh, dvh, nk, nv,
                                        {pack, groups, wg, tk, smem}),
                              stream);
  }
  return launch_dkdv<float>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh, stream);
}

extern "C" int rel_attention_bwd_dkdv_bf16(const void* qr, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int bn, int hw, int H, int W,
                                           int dkh, int dvh, int nk, int nv, int pack,
                                           int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dkdv_wide<__nv_bfloat16>(qr, k, v, dout, lse, delta, dk, dv,
                                      HeadMajor(bn, hw, H, W, dkh, dvh, nk, nv,
                                                {pack, groups, wg, tk, smem}),
                                      stream);
  }
  if (!amma::mma_fits(W, H))
    return launch_dkdv<__nv_bfloat16>(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh,
                                      stream);
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  return mma_passes::launch_dkdv(qr, k, v, dout, lse, delta, dk, dv, bn, hw, H, W, dkh, dvh,
                                 stream);
}

// tab: the key table of the map (ops/fused_attention.py::key_table), read by
// the tensor-core passes alone.
extern "C" int rel_attention_bwd_dq_f32(const void* qr, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        const void* tab, void* dqr, int bn, int hw, int H,
                                        int W, int dkh, int dvh, int nk, int nv, int pack,
                                        int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dq_wide<float>(qr, k, v, dout, lse, delta, tab, dqr,
                            HeadMajor(bn, hw, H, W, dkh, dvh, nk, nv,
                                      {pack, groups, wg, tk, smem}),
                            stream);
  }
  return launch_dq<float>(qr, k, v, dout, lse, delta, dqr, bn, hw, H, W, dkh, dvh, stream);
}

extern "C" int rel_attention_bwd_dq_bf16(const void* qr, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         const void* tab, void* dqr, int bn, int hw, int H,
                                         int W, int dkh, int dvh, int nk, int nv, int pack,
                                         int groups, int wg, int tk, int smem, void* stream) {
  const int route = attention_wide::route(dkh, dvh, nk, nv);
  if (route < 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (attention_wide::BUILT) {
    if (route > 0)
      return dq_wide<__nv_bfloat16>(qr, k, v, dout, lse, delta, tab, dqr,
                                    HeadMajor(bn, hw, H, W, dkh, dvh, nk, nv,
                                              {pack, groups, wg, tk, smem}),
                                    stream);
  }
  if (!amma::mma_fits(W, H))
    return launch_dq<__nv_bfloat16>(qr, k, v, dout, lse, delta, dqr, bn, hw, H, W, dkh, dvh,
                                    stream);
  if (bad_shape(bn, hw, H, W, dkh, dvh)) return static_cast<int>(cudaErrorInvalidValue);
  return mma_passes::launch_dq(qr, k, v, dout, lse, delta, tab, dqr, bn, hw, H, W, dkh, dvh,
                               stream);
}
