// Heads wider than the largest width class: the four attention kernels of
// both layouts (B1 / B2 head-major, B5 / B6 heads-in-lanes) for any dkh and
// dvh, with the head dimensions looped over in chunks, for sm_90a.
//
// A width class (KW, VW) of ops/fused_attention.py::width_plan takes a head
// of dkh <= KW, dvh <= VW in its own kernels. A head past the largest class,
// (128, 64), runs in that class's libraries on the kernels of this header,
// with nk = ceil(dkh / KW) key chunks and nv = ceil(dvh / VW) value chunks
// passed at run time (the entries check them against dkh and dvh). Two kinds
// of loop:
//   - A contraction over a head dimension loops inside the block. S = q k^T
//     sums over the nk chunks of dkh and dp = dout v^T over the nv chunks of
//     dvh, into the same accumulator fragments (tensor cores) or registers
//     (CUDA cores) as the class's kernels: chunk by chunk, both operands are
//     staged through the class's tiles (KW or VW columns, zero past the
//     head's width) and multiplied. The relative logits are added once, after
//     the last chunk.
//   - An output width splits over chunks on the grid's x axis, next to the
//     token tiles: each block recomputes S and p for its own output columns.
//     The forwards split out (dvh); pass dq splits dq (dkh), and its chunk 0
//     alone writes the bins (dRW / dRH lanes, or the dRC scratch) and the RC
//     scratch; pass dkdv splits dk and dv (chunk c writes dk chunk c where c <
//     nk and dv chunk c where c < nv) and its chunk 0 writes the zero pad
//     lanes of a slot. lse is written by the forward's chunk 0.
// One launch per call, and every block owns what it writes: no atomics.
//
// The relative logits: head-major, the RW / RH lanes of each query's qr row;
// heads-in-lanes, RC[t, m] = sum_d q[t, d] Rw[(col(t), d), m] (and rows with
// Rh) summed over all of dkh in f32 on the CUDA cores, by the one function
// (rc_rows) that the forward and pass dq both call, so the backward's p =
// exp(S - lse) sees the forward's S. Pass dq leaves those rows in the rc
// scratch, which pass dkdv reads on both routes (it is the only way pass
// dkdv sees RC here). The relative part of dq, sum_m dRC[t, m] Rw[(col(t),
// d), m], is summed on the CUDA cores from the block's bins.
//
// Two routes, as in the classes: bf16 maps up to amma::mma_fits run the
// tensor-core kernels below (the class's tiles: TN x KS and TN x VS, S and
// dp in mma.sync fragments; fwd_update, dq_ds / dq_accumulate and dkdv_ds /
// dkdv_accumulate of attention_fwd_mma.cuh / attention_bwd_mma.cuh do the
// rest of a tile, as in the class's kernels), f32 and larger maps the CUDA-core kernels, which
// stage CW = 32 columns at a time and split their outputs by CW, not by the
// class's widths: their rows of dk, dv, dq and out stay CW registers wide
// and do not spill. Every tile is staged by 2-byte loads with zero fill,
// which takes ragged widths, odd slot offsets and unaligned rows alike.
// Simple and right: each chunk is restaged once per tile of the other side,
// and every output chunk recomputes S (PERF.md has their times).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "attention_fwd_mma.cuh"

namespace attention_wide {

using namespace amma;

// The wide kernels are built into the largest width class's libraries alone.
constexpr bool BUILT = KW == 128 && VW == 64;
constexpr int CW = 32;  // the CUDA-core kernels' chunk of a head dimension

// 1: the head (dkh, dvh) takes the kernels of this header; 0: the width
// class's own kernels; -1: the chunk counts nk, nv do not match the head, or
// the head is past this library's class.
inline int route(int dkh, int dvh, int nk, int nv) {
  if (dkh < 1 || dvh < 1 || nk != (dkh + KW - 1) / KW || nv != (dvh + VW - 1) / VW) return -1;
  if (nk == 1 && nv == 1) return 0;
  return BUILT ? 1 : -1;
}

// Rows of one operand: element c of token r of grid cell (z, y) at
// p[z * sz + y * sy + r * sr + c]. A null p: the operand is absent.
template <typename T>
struct Rows {
  T* p;
  long long sz, sy, sr;
  __device__ __forceinline__ T* row(int z, int y, int r) const {
    return p + z * sz + y * sy + r * sr;
  }
};

struct Geo {
  int hw, H, W, dkh, dvh, nk, nv;
};

// Where the forward and pass dq find the relative logits: lanes (the qr
// rows' RW / RH lanes, head-major), or Rw / Rh (heads-in-lanes), or neither.
template <typename T>
struct Rel {
  Rows<const T> lanes;
  const float* Rw;
  const float* Rh;
};

// What pass dq writes: dq (dkh lanes per query); the bins as lanes of the
// same rows (head-major dqr) or as f32 dRC rows (heads-in-lanes); the RC rows
// for pass dkdv (heads-in-lanes with relative logits).
template <typename T>
struct DqOut {
  Rows<T> dq, bins;
  Rows<float> drc, rc;
};

// What pass dkdv writes: dk (dkh lanes per key), dv (dvh lanes), and npad
// zero lanes from pad (the rest of a heads-in-lanes slot).
template <typename T>
struct DkdvOut {
  Rows<T> dk, dv, pad;
  int npad;
};

__device__ __forceinline__ void put(float* d, float x) { *d = x; }
__device__ __forceinline__ void put(float* d, bf16 x) { *d = __bfloat162float(x); }
__device__ __forceinline__ void put(bf16* d, bf16 x) { *d = x; }
__device__ __forceinline__ void put(bf16* d, float x) { *d = __float2bfloat16(x); }

// A tile of rows x COLS (row stride ds): element (r, c) is lane c0 + c of
// token r0 + r of src where r < nr and c < nc, else zero (nc may be <= 0).
template <int COLS, typename D, typename T>
__device__ __forceinline__ void stage(D* dst, int ds, const Rows<const T>& src, int z, int y,
                                      int r0, int nr, int rows, int c0, int nc, int tid,
                                      int nthreads) {
  for (int e = tid; e < rows * COLS; e += nthreads) {
    const int r = e / COLS, c = e - r * COLS;
    if (r < nr && c < nc)
      put(dst + r * ds + c, src.row(z, y, r0 + r)[c0 + c]);
    else
      put(dst + r * ds + c, 0.f);
  }
}

// The RC rows of tokens q0 .. q0 + rows - 1 into rel_s (f32, row stride
// rel_stride, W + H lanes): zero past hw and without relative logits.
template <typename T>
__device__ __forceinline__ void rc_rows(float* rel_s, int rel_stride, const Rel<T>& rel,
                                        const Rows<const T>& q, int z, int y, int q0, int rows,
                                        const Geo& g, int tid, int nthreads) {
  const int WH = g.W + g.H;
  for (int e = tid; e < rows * WH; e += nthreads) {
    const int r = e / WH, c = e - r * WH, t = q0 + r;
    float s = 0.f;
    if (t < g.hw && rel.lanes.p != nullptr) {
      s = to_f(rel.lanes.row(z, y, t)[c]);
    } else if (t < g.hw && rel.Rw != nullptr) {
      const T* qt = q.row(z, y, t);
      const bool is_w = c < g.W;
      const float* base = is_w ? rel.Rw + static_cast<size_t>(t % g.W) * g.dkh * g.W + c
                               : rel.Rh + static_cast<size_t>(t / g.W) * g.dkh * g.H + c - g.W;
      const int stride = is_w ? g.W : g.H;
      for (int d = 0; d < g.dkh; ++d)
        s = fmaf(to_f(qt[d]), __ldg(base + static_cast<size_t>(d) * stride), s);
    }
    rel_s[r * rel_stride + c] = s;
  }
}

// Lane d of dq's relative part for query t from its bins (bin: W + H f32):
// sum_m dRC_w[m] Rw[(col(t), d), m] + sum_m dRC_h[m] Rh[(row(t), d), m].
__device__ __forceinline__ float rel_dq(const float* bin, const float* Rw, const float* Rh,
                                        int t, int d, const Geo& g) {
  const float* rw = Rw + (static_cast<size_t>(t % g.W) * g.dkh + d) * g.W;
  const float* rh = Rh + (static_cast<size_t>(t / g.W) * g.dkh + d) * g.H;
  float s = 0.f;
  for (int m = 0; m < g.W; ++m) s = fmaf(bin[m], __ldg(rw + m), s);
  for (int m = 0; m < g.H; ++m) s = fmaf(bin[g.W + m], __ldg(rh + m), s);
  return s;
}

// Chunk 0 of pass dq: the rows' bins (bin_s, f32 rows of stride bin_stride)
// to the dRW / dRH lanes or the dRC rows, and their RC rows (rel_s) to the
// rc scratch.
template <typename T>
__device__ __forceinline__ void dq_rows_out(const DqOut<T>& dst, const float* bin_s,
                                            const float* rel_s, int stride, int z, int y, int q0,
                                            int qn, const Geo& g, int tid, int nthreads) {
  const int WH = g.W + g.H;
  for (int e = tid; e < qn * WH; e += nthreads) {
    const int r = e / WH, c = e - r * WH;
    if (dst.bins.p != nullptr) put(dst.bins.row(z, y, q0 + r) + c, bin_s[r * stride + c]);
    if (dst.drc.p != nullptr) dst.drc.row(z, y, q0 + r)[c] = bin_s[r * stride + c];
    if (dst.rc.p != nullptr && rel_s != nullptr)
      dst.rc.row(z, y, q0 + r)[c] = rel_s[r * stride + c];
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16, maps up to amma::mma_fits).

// The forward: a block owns FWD_ROWS queries of one (batch, head) and value
// chunk blockIdx.x % nv; per key tile, S over the nk chunks of dkh (q and k
// chunks through q_s and k_s), then the online softmax and p v over its v
// chunk.
template <typename T>  // bf16: a template, so that only the library that runs it builds it
__global__ void __launch_bounds__(FWD_WARPS * 32)
fwd_mma_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rel<T> rel,
               const int* __restrict__ tab, Rows<T> out, Rows<float> lse, Geo g,
               int rel_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* rel_s = reinterpret_cast<float*>(smem_raw);                  // FWD_ROWS x rel_stride
  bf16* q_s = reinterpret_cast<bf16*>(rel_s + FWD_ROWS * rel_stride);  // FWD_ROWS x KS
  bf16* k_s = q_s + FWD_ROWS * KS;                                     // TN x KS
  bf16* v_s = k_s + TN * KS;                                           // TN x VS
  int* kpos_s = reinterpret_cast<int*>(v_s + TN * VS);                 // TN

  constexpr int NT = FWD_WARPS * 32;
  const int chunk = blockIdx.x % g.nv, q0 = blockIdx.x / g.nv * FWD_ROWS;
  const int y = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const int qn = min(FWD_ROWS, g.hw - q0), nbt = bin_tiles(g.W, g.H);
  const int v0 = chunk * VW, nvc = min(VW, g.dvh - v0);
  rc_rows(rel_s, rel_stride, rel, q, z, y, q0, FWD_ROWS, g, tid, NT);

  FwdWarp st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.m[i] = -INFINITY;
    st.l[i] = 0.f;
  }
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.o[nv][i] = 0.f;
  for (int j0 = 0; j0 < g.hw; j0 += TN) {
    const int kn = min(TN, g.hw - j0);
    float s[FWD_NT][4] = {};
    for (int c = 0; c < g.nk; ++c) {
      __syncthreads();  // the previous chunk's tiles are consumed
      stage<KW>(q_s, KS, q, z, y, q0, qn, FWD_ROWS, c * KW, g.dkh - c * KW, tid, NT);
      stage<KW>(k_s, KS, k, z, y, j0, kn, TN, c * KW, g.dkh - c * KW, tid, NT);
      __syncthreads();
      load_a_frags(st.qa, q_s, KS, warp * 16 + gl, warp * 16 + gl + 8, t);
#pragma unroll
      for (int nt = 0; nt < FWD_NT; ++nt) mma_k(s[nt], st.qa, k_s + (nt * 8 + gl) * KS + 2 * t);
    }
    __syncthreads();
    stage<VW>(v_s, VS, v, z, y, j0, kn, TN, v0, nvc, tid, NT);
    stage_kpos(kpos_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    fwd_update(st, s, v_s, VS, kpos_s, rel_s, rel_stride, g.W, kn, warp, lane);
  }
  float o[NV][4], l[2];
  fwd_finish(st, o, l);
  fwd_store(o, l, out.row(z, y, 0) + v0, out.sr, chunk == 0 ? lse.row(z, y, 0) : nullptr,
            q0 + warp * 16 + gl, g.hw, nvc, lane);
}

// Pass dq: a block owns DQ_ROWS queries of one (batch, head) and dq chunk
// blockIdx.x % nk; per key tile, S over the chunks of dkh (q, k through a_s,
// b_s), dp over the chunks of dvh (dout, v through the same tiles), then its
// own k chunk in b_s for dq += ds k and the bins.
template <int NBT>
__global__ void __launch_bounds__(DQ_WARPS * 32)
dq_mma_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rows<const bf16> dout,
              Rows<const float> lse, Rows<const float> delta, Rel<bf16> rel,
              const int* __restrict__ tab, DqOut<bf16> dst, Geo g, int rel_stride) {
  constexpr int ND = KW / 8, DQS = dq_stride<ND>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nbw = (g.W + 7) / 8, nbt = bin_tiles(g.W, g.H);
  float* rel_s = reinterpret_cast<float*>(smem_raw);          // DQ_ROWS x rel_stride: RC, bins
  float* ld_s = rel_s + DQ_ROWS * rel_stride;                 // DQ_ROWS x 2
  int* tab_s = reinterpret_cast<int*>(ld_s + DQ_ROWS * 2);    // one row of the key table
  bf16* a_s = reinterpret_cast<bf16*>(tab_s + key_table_words(nbt));  // DQ_ROWS x KS
  bf16* b_s = a_s + DQ_ROWS * KS;                                      // TN x KS
  float* dq_s = reinterpret_cast<float*>(b_s + TN * KS);               // DQ_ROWS x DQS

  constexpr int NT = DQ_WARPS * 32;
  const int chunk = blockIdx.x % g.nk, q0 = blockIdx.x / g.nk * DQ_ROWS;
  const int y = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const int qn = min(DQ_ROWS, g.hw - q0), r0 = warp * 16 + gl;
  stage_ld(ld_s, lse.row(z, y, q0), delta.row(z, y, q0), qn, DQ_ROWS, tid, NT);
  rc_rows(rel_s, rel_stride, rel, q, z, y, q0, DQ_ROWS, g, tid, NT);
  cp_async_wait();
  __syncthreads();
  if (chunk == 0)  // the RC rows for pass dkdv
    dq_rows_out(DqOut<bf16>{{}, {}, {}, dst.rc}, nullptr, rel_s, rel_stride, z, y, q0, qn, g,
                tid, NT);

  const float* rel0 = rel_s + r0 * rel_stride;
  const float* rel1 = rel0 + 8 * rel_stride;
  const bool paired = rc_paired(rel_s, g.W);
  DqWarp<NBT, ND> st;
  st.lse[0] = ld_s[2 * r0] * LOG2E;
  st.delta[0] = ld_s[2 * r0 + 1];
  st.lse[1] = ld_s[2 * (r0 + 8)] * LOG2E;
  st.delta[1] = ld_s[2 * (r0 + 8) + 1];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.dq[nd][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NBT; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.bins[nb][i] = 0.f;

  for (int j0 = 0; j0 < g.hw; j0 += TN) {
    const int kn = min(TN, g.hw - j0);
    float s[TN / 8][4] = {}, dp[TN / 8][4] = {};
    for (int c = 0; c < g.nk; ++c) {
      __syncthreads();  // the previous tiles are consumed
      stage<KW>(a_s, KS, q, z, y, q0, qn, DQ_ROWS, c * KW, g.dkh - c * KW, tid, NT);
      stage<KW>(b_s, KS, k, z, y, j0, kn, TN, c * KW, g.dkh - c * KW, tid, NT);
      __syncthreads();
      load_a_frags(st.qa, a_s, KS, r0, r0 + 8, t);
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt) mma_k(s[nt], st.qa, b_s + (nt * 8 + gl) * KS + 2 * t);
    }
    for (int c = 0; c < g.nv; ++c) {
      __syncthreads();
      stage<VW>(a_s, VS, dout, z, y, q0, qn, DQ_ROWS, c * VW, g.dvh - c * VW, tid, NT);
      stage<VW>(b_s, VS, v, z, y, j0, kn, TN, c * VW, g.dvh - c * VW, tid, NT);
      __syncthreads();
      load_v_frags(st.doa, a_s, r0, r0 + 8, t);
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt) mma_v(dp[nt], st.doa, b_s + (nt * 8 + gl) * VS + 2 * t);
    }
    __syncthreads();
    stage<KW>(b_s, KS, k, z, y, j0, kn, TN, chunk * KW, g.dkh - chunk * KW, tid, NT);
    stage_key_table(tab_s, tab, j0 / TN, nbt, tid, NT);
    cp_async_wait();
    __syncthreads();
    const KeyTable kt = key_table_at(tab_s, nbt);
#pragma unroll
    for (int kc = 0; kc < TN / 16; ++kc) {
      if (kc * 16 < kn) {  // uniform across the block
        uint32_t dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
          dq_ds(st, s[2 * kc + half], dp[2 * kc + half], kc * 16 + half * 8, kt, rel0, rel1,
                paired, g.W, kn, t, dsa[2 * half], dsa[2 * half + 1]);
        dq_accumulate(st, dsa, kc, b_s, kt, nbt, lane);
      }
    }
  }
  __syncthreads();  // every warp has read its last RC row: rel_s becomes the bins
  dq_dump(st, dq_s, warp, lane);
  bins_dump(st, rel_s, rel_stride, g.W, g.H, nbw, warp, lane);
  __syncthreads();
  const int d0 = chunk * KW, ndc = min(KW, g.dkh - d0);
  for (int e = tid; e < qn * ndc; e += NT) {
    const int r = e / ndc, d = e - r * ndc;
    float x = dq_s[r * DQS + d];
    if (rel.Rw != nullptr) x += rel_dq(rel_s + r * rel_stride, rel.Rw, rel.Rh, q0 + r, d0 + d, g);
    dst.dq.row(z, y, q0 + r)[d0 + d] = __float2bfloat16(x);
  }
  if (chunk == 0)
    dq_rows_out(DqOut<bf16>{{}, dst.bins, dst.drc, {}}, rel_s, nullptr, rel_stride, z, y, q0, qn,
                g, tid, NT);
}

// Pass dkdv: a block owns DKDV_ROWS keys of one (batch, head) and output
// chunk blockIdx.x % max(nk, nv); per query tile, S^T over the chunks of dkh
// (k, q through kv_s, q_s), dp^T over the chunks of dvh (v, dout through
// kv_s, do_s), then its own q and dout chunks for dk += ds^T q and dv += p^T
// dout. rcl: the queries' RC rows (qr lanes, or the rc scratch of pass dq).
template <typename RT>
__global__ void __launch_bounds__(DKDV_WARPS * 32, 1)
dkdv_mma_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v,
                Rows<const bf16> dout, Rows<const float> lse, Rows<const float> delta,
                Rows<const RT> rcl, DkdvOut<bf16> dst, Geo g, int rel_stride) {
  constexpr int ND = KW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kv_s = reinterpret_cast<bf16*>(smem_raw);           // DKDV_ROWS x KS: k or v chunk
  bf16* q_s = kv_s + DKDV_ROWS * KS;                        // TN x KS
  bf16* do_s = q_s + TN * KS;                               // TN x VS
  float* rel_s = reinterpret_cast<float*>(do_s + TN * VS);  // TN x rel_stride
  float* ld_s = rel_s + TN * rel_stride;                    // TN x 2

  constexpr int NT = DKDV_WARPS * 32;
  const int nco = max(g.nk, g.nv);
  const int chunk = blockIdx.x % nco, key0 = blockIdx.x / nco * DKDV_ROWS;
  const int y = blockIdx.y, z = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const int kn = min(DKDV_ROWS, g.hw - key0), WH = g.W + g.H;
  const int ra = dkdv_key(warp, lane, 0), rb = dkdv_key(warp, lane, 1);
  const bool paired = rc_paired(rel_s, g.W);  // even W: a thread's two keys share a row

  DkdvWarp<ND> st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + dkdv_key(warp, lane, i);
    st.ok[i] = j < g.hw;
    st.c[i] = st.ok[i] ? j % g.W : 0;
    st.r[i] = st.ok[i] ? j / g.W : 0;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.dk[nd][i] = 0.f;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.dv[nv][i] = 0.f;

  for (int i0 = 0; i0 < g.hw; i0 += TN) {
    const int qn = min(TN, g.hw - i0);
    float s[TN / 8][4] = {}, dp[TN / 8][4] = {};
    for (int c = 0; c < g.nk; ++c) {
      __syncthreads();  // the previous tiles are consumed
      stage<KW>(kv_s, KS, k, z, y, key0, kn, DKDV_ROWS, c * KW, g.dkh - c * KW, tid, NT);
      stage<KW>(q_s, KS, q, z, y, i0, qn, TN, c * KW, g.dkh - c * KW, tid, NT);
      __syncthreads();
      load_a_frags(st.ka, kv_s, KS, ra, rb, t);
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt) mma_k(s[nt], st.ka, q_s + (nt * 8 + gl) * KS + 2 * t);
    }
    for (int c = 0; c < g.nv; ++c) {
      __syncthreads();
      stage<VW>(kv_s, VS, v, z, y, key0, kn, DKDV_ROWS, c * VW, g.dvh - c * VW, tid, NT);
      stage<VW>(do_s, VS, dout, z, y, i0, qn, TN, c * VW, g.dvh - c * VW, tid, NT);
      __syncthreads();
      load_v_frags(st.va, kv_s, ra, rb, t);
#pragma unroll
      for (int nt = 0; nt < TN / 8; ++nt) mma_v(dp[nt], st.va, do_s + (nt * 8 + gl) * VS + 2 * t);
    }
    __syncthreads();
    stage<KW>(q_s, KS, q, z, y, i0, qn, TN, chunk * KW, g.dkh - chunk * KW, tid, NT);
    stage<VW>(do_s, VS, dout, z, y, i0, qn, TN, chunk * VW, g.dvh - chunk * VW, tid, NT);
    for (int e = tid; e < TN * WH; e += NT) {
      const int r = e / WH, c = e - r * WH;
      rel_s[r * rel_stride + c] =
          r < qn && rcl.p != nullptr ? to_f(rcl.row(z, y, i0 + r)[c]) : 0.f;
    }
    stage_ld(ld_s, lse.row(z, y, i0), delta.row(z, y, i0), qn, TN, tid, NT);
    cp_async_wait();
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < TN / 16; ++qc) {
      if (qc * 16 < qn) {  // uniform across the block
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half)
          dkdv_ds(st, s[2 * qc + half], dp[2 * qc + half], qc * 16 + half * 8, ld_s, rel_s,
                  rel_stride, paired, g.W, t, pa[2 * half], pa[2 * half + 1], dsa[2 * half],
                  dsa[2 * half + 1]);
        dkdv_accumulate(st, pa, dsa, qc, q_s, KS, do_s, lane);
      }
    }
  }

  const int d0 = chunk * KW, e0 = chunk * VW;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + dkdv_key(warp, lane, i);
    if (j >= g.hw) continue;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int d = d0 + nd * 8 + 2 * t;
      bf16* dk_j = dst.dk.row(z, y, j);
      if (d < g.dkh) dk_j[d] = __float2bfloat16(st.dk[nd][2 * i]);
      if (d + 1 < g.dkh) dk_j[d + 1] = __float2bfloat16(st.dk[nd][2 * i + 1]);
    }
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int c = e0 + nv * 8 + 2 * t;
      bf16* dv_j = dst.dv.row(z, y, j);
      if (c < g.dvh) dv_j[c] = __float2bfloat16(st.dv[nv][2 * i]);
      if (c + 1 < g.dvh) dv_j[c + 1] = __float2bfloat16(st.dv[nv][2 * i + 1]);
    }
    if (chunk == 0)
      for (int e = t; e < dst.npad; e += 4) dst.pad.row(z, y, j)[e] = __float2bfloat16(0.f);
  }
}

// ---------------------------------------------------------------------------
// The CUDA-core kernels (f32, and bf16 maps past amma::mma_fits): f32
// arithmetic, CW columns at a time.

constexpr float NEG_BIG = -1e30f;  // finite "minus infinity": exp(NEG_BIG - m) == 0
constexpr int CQ = 64;             // the forward's and pass dq's queries per block
constexpr int CK = 128;            // pass dkdv's keys per block
constexpr int CT = 16;             // the other side's tokens per tile in passes dq and dkdv
constexpr int FSPLIT = 4;          // the forward's threads per query row
constexpr int FTK = 64;            // the forward's keys per tile
constexpr int FKPT = FTK / FSPLIT;

__device__ __forceinline__ float dot_cw(const float* a, const float* b) {
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int d = 0; d < CW; d += 2) {
    s0 = fmaf(a[d], b[d], s0);
    s1 = fmaf(a[d + 1], b[d + 1], s1);
  }
  return s0 + s1;
}

// The forward: a block owns CQ queries of one (batch, head) and output chunk
// blockIdx.x % ceil(dvh / CW); FSPLIT threads per query row, each with every
// FSPLIT-th key of a tile and its own online-softmax state (merged at the
// end), S summed over the CW chunks of dkh (q_s, k_s).
template <typename T>
__global__ void __launch_bounds__(CQ * FSPLIT)
fwd_core_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rel<T> rel, Rows<T> out,
                Rows<float> lse, Geo g, int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                        // CQ x rel_stride
  float* q_s = rel_s + CQ * rel_stride;       // CQ x (CW + 1)
  float* k_s = q_s + CQ * (CW + 1);           // FTK x (CW + 1)
  float* v_s = k_s + FTK * (CW + 1);          // FTK x CW
  constexpr int NT = CQ * FSPLIT;
  const int nco = (g.dvh + CW - 1) / CW;
  const int chunk = blockIdx.x % nco, q0 = blockIdx.x / nco * CQ;
  const int y = blockIdx.y, z = blockIdx.z, tid = threadIdx.x;
  const int r = tid / FSPLIT, sub = tid % FSPLIT, i = q0 + r;
  const int qn = min(CQ, g.hw - q0), v0 = chunk * CW;
  rc_rows(rel_s, rel_stride, rel, q, z, y, q0, CQ, g, tid, NT);
  const float* rw = rel_s + r * rel_stride;
  const float* rh = rw + g.W;

  float m = NEG_BIG, l = 0.f, acc[CW];
#pragma unroll
  for (int e = 0; e < CW; ++e) acc[e] = 0.f;
  for (int j0 = 0; j0 < g.hw; j0 += FTK) {
    const int kn = min(FTK, g.hw - j0);
    float s[FKPT];
#pragma unroll
    for (int u = 0; u < FKPT; ++u) s[u] = 0.f;
    for (int c0 = 0; c0 < g.dkh; c0 += CW) {
      __syncthreads();  // the previous tiles are consumed
      stage<CW>(q_s, CW + 1, q, z, y, q0, qn, CQ, c0, g.dkh - c0, tid, NT);
      stage<CW>(k_s, CW + 1, k, z, y, j0, kn, FTK, c0, g.dkh - c0, tid, NT);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < FKPT; ++u)
        s[u] += dot_cw(q_s + r * (CW + 1), k_s + (sub + FSPLIT * u) * (CW + 1));
    }
    __syncthreads();
    stage<CW>(v_s, CW, v, z, y, j0, kn, FTK, v0, g.dvh - v0, tid, NT);
    __syncthreads();
    float tmax = NEG_BIG;
#pragma unroll
    for (int u = 0; u < FKPT; ++u) {
      const int j = j0 + sub + FSPLIT * u;
      s[u] = j - j0 < kn ? s[u] + rw[j % g.W] + rh[j / g.W] : NEG_BIG;
      tmax = fmaxf(tmax, s[u]);
    }
    const float m_new = fmaxf(m, tmax), alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < CW; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < FKPT; ++u) {
      const int jj = sub + FSPLIT * u;
      if (jj < kn) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < CW; ++e) acc[e] = fmaf(p, v_s[jj * CW + e], acc[e]);
      }
    }
    m = m_new;
  }
#pragma unroll
  for (int off = 1; off < FSPLIT; off <<= 1) {  // merge the row's partial states
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_n = fmaxf(m, m_o), a = expf(m - m_n), a_o = expf(m_o - m_n);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int e = 0; e < CW; ++e)
      acc[e] = acc[e] * a + __shfl_xor_sync(0xffffffffu, acc[e], off) * a_o;
    m = m_n;
  }
  if (i < g.hw && sub == 0) {
    const float inv = 1.f / l;
    T* o = out.row(z, y, i) + v0;
#pragma unroll
    for (int e = 0; e < CW; ++e)
      if (v0 + e < g.dvh) put(o + e, acc[e] * inv);
    if (chunk == 0) lse.row(z, y, i)[0] = m + logf(l);
  }
}

// Pass dq: a thread per query, CQ a block, and dq chunk blockIdx.x %
// ceil(dkh / CW); per tile of CT keys, S and dp over the CW chunks of dkh
// and dvh (q / dout in a_s, k / v in b_s), then its own k chunk in b_s. Each
// thread sums its own row's bins.
template <typename T>
__global__ void __launch_bounds__(CQ)
dq_core_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dout,
               Rows<const float> lse, Rows<const float> delta, Rel<T> rel, DqOut<T> dst, Geo g,
               int rel_stride) {
  extern __shared__ float smem[];
  float* rel_s = smem;                     // CQ x rel_stride
  float* bin_s = rel_s + CQ * rel_stride;  // CQ x rel_stride
  float* a_s = bin_s + CQ * rel_stride;    // CQ x (CW + 1)
  float* b_s = a_s + CQ * (CW + 1);        // CT x CW
  const int nco = (g.dkh + CW - 1) / CW;
  const int chunk = blockIdx.x % nco, q0 = blockIdx.x / nco * CQ;
  const int y = blockIdx.y, z = blockIdx.z, tid = threadIdx.x, i = q0 + tid;
  const int qn = min(CQ, g.hw - q0), d0 = chunk * CW;
  const bool row_ok = i < g.hw;
  rc_rows(rel_s, rel_stride, rel, q, z, y, q0, CQ, g, tid, CQ);
  for (int e = tid; e < CQ * rel_stride; e += CQ) bin_s[e] = 0.f;
  const float lse_i = row_ok ? lse.row(z, y, i)[0] : 0.f;
  const float delta_i = row_ok ? delta.row(z, y, i)[0] : 0.f;
  const float* rc = rel_s + tid * rel_stride;
  float* bin = bin_s + tid * rel_stride;

  float dq[CW];
#pragma unroll
  for (int d = 0; d < CW; ++d) dq[d] = 0.f;
  for (int j0 = 0; j0 < g.hw; j0 += CT) {
    const int kn = min(CT, g.hw - j0);
    float s[CT], dp[CT];
#pragma unroll
    for (int u = 0; u < CT; ++u) s[u] = dp[u] = 0.f;
    for (int c0 = 0; c0 < g.dkh; c0 += CW) {
      __syncthreads();  // the previous tiles are consumed
      stage<CW>(a_s, CW + 1, q, z, y, q0, qn, CQ, c0, g.dkh - c0, tid, CQ);
      stage<CW>(b_s, CW, k, z, y, j0, kn, CT, c0, g.dkh - c0, tid, CQ);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < CT; ++u) s[u] += dot_cw(a_s + tid * (CW + 1), b_s + u * CW);
    }
    for (int c0 = 0; c0 < g.dvh; c0 += CW) {
      __syncthreads();
      stage<CW>(a_s, CW + 1, dout, z, y, q0, qn, CQ, c0, g.dvh - c0, tid, CQ);
      stage<CW>(b_s, CW, v, z, y, j0, kn, CT, c0, g.dvh - c0, tid, CQ);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < CT; ++u) dp[u] += dot_cw(a_s + tid * (CW + 1), b_s + u * CW);
    }
    __syncthreads();
    stage<CW>(b_s, CW, k, z, y, j0, kn, CT, d0, g.dkh - d0, tid, CQ);
    __syncthreads();
    if (row_ok) {
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        if (u < kn) {
          const int j = j0 + u, c = j % g.W, kr = g.W + j / g.W;
          const float p = expf(s[u] + rc[c] + rc[kr] - lse_i);
          const float ds = p * (dp[u] - delta_i);
#pragma unroll
          for (int d = 0; d < CW; ++d) dq[d] = fmaf(ds, b_s[u * CW + d], dq[d]);
          bin[c] += ds;
          bin[kr] += ds;
        }
      }
    }
  }
  if (row_ok) {
    T* dq_i = dst.dq.row(z, y, i);
#pragma unroll
    for (int d = 0; d < CW; ++d) {
      if (d0 + d < g.dkh) {
        float x = dq[d];
        if (rel.Rw != nullptr) x += rel_dq(bin, rel.Rw, rel.Rh, i, d0 + d, g);
        put(dq_i + d0 + d, x);
      }
    }
  }
  __syncthreads();  // every row's bins are final
  if (chunk == 0) dq_rows_out(dst, bin_s, rel_s, rel_stride, z, y, q0, qn, g, tid, CQ);
}

// Pass dkdv: a thread per key, CK a block, and output chunk blockIdx.x %
// max(ceil(dkh / CW), ceil(dvh / CW)); per tile of CT queries, S^T and dp^T
// over the CW chunks of dkh and dvh (k / v in kv_s, q / dout in a_s), then
// its own q and dout chunks (qo_s, do_s).
template <typename T, typename RT>
__global__ void __launch_bounds__(CK)
dkdv_core_kernel(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dout,
                 Rows<const float> lse, Rows<const float> delta, Rows<const RT> rcl,
                 DkdvOut<T> dst, Geo g, int rel_stride) {
  extern __shared__ float smem[];
  float* kv_s = smem;                      // CK x (CW + 1)
  float* a_s = kv_s + CK * (CW + 1);       // CT x CW
  float* qo_s = a_s + CT * CW;             // CT x CW
  float* do_s = qo_s + CT * CW;            // CT x CW
  float* ld_s = do_s + CT * CW;            // CT x 2
  float* rel_s = ld_s + CT * 2;            // CT x rel_stride
  const int nco = max((g.dkh + CW - 1) / CW, (g.dvh + CW - 1) / CW);
  const int chunk = blockIdx.x % nco, key0 = blockIdx.x / nco * CK;
  const int y = blockIdx.y, z = blockIdx.z, tid = threadIdx.x, j = key0 + tid;
  const int kn = min(CK, g.hw - key0), WH = g.W + g.H, d0 = chunk * CW;
  const bool key_ok = j < g.hw;
  const int cj = key_ok ? j % g.W : 0, rj = key_ok ? g.W + j / g.W : g.W;

  float dk[CW], dv[CW];
#pragma unroll
  for (int d = 0; d < CW; ++d) dk[d] = dv[d] = 0.f;
  for (int i0 = 0; i0 < g.hw; i0 += CT) {
    const int qn = min(CT, g.hw - i0);
    float s[CT], dp[CT];
#pragma unroll
    for (int u = 0; u < CT; ++u) s[u] = dp[u] = 0.f;
    for (int c0 = 0; c0 < g.dkh; c0 += CW) {
      __syncthreads();  // the previous tiles are consumed
      stage<CW>(kv_s, CW + 1, k, z, y, key0, kn, CK, c0, g.dkh - c0, tid, CK);
      stage<CW>(a_s, CW, q, z, y, i0, qn, CT, c0, g.dkh - c0, tid, CK);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < CT; ++u) s[u] += dot_cw(a_s + u * CW, kv_s + tid * (CW + 1));
    }
    for (int c0 = 0; c0 < g.dvh; c0 += CW) {
      __syncthreads();
      stage<CW>(kv_s, CW + 1, v, z, y, key0, kn, CK, c0, g.dvh - c0, tid, CK);
      stage<CW>(a_s, CW, dout, z, y, i0, qn, CT, c0, g.dvh - c0, tid, CK);
      __syncthreads();
#pragma unroll
      for (int u = 0; u < CT; ++u) dp[u] += dot_cw(a_s + u * CW, kv_s + tid * (CW + 1));
    }
    stage<CW>(qo_s, CW, q, z, y, i0, qn, CT, d0, g.dkh - d0, tid, CK);
    stage<CW>(do_s, CW, dout, z, y, i0, qn, CT, d0, g.dvh - d0, tid, CK);
    for (int e = tid; e < CT * WH; e += CK) {
      const int r = e / WH, c = e - r * WH;
      rel_s[r * rel_stride + c] =
          r < qn && rcl.p != nullptr ? to_f(rcl.row(z, y, i0 + r)[c]) : 0.f;
    }
    for (int r = tid; r < CT; r += CK) {
      ld_s[2 * r] = r < qn ? lse.row(z, y, i0 + r)[0] : 0.f;
      ld_s[2 * r + 1] = r < qn ? delta.row(z, y, i0 + r)[0] : 0.f;
    }
    __syncthreads();
    if (key_ok) {
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        if (u < qn) {
          const float* rel = rel_s + u * rel_stride;
          const float p = expf(s[u] + rel[cj] + rel[rj] - ld_s[2 * u]);
          const float ds = p * (dp[u] - ld_s[2 * u + 1]);
#pragma unroll
          for (int d = 0; d < CW; ++d) {
            dv[d] = fmaf(p, do_s[u * CW + d], dv[d]);
            dk[d] = fmaf(ds, qo_s[u * CW + d], dk[d]);
          }
        }
      }
    }
  }
  if (key_ok) {
    T* dk_j = dst.dk.row(z, y, j);
    T* dv_j = dst.dv.row(z, y, j);
#pragma unroll
    for (int d = 0; d < CW; ++d) {
      if (d0 + d < g.dkh) put(dk_j + d0 + d, dk[d]);
      if (d0 + d < g.dvh) put(dv_j + d0 + d, dv[d]);
    }
    if (chunk == 0)
      for (int e = 0; e < dst.npad; ++e) put(dst.pad.row(z, y, j) + e, 0.f);
  }
}

// ---------------------------------------------------------------------------
// Launches, for the entries of the four sources: grid (token tiles x output
// chunks, Y, Z), where (Y, Z) = (bn, 1) head-major and (nh, B) heads-in-lanes.

template <typename T>
int fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rel<T> rel, const int* tab,
        Rows<T> out, Rows<float> lse, Geo g, int Y, int Z, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_fits(g.W, g.H)) {
      if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const int rs = rel_stride_of(g.W, g.H);
      const size_t smem = static_cast<size_t>(FWD_ROWS) * rs * sizeof(float) +
                          static_cast<size_t>(FWD_ROWS * KS + TN * (KS + VS)) * sizeof(bf16) +
                          TN * sizeof(int);
      auto kern = fwd_mma_kernel<T>;
      const cudaError_t e = amma::allow_smem(kern, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid((g.hw + FWD_ROWS - 1) / FWD_ROWS * g.nv, Y, Z);
      kern<<<grid, FWD_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, rel, tab,
                                                                              out, lse, g, rs);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int rs = (g.W + g.H) | 1;  // odd row stride spreads rows over banks
  const size_t smem =
      static_cast<size_t>(CQ * rs + (CQ + FTK) * (CW + 1) + FTK * CW) * sizeof(float);
  auto kern = fwd_core_kernel<T>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.hw + CQ - 1) / CQ * ((g.dvh + CW - 1) / CW), Y, Z);
  kern<<<grid, CQ * FSPLIT, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, rel, out, lse,
                                                                        g, rs);
  return static_cast<int>(cudaGetLastError());
}

template <int NBT>
int dq_mma_nbt(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v,
               Rows<const bf16> dout, Rows<const float> lse, Rows<const float> delta,
               Rel<bf16> rel, const int* tab, DqOut<bf16> dst, Geo g, int Y, int Z,
               void* stream) {
  const int rs = rel_stride_of(g.W, g.H);
  const size_t smem =
      static_cast<size_t>(DQ_ROWS) * (rs + 2 + dq_stride<KW / 8>()) * sizeof(float) +
                      key_table_words(bin_tiles(g.W, g.H)) * sizeof(int) +
                      static_cast<size_t>((DQ_ROWS + TN) * KS) * sizeof(bf16);
  auto kern = dq_mma_kernel<NBT>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.hw + DQ_ROWS - 1) / DQ_ROWS * g.nk, Y, Z);
  kern<<<grid, DQ_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, rel, tab, dst, g, rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dq(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dout,
       Rows<const float> lse, Rows<const float> delta, Rel<T> rel, const int* tab, DqOut<T> dst,
       Geo g, int Y, int Z, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_fits(g.W, g.H)) {
      if (tab == nullptr || reinterpret_cast<uintptr_t>(tab) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
      const int nb = bin_tiles(g.W, g.H);
      if (nb <= 4) return dq_mma_nbt<4>(q, k, v, dout, lse, delta, rel, tab, dst, g, Y, Z, stream);
      if (nb <= 10)
        return dq_mma_nbt<10>(q, k, v, dout, lse, delta, rel, tab, dst, g, Y, Z, stream);
      return dq_mma_nbt<MAX_BIN_TILES>(q, k, v, dout, lse, delta, rel, tab, dst, g, Y, Z, stream);
    }
  }
  const int rs = (g.W + g.H) | 1;
  const size_t smem =
      static_cast<size_t>(2 * CQ * rs + CQ * (CW + 1) + CT * CW) * sizeof(float);
  auto kern = dq_core_kernel<T>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((g.hw + CQ - 1) / CQ * ((g.dkh + CW - 1) / CW), Y, Z);
  kern<<<grid, CQ, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, delta, rel,
                                                              dst, g, rs);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename RT>
int dkdv(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dout,
         Rows<const float> lse, Rows<const float> delta, Rows<const RT> rcl, DkdvOut<T> dst,
         Geo g, int Y, int Z, void* stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (mma_fits(g.W, g.H)) {
      const int rs = rel_stride_of(g.W, g.H);
      const size_t smem = static_cast<size_t>(DKDV_ROWS * KS + TN * (KS + VS)) * sizeof(bf16) +
                          static_cast<size_t>(TN) * (rs + 2) * sizeof(float);
      auto kern = dkdv_mma_kernel<RT>;
      const cudaError_t e = amma::allow_smem(kern, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      const dim3 grid((g.hw + DKDV_ROWS - 1) / DKDV_ROWS * max(g.nk, g.nv), Y, Z);
      kern<<<grid, DKDV_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, dout, lse, delta, rcl, dst, g, rs);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const int rs = (g.W + g.H) | 1;
  const size_t smem =
      static_cast<size_t>(CK * (CW + 1) + 3 * CT * CW + CT * (2 + rs)) * sizeof(float);
  auto kern = dkdv_core_kernel<T, RT>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nco = max((g.dkh + CW - 1) / CW, (g.dvh + CW - 1) / CW);
  const dim3 grid((g.hw + CK - 1) / CK * nco, Y, Z);
  kern<<<grid, CK, smem, static_cast<cudaStream_t>(stream)>>>(q, k, v, dout, lse, delta, rcl,
                                                              dst, g, rs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attention_wide
