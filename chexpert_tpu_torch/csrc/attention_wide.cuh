// Heads wider than the largest width class: the four attention kernels of
// both layouts (B1 / B2 head-major, B5 / B6 heads-in-lanes) for any dkh and
// dvh, for sm_90a.
//
// A width class (KW, VW) of ops/fused_attention.py::width_plan takes a head
// of dkh <= KW, dvh <= VW in its own kernels. A head past the largest class,
// (128, 64), runs in that class's libraries on the kernels of this header,
// with nk = ceil(dkh / KW) key chunks and nv = ceil(dvh / VW) value chunks
// passed at run time (the entries check them against dkh and dvh).
//
// The CUDA-core kernels (f32, and bf16 maps past amma::mma_fits) loop over
// the head dimensions in chunks: a contraction (S = q k^T over dkh, dp =
// dout v^T over dvh) sums the chunks in the block, staged through CW = 32
// columns by 2-byte loads with zero fill; an output width splits over chunks
// on the grid's x axis, next to the token tiles, and each block recomputes S
// and p for its own output columns. The forward's chunk 0 writes lse; pass
// dq's chunk 0 writes the bins and the RC scratch, pass dkdv's the pad lanes
// of a slot.
//
// The bf16 kernels on the tensor cores (maps up to amma::mma_fits), the
// forward and both backward passes, do not: a block computes S and p (and dp,
// ds) once per tile pair over the whole head width and feeds every output
// column of its column group from them, with each operand row staged once
// per tile pair by cp.async into two buffers (see "The tensor-core kernels"
// below). One launch per call, and every block owns what it writes: no
// atomics.
//
// The relative logits: head-major, the RW / RH lanes of each query's qr row;
// heads-in-lanes, RC[t, m] = sum_d q[t, d] Rw[(col(t), d), m] (and rows with
// Rh) summed over all of dkh in f32 on the CUDA cores, by the one function
// (rc_at) that every forward and pass dq call, the tensor-core ones through
// the same rc_rows, so the backward's p = exp(S - lse) sees the forward's S.
// Pass dq leaves those rows in the rc scratch, which pass dkdv reads on both
// routes (it is the only way pass dkdv sees RC here). The relative part of
// dq, sum_m dRC[t, m] Rw[(col(t), d), m], is a product from the block's bins.
//
// Routes: bf16 maps up to amma::mma_fits run the tensor-core kernels, f32
// and larger maps the CUDA-core kernels, which stage CW = 32 columns at a
// time and split their outputs by CW: their rows of dk, dv, dq and out stay
// CW registers wide. A bf16 head whose rows do not fit a tensor-core
// kernel's shared memory (dkh + dvh past about 1150) takes the CUDA-core
// kernel too: the host plans each tensor-core kernel (ops/fused_attention.py
// ::wide_fwd_plan, ::wide_bwd_plan) and passes the plan in, which tc_plan
// checks (WidePlan).

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

// Lane c of the RC row of token t (< hw) of grid cell (z, y): the qr lane
// (head-major), or sum_d q[t, d] Rw[(col(t), d), c] (Rh past W) in f32,
// d in order (heads-in-lanes), or zero without relative logits.
template <typename T>
__device__ __forceinline__ float rc_at(const Rel<T>& rel, const Rows<const T>& q, int z, int y,
                                       int t, int c, const Geo& g) {
  float s = 0.f;
  if (rel.lanes.p != nullptr) {
    s = to_f(rel.lanes.row(z, y, t)[c]);
  } else if (rel.Rw != nullptr) {
    const T* qt = q.row(z, y, t);
    const bool is_w = c < g.W;
    const float* base = is_w ? rel.Rw + static_cast<size_t>(t % g.W) * g.dkh * g.W + c
                             : rel.Rh + static_cast<size_t>(t / g.W) * g.dkh * g.H + c - g.W;
    const int stride = is_w ? g.W : g.H;
    for (int d = 0; d < g.dkh; ++d)
      s = fmaf(to_f(qt[d]), __ldg(base + static_cast<size_t>(d) * stride), s);
  }
  return s;
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
    rel_s[r * rel_stride + c] = t < g.hw ? rc_at(rel, q, z, y, t, c, g) : 0.f;
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
// The tensor-core kernels (bf16, maps up to amma::mma_fits): the forward
// (fwd_tc_kernel, B1 / B5) and the backward passes dq and dkdv (B2 / B6).
//
// A warp group of BW_WARPS warps owns BW_ROWS tokens of its own side
// (queries in the forward and pass dq, keys in pass dkdv; a warp 16 rows)
// and a column group of the output's n8 tiles (every tile of out, dq, or of
// [dk | dv], where one group holds them), and walks the other side's tokens
// TK at a time (32, or 16 where that lets two blocks share an SM). Per (own
// tile, other tile):
//   - S (and S^T) and dp over the whole head width, once: the own rows' A
//     fragments and the other rows' B words read from shared memory, k16
//     step by step over dkh padded to 16 (dvh likewise);
//   - p (and ds) as bf16 A fragments in registers, once, reused by every
//     output tile of the group: out += p v under the online softmax; dq +=
//     ds k (and the bins dRC += ds onehot, from the key table); dk += ds^T
//     q, dv += p^T dout.
// The own rows (all of dkh and dvh) are staged once per block; the other
// rows, whole, once per tile pair, into two buffers: the next tile's
// cp.async copies run under this tile's products. Copies are 16 bytes where
// every row of the operand starts on 16 bytes (8, 4 where it does not: odd
// slot offsets, ragged widths); rows that allow none (dvh 75: 150-byte
// rows) and the columns past the last whole copy (dkh 150) take 2-byte
// loads, several in flight a thread, and rows past the last token are zero
// (the backward) or left as they are where nothing reads them unmasked (the
// forward).
// Registers bound a column group: a warp holds NTO n8 tiles of its 16 rows
// in f32 (dq with more than 4 bin tiles: NTO_BINS, beside its bins). A head
// with more tiles takes ceil(tiles / NTO) groups, BW_WG of them a block as
// warp groups that share the block's staged rows, RC rows and E; each warp
// group computes S, dp, p and ds for its own columns (recomputed per group):
// (320, 128) takes 2 groups in each backward pass (one block), (512, 256) 2
// and 3, (640, 320) 3 and 4; the forward one group up to dvh 256, two at
// (640, 320).
// Tiny maps: where hw <= BW_ROWS / 2 a tile packs up to BW_ROWS / hw
// (batch, head) pairs (1x1: 64, 2x2: 16, 4x4: 4), virtual token v being
// token v % hw of pair v / hw (tok_table), and S is masked to each pair's
// own keys, so a block does the work of pack heads and not of one row in 64.
// The backward packs BW_ROWS / hw. The forward packs the fewest pairs that
// let the whole grid be resident at once (ops/fused_attention.py::fwd_pack:
// a block's time hardly grows with its pairs, and a second wave of blocks
// doubles the call), not pairs // 132, which keeps a block for every SM: at
// 1x1 with 512 pairs that is 4 pairs a tile, 128 blocks, faster than 3 a
// tile, 171 blocks in two waves (scripts/ab_attention_torch.py --packs).
// mma.sync.m16n8k16, as the classes: a 64-row wgmma tile would hold a
// warpgroup's accumulators for the whole group (four times a warp's) and
// leave no registers for S and dp (in the forward, for S beside out's 32
// n8 tiles at dvh 256).
// Pass dq's relative part, sum_m dRC[t, m] Rw[(col(t), d), m], is a product
// on the tensor cores from the bins (the class kernels' skew): E = rel_w^T
// read back out of Rw a k16 step at a time; the RC rows stay rc_at's f32
// sums (rc_rows, the forward's too: q from the staged rows, R staged in
// chunks, each value of R feeding four queries).
// Shared memory: (BW_ROWS + 2 TK) rows of dkh + dvh (padded to 16, + 8 a
// row; the forward's own rows dkh alone), the RC rows and (lse, delta): at
// most 203 KB at (512, 256) and 194 KB at (640, 320) (TK 16) in the
// backward, 214 KB at (640, 320) in the forward; a head whose rows do not fit
// even at TK 16 takes the CUDA-core kernels below. The plan (pack, column
// groups, warp groups, TK, shared memory) is chosen on the host, once, by
// ops/fused_attention.py::wide_fwd_plan / wide_bwd_plan; tc_plan fills in
// what follows from it and refuses a plan the kernels cannot run.

constexpr int BW_WARPS = 4;
constexpr int BW_ROWS = BW_WARPS * 16;  // own tokens of a block
constexpr int BW_NT = BW_WARPS * 32;  // a warp group: the threads of one column group
constexpr int BW_WG = 2;                // warp groups (column groups) a block holds at most

__device__ __forceinline__ int block_threads() { return static_cast<int>(blockDim.x); }
constexpr int NTO = 32;       // n8 output tiles a warp holds: dkdv, and dq with <= 4 bin tiles
constexpr int NTO_BINS = 16;  // dq with 5 .. 16 bin tiles (its bins take the rest)
constexpr int BW_SMEM_MAX = 232448;  // dynamic shared memory of one block on the H100

// Where virtual token v of a block lives: pack == 1, token v of pair p0;
// pack > 1, token v % hw of pair p0 + v / hw (np pairs in all, pair p at
// grid cell (p / Y, p % Y)), read from tab: 4 words per token, (v / hw, z,
// y, token), filled once per block (tok_table).
struct VTok {
  int p0, hw, pack, np, Y;
  const int* tab;  // packed: the block's token table in shared memory
  __device__ __forceinline__ int n() const {  // the block's tokens on either side
    return pack > 1 ? min(pack, np - p0) * hw : hw;
  }
  template <typename T>
  __device__ __forceinline__ T* row(const Rows<T>& r, int v) const {
    if (pack > 1) return r.row(tab[4 * v + 1], tab[4 * v + 2], tab[4 * v + 3]);
    return r.row(p0 / Y, p0 - p0 / Y * Y, v);
  }
  __device__ __forceinline__ int tok(int v) const { return pack > 1 ? tab[4 * v + 3] : v; }
};

// The token table of a block's BW_ROWS tokens into tab_s (word 0 is the
// pair's offset in the block, 0 unpacked), and vt pointed at it.
__device__ __forceinline__ void tok_table(int* tab_s, VTok& vt, int tid) {
  for (int r = tid; r < BW_ROWS; r += block_threads()) {
    const int po = vt.pack > 1 ? r / vt.hw : 0, p = vt.p0 + po;
    tab_s[4 * r] = po;
    tab_s[4 * r + 1] = p / vt.Y;
    tab_s[4 * r + 2] = p % vt.Y;
    tab_s[4 * r + 3] = vt.pack > 1 ? r % vt.hw : r;
  }
  vt.tab = tab_s;
}

constexpr int RC_LANES = 4;  // RC lanes a thread reads at once in rc_rows (head-major)

// cp.async groups: close the thread's copies issued so far into one group;
// wait until at most N of its groups are in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (r, c) of the elements e = tid, tid + threads, ... of rows x cols, stepped
// by the block's threads without a division (stride (dr, dc), c < cols).
struct Step {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Step(int tid, int threads, int cols_) : cols(cols_) {
    dr = threads / cols;
    dc = threads - dr * cols;
    r = tid / cols;
    c = tid - r * cols;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// Values c0 .. c0 + dn - 1 of d of every row of Rw and Rh into chunk (f32):
// the W rows of Rw (image column cc at cc * D * W, D * W floats a row) and
// then the H rows of Rh (image row rr at W * W * D + rr * D * H), each row's
// run of d contiguous in device memory, by cp.async of VEC bytes (16 where W
// and H are multiples of 4 and R is 16-byte aligned, else 4).
template <int VEC, typename T>
__device__ __forceinline__ void stage_r(float* chunk, const Rel<T>& rel, int c0, int dn, int D,
                                        const Geo& g, int tid) {
  constexpr int PER = VEC / 4;
  const int bt = block_threads();
#pragma unroll
  for (int axis = 0; axis < 2; ++axis) {
    const int n = axis == 0 ? g.W : g.H;
    const float* R = axis == 0 ? rel.Rw : rel.Rh;
    float* dst = chunk + (axis == 0 ? 0 : g.W * g.W * D);
    const int cols = dn * n / PER;  // copies a row
    for (Step st(tid, bt, cols); st.r < n; st.next())
      cp_async<VEC>(dst + st.r * D * n + st.c * PER,
                    R + (static_cast<size_t>(st.r) * g.dkh + c0) * n + st.c * PER);
  }
}

// One task of rc_sums: G neighbouring lanes (c .. c + G - 1 of one axis) of
// up to RC_QS of the block's queries that read the same row of R there (the
// same image column for Rw, row for Rh), so that each value of R read feeds
// RC_QS queries; qo: the queries' rows in q_s, dst: their RC rows in rel_s
// (-1 for a query past the set).
constexpr int RC_QS = 4;

template <int G>
struct RcTask {
  int qo[RC_QS], dst[RC_QS];
  int rrow, n;  // the R row (the column or row of the image) and its lanes
  float x[RC_QS][G];
};

// x[i][j] += sum over d in [d0, d1) of q[qo[i] + d] r[(d - rd0) * n + j], f32
// fmaf with d in order; r: the task's R row at d = rd0 (device or shared
// memory). Four values of d at a time where they and q_s's rows allow one
// 8-byte read of q (q4).
template <int G, typename T>
__device__ __forceinline__ void rc_task_sums(RcTask<G>& tk, const T* q_s, const float* r, int rd0,
                                             int d0, int d1, bool q4) {
  int d = d0;
  if (q4 && d0 % 4 == 0) {
    for (; d + 4 <= d1; d += 4) {
      float qv[RC_QS][4];
#pragma unroll
      for (int i = 0; i < RC_QS; ++i) {
        const uint2 w = *reinterpret_cast<const uint2*>(q_s + tk.qo[i] + d);
        qv[i][0] = __uint_as_float(w.x << 16);
        qv[i][1] = __uint_as_float(w.x & 0xffff0000u);
        qv[i][2] = __uint_as_float(w.y << 16);
        qv[i][3] = __uint_as_float(w.y & 0xffff0000u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* rp = r + (d + u - rd0) * tk.n;
        float rv[G];
        if constexpr (G == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(rp);
          rv[0] = v4.x;
          rv[1] = v4.y;
          rv[2] = v4.z;
          rv[3] = v4.w;
        } else {
          rv[0] = *rp;
        }
#pragma unroll
        for (int i = 0; i < RC_QS; ++i)
#pragma unroll
          for (int j = 0; j < G; ++j) tk.x[i][j] = fmaf(qv[i][u], rv[j], tk.x[i][j]);
      }
    }
  }
  for (; d < d1; ++d) {
    const float* rp = r + (d - rd0) * tk.n;
#pragma unroll
    for (int i = 0; i < RC_QS; ++i) {
      const float qv = to_f(q_s[tk.qo[i] + d]);
#pragma unroll
      for (int j = 0; j < G; ++j) tk.x[i][j] = fmaf(qv, rp[j], tk.x[i][j]);
    }
  }
}

// The RC lanes of heads-in-lanes (rc_rows) as tasks (RcTask): for each axis
// (Rw over the W lanes, Rh over the H lanes), each row rho of R (an image
// column, an image row), each group of G lanes, the block's queries that
// read row rho, RC_QS at a time. G = 4 where W and H are multiples of 4 and
// R is 16-byte aligned (one 16-byte read of R feeds 16 sums), else 1. A
// block's tile of 64 queries at 16x16 is 128 tasks, one a thread. q from the
// staged rows q_s (row stride qs), R from chunks of D values of d staged in
// scratch by cp.async two at a time (the next one's copies under this one's
// sums), or, where D is 0 (a map whose R rows do not fit), from device
// memory. Rows past vt.n() are 0. Every thread calls it: it synchronises
// the block where D > 0.
template <int G, typename T>
__device__ __forceinline__ void rc_sums(float* rel_s, int rs, const Rel<T>& rel, const T* q_s,
                                        int qs, float* scratch, int D, const VTok& vt, int q0,
                                        const Geo& g, int tid) {
  const int W = g.W, H = g.H, WH = W + H, bt = block_threads();
  const int nq = min(BW_ROWS, vt.n() - q0);  // the block's queries
  for (int e = tid; e < (BW_ROWS - nq) * WH; e += bt) {
    const int r = e / WH;
    rel_s[(nq + r) * rs + e - r * WH] = 0.f;
  }
  const bool packed = vt.pack > 1;
  const int np = packed ? nq / vt.hw : 1;  // pairs of a packed tile
  // per axis: rows rho of R in reach, lane groups, query sets of RC_QS a row
  const int rho0_h = packed ? 0 : q0 / W, nrho_h = packed ? H : (q0 + nq - 1) / W - q0 / W + 1;
  const int nset_w = packed ? (np * H + RC_QS - 1) / RC_QS : ((nq + W - 1) / W + RC_QS - 1) / RC_QS;
  const int nset_h = packed ? (np * W + RC_QS - 1) / RC_QS : (min(W, nq) + RC_QS - 1) / RC_QS;
  const int tasks_w = W * (W / G) * nset_w, tasks = tasks_w + nrho_h * (H / G) * nset_h;
  const int chunk = D * (W * W + H * H), nchunks = D > 0 ? (g.dkh + D - 1) / D : 1;
  const bool q4 = qs % 4 == 0;

  for (int p0 = 0; p0 < tasks; p0 += bt) {  // passes, the same for every thread
    const int f = p0 + tid;
    RcTask<G> tk;
    const bool on = f < tasks;
    int axis = 0, c = 0;
    {
      const int h = f - tasks_w, ax = on && h >= 0 ? 1 : 0, ff = ax ? h : (on ? f : 0);
      const int lgs = (ax ? H : W) / G, nset = ax ? nset_h : nset_w;
      const int set = ff % nset, lg = ff / nset % lgs, rho = ff / nset / lgs + (ax ? rho0_h : 0);
      axis = ax;
      c = lg * G;
      tk.rrow = rho;
      tk.n = ax ? H : W;
#pragma unroll
      for (int i = 0; i < RC_QS; ++i) {
        const int j = set * RC_QS + i;  // the query's place among those that read row rho
        int v = -1;
        if (!on) {
        } else if (packed) {
          const int per = ax ? W : H;  // tokens of a pair that read row rho
          const int pp = j / per, k = j - pp * per;
          if (pp < np) v = pp * vt.hw + (ax ? rho * W + k : k * W + rho);
        } else if (ax == 0) {
          const int first = q0 + ((rho - q0 % W) % W + W) % W;
          if (first + j * W < q0 + nq) v = first + j * W - q0;
        } else {
          const int lo = max(q0, rho * W), hi = min(q0 + nq, rho * W + W);
          if (lo + j < hi) v = lo + j - q0;
        }
        tk.qo[i] = (v < 0 ? 0 : v) * qs;
        tk.dst[i] = v < 0 ? -1 : v * rs + (ax ? W : 0) + c;
#pragma unroll
        for (int jj = 0; jj < G; ++jj) tk.x[i][jj] = 0.f;
      }
    }
    const float* Rax = axis ? rel.Rh : rel.Rw;
    if (D == 0) {
      if (on) rc_task_sums(tk, q_s, Rax + static_cast<size_t>(tk.rrow) * g.dkh * tk.n + c, 0, 0,
                           g.dkh, q4);
    } else {
      constexpr int VEC = G == 4 ? 16 : 4;
      const int roff = (axis ? W * W * D : 0) + tk.rrow * D * tk.n + c;  // the task's row in a chunk
      stage_r<VEC>(scratch, rel, 0, min(D, g.dkh), D, g, tid);
      cp_async_commit();
      for (int ci = 0; ci < nchunks; ++ci) {
        const int c0 = ci * D, dn = min(D, g.dkh - c0);
        if (ci + 1 < nchunks) {  // the next chunk into the other buffer, under these sums
          stage_r<VEC>(scratch + ((ci + 1) & 1) * chunk, rel, c0 + D, min(D, g.dkh - c0 - D), D,
                       g, tid);
          cp_async_commit();
          cp_async_wait_groups<1>();
        } else {
          cp_async_wait_groups<0>();
        }
        __syncthreads();
        if (on) rc_task_sums(tk, q_s, scratch + (ci & 1) * chunk + roff, c0, c0, c0 + dn, q4);
        __syncthreads();  // this chunk's buffer is consumed
      }
    }
#pragma unroll
    for (int i = 0; i < RC_QS; ++i)
      if (tk.dst[i] >= 0)
#pragma unroll
        for (int j = 0; j < G; ++j) rel_s[tk.dst[i] + j] = tk.x[i][j];
  }
}

// The values of d a chunk of R holds in rc_sums where two chunks fit
// scratch_bytes (0 where not even one value's rows do: R is then read from
// device memory).
__device__ __forceinline__ int rc_chunk(const Geo& g, size_t scratch_bytes) {
  const long long per_d = static_cast<long long>(g.W * g.W + g.H * g.H) * 2 * sizeof(float);
  const long long d = static_cast<long long>(scratch_bytes) / per_d;
  return d >= g.dkh ? g.dkh : static_cast<int>(d >= 4 ? d / 4 * 4 : d);
}

// The RC rows of the block's virtual queries q0 .. q0 + BW_ROWS - 1 into
// rel_s (f32, row stride rs), zero past vt.n(): the qr lanes (head-major;
// rc_at, four lanes in flight a thread), or (heads-in-lanes) RC[t, c] =
// sum_d q[t, d] R[(col(t), d), c] (Rh at row(t) past c = W) as rc_at sums
// it: f32 fmaf over d in order from 0, q read from the block's staged query
// rows q_s (row stride qs; landed before the call), R staged through scratch
// (scratch_bytes of shared memory that the caller does not use until the
// call returns and refills afterwards) in chunks of d, a thread summing four
// lanes of four queries that read the same row of R (rc_sums). The
// tensor-core forward and pass dq call it, so the backward's p = exp(S -
// lse) sees the forward's S. vt.tab: tok_table's. Every thread calls it.
template <typename T>
__device__ __forceinline__ void rc_rows(float* rel_s, int rs, const Rel<T>& rel,
                                        const Rows<const T>& q, const T* q_s, int qs,
                                        void* scratch, size_t scratch_bytes, const VTok& vt,
                                        int q0, const Geo& g, int tid) {
  if (rel.Rw != nullptr) {
    const bool vec = g.W % 4 == 0 && g.H % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(rel.Rw) | reinterpret_cast<uintptr_t>(rel.Rh)) &
                      15) == 0;
    float* sc = static_cast<float*>(scratch);
    const int D = rc_chunk(g, scratch_bytes);
    if (vec)
      rc_sums<4>(rel_s, rs, rel, q_s, qs, sc, D, vt, q0, g, tid);
    else
      rc_sums<1>(rel_s, rs, rel, q_s, qs, sc, D, vt, q0, g, tid);
    return;
  }
  const int WH = g.W + g.H, n = vt.n(), bt = block_threads();
  for (int e0 = tid; e0 < BW_ROWS * WH; e0 += RC_LANES * bt) {
    float x[RC_LANES];  // lanes in flight
#pragma unroll
    for (int k = 0; k < RC_LANES; ++k) {
      const int e = e0 + k * bt, r = e / WH, c = e - r * WH, vq = q0 + r;
      x[k] = 0.f;
      if (e < BW_ROWS * WH && vq < n) {
        const int* tv = vt.tab + 4 * (vt.pack > 1 ? vq : 0);
        x[k] = rc_at(rel, q, tv[1], tv[2], vt.tok(vq), c, g);
      }
    }
#pragma unroll
    for (int k = 0; k < RC_LANES; ++k) {
      const int e = e0 + k * bt, r = e / WH;
      if (e < BW_ROWS * WH) rel_s[r * rs + (e - r * WH)] = x[k];
    }
  }
}

// What a launch of the passes below knows of its head (tc_plan).
struct TcPlan {
  int Y, np, pack, ntile, ngroup, ntg, tk;  // grid: pair groups x own tiles x column groups
  int wg, gblocks;  // column groups a block (warp groups), blocks over the column groups
  int kp, vp, ks, vs, rs;                    // dkh, dvh padded to 16; tile row strides
  int nbt, words;                            // bin tiles; key-table words per row
  int vq, vk, vv, vdo, vrel;                 // copy bytes of each operand's rows
  int vo, oflat;  // the forward's out: copy bytes of its rows; its virtual rows one run
};

// Columns [0, ncols) of virtual tokens v0 .. v0 + nrows - 1 of src into dst
// (row stride ds): copies of vec bytes by cp.async (complete after
// cp_async_wait), the columns past the last whole copy by plain loads (all
// of them where vec is the element size), zeros for tokens past vt.n()
// (left as they are where zero is false). The threads form a grid of rows x
// (copies a row, rounded up to a power of two), so a copy costs no
// division; a row's start is the pair's first row plus v rows, but for
// packed tokens.
template <typename T>
__device__ __forceinline__ void stage_v(T* dst, int ds, const Rows<const T>& src, const VTok& vt,
                                        int v0, int nrows, int ncols, int vec, int tid,
                                        bool zero = true) {
  if (!zero) nrows = max(0, min(nrows, vt.n() - v0));  // rows past the last token: untouched
  const int per = vec / static_cast<int>(sizeof(T));
  const int nfull = vec >= 4 ? ncols / per : 0;
  const int cpr = nfull + (ncols - nfull * per);
  const int nv = vt.n();
  const T* base = vt.pack > 1 ? nullptr : vt.row(src, 0);
  auto src_of = [&](int v) { return base != nullptr ? base + v * src.sr : vt.row(src, v); };
  auto copy = [&](int r, int c) {
    const int v = v0 + r;
    const bool whole = c < nfull;
    const int c0 = whole ? c * per : nfull * per + (c - nfull);
    T* d = dst + r * ds + c0;
    if (v >= nv) {  // (zero: nrows stops at the last token otherwise)
      for (int i = 0; i < (whole ? per : 1); ++i) put(d + i, 0.f);
      return;
    }
    const T* s = src_of(v) + c0;
    if (!whole)
      *d = *s;
    else if (vec == 16)
      cp_async<16>(d, s);
    else if (vec == 8)
      cp_async<8>(d, s);
    else
      cp_async<4>(d, s);
  };
  const int bt = block_threads();
  if (nfull == 0) {  // rows of plain loads: every thread by turns, eight loads in flight
    for (Step st(tid, bt, ncols); st.r < nrows;) {
      T x[8];
      Step s1 = st;
#pragma unroll
      for (int k = 0; k < 8; ++k, s1.next())
        x[k] = s1.r < nrows && v0 + s1.r < nv ? src_of(v0 + s1.r)[s1.c] : T(0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k, st.next())
        if (st.r < nrows) dst[st.r * ds + st.c] = x[k];
    }
    return;
  }
  const int lg = cpr > 1 ? 32 - __clz(cpr - 1) : 0;
  if ((1 << lg) > bt) {  // a row of more copies than threads
    for (Step st(tid, bt, cpr); st.r < nrows; st.next()) copy(st.r, st.c);
    return;
  }
  const int c = tid & ((1 << lg) - 1), rstep = bt >> lg;
  if (c >= cpr) return;
  if (c < nfull) {
    for (int r = tid >> lg; r < nrows; r += rstep) copy(r, c);
    return;
  }
  // the column past the last whole copy: four rows' loads in flight
  const int col = nfull * per + (c - nfull);
  for (int r0 = tid >> lg; r0 < nrows; r0 += 4 * rstep) {
    T x[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = r0 + k * rstep, v = v0 + r;
      x[k] = r < nrows && v < nv ? src_of(v)[col] : T(0.f);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (r0 + k * rstep < nrows) dst[(r0 + k * rstep) * ds + col] = x[k];
  }
}

// (lse, delta) of virtual tokens v0 .. v0 + nrows - 1 by 4-byte cp.async;
// (LSE_PAD, 0) past vt.n(), so that their p is 0.
__device__ __forceinline__ void stage_ld_v(float* ld_s, const Rows<const float>& lse,
                                           const Rows<const float>& delta, const VTok& vt,
                                           int v0, int nrows, int tid) {
  const int nv = vt.n();
  for (int r = tid; r < nrows; r += block_threads()) {
    if (v0 + r < nv) {
      cp_async<4>(ld_s + 2 * r, vt.row(lse, v0 + r));
      cp_async<4>(ld_s + 2 * r + 1, vt.row(delta, v0 + r));
    } else {
      ld_s[2 * r] = LSE_PAD;
      ld_s[2 * r + 1] = 0.f;
    }
  }
}

// acc[nt] += rows ra, ra + 8 of a_s (row stride as) times rows 8 nt .. 8 nt
// + 7 of b_s (row stride bs) transposed, over kp columns (a multiple of 16),
// for the ntk (<= 4) n8 tiles of a tile of other tokens.
__device__ __forceinline__ void rows_product(float (&acc)[4][4], const bf16* a_s, int as, int ra,
                                             const bf16* b_s, int bs, int kp, int ntk, int g,
                                             int t) {
#pragma unroll 2
  for (int k0 = 0; k0 < kp; k0 += 16) {
    const bf16* a = a_s + ra * as + k0 + 2 * t;
    const uint32_t a0 = lds32(a), a1 = lds32(a + 8 * as), a2 = lds32(a + 8),
                   a3 = lds32(a + 8 * as + 8);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (nt < ntk) {
        const bf16* b = b_s + (nt * 8 + g) * bs + k0 + 2 * t;
        mma16816(acc[nt], a0, a1, a2, a3, lds32(b), lds32(b + 8));
      }
    }
  }
}

// Lanes d (even) and d + 1 of a bf16 row, those below w: one 4-byte store
// where the row is 4-byte aligned.
__device__ __forceinline__ void store_pair(bf16* row, int d, int w, bool pairs, float x0,
                                           float x1) {
  if (pairs && d + 1 < w) {
    *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(x0, x1);
  } else {
    if (d < w) row[d] = __float2bfloat16(x0);
    if (d + 1 < w) row[d + 1] = __float2bfloat16(x1);
  }
}

// Zero n bytes (a multiple of 16) of shared memory from p (16-byte aligned).
__device__ __forceinline__ void zero_smem(void* p, size_t n, int tid) {
  uint4* d = static_cast<uint4*>(p);
  for (size_t e = tid; e < n / 16; e += block_threads()) d[e] = make_uint4(0u, 0u, 0u, 0u);
}

// The block's place: pair group, own tile and its first column group (it
// holds pl.wg of them, one a warp group of BW_WARPS warps); its VTok.
struct TcBlock {
  VTok vt;
  int own0, group0;  // first own virtual token; first column group
};

__device__ __forceinline__ TcBlock tc_block(const TcPlan& pl, int hw) {
  int b = blockIdx.x;
  TcBlock tb;
  tb.group0 = b % pl.gblocks * pl.wg;
  b /= pl.gblocks;
  const int tile = b % pl.ntile, pg = b / pl.ntile;
  tb.vt = VTok{pl.pack > 1 ? pg * pl.pack : pg, hw, pl.pack, pl.np, pl.Y, nullptr};
  tb.own0 = tile * BW_ROWS;
  return tb;
}

// A warp's column group: its first n8 tile and how many of the tiles tiles
// it holds (0: a warp group past the last column group, which stages and
// waits with the block and computes nothing).
struct TcCols {
  int group, t0, ntg;
};

__device__ __forceinline__ TcCols tc_cols(const TcPlan& pl, const TcBlock& tb, int warp,
                                          int tiles) {
  TcCols tc;
  tc.group = tb.group0 + warp / BW_WARPS;
  tc.t0 = tc.group * pl.ntg;
  tc.ntg = tc.group < pl.ngroup ? min(pl.ntg, tiles - tc.t0) : 0;
  return tc;
}

// Pass dq: own tokens are queries. Per key tile: S = q k^T and dp = dout
// v^T, the relative logits from the queries' RC rows (rc_at, the forward's
// arithmetic) at each key's image column and row (key table), p, ds; then dq
// += ds k over the group's tiles of dkh and the bins += ds onehot. After the
// walk the bins give dq's relative part (heads-in-lanes) and are written
// with the RC rows by group 0: the dRW / dRH lanes of dqr (head-major) or the
// dRC and rc scratch rows (heads-in-lanes).
template <int NBT, int NTG>
__global__ void __launch_bounds__(BW_WG * BW_NT, 1)
dq_tc_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rows<const bf16> dout,
             Rows<const float> lse, Rows<const float> delta, Rel<bf16> rel,
             const int* __restrict__ tab, DqOut<bf16> dst, Geo g, TcPlan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = pl.ks, vs = pl.vs, rs = pl.rs, tk = pl.tk;
  bf16* qo_s = reinterpret_cast<bf16*>(smem_raw);  // BW_ROWS x ks: the queries
  bf16* do_s = qo_s + BW_ROWS * ks;                // BW_ROWS x vs: their dout
  bf16* kb_s = do_s + BW_ROWS * vs;                // 2 x (tk x ks): key tiles
  bf16* vb_s = kb_s + 2 * tk * ks;                 // 2 x (tk x vs): value tiles
  float* rel_s = reinterpret_cast<float*>(vb_s + 2 * tk * vs);  // BW_ROWS x rs: RC, then bins
  float* ld_s = rel_s + BW_ROWS * rs;              // BW_ROWS x 2
  int* tok_s = reinterpret_cast<int*>(ld_s + BW_ROWS * 2);  // BW_ROWS x 4: tok_table

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const TcBlock tb = tc_block(pl, g.hw);
  VTok vt = tb.vt;
  const int n = vt.n(), q0 = tb.own0, WH = g.W + g.H;
  const bool packed = pl.pack > 1;
  const bool relative = rel.lanes.p != nullptr || rel.Rw != nullptr;
  const TcCols tc = tc_cols(pl, tb, warp, (g.dkh + 7) / 8);
  const int ntg = tc.ntg;
  // the bins: head-major group 0 writes them; heads-in-lanes every group
  // needs them for dq's relative part (a block's warp group 0 stores them)
  const bool bins_block = relative && (tb.group0 == 0 || rel.Rw != nullptr);
  const bool bins_on = relative && ntg > 0 && (tc.group == 0 || rel.Rw != nullptr);

  // the own rows, then (heads-in-lanes) their RC rows with R staged through
  // the key and value tiles' room, then the first key tile
  const size_t tiles_bytes = static_cast<size_t>(2 * tk) * (ks + vs) * sizeof(bf16);
  const bool r_staged = rel.Rw != nullptr;
  zero_smem(smem_raw, static_cast<size_t>(BW_ROWS + 2 * tk) * (ks + vs) * sizeof(bf16), tid);
  tok_table(tok_s, vt, tid);
  __syncthreads();
  stage_v(qo_s, ks, q, vt, q0, BW_ROWS, g.dkh, pl.vq, tid);
  stage_v(do_s, vs, dout, vt, q0, BW_ROWS, g.dvh, pl.vdo, tid);
  stage_ld_v(ld_s, lse, delta, vt, q0, BW_ROWS, tid);
  auto stage_first = [&] {
    stage_v(kb_s, ks, k, vt, 0, tk, g.dkh, pl.vk, tid);
    stage_v(vb_s, vs, v, vt, 0, tk, g.dvh, pl.vv, tid);
  };
  if (!r_staged) stage_first();
  cp_async_wait();
  __syncthreads();
  rc_rows(rel_s, rs, rel, q, qo_s, ks, kb_s, tiles_bytes, vt, q0, g, tid);
  if (r_staged) {  // the tiles' room again: its zero pad columns, the first tile
    __syncthreads();
    zero_smem(kb_s, tiles_bytes, tid);
    __syncthreads();
    stage_first();
    cp_async_wait();
  }
  __syncthreads();
  if (tb.group0 == 0 && dst.rc.p != nullptr)  // the RC rows for pass dkdv
    for (int e = tid; e < BW_ROWS * WH; e += block_threads()) {
      const int r = e / WH, c = e - r * WH;
      if (q0 + r < n) vt.row(dst.rc, q0 + r)[c] = rel_s[r * rs + c];
    }

  const int ra = warp % BW_WARPS * 16 + gl;
  float lse2[2], dl[2];
  int pr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = ld_s[2 * (ra + 8 * i)] * LOG2E;
    dl[i] = ld_s[2 * (ra + 8 * i) + 1];
    pr[i] = tok_s[4 * (ra + 8 * i)];
  }
  const float* rel0 = rel_s + ra * rs;
  const float* rel1 = rel0 + 8 * rs;
  float acc[NTG][4], bins[NBT][4];
#pragma unroll
  for (int u = 0; u < NTG; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NBT; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i) bins[nb][i] = 0.f;

  const int ntiles = (n + tk - 1) / tk, ntk = tk / 8;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * tk, buf = it & 1;
    if (it + 1 < ntiles) {  // the next key tile into the other buffer, under this tile's work
      stage_v(kb_s + (buf ^ 1) * tk * ks, ks, k, vt, j0 + tk, tk, g.dkh, pl.vk, tid);
      stage_v(vb_s + (buf ^ 1) * tk * vs, vs, v, vt, j0 + tk, tk, g.dvh, pl.vv, tid);
    }
    const bf16* k_s = kb_s + buf * tk * ks;
    const bf16* v_s = vb_s + buf * tk * vs;
    float s[4][4] = {}, dp[4][4] = {};
    if (ntg > 0) {
      rows_product(s, qo_s, ks, ra, k_s, ks, pl.kp, ntk, gl, t);
      rows_product(dp, do_s, vs, ra, v_s, vs, pl.vp, ntk, gl, t);
    }
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      if (kc * 16 < tk && ntg > 0) {  // uniform across the warp
        const int jc = j0 + kc * 16;  // the chunk's first key; its table row and chunk
        const int* trow = tab + static_cast<size_t>(jc / TN) * pl.words;
        const int c4 = (jc % TN) / 16;
        uint32_t dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kc + half, jv = jc + half * 8 + 2 * t;
          const int2 kp = __ldg(reinterpret_cast<const int2*>(
              trow + (TN / 16) * pl.nbt * 64 + TN / 16 + (jv % TN)));
          const int ca = kp.x & 0xffff, rwa = kp.x >> 16, cb = kp.y & 0xffff, rwb = kp.y >> 16;
          bool m[4] = {jv < n, jv + 1 < n, jv < n, jv + 1 < n};
          if (packed) {  // each query sees its own pair's keys
            const int pa = jv < n ? tok_s[4 * jv] : -1, pb = jv + 1 < n ? tok_s[4 * jv + 4] : -1;
            m[0] = m[0] && pa == pr[0];
            m[1] = m[1] && pb == pr[0];
            m[2] = m[2] && pa == pr[1];
            m[3] = m[3] && pb == pr[1];
          }
          const float s0 = s[nt][0] + (rel0[ca] + rel0[g.W + rwa]);
          const float s1 = s[nt][1] + (rel0[cb] + rel0[g.W + rwb]);
          const float s2 = s[nt][2] + (rel1[ca] + rel1[g.W + rwa]);
          const float s3 = s[nt][3] + (rel1[cb] + rel1[g.W + rwb]);
          const float p0 = m[0] ? exp_shifted(s0, lse2[0]) : 0.f;
          const float p1 = m[1] ? exp_shifted(s1, lse2[0]) : 0.f;
          const float p2 = m[2] ? exp_shifted(s2, lse2[1]) : 0.f;
          const float p3 = m[3] ? exp_shifted(s3, lse2[1]) : 0.f;
          dsa[2 * half] = pack_bf16(p0 * (dp[nt][0] - dl[0]), p1 * (dp[nt][1] - dl[0]));
          dsa[2 * half + 1] = pack_bf16(p2 * (dp[nt][2] - dl[1]), p3 * (dp[nt][3] - dl[1]));
        }
        const bf16* k_row = k_s + (kc * 16 + (lane & 15)) * ks + tc.t0 * 8;
#pragma unroll
        for (int u = 0; u < NTG; ++u) {  // dq += ds k over the group's tiles
          if (u < ntg) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, k_row + u * 8);
            mma16816(acc[u], dsa[0], dsa[1], dsa[2], dsa[3], b0, b1);
          }
        }
        if (bins_on) {  // the bins: dRC += ds onehot, over the bin tiles these keys touch
          const unsigned touched =
              static_cast<unsigned>(__ldg(trow + (TN / 16) * pl.nbt * 64 + c4));
          const uint2* oh = reinterpret_cast<const uint2*>(trow) + c4 * pl.nbt * 32 + lane;
#pragma unroll
          for (int nb = 0; nb < NBT; ++nb) {
            if ((touched >> nb) & 1u) {
              const uint2 b = __ldg(oh + nb * 32);
              mma16816(bins[nb], dsa[0], dsa[1], dsa[2], dsa[3], b.x, b.y);
            }
          }
        }
      }
    }
    cp_async_wait();
    __syncthreads();  // the next tile has landed; this one is consumed
  }

  if (bins_block) {  // every warp has read its last RC row: rel_s becomes the bins
    if (warp < BW_WARPS) bins_store(bins, rel_s, rs, g.W, g.H, (g.W + 7) / 8, warp, lane);
    __syncthreads();
  }
  if (rel.Rw != nullptr) {
    // dq's relative part on the tensor cores: sum_m dRC_w[t, m] Rw[(col(t), d), m]
    // = sum_x G[t, x] E_w[x, d], E_w[x, d] = rel_w[d, x] read back out of Rw,
    // G the bins skewed by the query's column (rows likewise), G split into
    // hi + lo bf16 (as the class kernels' dq_rel_axis); E a k16 step at a time
    // in e_s (the queries' tile is consumed)
    bf16* e_s = qo_s;  // 16 x ks: E's rows x0 .. x0 + 15 over the block's columns
    const int bt0 = tb.group0 * pl.ntg;  // the block's first n8 tile
    const int d0 = bt0 * 8;
    const int ncol = (min((g.dkh + 7) / 8, (tb.group0 + pl.wg) * pl.ntg) - bt0) * 8;
    int pos[2][2];     // [axis][row g, g + 8]: the query's image column and row
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int vq = q0 + ra + 8 * rr, tq = vq < n ? vt.tok(vq) : 0;
      pos[0][rr] = tq % g.W;
      pos[1][rr] = tq / g.W;
    }
#pragma unroll
    for (int axis = 0; axis < 2; ++axis) {
      const int nn = axis == 0 ? g.W : g.H, off = axis == 0 ? 0 : g.W;
      const float* R = axis == 0 ? rel.Rw : rel.Rh;
      for (int x0 = 0; x0 < 2 * nn - 1; x0 += 16) {
        __syncthreads();  // the previous step of E is consumed
        // E[x, d] = R[(c, d), m] for any m - c = x - nn + 1: c = 0 past x = nn - 2,
        // else c = nn - 1, so that neighbouring x read neighbouring m
        for (int e0 = tid; e0 < 16 * ncol; e0 += 4 * block_threads()) {
          float val[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = e0 + k * block_threads(), dd = e >> 4, x = x0 + (e & 15), d = d0 + dd;
            val[k] = 0.f;
            if (e < 16 * ncol && x < 2 * nn - 1 && d < g.dkh)
              val[k] = __ldg(R + (static_cast<size_t>(x >= nn - 1 ? 0 : nn - 1) * g.dkh + d) * nn +
                             (x >= nn - 1 ? x - (nn - 1) : x));
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int e = e0 + k * block_threads();
            if (e < 16 * ncol) e_s[(e & 15) * ks + (e >> 4)] = __float2bfloat16(val[k]);
          }
        }
        __syncthreads();
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = i & 1;  // a0, a2: row g; a1, a3: row g + 8
          const int m = x0 + 2 * t + (i >> 1) * 8 - (nn - 1) + pos[axis][rr];
          const float* bin = rel_s + (ra + 8 * rr) * rs + off;
          const float v0 = (m >= 0 && m < nn) ? bin[m] : 0.f;
          const float v1 = (m + 1 >= 0 && m + 1 < nn) ? bin[m + 1] : 0.f;
          const bf16 h0 = __float2bfloat16(v0), h1 = __float2bfloat16(v1);
          ahi[i] = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
          alo[i] = pack_bf16(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
        }
#pragma unroll
        for (int u = 0; u < NTG; ++u) {
          if (u < ntg) {
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, e_s + (lane & 15) * ks + (tc.t0 - bt0 + u) * 8);
            mma16816(acc[u], ahi[0], ahi[1], ahi[2], ahi[3], b0, b1);
            mma16816(acc[u], alo[0], alo[1], alo[2], alo[3], b0, b1);
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int vq = q0 + ra + 8 * rr;
    if (vq >= n) continue;
    bf16* dq_i = vt.row(dst.dq, vq);
    const bool pairs = (reinterpret_cast<uintptr_t>(dq_i) & 3) == 0;
#pragma unroll
    for (int u = 0; u < NTG; ++u)
      if (u < ntg) store_pair(dq_i, (tc.t0 + u) * 8 + 2 * t, g.dkh, pairs, acc[u][2 * rr],
                              acc[u][2 * rr + 1]);
  }
  if (tb.group0 == 0 && relative)  // the bins: dRW / dRH lanes, or the dRC rows
    for (int e = tid; e < BW_ROWS * WH; e += block_threads()) {
      const int r = e / WH, c = e - r * WH;
      if (q0 + r >= n) continue;
      if (dst.bins.p != nullptr) put(vt.row(dst.bins, q0 + r) + c, rel_s[r * rs + c]);
      if (dst.drc.p != nullptr) vt.row(dst.drc, q0 + r)[c] = rel_s[r * rs + c];
    }
}

// Pass dkdv: own tokens are keys. Per query tile: S^T = k q^T and dp^T = v
// dout^T, the relative logits from the queries' RC rows (rcl: the qr lanes,
// or the rc scratch of pass dq, staged with the tile) at the keys' image
// columns and rows, p^T, ds^T; then over the group's n8 tiles of [dk | dv]:
// dk += ds^T q, dv += p^T dout. Group 0 writes the zero pad lanes of a slot.
template <typename RT>
__global__ void __launch_bounds__(BW_WG * BW_NT, 1)
dkdv_tc_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v,
               Rows<const bf16> dout, Rows<const float> lse, Rows<const float> delta,
               Rows<const RT> rcl, DkdvOut<bf16> dst, Geo g, TcPlan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = pl.ks, vs = pl.vs, rs = pl.rs, tk = pl.tk;
  bf16* ko_s = reinterpret_cast<bf16*>(smem_raw);  // BW_ROWS x ks: the keys
  bf16* vo_s = ko_s + BW_ROWS * ks;                // BW_ROWS x vs: their values
  // two buffers of a query tile: q (tk x ks), dout (tk x vs), RC (tk x rs), (lse, delta)
  unsigned char* tiles = reinterpret_cast<unsigned char*>(vo_s + BW_ROWS * vs);
  const size_t tile_bytes = static_cast<size_t>(tk) * ((ks + vs) * sizeof(bf16) +
                                                       rs * sizeof(RT) + 2 * sizeof(float));
  int* tok_s = reinterpret_cast<int*>(tiles + 2 * tile_bytes);  // BW_ROWS x 4: tok_table
  auto q_of = [&](int b) { return reinterpret_cast<bf16*>(tiles + b * tile_bytes); };
  auto do_of = [&](int b) { return q_of(b) + tk * ks; };
  auto rel_of = [&](int b) { return reinterpret_cast<RT*>(do_of(b) + tk * vs); };
  auto ld_of = [&](int b) { return reinterpret_cast<float*>(rel_of(b) + tk * rs); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const TcBlock tb = tc_block(pl, g.hw);
  VTok vt = tb.vt;
  const int n = vt.n(), key0 = tb.own0, WH = g.W + g.H;
  const bool packed = pl.pack > 1;
  const int ndk = (g.dkh + 7) / 8;
  const TcCols tc = tc_cols(pl, tb, warp, ndk + (g.dvh + 7) / 8);
  const int ntg = tc.ntg;

  // zeros: the pad columns, RC without relative logits
  zero_smem(smem_raw, static_cast<size_t>(BW_ROWS) * (ks + vs) * sizeof(bf16) + 2 * tile_bytes,
            tid);
  tok_table(tok_s, vt, tid);
  __syncthreads();
  auto stage_tile = [&](int i0, int b) {
    stage_v(q_of(b), ks, q, vt, i0, tk, g.dkh, pl.vq, tid);
    stage_v(do_of(b), vs, dout, vt, i0, tk, g.dvh, pl.vdo, tid);
    if (rcl.p != nullptr) stage_v(rel_of(b), rs, rcl, vt, i0, tk, WH, pl.vrel, tid);
    stage_ld_v(ld_of(b), lse, delta, vt, i0, tk, tid);
  };
  stage_v(ko_s, ks, k, vt, key0, BW_ROWS, g.dkh, pl.vk, tid);
  stage_v(vo_s, vs, v, vt, key0, BW_ROWS, g.dvh, pl.vv, tid);
  stage_tile(0, 0);
  cp_async_wait();
  __syncthreads();

  const int ra = warp % BW_WARPS * 16 + gl;
  bool ok[2];
  int kc_[2], kr_[2], pk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + ra + 8 * i;
    ok[i] = j < n;
    const int tj = ok[i] ? vt.tok(j) : 0;
    kc_[i] = tj % g.W;
    kr_[i] = g.W + tj / g.W;
    pk[i] = tok_s[4 * (ra + 8 * i)];
  }
  float acc[NTO][4];
#pragma unroll
  for (int u = 0; u < NTO; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;

  const int ntiles = (n + tk - 1) / tk, ntk = tk / 8;
  for (int it = 0; it < ntiles; ++it) {
    const int i0 = it * tk, buf = it & 1;
    if (it + 1 < ntiles) stage_tile(i0 + tk, buf ^ 1);
    const bf16* q_s = q_of(buf);
    const bf16* d_s = do_of(buf);
    const RT* rel_s = rel_of(buf);
    const float* ld_s = ld_of(buf);
    float s[4][4] = {}, dp[4][4] = {};
    if (ntg > 0) {
      rows_product(s, ko_s, ks, ra, q_s, ks, pl.kp, ntk, gl, t);
      rows_product(dp, vo_s, vs, ra, d_s, vs, pl.vp, ntk, gl, t);
    }
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      if (kc * 16 < tk && ntg > 0) {  // uniform across the warp
        uint32_t pa[4], dsa[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int nt = 2 * kc + half, la = nt * 8 + 2 * t;  // queries la, la + 1 of the tile
          const float4 ld = *reinterpret_cast<const float4*>(ld_s + 2 * la);
          const RT* rqa = rel_s + la * rs;
          const RT* rqb = rqa + rs;
          bool m[4] = {ok[0], ok[0], ok[1], ok[1]};
          if (packed) {  // each key sees its own pair's queries
            const int qa = i0 + la, pa_ = qa < n ? tok_s[4 * qa] : -1,
                      pb_ = qa + 1 < n ? tok_s[4 * qa + 4] : -1;
            m[0] = m[0] && pk[0] == pa_;
            m[1] = m[1] && pk[0] == pb_;
            m[2] = m[2] && pk[1] == pa_;
            m[3] = m[3] && pk[1] == pb_;
          }
          const float s0 = s[nt][0] + (to_f(rqa[kc_[0]]) + to_f(rqa[kr_[0]]));
          const float s1 = s[nt][1] + (to_f(rqb[kc_[0]]) + to_f(rqb[kr_[0]]));
          const float s2 = s[nt][2] + (to_f(rqa[kc_[1]]) + to_f(rqa[kr_[1]]));
          const float s3 = s[nt][3] + (to_f(rqb[kc_[1]]) + to_f(rqb[kr_[1]]));
          const float la2 = ld.x * LOG2E, lb2 = ld.z * LOG2E;
          const float p0 = m[0] ? exp_shifted(s0, la2) : 0.f;
          const float p1 = m[1] ? exp_shifted(s1, lb2) : 0.f;
          const float p2 = m[2] ? exp_shifted(s2, la2) : 0.f;
          const float p3 = m[3] ? exp_shifted(s3, lb2) : 0.f;
          pa[2 * half] = pack_bf16(p0, p1);
          pa[2 * half + 1] = pack_bf16(p2, p3);
          dsa[2 * half] = pack_bf16(p0 * (dp[nt][0] - ld.y), p1 * (dp[nt][1] - ld.w));
          dsa[2 * half + 1] = pack_bf16(p2 * (dp[nt][2] - ld.y), p3 * (dp[nt][3] - ld.w));
        }
        const bf16* q_row = q_s + (kc * 16 + (lane & 15)) * ks;
        const bf16* d_row = d_s + (kc * 16 + (lane & 15)) * vs - ndk * 8;
#pragma unroll
        for (int u = 0; u < NTO; ++u) {  // dk += ds^T q, dv += p^T dout over the group's tiles
          if (u < ntg) {
            const int i = tc.t0 + u;
            const bool is_k = i < ndk;
            uint32_t b0, b1;
            ldsm_x2_trans(b0, b1, (is_k ? q_row : d_row) + i * 8);
            mma16816(acc[u], is_k ? dsa[0] : pa[0], is_k ? dsa[1] : pa[1], is_k ? dsa[2] : pa[2],
                     is_k ? dsa[3] : pa[3], b0, b1);
          }
        }
      }
    }
    cp_async_wait();
    __syncthreads();  // the next tile has landed; this one is consumed
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int j = key0 + ra + 8 * rr;
    if (j >= n) continue;
    bf16* dk_j = vt.row(dst.dk, j);
    bf16* dv_j = vt.row(dst.dv, j);
    const bool k_pairs = (reinterpret_cast<uintptr_t>(dk_j) & 3) == 0;
    const bool v_pairs = (reinterpret_cast<uintptr_t>(dv_j) & 3) == 0;
#pragma unroll
    for (int u = 0; u < NTO; ++u) {
      if (u < ntg) {
        const int i = tc.t0 + u;
        if (i < ndk)
          store_pair(dk_j, i * 8 + 2 * t, g.dkh, k_pairs, acc[u][2 * rr], acc[u][2 * rr + 1]);
        else
          store_pair(dv_j, (i - ndk) * 8 + 2 * t, g.dvh, v_pairs, acc[u][2 * rr],
                     acc[u][2 * rr + 1]);
      }
    }
    if (tc.group == 0)
      for (int e = t; e < dst.npad; e += 4) vt.row(dst.pad, j)[e] = __float2bfloat16(0.f);
  }
}

// The forward's instances: n8 tiles of out a warp holds, and the blocks an
// SM's registers hold of each (ops/fused_attention.py::FWD_INSTANCES).
constexpr int FWD_NTG[4] = {8, 12, 16, 32};
constexpr int fwd_blocks(int ntg) { return ntg <= 12 ? 4 : ntg <= 16 ? 3 : 1; }

// ldmatrix.x4: four 8x8 bf16 matrices, the rows of matrix i named by lanes
// 8i .. 8i + 7; register i holds matrix i's fragment (row lane / 4, columns
// 2 (lane % 4) and + 1), or its transpose's with trans.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// s[nt] += rows r0 .. r0 + 15 of a_s (row stride as) times rows 8 nt .. 8 nt
// + 7 of b_s (row stride bs) transposed, over kp columns (a multiple of 16),
// for the ntk (<= 4) n8 tiles that hold a key: rows_product's sums in its
// order, each k16 step's fragments by one ldmatrix.x4 a side and pair of
// tiles.
__device__ __forceinline__ void s_product(float (&s)[4][4], const bf16* a_s, int as, int r0,
                                          const bf16* b_s, int bs, int kp, int ntk, int lane) {
  const int i = lane >> 3, r = lane & 7;
  const bf16* a = a_s + (r0 + r + (i & 1) * 8) * as + (i >> 1) * 8;
  const bf16* b = b_s + (r + (i >> 1) * 8) * bs + (i & 1) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < kp; k0 += 16) {
    uint32_t af[4], bf[4];
    ldsm_x4(af, a + k0);
    ldsm_x4(bf, b + k0);
    mma16816(s[0], af[0], af[1], af[2], af[3], bf[0], bf[1]);
    if (ntk > 1) mma16816(s[1], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    if (ntk > 2) {
      ldsm_x4(bf, b + 16 * bs + k0);
      mma16816(s[2], af[0], af[1], af[2], af[3], bf[0], bf[1]);
      if (ntk > 3) mma16816(s[3], af[0], af[1], af[2], af[3], bf[2], bf[3]);
    }
  }
}

// The forward (B1 head-major, B5 heads-in-lanes): own tokens are queries,
// NTG the n8 tiles of out a warp holds at most (FWD_NTG: registers scale
// with it). A block stages its queries once (all of dkh), sums their RC rows
// (rc_rows: the qr lanes head-major; heads-in-lanes rc_at's f32 sums, pass
// dq's code, with R staged through the key tiles' room before the first key
// tile lands), then per key tile: S = q k^T over all of dkh, the relative
// logits at each key's image column and row (key table), masked past the
// last key and, packed, to each query's own pair; the online softmax (a
// row's max over a quad of lanes; out's rescale skipped where no row of the
// warp moved its max) and out += p v over the group's tiles of dvh, p
// rounded to bf16 once; the next tile's copies run under these products.
// out leaves through the tiles' room in copies as wide as its rows allow
// (one run of 16-byte copies where the block's rows are contiguous); lse is
// written once per query row, by group 0. Own rows and key rows past the
// last token are left as they are (their rows of S are never written, their
// columns are masked); the pad columns of q and k and the value tiles are
// zeroed, so that a masked p of 0 meets finite values.
template <int NTG>  // one warp group up to 16 n8 tiles: fwd_blocks(NTG) blocks an SM
__global__ void __launch_bounds__(NTG <= 16 ? BW_NT : BW_WG * BW_NT, fwd_blocks(NTG))
fwd_tc_kernel(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rel<bf16> rel,
              const int* __restrict__ tab, Rows<bf16> out, Rows<float> lse, Geo g, TcPlan pl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ks = pl.ks, vs = pl.vs, rs = pl.rs, tk = pl.tk;
  bf16* qo_s = reinterpret_cast<bf16*>(smem_raw);  // BW_ROWS x ks: the queries
  bf16* kb_s = qo_s + BW_ROWS * ks;                // 2 x (tk x ks): key tiles
  bf16* vb_s = kb_s + 2 * tk * ks;                 // 2 x (tk x vs): value tiles
  float* rel_s = reinterpret_cast<float*>(vb_s + 2 * tk * vs);  // BW_ROWS x rs: RC
  int* tok_s = reinterpret_cast<int*>(rel_s + BW_ROWS * rs);    // BW_ROWS x 4: tok_table

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gl = lane >> 2, t = lane & 3;
  const TcBlock tb = tc_block(pl, g.hw);
  VTok vt = tb.vt;
  const int n = vt.n(), q0 = tb.own0;
  const bool packed = pl.pack > 1;
  const int kpos0 = (TN / 16) * pl.nbt * 64 + TN / 16;  // the key positions in a table row
  const TcCols tc = tc_cols(pl, tb, warp, (g.dvh + 7) / 8);
  const int ntg = tc.ntg, w16 = warp % BW_WARPS * 16, ra = w16 + gl;
  const bool active = ntg > 0 && q0 + w16 < n;  // uniform across the warp

  // the queries, their RC rows ((heads-in-lanes) with R staged through the
  // key and value tiles' room, before the first key tile); zeros: the pad
  // columns of the query and key rows (one run of rows), the value tiles
  const size_t tiles_bytes = static_cast<size_t>(2 * tk) * (ks + vs) * sizeof(bf16);
  const bool r_staged = rel.Rw != nullptr;
  auto zeros = [&](bf16* rows, int nr) {
    for (int r = tid; r < nr; r += block_threads())
      for (int c = g.dkh; c < pl.kp; ++c) rows[r * ks + c] = __float2bfloat16(0.f);
    zero_smem(vb_s, static_cast<size_t>(2 * tk) * vs * sizeof(bf16), tid);
  };
  auto stage_tile = [&](int j0, int b) {  // key tile j0 into buffer b
    stage_v(kb_s + b * tk * ks, ks, k, vt, j0, tk, g.dkh, pl.vk, tid, false);
    stage_v(vb_s + b * tk * vs, vs, v, vt, j0, tk, g.dvh, pl.vv, tid, false);
  };
  zeros(qo_s, BW_ROWS + 2 * tk);
  tok_table(tok_s, vt, tid);
  __syncthreads();
  stage_v(qo_s, ks, q, vt, q0, BW_ROWS, g.dkh, pl.vq, tid, false);
  if (!r_staged) stage_tile(0, 0);
  cp_async_wait();
  __syncthreads();
  rc_rows(rel_s, rs, rel, q, qo_s, ks, kb_s, tiles_bytes, vt, q0, g, tid);
  if (r_staged) {  // the tiles' room again: its zeros, the first tile
    __syncthreads();
    zeros(kb_s, 2 * tk);
    __syncthreads();
    stage_tile(0, 0);
    cp_async_wait();
  }
  __syncthreads();

  int pr[2];  // the rows' pairs in the block (packed)
#pragma unroll
  for (int i = 0; i < 2; ++i) pr[i] = tok_s[4 * (ra + 8 * i)];
  const float* rel0 = rel_s + ra * rs;
  const float* rel1 = rel0 + 8 * rs;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[NTG][4];
#pragma unroll
  for (int u = 0; u < NTG; ++u)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[u][i] = 0.f;

  const int ntiles = (n + tk - 1) / tk;
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = it * tk, buf = it & 1;
    if (it + 1 < ntiles) stage_tile(j0 + tk, buf ^ 1);  // under this tile's work
    if (active) {
      const bf16* k_s = kb_s + buf * tk * ks;
      const bf16* v_s = vb_s + buf * tk * vs;
      const int kn = min(tk, n - j0);  // keys of this tile
      float s[4][4] = {};
      s_product(s, qo_s, ks, w16, k_s, ks, pl.kp, (kn + 7) / 8, lane);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt * 8 < tk) {
          const int jv = j0 + nt * 8 + 2 * t;  // keys jv, jv + 1 (one 64-key table row)
          const int2 kp = __ldg(reinterpret_cast<const int2*>(
              tab + static_cast<size_t>(jv / TN) * pl.words + kpos0 + jv % TN));
          const int ca = kp.x & 0xffff, rwa = kp.x >> 16, cb = kp.y & 0xffff, rwb = kp.y >> 16;
          bool ok[4] = {jv < n, jv + 1 < n, jv < n, jv + 1 < n};
          if (packed) {  // each query sees its own pair's keys
            const int pa = jv < n ? tok_s[4 * jv] : -1, pb = jv + 1 < n ? tok_s[4 * jv + 4] : -1;
            ok[0] = ok[0] && pa == pr[0];
            ok[1] = ok[1] && pb == pr[0];
            ok[2] = ok[2] && pa == pr[1];
            ok[3] = ok[3] && pb == pr[1];
          }
          s[nt][0] = ok[0] ? s[nt][0] + (rel0[ca] + rel0[g.W + rwa]) : -INFINITY;
          s[nt][1] = ok[1] ? s[nt][1] + (rel0[cb] + rel0[g.W + rwb]) : -INFINITY;
          s[nt][2] = ok[2] ? s[nt][2] + (rel1[ca] + rel1[g.W + rwa]) : -INFINITY;
          s[nt][3] = ok[3] ? s[nt][3] + (rel1[cb] + rel1[g.W + rwb]) : -INFINITY;
          mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
        }
      }
      float ml[2], alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);  // -inf while a packed row has seen no own key
        ml[i] = mn == -INFINITY ? 0.f : mn * LOG2E;
        alpha[i] = mn == m[i] ? 1.f : exp_shifted(m[i], ml[i]);
        m[i] = mn;
        l[i] *= alpha[i];
      }
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int u = 0; u < NTG; ++u) {
          acc[u][0] *= alpha[0];
          acc[u][1] *= alpha[0];
          acc[u][2] *= alpha[1];
          acc[u][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        if (kc * 16 < kn) {  // uniform across the warp
          uint32_t pa[4];
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float* c = s[2 * kc + half];
            const float p0 = exp_shifted(c[0], ml[0]), p1 = exp_shifted(c[1], ml[0]);
            const float p2 = exp_shifted(c[2], ml[1]), p3 = exp_shifted(c[3], ml[1]);
            l[0] += p0 + p1;
            l[1] += p2 + p3;
            pa[2 * half] = pack_bf16(p0, p1);
            pa[2 * half + 1] = pack_bf16(p2, p3);
          }
          // out += p v over the group's tiles, two a ldmatrix.x4.trans
          const bf16* v_row = v_s + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * vs +
                              (tc.t0 + (lane >> 4)) * 8;
#pragma unroll
          for (int u = 0; u < NTG; u += 2) {
            if (u + 1 < ntg) {
              uint32_t b[4];
              ldsm_x4_trans(b, v_row + u * 8);
              mma16816(acc[u], pa[0], pa[1], pa[2], pa[3], b[0], b[1]);
              mma16816(acc[u + 1], pa[0], pa[1], pa[2], pa[3], b[2], b[3]);
            } else if (u < ntg) {
              uint32_t b0, b1;
              ldsm_x2_trans(b0, b1, v_s + (kc * 16 + (lane & 15)) * vs + (tc.t0 + u) * 8);
              mma16816(acc[u], pa[0], pa[1], pa[2], pa[3], b0, b1);
            }
          }
        }
      }
    }
    cp_async_wait();
    __syncthreads();  // the next tile has landed; this one is consumed
  }

  // out through the tiles' room (all of it consumed): each warp's rows and
  // columns into a tile of the block's rows, row stride os (dvh where the
  // block's out rows are one run of memory, oflat, else dvh rounded up to 8),
  // then copied out by every thread, in copies as wide as the rows allow
  const int os = pl.oflat ? g.dvh : (g.dvh + 7) / 8 * 8;
  const bool via_smem = static_cast<size_t>(BW_ROWS) * os * sizeof(bf16) <= tiles_bytes;
  bf16* o_s = kb_s;
  if (active) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float lr = l[rr];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int r = ra + 8 * rr, vq = q0 + r;
      if (vq >= n) continue;
      const float inv = 1.f / lr;
      if (tc.group == 0 && t == 0) *vt.row(lse, vq) = m[rr] + logf(lr);
      bf16* o = via_smem ? o_s + r * os : vt.row(out, vq);
      const bool pairs = (reinterpret_cast<uintptr_t>(o) & 3) == 0;
#pragma unroll
      for (int u = 0; u < NTG; ++u)
        if (u < ntg) store_pair(o, (tc.t0 + u) * 8 + 2 * t, g.dvh, pairs, acc[u][2 * rr] * inv,
                                acc[u][2 * rr + 1] * inv);
    }
  }
  if (!via_smem) return;
  __syncthreads();
  const int nr = min(BW_ROWS, n - q0), bt = block_threads();
  auto vcopy = [](bf16* d, const bf16* s, int bytes) {
    if (bytes == 16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else if (bytes == 8)
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
    else if (bytes == 4)
      *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
    else
      *d = *s;
  };
  if (pl.oflat) {  // one run: nr * dvh elements from the block's first row
    bf16* dst = vt.row(out, q0);
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
    const int vec = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : a % 4 == 0 ? 4 : 2, per = vec / 2;
    const int total = nr * g.dvh, nvec = total / per;
#pragma unroll 4
    for (int e = tid; e < nvec; e += bt) vcopy(dst + e * per, o_s + e * per, vec);
    for (int e = nvec * per + tid; e < total; e += bt) dst[e] = o_s[e];
    return;
  }
  const int per = pl.vo / 2, nfull = g.dvh / per, cpr = nfull + (g.dvh - nfull * per);
  for (Step st(tid, bt, cpr); st.r < nr; st.next()) {
    const int c0 = st.c < nfull ? st.c * per : nfull * per + (st.c - nfull);
    vcopy(vt.row(out, q0 + st.r) + c0, o_s + st.r * os + c0, st.c < nfull ? pl.vo : 2);
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
// Launches, for the entries of the four sources: (Y, Z) = (bn, 1) head-major
// and (nh, B) heads-in-lanes; the CUDA-core kernels' grid (token tiles x
// output chunks, Y, Z), the tensor-core kernels' one axis (tc_grid).

// The widest copy (16 bytes, or 8, 4, at most cap) that every row of r
// allows, its start and strides included; else the element size (plain loads).
template <typename T>
int copy_bytes(const Rows<T>& r, int cap) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(r.p);
  const long long e = sizeof(T);
  for (int v = cap; v >= 4; v /= 2)
    if (a % v == 0 && r.sz * e % v == 0 && r.sy * e % v == 0 && r.sr * e % v == 0) return v;
  return static_cast<int>(sizeof(T));
}

// The tensor-core kernels, as tc_smem and tc_plan count them.
enum class TcKernel { dq, dkdv, fwd };

// Shared memory of a tensor-core kernel at tk other tokens a tile (rel_bytes:
// the element size of pass dkdv's RC rows).
inline size_t tc_smem(TcKernel kernel, int tk, int ks, int vs, int rs, int rel_bytes) {
  const size_t tab = BW_ROWS * 4 * sizeof(int);
  if (kernel == TcKernel::fwd)
    return static_cast<size_t>(BW_ROWS) * ks * sizeof(bf16) + tab +
           2 * static_cast<size_t>(tk) * (ks + vs) * sizeof(bf16) +
           static_cast<size_t>(BW_ROWS) * rs * sizeof(float);
  const size_t own = static_cast<size_t>(BW_ROWS) * (ks + vs) * sizeof(bf16) + tab;
  if (kernel == TcKernel::dq)
    return own + 2 * static_cast<size_t>(tk) * (ks + vs) * sizeof(bf16) +
           static_cast<size_t>(BW_ROWS) * (rs + 2) * sizeof(float);
  return own + 2 * static_cast<size_t>(tk) *
                   ((ks + vs) * sizeof(bf16) + static_cast<size_t>(rs) * rel_bytes +
                    2 * sizeof(float));
}

// The host's plan of a tensor-core kernel (ops/fused_attention.py::
// wide_fwd_plan, ::wide_bwd_plan, where it is chosen): (batch, head) pairs a
// tile, column groups of the output's n8 tiles, warp groups a block, other
// tokens a tile and the shared memory all that takes; tk 0 sends the call to
// the CUDA-core kernels.
struct WidePlan {
  int pack, groups, wg, tk, smem;
};

// The TcPlan of the host's plan wp for a tensor-core kernel over (Y x Z) pairs
// of the head g, at most cap n8 output tiles a group; false where the
// kernels cannot run it: a pack that overfills a tile, a column group past
// cap or empty, warp groups past BW_WG or the groups, tk other than 16 or 32,
// shared memory other than tc_smem's or past BW_SMEM_MAX, or a grid too
// large.
inline bool tc_plan(TcPlan& pl, TcKernel kernel, const Geo& g, int Y, int Z, int cap,
                    int rel_bytes, const WidePlan& wp) {
  const long long np = static_cast<long long>(Y) * Z;
  pl.Y = Y;
  pl.np = static_cast<int>(np);
  pl.pack = wp.pack;
  if (wp.pack < 1 || (wp.pack > 1 && static_cast<long long>(wp.pack) * g.hw > BW_ROWS) ||
      wp.groups < 1 || wp.wg < 1 || wp.wg > BW_WG || wp.wg > wp.groups ||
      (wp.tk != 16 && wp.tk != 32))
    return false;
  pl.kp = (g.dkh + 15) / 16 * 16;
  pl.vp = (g.dvh + 15) / 16 * 16;
  pl.ks = pl.kp + 8;
  pl.vs = pl.vp + 8;
  pl.rs = rel_stride_of(g.W, g.H);
  pl.nbt = bin_tiles(g.W, g.H);
  pl.words = key_table_words(pl.nbt);
  const int ndk = (g.dkh + 7) / 8, ndv = (g.dvh + 7) / 8;  // the output's n8 tiles
  const int tiles = kernel == TcKernel::dq ? ndk : kernel == TcKernel::dkdv ? ndk + ndv : ndv;
  pl.ngroup = wp.groups;
  pl.ntg = (tiles + pl.ngroup - 1) / pl.ngroup;
  if (pl.ntg > cap || (pl.ngroup - 1) * pl.ntg >= tiles) return false;
  pl.wg = wp.wg;
  pl.gblocks = (pl.ngroup + pl.wg - 1) / pl.wg;
  pl.ntile = pl.pack > 1 ? 1 : (g.hw + BW_ROWS - 1) / BW_ROWS;
  const long long npg = pl.pack > 1 ? (np + pl.pack - 1) / pl.pack : np;
  if (np > 0x7fffffff || npg * pl.ntile * pl.gblocks > 0x7fffffff) return false;
  pl.tk = wp.tk;
  const size_t smem = tc_smem(kernel, pl.tk, pl.ks, pl.vs, pl.rs, rel_bytes);
  return smem == static_cast<size_t>(wp.smem) && smem <= BW_SMEM_MAX;
}

inline dim3 tc_grid(const TcPlan& pl) {
  const long long npg = pl.pack > 1 ? (static_cast<long long>(pl.np) + pl.pack - 1) / pl.pack
                                    : pl.np;
  return dim3(static_cast<unsigned>(npg * pl.ntile * pl.gblocks));
}

template <int NTG>
int fwd_tc(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rel<bf16> rel,
           const int* tab, Rows<bf16> out, Rows<float> lse, Geo g, const TcPlan& pl,
           void* stream) {
  const size_t smem = tc_smem(TcKernel::fwd, pl.tk, pl.ks, pl.vs, pl.rs, 4);
  auto kern = fwd_tc_kernel<NTG>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<tc_grid(pl), pl.wg * BW_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, rel, tab, out, lse, g, pl);
  return static_cast<int>(cudaGetLastError());
}

// The forward. wp: the host's plan (WidePlan); tk 0 runs the CUDA-core
// kernel, which f32 always does. The tensor-core kernel is instantiated for
// 8, 12, 16 and 32 n8 tiles of out a warp (FWD_NTG: the least that holds the
// plan's column group; 32 for two warp groups a block), so that narrow heads
// keep few registers and fwd_blocks blocks an SM.
template <typename T>
int fwd(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rel<T> rel, const int* tab,
        Rows<T> out, Rows<float> lse, Geo g, int Y, int Z, const WidePlan& wp, void* stream) {
  if (wp.tk != 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      TcPlan pl;
      if (!mma_fits(g.W, g.H) || tab == nullptr ||
          reinterpret_cast<uintptr_t>(tab) % 16 != 0 ||
          !tc_plan(pl, TcKernel::fwd, g, Y, Z, NTO, 4, wp))
        return static_cast<int>(cudaErrorInvalidValue);
      pl.vq = copy_bytes(q, 16);
      pl.vk = copy_bytes(k, 16);
      pl.vv = copy_bytes(v, 16);
      pl.vdo = pl.vrel = 0;
      pl.vo = copy_bytes(out, 16);
      const long long run = static_cast<long long>(g.hw) * g.dvh;  // a pair's out rows, one run
      pl.oflat = out.sr == g.dvh && (Y == 1 ? out.sz == run : Z == 1 && out.sy == run);
      if (pl.wg == 1 && pl.ntg <= FWD_NTG[0])
        return fwd_tc<FWD_NTG[0]>(q, k, v, rel, tab, out, lse, g, pl, stream);
      if (pl.wg == 1 && pl.ntg <= FWD_NTG[1])
        return fwd_tc<FWD_NTG[1]>(q, k, v, rel, tab, out, lse, g, pl, stream);
      if (pl.wg == 1 && pl.ntg <= FWD_NTG[2])
        return fwd_tc<FWD_NTG[2]>(q, k, v, rel, tab, out, lse, g, pl, stream);
      return fwd_tc<FWD_NTG[3]>(q, k, v, rel, tab, out, lse, g, pl, stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
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

template <int NBT, int NTG>
int dq_tc(Rows<const bf16> q, Rows<const bf16> k, Rows<const bf16> v, Rows<const bf16> dout,
          Rows<const float> lse, Rows<const float> delta, Rel<bf16> rel, const int* tab,
          DqOut<bf16> dst, Geo g, const TcPlan& pl, void* stream) {
  const size_t smem = tc_smem(TcKernel::dq, pl.tk, pl.ks, pl.vs, pl.rs, 4);
  auto kern = dq_tc_kernel<NBT, NTG>;
  const cudaError_t e = amma::allow_smem(kern, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kern<<<tc_grid(pl), pl.wg * BW_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, dout, lse, delta, rel, tab, dst, g, pl);
  return static_cast<int>(cudaGetLastError());
}

// wp: the host's plan of the pass (WidePlan); tk 0 runs the CUDA-core kernel,
// which f32 always does.
template <typename T>
int dq(Rows<const T> q, Rows<const T> k, Rows<const T> v, Rows<const T> dout,
       Rows<const float> lse, Rows<const float> delta, Rel<T> rel, const int* tab, DqOut<T> dst,
       Geo g, int Y, int Z, const WidePlan& wp, void* stream) {
  if (wp.tk != 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      const bool few_bins = bin_tiles(g.W, g.H) <= 4;
      TcPlan pl;
      if (!mma_fits(g.W, g.H) || tab == nullptr ||
          reinterpret_cast<uintptr_t>(tab) % 16 != 0 ||
          !tc_plan(pl, TcKernel::dq, g, Y, Z, few_bins ? NTO : NTO_BINS, 4, wp))
        return static_cast<int>(cudaErrorInvalidValue);
      pl.vq = copy_bytes(q, 16);
      pl.vk = copy_bytes(k, 16);
      pl.vv = copy_bytes(v, 16);
      pl.vdo = copy_bytes(dout, 16);
      pl.vrel = 4;
      if (few_bins)
        return dq_tc<4, NTO>(q, k, v, dout, lse, delta, rel, tab, dst, g, pl, stream);
      return dq_tc<MAX_BIN_TILES, NTO_BINS>(q, k, v, dout, lse, delta, rel, tab, dst, g, pl,
                                            stream);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
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
         Geo g, int Y, int Z, const WidePlan& wp, void* stream) {
  if (wp.tk != 0) {
    if constexpr (std::is_same<T, bf16>::value) {
      TcPlan pl;
      if (!mma_fits(g.W, g.H) || !tc_plan(pl, TcKernel::dkdv, g, Y, Z, NTO, sizeof(RT), wp))
        return static_cast<int>(cudaErrorInvalidValue);
      pl.vq = copy_bytes(q, 16);
      pl.vk = copy_bytes(k, 16);
      pl.vv = copy_bytes(v, 16);
      pl.vdo = copy_bytes(dout, 16);
      pl.vrel = copy_bytes(rcl, sizeof(RT) == 2 ? 8 : 16);  // bf16 RC rows: 8-byte rows in smem
      const size_t smem = static_cast<size_t>(wp.smem);
      auto kern = dkdv_tc_kernel<RT>;
      const cudaError_t e = amma::allow_smem(kern, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      kern<<<tc_grid(pl), pl.wg * BW_NT, smem, static_cast<cudaStream_t>(stream)>>>(
          q, k, v, dout, lse, delta, rcl, dst, g, pl);
      return static_cast<int>(cudaGetLastError());
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
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
