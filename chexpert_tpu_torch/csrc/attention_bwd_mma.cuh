// The tensor-core tile arithmetic of the two attention backward kernels,
// rel_attention_bwd.cu (head-major operands) and hil_attention_bwd.cu
// (heads-in-lanes operands), bf16 in and f32 sums, for sm_90a.
//
// Both compute, per (batch, head),
//   S = q k^T + RC_w[t, col(j)] + RC_h[t, row(j)],  p = exp(S - lse)
//   dv = p^T dout,  dp = dout v^T,  ds = p (dp - delta),  dk = ds^T q,  dq = ds k
//   dRC_w[t, c] = sum_{col(j)=c} ds[t, j],  dRC_h[t, r] = sum_{row(j)=r} ds[t, j]
// and differ in where the operands live and what is written. This header
// holds what they share: the fragment helpers of mma.sync.m16n8k16, the
// shared-memory tile layouts, and the two inner loops. Each .cu stages its
// own operands into the tiles and writes its own outputs.
//
// Every product runs on the tensor cores; a warp owns 16 rows of the block's
// tile and walks the other side 8 columns at a time:
//   pass dq   (DqWarp):   rows are queries. S = q k^T and dp = dout v^T are
//     accumulator fragments; after exp and the ds formula the fragment of two
//     neighbouring 8-key tiles IS the A fragment (16 queries x 16 keys) of the
//     next products, so ds never leaves registers: dq += ds k, and the bins
//     dRC += ds onehot(keys -> W+H). The one-hot B fragments depend on the
//     map alone, so they come ready-made from a table (see KeyTable) and only
//     the 8-bin tiles that the 16 keys touch are multiplied.
//   pass dkdv (DkdvWarp): rows are keys. S^T = k q^T and dp^T = v dout^T; the
//     fragments of p^T and ds^T are the A operands of dv += p^T dout and
//     dk += ds^T q, contraction over the queries.
// The transposed B operands (k, q, dout as [contraction][column]) come out of
// the same row-major tiles through ldmatrix.trans. The relative logits are
// added to each accumulator element from the tile's RC rows in shared memory
// (two reads per element), in the type the caller holds them in: f32 rows
// computed in the block (heads-in-lanes) or the bf16 RW / RH lanes of qr as
// they stand (head-major). Tiles are staged by cp.async where the rows are
// 8-byte aligned, by 2-byte loads otherwise. Pass dkdv (two blocks of 8 warps
// per SM) double-buffers its query tiles: the next one is on its way while
// this one is consumed. Pass dq (four blocks of 4 warps) keeps one buffer: its
// blocks cover each other's staging, and a second buffer measured 2.5 %.
//
// The head widths come from the build: each width class (KW, VW) of
// ops/fused_attention.py::width_plan is its own library, compiled with
// -DATTN_KW=KW -DATTN_VW=VW, and takes every dkh <= KW and dvh <= VW, passed at
// run time, in the kernels of the .cu files; a head past the largest class
// runs in that class's library (attention_wide.cuh: the forward and the
// backward passes with their own tiles over the whole head). Padding lives in shared
// memory only: dkh -> KW as a contraction
// (KW / 16 k16 steps) and -> 8 * ND as an output width (ND n8 tiles), dvh -> VW
// as a width (VW / 8 n8 tiles) and -> 16 as a contraction where VW is 8 (the
// upper half of the fragment is the constant 0), ragged token tails as zero
// rows with lse = LSE_PAD (so p = 0) and masked stores. A row of dkh or dvh
// bf16 is 8-byte aligned only where the width is a multiple of 4: other
// widths (dkh 26) are staged by 2-byte loads. p and ds are rounded to bf16
// once, where they become MMA operands; every sum is f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#ifndef ATTN_KW
#error "build with -DATTN_KW=<32|64|128> -DATTN_VW=<8|16|32|64> (fused_attention.py::width_class)"
#endif
#ifndef ATTN_VW
#error "build with -DATTN_VW=<8|16|32|64> (ops/fused_attention.py::width_class)"
#endif

namespace amma {

typedef __nv_bfloat16 bf16;

constexpr int KW = ATTN_KW;      // staged columns of a dkh-wide tile: dkh <= KW, KW / 16 k16 steps
constexpr int VW = ATTN_VW;      // staged columns of a dvh-wide tile: dvh <= VW
static_assert(KW == 32 || KW == 64 || KW == 128, "KW: a width class of ops/fused_attention.py");
static_assert(VW == 8 || VW == 16 || VW == 32 || VW == 64, "VW: a width class");
constexpr int KS = KW + 8;       // bf16 row stride of a dkh-wide tile: columns dkh..KW-1 are
                                 // zero, KW..KS-1 spread the rows over the banks
constexpr int VS = VW == 8 ? 8 : VW + 8;  // bf16 row stride of a dvh-wide tile (zero beyond dvh)
constexpr int KK = KW / 16;      // k16 steps of a product over dkh
constexpr int VK = (VW + 15) / 16;  // k16 steps of a product over dvh (VW 8: one, half of it 0)
constexpr int NV = VW / 8;       // n8 tiles of a dvh-wide output
constexpr int TN = 64;           // rows of the tile a pass loops over
constexpr int DQ_WARPS = 4;      // pass dq: 64 queries a block
constexpr int DKDV_WARPS = 8;    // pass dkdv: 128 keys a block
constexpr int DKDV_MIN_BLOCKS = KW == 32 ? 2 : 1;  // pass dkdv blocks per SM (registers)
constexpr int DQ_ROWS = DQ_WARPS * 16;
constexpr int DKDV_ROWS = DKDV_WARPS * 16;
constexpr int MAX_BIN_TILES = 16;  // ceil(W/8) + ceil(H/8) that pass dq is instantiated for
constexpr float LSE_PAD = 1e30f;   // lse of a padded query row: exp(S - LSE_PAD) == 0
constexpr float LOG2E = 1.4426950408889634f;

// The model zoo's head width (min_dk_per_head). Every kernel has an
// instantiation that takes it as a compile-time constant (DKC = DK_ZOO; DKC =
// 0 reads dkh at run time), so the zoo's attention runs the code it was tuned
// as, with its offsets and row widths folded in.
constexpr int DK_ZOO = 20;

// The n8 tiles of a dkh-wide output (dq, dk), a template argument of the
// backward passes: KW / 8, and in the narrowest class 3 where dkh <= 24, so
// that the model zoo's dkh 20 keeps the tiles and registers it was tuned with.
constexpr int ND_SMALL = KW == 32 ? 3 : KW / 8;
inline int nd_tiles(int dkh) { return dkh <= 8 * ND_SMALL ? ND_SMALL : KW / 8; }

// The f32 row stride of the RC tile: >= W + H and = 4 mod 8, so that the
// reads of pass dkdv (rows 2t, columns g) fall on 32 distinct banks and
// those of pass dq (rows g, columns 2t) on 16.
inline int rel_stride_of(int W, int H) {
  const int s = W + H;
  return s + ((4 - s % 8) + 8) % 8;
}

__host__ __device__ inline int bin_tiles(int W, int H) { return (W + 7) / 8 + (H + 7) / 8; }

// The rule that sends a bf16 map to the tensor-core kernels, forwards and
// backwards alike: a number of bin tiles that pass dq is instantiated for
// (every map up to 64x64). Larger maps, and f32, take the CUDA-core kernels.
// ops/fused_attention.py::on_tensor_cores states the same rule.
inline bool mma_fits(int W, int H) { return bin_tiles(W, H) <= MAX_BIN_TILES; }

// The bf16 row stride of a tile of whole head-major qr rows [q ; RW ; RH]: >= L
// and >= KW (the q fragments read KW columns; what lies past dkh meets the
// zeros of k), and = 8 mod 16, which keeps rows 16-byte aligned for ldmatrix
// and spreads the fragment reads (rows g, words t) and the RC reads over the
// banks.
inline int qr_stride_of(int L) {
  const int x = L > KW ? L : KW;
  return x + ((8 - x % 16) + 16) % 16;
}

inline int aligned8(const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// Asynchronous copies of BYTES (4, 8 or 16; both addresses aligned to it) from
// device to shared memory; cp_async_wait waits for all of this thread's.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst_smem, const void* src) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(dst_smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(addr), "l"(src), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// exp(s - lse) as one multiply-add and one ex2: lse2 = lse * LOG2E.
__device__ __forceinline__ float exp_shifted(float s, float lse2) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(fmaf(s, LOG2E, -lse2)));
  return y;
}

// Two neighbouring RC lanes in one load (the address is aligned to the pair).
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const bf16* p, float& a, float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16 x 16, row-major fragments) * b (16 x 8): lane = 4 g + t holds
//   a0 (row g, k 2t..2t+1)  a1 (row g+8, same k)  a2 (row g, k 2t+8..)  a3 (row g+8, k 2t+8..)
//   b0 (k 2t..2t+1, column g)  b1 (k 2t+8.., column g)
//   c0 (row g, column 2t)  c1 (row g, 2t+1)  c2 (row g+8, 2t)  c3 (row g+8, 2t+1)
__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The B fragment (16 x 8) of a row-major tile read as [contraction][column]:
// lanes 0..15 name the 16 contraction rows, each 8 bf16 (16 bytes) wide.
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// rows_valid rows of cpr chunks of BYTES bytes each (both sides aligned to
// BYTES, strides in bytes) by cp.async, complete after cp_async_wait. The
// threads form a grid of rows x (cpr rounded up to a power of two) chunks, so
// no thread divides by cpr.
template <int BYTES>
__device__ __forceinline__ void cp_rows(void* dst, int dst_stride, const void* src,
                                        size_t src_stride, int rows_valid, int cpr, int tid,
                                        int nthreads) {
  int lg = 0;
  while ((1 << lg) < cpr) ++lg;
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if ((nthreads >> lg) > 0) {
    const int c = tid & ((1 << lg) - 1);
    if (c < cpr)
      for (int r = tid >> lg; r < rows_valid; r += nthreads >> lg)
        cp_async<BYTES>(d + r * dst_stride + c * BYTES, s + r * src_stride + c * BYTES);
  } else {  // a row wider than the block: one row at a time
    for (int r = 0; r < rows_valid; ++r)
      for (int c = tid; c < cpr; c += nthreads)
        cp_async<BYTES>(d + r * dst_stride + c * BYTES, s + r * src_stride + c * BYTES);
  }
}

// cols (a multiple of 4 when vec) bf16 of each of rows_valid rows into a tile
// of row stride dst_stride. vec: 8-byte cp.async (the caller has checked that
// both sides are 8-byte aligned, strides included), complete after
// cp_async_wait; else 2-byte loads. Columns from cols on are left as they are.
__device__ __forceinline__ void stage_rows(bf16* dst, int dst_stride,
                                           const bf16* __restrict__ src, size_t src_stride,
                                           int rows_valid, int cols, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    cp_rows<8>(dst, dst_stride * 2, src, src_stride * 2, rows_valid, cols >> 2, tid, nthreads);
  } else {
#pragma unroll 4
    for (int e = tid; e < rows_valid * cols; e += nthreads) {
      const int r = e / cols, c = e - r * cols;
      dst[r * dst_stride + c] = src[r * src_stride + c];
    }
  }
}

// Zero a whole bf16 tile.
__device__ __forceinline__ void zero_tile(bf16* dst, int n, int tid, int nthreads) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < n; e += nthreads) dst[e] = zero;
}

// Zero the columns [0, cols) of rows [row0, row1) of a bf16 tile.
__device__ __forceinline__ void zero_rows(bf16* dst, int dst_stride, int row0, int row1,
                                          int cols, int tid, int nthreads) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < (row1 - row0) * cols; e += nthreads) {
    const int r = e / cols, c = e - r * cols;
    dst[(row0 + r) * dst_stride + c] = zero;
  }
}

// rows x VS of a dvh-wide operand (v or dout); zero beyond dvh and rows_valid.
__device__ __forceinline__ void stage_dv(bf16* dst, const bf16* __restrict__ src,
                                         size_t src_stride, int dvh, int rows_valid, int rows,
                                         int tid, int nthreads) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int e = tid; e < rows * VS; e += nthreads) {
    const int r = e / VS, c = e - r * VS;
    dst[e] = (r < rows_valid && c < dvh) ? src[r * src_stride + c] : zero;
  }
}

// The same in two halves, for a tile that is loaded while another is being
// consumed: the loads into N = rows * VS / nthreads registers before the
// work, the stores into the free buffer after it.
template <int N>
__device__ __forceinline__ void load_dv(bf16 (&regs)[N], const bf16* __restrict__ src,
                                        size_t src_stride, int dvh, int rows_valid, int tid,
                                        int nthreads) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int e = tid + i * nthreads;
    const int r = e / VS, c = e - r * VS;
    regs[i] = (r < rows_valid && c < dvh) ? src[r * src_stride + c] : __float2bfloat16(0.f);
  }
}

template <int N>
__device__ __forceinline__ void store_dv(bf16* dst, const bf16 (&regs)[N], int tid,
                                         int nthreads) {
#pragma unroll
  for (int i = 0; i < N; ++i) dst[tid + i * nthreads] = regs[i];
}

// (lse, delta) pairs of rows query rows by 4-byte cp.async (complete after
// cp_async_wait); padded rows get (LSE_PAD, 0).
__device__ __forceinline__ void stage_ld(float* ld_s, const float* __restrict__ lse,
                                         const float* __restrict__ delta, int rows_valid,
                                         int rows, int tid, int nthreads) {
  for (int r = tid; r < rows; r += nthreads) {
    if (r < rows_valid) {
      cp_async<4>(ld_s + 2 * r, lse + r);
      cp_async<4>(ld_s + 2 * r + 1, delta + r);
    } else {
      ld_s[2 * r] = LSE_PAD;
      ld_s[2 * r + 1] = 0.f;
    }
  }
}

// What pass dq needs to know of a tile of TN keys, one row of a table that
// depends on the map (H, W) alone and is built once by the host side
// (ops/fused_attention.py::key_table), as 32-bit words:
//   [TN/16 chunks][nbt bin tiles][32 lanes][2]  the B fragments (b0, b1) of
//        onehot(16 keys -> 8 bins) in bf16: bin tiles are ceil(W/8) tiles of
//        image columns, then ceil(H/8) of image rows; nbt of them in all
//   [TN/16]  per chunk, bit nb set where its keys touch bin tile nb
//   [TN]     per key, image column | row << 16 (0 past hw)
// A row is a multiple of 16 bytes and is staged by one flat cp.async sweep.
struct KeyTable {
  const uint2* frags;
  const unsigned* touched;
  const int* kpos;
};

__host__ __device__ inline int key_table_words(int nbt) {
  return (TN / 16) * nbt * 64 + TN / 16 + TN;
}

__device__ __forceinline__ KeyTable key_table_at(const int* tab_s, int nbt) {
  KeyTable kt;
  kt.frags = reinterpret_cast<const uint2*>(tab_s);
  kt.touched = reinterpret_cast<const unsigned*>(tab_s + (TN / 16) * nbt * 64);
  kt.kpos = tab_s + (TN / 16) * nbt * 64 + TN / 16;
  return kt;
}

// The table row of key tile number `tile` into tab_s (complete after
// cp_async_wait); both 16-byte aligned.
__device__ __forceinline__ void stage_key_table(int* tab_s, const int* __restrict__ tab,
                                                int tile, int nbt, int tid, int nthreads) {
  const int words = key_table_words(nbt);
  const int* src = tab + static_cast<size_t>(tile) * words;
  for (int e = tid * 4; e < words; e += nthreads * 4) cp_async<16>(tab_s + e, src + e);
}

// The A fragments (16 rows x KW columns, KK k16 steps) of a bf16 tile of
// row stride stride: fragment rows g and g+8 are the tile's rows ra and rb.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[KK][4], const bf16* tile, int stride,
                                             int ra, int rb, int t) {
#pragma unroll
  for (int ks = 0; ks < KK; ++ks) {
    a[ks][0] = lds32(tile + ra * stride + ks * 16 + 2 * t);
    a[ks][1] = lds32(tile + rb * stride + ks * 16 + 2 * t);
    a[ks][2] = lds32(tile + ra * stride + ks * 16 + 8 + 2 * t);
    a[ks][3] = lds32(tile + rb * stride + ks * 16 + 8 + 2 * t);
  }
}

// The same over a dvh-wide tile (row stride VS): 16 rows x VW columns, VK
// k16 steps; where VW is 8 the upper half of the step is the constant 0.
__device__ __forceinline__ void load_v_frags(uint32_t (&a)[VK][4], const bf16* tile, int ra,
                                             int rb, int t) {
#pragma unroll
  for (int vk = 0; vk < VK; ++vk) {
    a[vk][0] = lds32(tile + ra * VS + vk * 16 + 2 * t);
    a[vk][1] = lds32(tile + rb * VS + vk * 16 + 2 * t);
    a[vk][2] = VW > 8 ? lds32(tile + ra * VS + vk * 16 + 8 + 2 * t) : 0u;
    a[vk][3] = VW > 8 ? lds32(tile + rb * VS + vk * 16 + 8 + 2 * t) : 0u;
  }
}

// c += a (16 x VW, load_v_frags) * the 8 rows of a dvh-wide tile as
// [contraction][column]: row is the tile + (row of column g) * VS + 2t.
__device__ __forceinline__ void mma_v(float (&c)[4], const uint32_t (&a)[VK][4],
                                      const bf16* row) {
#pragma unroll
  for (int vk = 0; vk < VK; ++vk)
    mma16816(c, a[vk][0], a[vk][1], a[vk][2], a[vk][3], lds32(row + vk * 16),
             VW > 8 ? lds32(row + vk * 16 + 8) : 0u);
}

// c += a (16 x KW, load_a_frags) * the 8 rows of a dkh-wide tile as
// [contraction][column]: row is the tile + (row of column g) * stride + 2t.
__device__ __forceinline__ void mma_k(float (&c)[4], const uint32_t (&a)[KK][4],
                                      const bf16* row) {
#pragma unroll
  for (int ks = 0; ks < KK; ++ks)
    mma16816(c, a[ks][0], a[ks][1], a[ks][2], a[ks][3], lds32(row + ks * 16),
             lds32(row + ks * 16 + 8));
}

// Whether the RC lanes of rel_s can be read two at a time (load_pair): W even
// (two keys of a pair sit in one image row) and the lanes 4-byte aligned,
// which a bf16 tile of head-major qr rows is not at an odd dkh.
template <typename RelT>
__device__ __forceinline__ bool rc_paired(const RelT* rel_s, int W) {
  return (W & 1) == 0 && (reinterpret_cast<uintptr_t>(rel_s) & 3) == 0;
}

// ---------------------------------------------------------------------------
// Pass dq: a warp's 16 query rows against key tiles.

template <int NBT, int ND>
struct DqWarp {
  uint32_t qa[KK][4];   // A fragments of q
  uint32_t doa[VK][4];  // A fragments of dout
  float lse[2], delta[2];  // of rows g and g+8; lse times LOG2E
  float dq[ND][4];      // ND n8 tiles cover dkh
  float bins[NBT][4];   // tiles of [dRC_w | dRC_h]: ceil(W/8) column tiles, then the row tiles
};

template <int NBT, int ND>
__device__ __forceinline__ void dq_init(DqWarp<NBT, ND>& st, const bf16* q_s, int qs,
                                        const bf16* do_s, const float* ld_s, int warp,
                                        int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
  load_a_frags(st.qa, q_s, qs, r0, r0 + 8, t);
  load_v_frags(st.doa, do_s, r0, r0 + 8, t);
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
}

// ds of the n8 tile of keys n0 .. n0 + 7 from its products s = q k^T and dp
// = dout v^T (rows g, g + 8 x keys n0 + 2t, n0 + 2t + 1): the relative
// logits, p = exp(S - lse), ds = p (dp - delta), packed as the A-fragment
// words ds0 (row g) and ds1 (row g + 8). rel0 / rel1: the RC rows of rows g
// and g + 8; paired: rc_paired of the RC tile.
template <int NBT, int ND, typename RelT>
__device__ __forceinline__ void dq_ds(const DqWarp<NBT, ND>& st, const float (&s)[4],
                                      const float (&dp)[4], int n0, const KeyTable& kt,
                                      const RelT* rel0, const RelT* rel1, bool paired, int W,
                                      int kn, int t, uint32_t& ds0, uint32_t& ds1) {
  const int2 kp = *reinterpret_cast<const int2*>(kt.kpos + n0 + 2 * t);
  const int ca = kp.x & 0xffff, ra = kp.x >> 16;
  const int cb = kp.y & 0xffff, rb = kp.y >> 16;
  const bool va = n0 + 2 * t < kn, vb = n0 + 2 * t + 1 < kn;
  float s0, s1, s2, s3;
  if (paired) {  // W even: keys 2t and 2t+1 are neighbours in one image row
    float c0a, c0b, c1a, c1b;
    load_pair(rel0 + ca, c0a, c0b);
    load_pair(rel1 + ca, c1a, c1b);
    const float r0r = to_f(rel0[W + ra]), r1r = to_f(rel1[W + ra]);
    s0 = s[0] + c0a + r0r;
    s1 = s[1] + c0b + r0r;
    s2 = s[2] + c1a + r1r;
    s3 = s[3] + c1b + r1r;
  } else {
    s0 = s[0] + to_f(rel0[ca]) + to_f(rel0[W + ra]);
    s1 = s[1] + to_f(rel0[cb]) + to_f(rel0[W + rb]);
    s2 = s[2] + to_f(rel1[ca]) + to_f(rel1[W + ra]);
    s3 = s[3] + to_f(rel1[cb]) + to_f(rel1[W + rb]);
  }
  const float p0 = va ? exp_shifted(s0, st.lse[0]) : 0.f;
  const float p1 = vb ? exp_shifted(s1, st.lse[0]) : 0.f;
  const float p2 = va ? exp_shifted(s2, st.lse[1]) : 0.f;
  const float p3 = vb ? exp_shifted(s3, st.lse[1]) : 0.f;
  ds0 = pack_bf16(p0 * (dp[0] - st.delta[0]), p1 * (dp[1] - st.delta[0]));
  ds1 = pack_bf16(p2 * (dp[2] - st.delta[1]), p3 * (dp[3] - st.delta[1]));
}

// dq += ds k and the bins for the 16 keys of chunk kc of the tile, dsa their
// ds as an A fragment (dq_ds of its two n8 tiles); k_s and kt as dq_step
// takes them.
template <int NBT, int ND>
__device__ __forceinline__ void dq_accumulate(DqWarp<NBT, ND>& st, const uint32_t (&dsa)[4],
                                              int kc, const bf16* k_s, const KeyTable& kt,
                                              int nbt, int lane) {
  // dq += ds k: k as [key][d] through ldmatrix.trans
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    uint32_t b0, b1;
    ldsm_x2_trans(b0, b1, k_s + (kc * 16 + (lane & 15)) * KS + nd * 8);
    mma16816(st.dq[nd], dsa[0], dsa[1], dsa[2], dsa[3], b0, b1);
  }
  // the bins: dRC += ds onehot, over the bin tiles these 16 keys touch
  const unsigned touched = kt.touched[kc];
  const uint2* oh = kt.frags + kc * nbt * 32 + lane;
#pragma unroll
  for (int nb = 0; nb < NBT; ++nb) {
    if ((touched >> nb) & 1u) {  // uniform across the block
      const uint2 b = oh[nb * 32];
      mma16816(st.bins[nb], dsa[0], dsa[1], dsa[2], dsa[3], b.x, b.y);
    }
  }
}

// One key tile: k_s (TN x KS), v_s (TN x VS) and its table row kt, of which
// kn keys exist; rel_s holds the RC rows of the block's queries; nbt bin
// tiles (<= NBT).
template <int NBT, int ND, typename RelT>
__device__ __forceinline__ void dq_step(DqWarp<NBT, ND>& st, const bf16* k_s, const bf16* v_s,
                                        const KeyTable& kt, const RelT* rel_s, int rel_stride,
                                        int W, int nbt, int kn, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const RelT* rel0 = rel_s + (warp * 16 + g) * rel_stride;
  const RelT* rel1 = rel0 + 8 * rel_stride;
  const bool paired = rc_paired(rel_s, W);  // rel_s + even offsets are aligned to a pair of lanes
#pragma unroll
  for (int kc = 0; kc < TN / 16; ++kc) {
    if (kc * 16 < kn) {  // uniform across the block
      uint32_t dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = kc * 16 + half * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_k(s, st.qa, k_s + (n0 + g) * KS + 2 * t);
        mma_v(dp, st.doa, v_s + (n0 + g) * VS + 2 * t);
        dq_ds(st, s, dp, n0, kt, rel0, rel1, paired, W, kn, t, dsa[2 * half], dsa[2 * half + 1]);
      }
      dq_accumulate(st, dsa, kc, k_s, kt, nbt, lane);
    }
  }
}

// The f32 row stride of dq rows dumped to shared memory (dq_dump).
template <int ND>
__host__ __device__ constexpr int dq_stride() { return ND * 8 + 1; }

// The warp's dq sums into shared memory: dq_s (rows x dq_stride, columns
// 0 .. 8 ND - 1).
template <int NBT, int ND>
__device__ __forceinline__ void dq_dump(const DqWarp<NBT, ND>& st, float* dq_s, int warp,
                                        int lane) {
  constexpr int DQS = dq_stride<ND>();
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int d = nd * 8 + 2 * t;
    dq_s[r0 * DQS + d] = st.dq[nd][0];
    dq_s[r0 * DQS + d + 1] = st.dq[nd][1];
    dq_s[(r0 + 8) * DQS + d] = st.dq[nd][2];
    dq_s[(r0 + 8) * DQS + d + 1] = st.dq[nd][3];
  }
}

// A warp's bins (NBT 8-wide tiles: ceil(W/8) of image columns, then rows)
// into shared memory: bin_s (rows x bin_stride, [dRC_w (W) | dRC_h (H)]).
template <int NBT>
__device__ __forceinline__ void bins_store(const float (&bins)[NBT][4], float* bin_s,
                                           int bin_stride, int W, int H, int nbw, int warp,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int nb = 0; nb < NBT; ++nb) {
    const bool is_col = nb < nbw;
    const int idx = (is_col ? nb : nb - nbw) * 8 + 2 * t;
    const int lim = is_col ? W : H;
    float* b0 = bin_s + r0 * bin_stride + (is_col ? 0 : W);
    float* b1 = b0 + 8 * bin_stride;
    if (idx < lim) {
      b0[idx] = bins[nb][0];
      b1[idx] = bins[nb][2];
    }
    if (idx + 1 < lim) {
      b0[idx + 1] = bins[nb][1];
      b1[idx + 1] = bins[nb][3];
    }
  }
}

template <int NBT, int ND>
__device__ __forceinline__ void bins_dump(const DqWarp<NBT, ND>& st, float* bin_s, int bin_stride,
                                          int W, int H, int nbw, int warp, int lane) {
  bins_store(st.bins, bin_s, bin_stride, W, H, nbw, warp, lane);
}

// ---------------------------------------------------------------------------
// Pass dkdv: a warp's 16 key rows against query tiles.

// Fragment rows g and g+8 of a warp hold its keys 2g and 2g+1 (not g and
// g+8): two neighbouring tokens, so where W is even their RC lanes of a query
// come in one load and they share the row's lane. dkdv_key names the key.
__device__ __forceinline__ int dkdv_key(int warp, int lane, int i) {
  return warp * 16 + 2 * (lane >> 2) + i;
}

template <int ND>
struct DkdvWarp {
  uint32_t ka[KK][4];  // A fragments of k
  uint32_t va[VK][4];  // A fragments of v
  int c[2], r[2];      // image column and row of the thread's two keys
  bool ok[2];          // those keys exist
  float dk[ND][4];     // ND n8 tiles cover dkh
  float dv[NV][4];
};

// k_s (DKDV_ROWS x KS) and v_s (DKDV_ROWS x VS) hold the block's keys key0 ..
template <int ND>
__device__ __forceinline__ void dkdv_init(DkdvWarp<ND>& st, const bf16* k_s, const bf16* v_s,
                                          int key0, int hw, int W, int warp, int lane) {
  const int t = lane & 3;
  const int r0 = dkdv_key(warp, lane, 0), r1 = dkdv_key(warp, lane, 1);
  load_a_frags(st.ka, k_s, KS, r0, r1, t);
  load_v_frags(st.va, v_s, r0, r1, t);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = key0 + dkdv_key(warp, lane, i);
    st.ok[i] = j < hw;
    st.c[i] = st.ok[i] ? j % W : 0;
    st.r[i] = st.ok[i] ? j / W : 0;
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.dk[nd][i] = 0.f;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv)
#pragma unroll
    for (int i = 0; i < 4; ++i) st.dv[nv][i] = 0.f;
}

// p^T and ds^T of the n8 tile of queries n0 .. n0 + 7 from its products s =
// k q^T and dp = v dout^T (the thread's keys x queries n0 + 2t, n0 + 2t + 1):
// the relative logits, p = exp(S - lse), ds = p (dp - delta), packed as the
// A-fragment words p0 / ds0 (the first key) and p1 / ds1 (the second). ld_s,
// rel_s as dkdv_step takes them; paired: rc_paired of the RC tile.
template <int ND, typename RelT>
__device__ __forceinline__ void dkdv_ds(const DkdvWarp<ND>& st, const float (&s)[4],
                                        const float (&dp)[4], int n0, const float* ld_s,
                                        const RelT* rel_s, int rel_stride, bool paired, int W,
                                        int t, uint32_t& p0w, uint32_t& p1w, uint32_t& ds0,
                                        uint32_t& ds1) {
  // (lse, delta) of queries n0+2t and n0+2t+1, and their RC rows
  const float4 ld = *reinterpret_cast<const float4*>(ld_s + 2 * (n0 + 2 * t));
  const RelT* ra = rel_s + (n0 + 2 * t) * rel_stride;
  const RelT* rb = ra + rel_stride;
  float s0, s1, s2, s3;
  if (paired) {
    float a0, a1, b0, b1;
    load_pair(ra + st.c[0], a0, a1);
    load_pair(rb + st.c[0], b0, b1);
    const float ar = to_f(ra[W + st.r[0]]), br = to_f(rb[W + st.r[0]]);
    s0 = s[0] + a0 + ar;
    s1 = s[1] + b0 + br;
    s2 = s[2] + a1 + ar;
    s3 = s[3] + b1 + br;
  } else {
    s0 = s[0] + to_f(ra[st.c[0]]) + to_f(ra[W + st.r[0]]);
    s1 = s[1] + to_f(rb[st.c[0]]) + to_f(rb[W + st.r[0]]);
    s2 = s[2] + to_f(ra[st.c[1]]) + to_f(ra[W + st.r[1]]);
    s3 = s[3] + to_f(rb[st.c[1]]) + to_f(rb[W + st.r[1]]);
  }
  const float la = ld.x * LOG2E, lb = ld.z * LOG2E;
  const float p0 = st.ok[0] ? exp_shifted(s0, la) : 0.f;
  const float p1 = st.ok[0] ? exp_shifted(s1, lb) : 0.f;
  const float p2 = st.ok[1] ? exp_shifted(s2, la) : 0.f;
  const float p3 = st.ok[1] ? exp_shifted(s3, lb) : 0.f;
  p0w = pack_bf16(p0, p1);
  p1w = pack_bf16(p2, p3);
  ds0 = pack_bf16(p0 * (dp[0] - ld.y), p1 * (dp[1] - ld.w));
  ds1 = pack_bf16(p2 * (dp[2] - ld.y), p3 * (dp[3] - ld.w));
}

// dv += p^T dout and dk += ds^T q for the 16 queries of chunk qc of the tile,
// pa / dsa their p^T / ds^T as A fragments (dkdv_ds of its two n8 tiles);
// q_s, do_s as dkdv_step takes them.
template <int ND>
__device__ __forceinline__ void dkdv_accumulate(DkdvWarp<ND>& st, const uint32_t (&pa)[4],
                                                const uint32_t (&dsa)[4], int qc,
                                                const bf16* q_s, int qs, const bf16* do_s,
                                                int lane) {
  uint32_t b0, b1;
#pragma unroll
  for (int nv = 0; nv < NV; ++nv) {
    ldsm_x2_trans(b0, b1, do_s + (qc * 16 + (lane & 15)) * VS + nv * 8);
    mma16816(st.dv[nv], pa[0], pa[1], pa[2], pa[3], b0, b1);
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    ldsm_x2_trans(b0, b1, q_s + (qc * 16 + (lane & 15)) * qs + nd * 8);
    mma16816(st.dk[nd], dsa[0], dsa[1], dsa[2], dsa[3], b0, b1);
  }
}

// One query tile: q_s (TN rows of stride qs, a multiple of 8; what lies in
// columns dkh..KW-1 meets the zeros of k, so it only has to be finite), do_s
// (TN x VS), ld_s (TN x 2: lse, delta), rel_s (TN x rel_stride: the queries'
// RC rows, f32 or bf16, rows and even lanes aligned to a pair), of which qn
// queries exist.
template <int ND, typename RelT>
__device__ __forceinline__ void dkdv_step(DkdvWarp<ND>& st, const bf16* q_s, int qs,
                                          const bf16* do_s, const float* ld_s,
                                          const RelT* rel_s, int rel_stride, int W, int qn,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  // W even: the thread's keys are neighbours in one image row (an even key
  // sits on an even column); a key past hw has column 0 and p = 0
  const bool paired = rc_paired(rel_s, W);
#pragma unroll
  for (int qc = 0; qc < TN / 16; ++qc) {
    if (qc * 16 < qn) {  // uniform across the block
      uint32_t pa[4], dsa[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n0 = qc * 16 + half * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_k(s, st.ka, q_s + (n0 + g) * qs + 2 * t);
        mma_v(dp, st.va, do_s + (n0 + g) * VS + 2 * t);
        dkdv_ds(st, s, dp, n0, ld_s, rel_s, rel_stride, paired, W, t, pa[2 * half],
                pa[2 * half + 1], dsa[2 * half], dsa[2 * half + 1]);
      }
      dkdv_accumulate(st, pa, dsa, qc, q_s, qs, do_s, lane);
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace amma
