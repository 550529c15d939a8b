// Shared by depthwise_fwd.cu (B3) and depthwise_bwd.cu (B4): the tile plan,
// the staging of a tile in shared memory, the element helpers and the
// dispatch over k. Both kernels split the work the same way, so the plan
// lives here and nowhere else (the host side asks depthwise_bwd_n_part for
// the count of dw partial rows instead of repeating it).
//
// Tile plan (plan()). An item is R x CW outputs of one (b, c) plane: R rows
// of CW adjacent columns, computed by one thread from a register tile. A
// tile is G planes (channels cg*G .. cg*G + G - 1 of one batch element) x TH
// rows x TW columns, TH = nrg * R and TW = ncg * CW. A thread takes `it` of
// a plane's row groups, rg0, rg0 + tr, ..., one column group and one plane
// (G * tr * ncg <= MAX_THREADS threads, rounded up to a warp), so what it
// sets up once (its decode from threadIdx, the channel's weights, its tile
// rows' offsets) serves it items: the kernels are bound by the instructions
// they issue as much as by bytes. Threads are ordered column group first,
// then plane, then row group, and planes sit in shared
// memory at a stride that puts consecutive planes on consecutive banks
// (plane_stride()), so a warp's reads of a small map's planes do not pile
// onto the same banks. Maps up to MAX_TW wide take whole rows (TW >= W): the
// TH + 2p rows of a band, halo included, are one contiguous span of x. A
// plane that fits one tile takes G > 1: small maps (12x12, 24x24) group
// consecutive channels, which are contiguous in NCHW, so a block's threads
// are busy and the grid has enough blocks at batch 4. A B3 block takes one
// tile; a B4 block owns one channel group and walks nt consecutive tiles of
// it (bands, then batch elements), with the next tile's copy in flight while
// it computes the current one (two buffers where nt > 1). Each operand's
// tile is at most TILE_BYTES counted at 4 bytes an element.
//
// Staging (issue(), then finish()). Each tile row (one row of one plane,
// halo rows and columns included) is copied with 16-byte cp.async from the
// 16-byte-aligned address at or below its first element, into a shared row
// of `pitch` elements; the row's offset `off` (its first element's position
// inside that aligned chunk, in elements) follows from the row's first
// element, which a row table in shared memory holds for the tile.
// Rows of 190, 95 and 12 bf16 elements are not 16-byte multiples and plane
// starts alternate in alignment (95 x 95 = 9025 elements), so every row has
// its own offset. Chunks outside the map's columns are zero-filled without a
// read; columns of a copied chunk that fall outside the map (the previous or
// next row's elements) are zeroed after the copy (finish()), as are rows
// above and below the map, so a left or right tap never reads a neighbouring
// row and the compute loops carry no edge predicates. TMA would not describe these
// tensors: its global strides must be multiples of 16 bytes, and the row
// strides of W = 190 / 95 / 12 in bf16 are not.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace dw {

constexpr int MAX_THREADS = 256;        // threads of a block at most: one item each
constexpr int R = 4;                    // output rows of an item
constexpr int CW = 4;                   // output columns of an item
constexpr int MAX_TW = 256;             // widest tile, in columns
constexpr int TILE_BYTES = 48 * 1024;   // one operand's tile, counted at 4 bytes an element
constexpr int TARGET_BLOCKS = 4 * 132;  // B4 walks tiles so that its grid is about this large
constexpr int PLANE_PAD = 128;          // a plane's stride in shared memory grows by < this (bytes)
// row groups a thread takes at least, where they divide the plane's: B3
// gains more from amortizing its set-up over two items, B4 (two operands,
// twice the registers) from more, smaller blocks
constexpr int FWD_MIN_IT = 2;
constexpr int BWD_MIN_IT = 1;
constexpr int MAX_IT = 4;               // row groups a thread takes at most
// bytes of one tile's row table (8 per shared row; a row is >= 32 counted bytes)
constexpr int ROWTAB_BYTES = TILE_BYTES / 32 * 8;
constexpr int MAX_C = 65535;            // the grid's y limit

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Elements of a shared tile row: the tile's TW + 2p columns rounded up to
// whole 16-byte chunks, plus one chunk for the row's offset.
__host__ __device__ __forceinline__ int pitch_of(int tw, int p, int vec) {
  return cdiv(tw + 2 * p, vec) * vec + vec;
}

struct Plan {
  int p;          // k / 2
  int ncg, nrg;   // column groups (of CW) and row groups (of R) of a tile
  int tr, it;     // thread rows of a plane, row groups a thread takes: nrg <= tr * it
  int tw, th;     // tile width and height: ncg * CW, nrg * R
  int n_ct, n_rt; // column and row tiles of a plane
  int g;          // planes (consecutive channels) of a tile
  int n_cg;       // channel groups: ceil(C / g)
  int threads;    // threads of a block: g * tr * ncg rounded up to a warp
  int tpc;        // tiles of a channel group: B * n_rt * n_ct
  int nt;         // B4: tiles a block walks
  int s;          // B4: blocks of a channel group, the rows of dw_part
  bool ok;
};

// The plan for x (B, C, H, W), an odd k and a thread's least row groups
// min_it (FWD_MIN_IT or BWD_MIN_IT); ok is false for a shape the kernels do
// not take.
inline Plan plan(int B, int C, int H, int W, int k, int min_it) {
  Plan pl{};
  pl.ok = false;
  if (B < 1 || C < 1 || H < 1 || W < 1 || C > MAX_C || k < 1 || k % 2 == 0) return pl;
  pl.p = k / 2;
  const int ncg_full = cdiv(W, CW);
  pl.n_ct = cdiv(ncg_full, MAX_TW / CW);
  pl.ncg = cdiv(ncg_full, pl.n_ct);
  pl.tw = pl.ncg * CW;
  const int row_bytes = pitch_of(pl.tw, pl.p, 4) * 4;
  const int rows_max = (TILE_BYTES - PLANE_PAD) / row_bytes;  // shared rows of one tile
  const int tr_max = MAX_THREADS / pl.ncg;
  int nrg_max = (rows_max - 2 * pl.p) / R;
  if (nrg_max > tr_max * MAX_IT) nrg_max = tr_max * MAX_IT;
  if (nrg_max < 1) return pl;
  const int nrg_full = cdiv(H, R);
  pl.n_rt = cdiv(nrg_full, nrg_max);
  pl.nrg = cdiv(nrg_full, pl.n_rt);
  pl.th = pl.nrg * R;
  pl.it = cdiv(pl.nrg, tr_max);
  if (pl.it < min_it && pl.nrg % min_it == 0) pl.it = min_it;  // and no thread left short
  pl.tr = cdiv(pl.nrg, pl.it);
  pl.g = 1;
  if (pl.n_rt == 1 && pl.n_ct == 1) {  // a plane fits one tile: group planes
    int g = MAX_THREADS / (pl.tr * pl.ncg);
    const int plane_max = TILE_BYTES / ((pl.th + 2 * pl.p) * row_bytes + PLANE_PAD);
    if (g > plane_max) g = plane_max;
    if (g > C) g = C;
    if (g < 1) g = 1;
    pl.g = cdiv(C, cdiv(C, g));  // the same count of groups, evened out
  }
  pl.n_cg = cdiv(C, pl.g);
  pl.threads = cdiv(pl.g * pl.tr * pl.ncg, 32) * 32;
  const long long tpc = static_cast<long long>(B) * pl.n_rt * pl.n_ct;
  if (tpc > INT_MAX) return pl;
  pl.tpc = static_cast<int>(tpc);
  long long nt = tpc * pl.n_cg / TARGET_BLOCKS;
  if (nt < 1) nt = 1;
  if (nt > tpc) nt = tpc;
  pl.s = static_cast<int>((tpc + nt - 1) / nt);
  pl.nt = cdiv(pl.tpc, pl.s);  // the same count of blocks, evened out
  pl.ok = true;
  return pl;
}

// Elements between two planes of a shared tile in type T: the plane's rows,
// padded so that the stride in bytes is, modulo the 128 bytes of the banks,
// the width of a plane's column groups rounded up to 16 bytes: the next
// plane's threads of a warp then start on the banks after this plane's.
template <typename T>
__host__ __device__ __forceinline__ int plane_stride(const Plan& pl) {
  constexpr int es = static_cast<int>(sizeof(T));
  const int rows = (pl.th + 2 * pl.p) * pitch_of(pl.tw, pl.p, 16 / es);
  const int target = cdiv(pl.ncg * CW * es, 16) * 16 % PLANE_PAD;
  return rows + ((target - rows * es) % PLANE_PAD + PLANE_PAD) % PLANE_PAD / es;
}

// Elements of one operand's shared tile in type T.
template <typename T>
__host__ __device__ __forceinline__ int tile_elems(const Plan& pl) {
  return pl.g * plane_stride<T>(pl);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T zero() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __ushort_as_bfloat16(0); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// CW = 4 adjacent outputs in one store (16 bytes of f32, 8 of bf16); p aligned to it
__device__ __forceinline__ void store4(float* p, const float (&v)[CW]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[CW]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&a);
  u.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}
// the f32 weight rounded to the activation type, as the forward reads it
// (the JAX host side's w.astype(x.dtype).astype(f32))
__device__ __forceinline__ float rounded(float w, float) { return w; }
__device__ __forceinline__ float rounded(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

// The channel's k*k weights, rounded to T.
template <typename T, int K>
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int c, float* wr) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = rounded(__ldg(w + static_cast<size_t>(c) * K * K + t), T());
}

// The position of element e of src inside its 16-byte-aligned chunk.
template <typename T>
__device__ __forceinline__ int off_of(const T* src, long long e) {
  return static_cast<int>(
      ((reinterpret_cast<uintptr_t>(src) + static_cast<uintptr_t>(e * static_cast<long long>(sizeof(T)))) & 15u) /
      sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A tile: batch element b, channel group cg, first output row i0 and column j0.
struct Tile {
  int b, cg, i0, j0;
};

// Tile u of a channel group: u = (b * n_rt + rt) * n_ct + ct.
__device__ __forceinline__ Tile tile_of(int u, int cg, const Plan& pl) {
  Tile t;
  const int ct = u % pl.n_ct;
  u /= pl.n_ct;
  t.i0 = (u % pl.n_rt) * pl.th;
  t.b = u / pl.n_rt;
  t.j0 = ct * pl.tw;
  t.cg = cg;
  return t;
}

// This thread's items: column group cq, plane g of the tile, row groups
// rg0, rg0 + tr, ... below nrg (threadIdx = (rg0 * G + g) * ncg + cq); its
// channel c, and whether it has any (threads past the items and planes past
// C have none).
struct Item {
  int g, rg0, cq, c;
  bool active;
};

__device__ __forceinline__ Item item_of(int cg, const Plan& pl, int C) {
  Item it;
  const int rest = threadIdx.x / pl.ncg;
  it.cq = threadIdx.x - rest * pl.ncg;
  it.rg0 = rest / pl.g;
  it.g = rest - it.rg0 * pl.g;
  it.c = cg * pl.g + it.g;
  it.active = it.rg0 < pl.tr && it.c < C;
  return it;
}

// The element of x at tile column 0 of the tile's shared row rr of plane g
// (rr counts from the first halo row).
__device__ __forceinline__ long long row_elem(const Tile& t, int g, int rr, const Plan& pl, int C,
                                              int H, int W) {
  return (static_cast<long long>(t.b) * C + t.cg * pl.g + g) * H * W +
         static_cast<long long>(t.i0 - pl.p + rr) * W + (t.j0 - pl.p);
}

// Shared rows of a tile: G planes of TH + 2p rows.
__host__ __device__ __forceinline__ int tile_rows(const Plan& pl) {
  return pl.g * (pl.th + 2 * pl.p);
}

// A tile row's entry in the row table: e0, the element of x at the row's
// tile column 0, the row's offset in the shared tile (< 2^17 elements) and
// whether the row lies in the map.
__device__ __forceinline__ long long row_code(long long e0, int at, bool in) {
  return (e0 * (1 << 17) + at) * 2 + (in ? 1 : 0);
}
__device__ __forceinline__ long long code_e0(long long code) { return code >> 18; }
__device__ __forceinline__ int code_at(long long code) {
  return static_cast<int>((code >> 1) & ((1 << 17) - 1));
}

// Start copying the tile t of NOP operands (each src[k], (B, C, H, W)) into
// shared memory, operand k at buf + k * tile_elems. First the row table
// (row_code per shared row), then 16-byte cp.async for the chunks that hold
// map columns and zeros for the rest, the threads walking (row, chunk)
// pairs with no division; one commit group. finish() completes it. Every
// thread of the block calls this.
template <typename T, int NOP>
__device__ __forceinline__ void issue(T* buf, long long* rowtab, const T* const (&src)[NOP],
                                      const Plan& pl, int C, int H, int W, const Tile& t) {
  constexpr int VEC = 16 / sizeof(T);
  const int pitch = pitch_of(pl.tw, pl.p, VEC), nch = pitch / VEC, te = tile_elems<T>(pl);
  const int ps = plane_stride<T>(pl);
  const int rows_pp = pl.th + 2 * pl.p, rows = tile_rows(pl);
  for (int sr = threadIdx.x; sr < rows; sr += blockDim.x) {
    const int g = sr / rows_pp, rr = sr - g * rows_pp;
    const int ii = t.i0 - pl.p + rr;
    const bool in = t.cg * pl.g + g < C && ii >= 0 && ii < H;
    rowtab[sr] = row_code(row_elem(t, g, rr, pl, C, H, W), g * ps + rr * pitch, in);
  }
  __syncthreads();
  const int c0 = t.j0 - pl.p;                                  // map column of tile column 0
  const int lo = c0 < 0 ? 0 : c0;                              // the map's columns in the span
  const int hi = t.j0 + pl.tw + pl.p < W ? t.j0 + pl.tw + pl.p : W;
  const int step_r = blockDim.x / nch, step_q = blockDim.x - step_r * nch;
  int sr = threadIdx.x / nch, q = threadIdx.x - sr * nch;
  while (sr < rows) {
    const long long code = rowtab[sr];
    const long long e0 = code_e0(code);
    const int at = code_at(code) + q * VEC;
#pragma unroll
    for (int k = 0; k < NOP; ++k) {
      T* dst = buf + k * te + at;
      if (code & 1) {
        const int off = off_of(src[k], e0);
        const int col = c0 - off + q * VEC;  // map column of the chunk's first element
        if (col + VEC > lo && col < hi) {
          cp_async16(dst, src[k] + (e0 - off + q * VEC));
          continue;
        }
      }
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
    }
    q += step_q;
    sr += step_r;
    if (q >= nch) {
      q -= nch;
      ++sr;
    }
  }
  cp_async_commit();
}

// Complete the copy of a tile into buf (row table rowtab): the caller has
// waited for its commit group; every thread of the block calls this, and it
// ends with the block synchronised. The tile columns [0, left) and
// [right, span) lie outside the map: the copies brought the neighbouring
// rows' elements there, which are zeroed.
template <typename T, int NOP>
__device__ __forceinline__ void finish(T* buf, const long long* rowtab,
                                       const T* const (&src)[NOP], const Plan& pl, int W,
                                       const Tile& t) {
  __syncthreads();
  const int c0 = t.j0 - pl.p;
  const int lo = c0 < 0 ? 0 : c0;
  const int hi = t.j0 + pl.tw + pl.p < W ? t.j0 + pl.tw + pl.p : W;
  const int left = lo - c0, right = hi - c0, span = pl.tw + 2 * pl.p;
  if (left == 0 && right == span) return;
  const int te = tile_elems<T>(pl), rows = tile_rows(pl);
  for (int sr = threadIdx.x; sr < rows; sr += blockDim.x) {
    const long long code = rowtab[sr];
    if (!(code & 1)) continue;
#pragma unroll
    for (int k = 0; k < NOP; ++k) {
      T* row = buf + k * te + code_at(code) + off_of(src[k], code_e0(code));
      for (int cc = 0; cc < left; ++cc) row[cc] = zero<T>();
      for (int cc = right; cc < span; ++cc) row[cc] = zero<T>();
    }
  }
  __syncthreads();
}

// Two adjacent outputs in one store; p aligned to both.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Store an item's row of CW outputs at p, map column j. Where all CW lie in
// the map: one store when p is aligned to all four, else two pairs, or one
// pair between two singles (rows of 190 and 95 bf16 elements start at every
// 2-byte offset); past the map's right edge, one by one.
template <typename T>
__device__ __forceinline__ void store_row(T* p, int j, int W, const float (&v)[CW]) {
  if (j + CW <= W) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(p);
    if ((a & (CW * sizeof(T) - 1)) == 0) {
      store4(p, v);
    } else if ((a & (2 * sizeof(T) - 1)) == 0) {
      store2(p, v[0], v[1]);
      store2(p + 2, v[2], v[3]);
    } else {
      store(p, v[0]);
      store2(p + 1, v[1], v[2]);
      store(p + 3, v[3]);
    }
    return;
  }
#pragma unroll
  for (int q = 0; q < CW; ++q)
    if (j + q < W) store(p + q, v[q]);
}

// Calls f(std::integral_constant<int, K>{}) for the odd k the kernels are
// instantiated for.
template <typename F>
int dispatch_k(int k, F&& f) {
  switch (k) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 7: return f(std::integral_constant<int, 7>{});
    case 9: return f(std::integral_constant<int, 9>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Raise the kernel's dynamic shared memory limit to bytes (once per
// instantiation); returns the CUDA error.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace dw
