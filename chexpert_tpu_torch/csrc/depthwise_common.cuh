// Shared by depthwise_fwd.cu (B3) and depthwise_bwd.cu (B4): the blocking,
// the element helpers and the dispatch over k. Both kernels split the work
// the same way, so the grid, the item decode and the count of blocks live
// here and nowhere else (the host side asks depthwise_bwd_n_part for the
// count of dw partial rows instead of repeating it).
//
// Blocking. A block owns one channel (blockIdx.y) and a chunk of ITEMS that
// channel's (batch, row group, column) items (blockIdx.x); an item is RPT
// vertically adjacent positions of one column, so neighbouring threads
// touch neighbouring columns (coalesced in NCHW). Spreading a block over all
// of a channel's planes keeps every thread busy from 190x190 maps with 24
// channels down to 12x12 maps with 2688.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace dw {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RPT = 4;                   // positions per item, along a column
constexpr int ITERS = 4;                 // items per thread per block
constexpr int ITEMS = THREADS * ITERS;   // items per block
constexpr long long MAX_ITEMS = 0x7fff0000LL;
constexpr int MAX_C = 65535;             // the grid's y limit

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
// the f32 weight rounded to the activation type, as the forward reads it
// (the JAX host side's w.astype(x.dtype).astype(f32))
__device__ __forceinline__ float rounded(float w, float) { return w; }
__device__ __forceinline__ float rounded(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

// Item `it` of a channel: batch b, first row i0, column j, and the offset of
// the (b, c) plane.
struct Item {
  int b, i0, j;
  size_t plane;
};

__device__ __forceinline__ Item decode(int it, int c, int C, int H, int W) {
  const int n_rg = (H + RPT - 1) / RPT;
  const int rest = it / W;
  Item item;
  item.j = it % W;
  item.i0 = (rest % n_rg) * RPT;
  item.b = rest / n_rg;
  item.plane = (static_cast<size_t>(item.b) * C + c) * H * W;
  return item;
}

// The channel's k*k weights, rounded to T.
template <typename T, int K>
__device__ __forceinline__ void load_weights(const float* __restrict__ w, int c, float* wr) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wr[t] = rounded(__ldg(w + static_cast<size_t>(c) * K * K + t), T());
}

// Items per channel, or -1 for a shape the grid does not take.
inline long long n_items(int B, int C, int H, int W) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || C > MAX_C) return -1;
  const long long items = static_cast<long long>(B) * ((H + RPT - 1) / RPT) * W;
  return items > MAX_ITEMS ? -1 : items;
}

// Blocks along x (one dw partial row each in B4), or -1.
inline long long n_blocks(int B, int C, int H, int W) {
  const long long items = n_items(B, C, H, W);
  return items < 0 ? -1 : (items + ITEMS - 1) / ITEMS;
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

}  // namespace dw
