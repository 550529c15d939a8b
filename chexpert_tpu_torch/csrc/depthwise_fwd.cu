// Depthwise convolution, forward, stride 1, odd k, SAME (p = k/2), for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_depthwise.py::_fwd_kernel
// (host side _pallas_fwd, pl.pallas_call at :262). Same contract, in the
// port's NCHW layout:
//   x (B, C, H, W) f32 or bf16, w (C, k*k) the f32 parameter, which the
//   kernel rounds to x's dtype (the JAX host side's w.astype(x.dtype).astype(f32))
//   y[b, c, i, j] = sum_{dy, dx} w[c, dy, dx] * x[b, c, i + dy - p, j + dx - p]
// with zero padding; the sum is f32 and y is written in x's dtype.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor
// cores; a depthwise conv has no tensor-core work): one read of x and one
// write of y against 2*k*k operations per output. At efficientnet-b4 380x380
// the 28 stride-1 layers hold 17.47 M elements per image, so in bf16 a
// served forward at batch 4 moves ~280 MB (0.084 ms) for ~2.2 GFLOP
// (0.032 ms): the kernel is bound by bytes.
//
// Design. The TPU kernel puts channels on the lanes and walks row windows on
// a sequential grid. Here a block takes one tile of depthwise_common.cuh's
// plan (a band of whole rows of one plane, or G whole small planes), copies
// it with its halo into shared memory once by 16-byte cp.async (each input
// byte comes from memory about (TH + 2p) / TH times), and each thread
// computes its items, R x CW outputs each, from shared memory: (R + k - 1) *
// (CW + k - 1) reads for R * CW * k * k multiply-adds, the channel's k*k
// weights in registers. The tile is zero outside the map, so the loops have
// no edge predicates; stores are CW outputs at once where the alignment
// allows. No layout change around the call is needed (the model stays NCHW).
// Nothing carries between blocks.

#include "depthwise_common.cuh"

namespace {

using namespace dw;

template <typename T, int K>
__global__ void __launch_bounds__(MAX_THREADS)
depthwise_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                     Plan pl, int C, int H, int W) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);
  long long* rowtab = reinterpret_cast<long long*>(tile + tile_elems<T>(pl));

  const Tile t = tile_of(blockIdx.x, blockIdx.y, pl);
  const Item it = item_of(blockIdx.y, pl, C);
  float wr[K * K];
  if (it.active) load_weights<T, K>(w, it.c, wr);
  const T* const srcs[1] = {x};
  issue<T, 1>(tile, rowtab, srcs, pl, C, H, W, t);
  cp_async_wait<0>();
  finish<T, 1>(tile, rowtab, srcs, pl, W, t);
  if (!it.active) return;

  const int pitch = pitch_of(pl.tw, P, VEC);
  const int wstep = W & (VEC - 1);  // a row further, a row's offset moves by W elements
  const int rows_pp = pl.th + 2 * P;
  T* yc = y + (static_cast<size_t>(t.b) * C + it.c) * H * W + t.j0 + it.cq * CW;
  const int j = t.j0 + it.cq * CW;
  for (int rg = it.rg0; rg < pl.nrg; rg += pl.tr) {
    const int sr = it.g * rows_pp + rg * R;  // the shared row of the item's first input row
    const long long code = rowtab[sr];
    const int off0 = off_of(x, code_e0(code));
    const T* base = tile + code_at(code) + it.cq * CW;
    float acc[R][CW];
#pragma unroll
    for (int o = 0; o < R; ++o)
#pragma unroll
      for (int q = 0; q < CW; ++q) acc[o][q] = 0.f;
#pragma unroll
    for (int r = 0; r < R + K - 1; ++r) {
      const T* row = base + r * pitch + ((off0 + r * wstep) & (VEC - 1));
      float v[CW + K - 1];
#pragma unroll
      for (int e = 0; e < CW + K - 1; ++e) v[e] = to_f32(row[e]);
#pragma unroll
      for (int o = 0; o < R; ++o) {
        const int dy = r - o;
        if (dy < 0 || dy >= K) continue;
#pragma unroll
        for (int e = 0; e < K; ++e)
#pragma unroll
          for (int q = 0; q < CW; ++q) acc[o][q] = fmaf(wr[dy * K + e], v[q + e], acc[o][q]);
      }
    }
    const int i = t.i0 + rg * R;
#pragma unroll
    for (int o = 0; o < R; ++o)
      if (i + o < H) store_row(yc + static_cast<size_t>(i + o) * W, j, W, acc[o]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int C, int H, int W, int k,
           void* stream) {
  const Plan pl = plan(B, C, H, W, k, FWD_MIN_IT);
  if (!pl.ok) return static_cast<int>(cudaErrorInvalidValue);
  // one tile a block: B3 has no reduction to spread, and one tile's copy and
  // compute in each of the SM's resident blocks overlap better than a walk
  const dim3 grid(static_cast<unsigned>(pl.tpc), static_cast<unsigned>(pl.n_cg));
  const int smem = tile_elems<T>(pl) * static_cast<int>(sizeof(T)) + tile_rows(pl) * 8;
  return dispatch_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    static const int attr = allow_smem(depthwise_fwd_kernel<T, K>, TILE_BYTES + ROWTAB_BYTES);
    if (attr != 0) return attr;
    depthwise_fwd_kernel<T, K><<<grid, pl.threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), pl, C, H, W);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

extern "C" int depthwise_fwd_f32(const void* x, const void* w, void* y, int B, int C, int H,
                                 int W, int k, void* stream) {
  return launch<float>(x, w, y, B, C, H, W, k, stream);
}

extern "C" int depthwise_fwd_bf16(const void* x, const void* w, void* y, int B, int C, int H,
                                  int W, int k, void* stream) {
  return launch<__nv_bfloat16>(x, w, y, B, C, H, W, k, stream);
}
