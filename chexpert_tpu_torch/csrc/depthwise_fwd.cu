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
// a sequential grid. Here the blocking of depthwise_common.cuh: a thread
// computes RPT vertically adjacent outputs of one column, so each input
// value it loads serves up to RPT outputs ((RPT + k - 1) * k loads for
// RPT * k * k multiply-adds). The channel's k*k weights sit in registers.
// No layout change around the call is needed (the model stays NCHW). Edges
// are masked by index; no padded copy of x exists. Nothing carries between
// blocks.

#include "depthwise_common.cuh"

namespace {

using namespace dw;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
depthwise_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
                     int C, int H, int W, int n_items) {
  constexpr int P = K / 2;
  const int c = blockIdx.y;
  float wr[K * K];
  load_weights<T, K>(w, c, wr);

  const int begin = blockIdx.x * ITEMS;
  const int end = min(n_items, begin + ITEMS);
  for (int it = begin + threadIdx.x; it < end; it += THREADS) {
    const Item item = decode(it, c, C, H, W);
    const int i0 = item.i0, j = item.j;
    const T* xp = x + item.plane;

    float acc[RPT];
#pragma unroll
    for (int o = 0; o < RPT; ++o) acc[o] = 0.f;
#pragma unroll
    for (int r = 0; r < RPT + K - 1; ++r) {
      const int ii = i0 - P + r;
      if (ii < 0 || ii >= H) continue;
      const T* row = xp + static_cast<size_t>(ii) * W;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const int jj = j - P + e;
        const float xv = (jj >= 0 && jj < W) ? to_f32(row[jj]) : 0.f;
#pragma unroll
        for (int o = 0; o < RPT; ++o) {
          const int dy = r - o;
          if (dy >= 0 && dy < K) acc[o] = fmaf(wr[dy * K + e], xv, acc[o]);
        }
      }
    }
    T* yp = y + item.plane + j;
#pragma unroll
    for (int o = 0; o < RPT; ++o)
      if (i0 + o < H) store(yp + static_cast<size_t>(i0 + o) * W, acc[o]);
  }
}

template <typename T>
int launch(const void* x, const void* w, void* y, int B, int C, int H, int W, int k,
           void* stream) {
  const long long items = n_items(B, C, H, W);
  if (items < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_blocks(B, C, H, W)), C);
  return dispatch_k(k, [&](auto kc) {
    depthwise_fwd_kernel<T, decltype(kc)::value>
        <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y), C, H,
            W, static_cast<int>(items));
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
