// Depthwise convolution, backward, stride 1, odd k, SAME (p = k/2), for sm_90a.
//
// Replaces the TPU kernel chexpert_tpu/ops/pallas_depthwise.py::_bwd_kernel
// (host side _pallas_bwd, pl.pallas_call at :289). Same contract, in the
// port's NCHW layout, given x and the output cotangent g (both (B, C, H, W),
// one dtype, f32 or bf16) and w (C, k*k), the f32 parameter, which the kernel
// rounds to that dtype as the forward does:
//   dx[b, c, i, j] = sum_{dy, dx} w[c, k-1-dy, k-1-dx] * g[b, c, i + dy - p, j + dx - p]
//                    (the flipped-kernel conv of the zero-padded g), in g's dtype;
//   dw[c, dy, dx]  = sum_{b, i, j} x[b, c, i + dy - p, j + dx - p] * g[b, c, i, j], f32.
// One kernel reads x and g once and produces both, as the TPU kernel does.
//
// The TPU kernel accumulates dw across row windows into an output block that
// stays resident in VMEM on its sequential grid (:233-240) and leaves the sum
// over the batch to XLA (:313). GPU blocks run concurrently, so here each
// block writes its own f32 partial dw (one row of dw_part, (S, C, k*k), S
// from depthwise_bwd_n_part) and the wrapper sums the S partials with one
// torch op: deterministic, no atomics.
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor
// cores): reads of x and g and the write of dx against 4*k*k operations per
// element (2*k*k for dx, 2*k*k for dw). At efficientnet-b4 380x380, bf16,
// batch 16, the 28 stride-1 layers move ~1.68 GB (0.50 ms) for ~17 GFLOP
// (0.26 ms): bound by bytes.
//
// Design: the blocking of depthwise_common.cuh, as in depthwise_fwd.cu. A
// thread owns RPT vertically adjacent positions of one column. For each of
// the (RPT + k - 1) * k input positions around them it loads x and g once;
// g feeds the thread's RPT dx sums through the flipped weights, x times the
// thread's own g values feeds its k*k dw sums. The block then reduces its
// threads' dw sums (warp shuffles, then the warps in a fixed order) into its
// partial row.

#include "depthwise_common.cuh"

namespace {

using namespace dw;

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
depthwise_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ w, T* __restrict__ dx,
                     float* __restrict__ dw_part, int C, int H, int W, int n_items) {
  constexpr int P = K / 2;
  __shared__ float red[WARPS][K * K];
  const int c = blockIdx.y;
  float wr[K * K];
  float dwacc[K * K];
  load_weights<T, K>(w, c, wr);
#pragma unroll
  for (int t = 0; t < K * K; ++t) dwacc[t] = 0.f;

  const int begin = blockIdx.x * ITEMS;
  const int end = min(n_items, begin + ITEMS);
  for (int it = begin + threadIdx.x; it < end; it += THREADS) {
    const Item item = decode(it, c, C, H, W);
    const int i0 = item.i0, j = item.j;
    const T* xp = x + item.plane;
    const T* gp = g + item.plane;

    float gc[RPT];  // this thread's own g values, zero below the map
    float dacc[RPT];
#pragma unroll
    for (int o = 0; o < RPT; ++o) {
      gc[o] = (i0 + o < H) ? to_f32(gp[static_cast<size_t>(i0 + o) * W + j]) : 0.f;
      dacc[o] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < RPT + K - 1; ++r) {
      const int ii = i0 - P + r;
      if (ii < 0 || ii >= H) continue;
      const T* xrow = xp + static_cast<size_t>(ii) * W;
      const T* grow = gp + static_cast<size_t>(ii) * W;
#pragma unroll
      for (int e = 0; e < K; ++e) {
        const int jj = j - P + e;
        const bool in = jj >= 0 && jj < W;
        const float xv = in ? to_f32(xrow[jj]) : 0.f;
        const float gv = in ? to_f32(grow[jj]) : 0.f;
#pragma unroll
        for (int o = 0; o < RPT; ++o) {
          const int a = r - o;  // the row tap that joins input row r to position o
          if (a >= 0 && a < K) {
            dacc[o] = fmaf(wr[(K - 1 - a) * K + (K - 1 - e)], gv, dacc[o]);
            dwacc[a * K + e] = fmaf(xv, gc[o], dwacc[a * K + e]);
          }
        }
      }
    }
    T* dxp = dx + item.plane + j;
#pragma unroll
    for (int o = 0; o < RPT; ++o)
      if (i0 + o < H) store(dxp + static_cast<size_t>(i0 + o) * W, dacc[o]);
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    float v = dwacc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < K * K; t += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < WARPS; ++q) s += red[q][t];
    dw_part[(static_cast<size_t>(blockIdx.x) * C + c) * K * K + t] = s;
  }
}

template <typename T>
int launch(const void* x, const void* g, const void* w, void* dx, void* dw_part, int B, int C,
           int H, int W, int k, int n_part, void* stream) {
  const long long items = n_items(B, C, H, W);
  // n_part is the count of partial rows the caller allocated: it must be the grid's
  if (items < 0 || n_blocks(B, C, H, W) != n_part) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n_part), C);
  return dispatch_k(k, [&](auto kc) {
    depthwise_bwd_kernel<T, decltype(kc)::value>
        <<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(w),
            static_cast<T*>(dx), static_cast<float*>(dw_part), C, H, W,
            static_cast<int>(items));
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Rows of dw_part (blocks along x) for a (B, C, H, W) input, or -1 for a
// shape the kernel does not take.
extern "C" long long depthwise_bwd_n_part(int B, int C, int H, int W) {
  return n_blocks(B, C, H, W);
}

extern "C" int depthwise_bwd_f32(const void* x, const void* g, const void* w, void* dx,
                                 void* dw_part, int B, int C, int H, int W, int k, int n_part,
                                 void* stream) {
  return launch<float>(x, g, w, dx, dw_part, B, C, H, W, k, n_part, stream);
}

extern "C" int depthwise_bwd_bf16(const void* x, const void* g, const void* w, void* dx,
                                  void* dw_part, int B, int C, int H, int W, int k, int n_part,
                                  void* stream) {
  return launch<__nv_bfloat16>(x, g, w, dx, dw_part, B, C, H, W, k, n_part, stream);
}
