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
// torch op: deterministic, no atomics, one writer per (row, channel, tap).
//
// Bound on the H100 (SXM: 3.35 TB/s HBM, 67 TFLOP/s f32 outside the tensor
// cores): reads of x and g and the write of dx against 4*k*k operations per
// element (2*k*k for dx, 2*k*k for dw). At efficientnet-b4 380x380, bf16,
// batch 16, the 28 stride-1 layers move ~1.68 GB (0.50 ms) for ~17 GFLOP
// (0.26 ms): bound by bytes.
//
// Design: the tile plan and staging of depthwise_common.cuh, as in
// depthwise_fwd.cu, with x and g staged side by side. A block owns one
// channel group and walks nt of its tiles (consecutive bands, then batch
// elements; the next tiles' copy in flight while the current ones are
// computed), so the k*k reduction of dw over the block's threads is paid
// once per nt tiles. Per tile a thread reads its own R x CW g values, then
// for each of its R + k - 1 input rows the CW + k - 1 values of x and of g:
// g feeds its dx sums through the flipped weights, x times its own g values
// its k*k dw sums, which stay in registers across the tiles. The block then
// sums each plane's items in a fixed order (each row group's items, then
// the row groups) into its partial rows.

#include "depthwise_common.cuh"

namespace {

using namespace dw;

template <typename T, int K>
__global__ void __launch_bounds__(MAX_THREADS, K <= 3 ? 3 : K <= 5 ? 2 : 1)
depthwise_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ w, T* __restrict__ dx,
                     float* __restrict__ dw_part, Plan pl, int C, int H, int W, int smem_bytes) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  const int te = tile_elems<T>(pl);  // x's tile, then g's, in each of one or two buffers
  long long* rowtabs = reinterpret_cast<long long*>(tiles + (pl.nt > 1 ? 4 : 2) * te);
  const int rows = tile_rows(pl);

  const int cg = blockIdx.y;
  const Item it = item_of(cg, pl, C);
  float wr[K * K];
  float dwacc[K * K];
  if (it.active) load_weights<T, K>(w, it.c, wr);
#pragma unroll
  for (int t = 0; t < K * K; ++t) dwacc[t] = 0.f;

  const int pitch = pitch_of(pl.tw, P, VEC);
  const int wstep = W & (VEC - 1);
  const int rows_pp = pl.th + 2 * P;
  const T* const srcs[2] = {x, g};
  const int u0 = blockIdx.x * pl.nt;
  const int u1 = u0 + pl.nt < pl.tpc ? u0 + pl.nt : pl.tpc;
  Tile t = tile_of(u0, cg, pl);
  issue<T, 2>(tiles, rowtabs, srcs, pl, C, H, W, t);
  for (int u = u0, buf = 0; u < u1; ++u, buf ^= 1) {
    Tile next = t;
    if (u != u0) __syncthreads();  // every thread is done with the other buffer's tiles
    if (u + 1 < u1) {  // the next tiles' copy runs while these are computed
      next = tile_of(u + 1, cg, pl);
      issue<T, 2>(tiles + (buf ^ 1) * 2 * te, rowtabs + (buf ^ 1) * rows, srcs, pl, C, H, W,
                  next);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    T* cur = tiles + buf * 2 * te;
    const long long* rowtab = rowtabs + buf * rows;
    finish<T, 2>(cur, rowtab, srcs, pl, W, t);
    if (it.active) {
      T* dxc = dx + (static_cast<size_t>(t.b) * C + it.c) * H * W + t.j0 + it.cq * CW;
      const int j = t.j0 + it.cq * CW;
      for (int rg = it.rg0; rg < pl.nrg; rg += pl.tr) {
        const long long code = rowtab[it.g * rows_pp + rg * R];
        const long long e0 = code_e0(code);
        const int offx = off_of(x, e0), offg = off_of(g, e0);
        const T* xb = cur + code_at(code) + it.cq * CW;
        const T* gb = xb + te;
        float gc[R][CW];  // this item's own g values (zero outside the map)
        float dacc[R][CW];
#pragma unroll
        for (int o = 0; o < R; ++o) {
          const T* row = gb + (o + P) * pitch + ((offg + (o + P) * wstep) & (VEC - 1)) + P;
#pragma unroll
          for (int q = 0; q < CW; ++q) {
            gc[o][q] = to_f32(row[q]);
            dacc[o][q] = 0.f;
          }
        }
#pragma unroll
        for (int r = 0; r < R + K - 1; ++r) {
          const T* xrow = xb + r * pitch + ((offx + r * wstep) & (VEC - 1));
          const T* grow = gb + r * pitch + ((offg + r * wstep) & (VEC - 1));
          float xv[CW + K - 1], gv[CW + K - 1];
#pragma unroll
          for (int e = 0; e < CW + K - 1; ++e) {
            xv[e] = to_f32(xrow[e]);
            gv[e] = to_f32(grow[e]);
          }
#pragma unroll
          for (int o = 0; o < R; ++o) {
            const int a = r - o;  // the row tap that joins input row r to output row o
            if (a < 0 || a >= K) continue;
#pragma unroll
            for (int e = 0; e < K; ++e) {
              const float wf = wr[(K - 1 - a) * K + (K - 1 - e)];
              float s = dwacc[a * K + e];
#pragma unroll
              for (int q = 0; q < CW; ++q) {
                dacc[o][q] = fmaf(wf, gv[q + e], dacc[o][q]);
                s = fmaf(xv[q + e], gc[o][q], s);
              }
              dwacc[a * K + e] = s;
            }
          }
        }
        const int i = t.i0 + rg * R;
#pragma unroll
        for (int o = 0; o < R; ++o)
          if (i + o < H) store_row(dxc + static_cast<size_t>(i + o) * W, j, W, dacc[o]);
      }
    }
    t = next;
  }

  // dw: sum each plane's items in a fixed order into row blockIdx.x of
  // dw_part, tb taps at a time through shared memory: the threads' values
  // (tb x threads), then per plane the sum of each thread row's ncg threads,
  // which are consecutive (tb x G x tr), then those sums in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  const int nthr = blockDim.x, runs = pl.g * pl.tr, per_tap = nthr + runs;
  const int tb = smem_bytes / 4 / per_tap < K * K ? smem_bytes / 4 / per_tap : K * K;
  float* rs = red + tb * nthr;
  for (int t0 = 0; t0 < K * K; t0 += tb) {
    const int n = t0 + tb < K * K ? tb : K * K - t0;
#pragma unroll
    for (int t = 0; t < K * K; ++t)
      if (t >= t0 && t < t0 + n) red[(t - t0) * nthr + threadIdx.x] = dwacc[t];
    __syncthreads();
    // (plane, thread row) pairs in thread order rg0 * G + pg
    for (int job = threadIdx.x; job < n * runs; job += nthr) {
      const int tl = job / runs, run = job - tl * runs;
      const float* v = red + tl * nthr + run * pl.ncg;
      float s = 0.f;
      for (int q = 0; q < pl.ncg; ++q) s += v[q];
      rs[job] = s;
    }
    __syncthreads();
    for (int job = threadIdx.x; job < n * pl.g; job += nthr) {
      const int tl = job / pl.g, pg = job - tl * pl.g, c = cg * pl.g + pg;
      if (c >= C) continue;
      float s = 0.f;
      for (int rt = 0; rt < pl.tr; ++rt) s += rs[tl * runs + rt * pl.g + pg];
      dw_part[(static_cast<size_t>(blockIdx.x) * C + c) * K * K + t0 + tl] = s;
    }
    __syncthreads();
  }
}

// Shared memory of a B4 block: the two operand tiles and the row table, in
// two buffers where the block walks more than one tile, or the reduction's
// scratch for one tap (threads + G * tr floats) where that is larger.
inline int bwd_smem(const Plan& pl, int es, int te) {
  const int nbuf = pl.nt > 1 ? 2 : 1;
  const int tiles = nbuf * (2 * te * es + tile_rows(pl) * 8);
  const int red = (pl.threads + pl.g * pl.tr) * 4;
  return tiles > red ? tiles : red;
}

template <typename T>
int launch(const void* x, const void* g, const void* w, void* dx, void* dw_part, int B, int C,
           int H, int W, int k, int n_part, void* stream) {
  const Plan pl = plan(B, C, H, W, k, BWD_MIN_IT);
  // n_part is the count of partial rows the caller allocated: it must be the grid's
  if (!pl.ok || pl.s != n_part) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(pl.s), static_cast<unsigned>(pl.n_cg));
  const int smem = bwd_smem(pl, static_cast<int>(sizeof(T)), tile_elems<T>(pl));
  return dispatch_k(k, [&](auto kc) {
    constexpr int K = decltype(kc)::value;
    static const int attr =
        allow_smem(depthwise_bwd_kernel<T, K>, 4 * TILE_BYTES + 2 * ROWTAB_BYTES);
    if (attr != 0) return attr;
    depthwise_bwd_kernel<T, K><<<grid, pl.threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float*>(w),
        static_cast<T*>(dx), static_cast<float*>(dw_part), pl, C, H, W, smem);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// Rows of dw_part (B4's blocks per channel group) for a (B, C, H, W) input
// and kernel size k, or -1 for a shape the kernel does not take.
extern "C" long long depthwise_bwd_n_part(int B, int C, int H, int W, int k) {
  const Plan pl = plan(B, C, H, W, k, BWD_MIN_IT);
  return pl.ok ? pl.s : -1;
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
