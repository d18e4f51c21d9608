// alpha-entmax forward and backward for Hopper (sm_90a): one thread per
// column.
//
// Replaces the Pallas TPU kernels armnet_tpu/kernels/entmax_pallas.py
// `_fwd_kernel` (the general [d, rows] entry, K1) and `_mid_fwd_kernel`
// (the [B, d, C] mid-axis entry, K2) with ONE kernel over an (outer, d,
// inner) view of a contiguous tensor: the normalized axis has length d and
// stride `inner`. K2 is outer=B, d=F, inner=C; K1 is any axis, with no
// relayout on either side.
//
// What it computes: exactly armnet_tpu_torch/kernels/entmax_common.py
// `solve_entmax_axis0` at its production budgets, through the column solve
// of entmax_solver.cuh (MODE picks the solver branch; see there).
//
// What bounds it on an H100: at the armnet_1h serving shape [4096, 39, 128]
// f32 it must read 81.8 MB and write 81.8 MB: 163.6 MB at 3.35 TB/s is
// about 49 us. The alpha=2 bisection adds about 31 x 39 subtract/max/add
// per column (~2.2e9 f32 instructions, ~66 us at 33.5e12 non-FMA f32
// instructions/s), so operations bound it, with bytes close behind. The
// design does the one read and one write of device memory and nothing
// else: each thread keeps its column's d values in registers (a
// compile-time MAXD bucket with a masked tail) for the whole solve, and
// neighbouring threads take neighbouring columns, so each of the d loads
// and stores is coalesced across the warp.
//
// The backward (`entmax_bwd_kernel`) replaces the Pallas `_bwd_kernel`
// (general entry, K3) and `_mid_bwd_kernel` (mid-axis entry, K4) the same
// way, over the same (outer, d, inner) view: g = y^(2-alpha) on the support
// (y > 0), dx = dy*g - (sum(dy*g) / sum(g)) * g, exactly as
// entmax_common.entmax_bwd_axis0. GMODE picks g: G_ONE (alpha = 2, g = 1),
// G_SQRT (alpha = 1.5, g = sqrt(y)), G_POW (any other alpha,
// g = powf(max(y, 1e-38), 2 - alpha)). What bounds it: it must read y and
// dy and write dx, 3 x 4 bytes per element (245 MB at [4096, 39, 128],
// about 73 us at 3.35 TB/s); at alpha 2 and 1.5 it does a few f32
// instructions per element, so bytes bound it. The design reads y and dy
// once into registers (the same MAXD buckets), sums both reductions there
// and writes dx once, coalesced as in the forward. The NaN rule of the
// plain version holds without a special case: y > 0 is false for NaN, so
// a NaN column has sum(g) = 0 and dx = 0 - (0/0)*0 = NaN; sum(g) == 0 is
// not special-cased either.
//
// Numerics: see entmax_solver.cuh (no --use_fast_math; NaN columns stay
// NaN; __fmul_rn where the plain version rounds on its own).

#include "entmax_solver.cuh"

namespace {

using namespace armnet;

constexpr int kThreads = 128;

template <int MAXD, int MODE>
__global__ void __launch_bounds__(kThreads)
entmax_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                  int64_t outer, int d, int64_t inner, int n_iter, float am1,
                  float inv_am1, float c_hi) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= outer * inner) return;
  const int64_t o = col / inner;
  const int64_t base = o * d * inner + (col - o * inner);
  const float* xp = x + base;
  float* yp = y + base;

  float v[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (k < d) v[k] = __fmul_rn(xp[k * inner], am1);
  entmax_column<MAXD, MODE>(v, d, n_iter, inv_am1, c_hi);
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (k < d) yp[k * inner] = v[k];
}

template <int MAXD, int GMODE>
__global__ void __launch_bounds__(kThreads)
entmax_bwd_kernel(const float* __restrict__ y, const float* __restrict__ dy,
                  float* __restrict__ dx, int64_t outer, int d, int64_t inner,
                  float e) {
  const int64_t col = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (col >= outer * inner) return;
  const int64_t o = col / inner;
  const int64_t base = o * d * inner + (col - o * inner);
  const float* yp = y + base;
  const float* dyp = dy + base;
  float* dxp = dx + base;

  float g[MAXD], t[MAXD];
  float sum_t = 0.0f, sum_g = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (k < d) {
      g[k] = gppr<GMODE>(yp[k * inner], e);
      t[k] = __fmul_rn(dyp[k * inner], g[k]);
      sum_t += t[k];
      sum_g += g[k];
    }
  }
  const float q = sum_t / sum_g;
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (k < d) dxp[k * inner] = __fsub_rn(t[k], __fmul_rn(q, g[k]));
}

template <int MAXD>
cudaError_t launch_bwd(int gmode, const float* y, const float* dy, float* dx,
                       int64_t outer, int d, int64_t inner, float e,
                       cudaStream_t stream) {
  const int64_t cols = outer * inner;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  switch (gmode) {
#define ENTMAX_BWD_CASE(M)                                                  \
  case M:                                                                   \
    entmax_bwd_kernel<MAXD, M><<<grid, kThreads, 0, stream>>>(              \
        y, dy, dx, outer, d, inner, e);                                     \
    break;
    ENTMAX_BWD_CASE(G_ONE)
    ENTMAX_BWD_CASE(G_SQRT)
    ENTMAX_BWD_CASE(G_POW)
#undef ENTMAX_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int MAXD>
cudaError_t launch(int mode, const float* x, float* y, int64_t outer, int d,
                   int64_t inner, int n_iter, float am1, float inv_am1,
                   float c_hi, cudaStream_t stream) {
  const int64_t cols = outer * inner;
  const dim3 grid((unsigned)((cols + kThreads - 1) / kThreads));
  switch (mode) {
#define ENTMAX_CASE(M)                                                      \
  case M:                                                                   \
    entmax_fwd_kernel<MAXD, M><<<grid, kThreads, 0, stream>>>(              \
        x, y, outer, d, inner, n_iter, am1, inv_am1, c_hi);                 \
    break;
    ENTMAX_CASE(BISECT1)
    ENTMAX_CASE(BISECT2)
    ENTMAX_CASE(BISECT3)
    ENTMAX_CASE(FASTPOW)
    ENTMAX_CASE(NEWTON)
#undef ENTMAX_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// y = entmax over the middle axis of the contiguous (outer, d, inner) view
// of x. Returns the cudaError_t of the launch (0 on success). d <= 64.
extern "C" int armnet_entmax_fwd(const float* x, float* y, long long outer,
                                 int d, long long inner, int mode, int n_iter,
                                 float am1, float inv_am1, float c_hi,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || outer * inner < 1) return (int)cudaErrorInvalidValue;
  if (d <= 8)
    return (int)launch<8>(mode, x, y, outer, d, inner, n_iter, am1, inv_am1,
                          c_hi, s);
  if (d <= 16)
    return (int)launch<16>(mode, x, y, outer, d, inner, n_iter, am1, inv_am1,
                           c_hi, s);
  if (d <= 32)
    return (int)launch<32>(mode, x, y, outer, d, inner, n_iter, am1, inv_am1,
                           c_hi, s);
  if (d <= 64)
    return (int)launch<64>(mode, x, y, outer, d, inner, n_iter, am1, inv_am1,
                           c_hi, s);
  return (int)cudaErrorInvalidValue;
}

// dx = the entmax VJP over the middle axis of the contiguous (outer, d,
// inner) views of y and dy; e = 2 - alpha. Returns the cudaError_t of the
// launch (0 on success). d <= 64.
extern "C" int armnet_entmax_bwd(const float* y, const float* dy, float* dx,
                                 long long outer, int d, long long inner,
                                 int gmode, float e, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1 || outer * inner < 1) return (int)cudaErrorInvalidValue;
  if (d <= 8)
    return (int)launch_bwd<8>(gmode, y, dy, dx, outer, d, inner, e, s);
  if (d <= 16)
    return (int)launch_bwd<16>(gmode, y, dy, dx, outer, d, inner, e, s);
  if (d <= 32)
    return (int)launch_bwd<32>(gmode, y, dy, dx, outer, d, inner, e, s);
  if (d <= 64)
    return (int)launch_bwd<64>(gmode, y, dy, dx, outer, d, inner, e, s);
  return (int)cudaErrorInvalidValue;
}
