// alpha-entmax forward and backward for Hopper (sm_90a): one thread per
// column.
//
// The forward (K1/K2) is entmax_fwd.cuh's kernel; this source instantiates
// it in the bisection modes (alpha 2, 1.5, 4/3), and entmax_fastpow.cu and
// entmax_newton.cu in the powf modes.
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

#include "entmax_fwd.cuh"

namespace {

using namespace armnet;

constexpr int kThreads = 128;      // the backward's block

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

}  // namespace

// y = entmax over the middle axis of the contiguous (outer, d, inner) view
// of x, in a bisection mode (BISECT1/2/3; any other is refused) and the
// register bucket `bucket` (a multiple of 8 from 8 to 64, d <= bucket; any
// other is refused). Returns the cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_fwd(const float* x, float* y, long long outer,
                                 int d, long long inner, int bucket, int mode,
                                 int n_iter, float am1, float inv_am1,
                                 float c_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define ENTMAX_MODE(M)                                                      \
  case M:                                                                   \
    return (int)launch_fwd<M>(x, y, outer, d, inner, bucket, n_iter, am1,   \
                              inv_am1, c_hi, s);
    ENTMAX_MODE(BISECT1)
    ENTMAX_MODE(BISECT2)
    ENTMAX_MODE(BISECT3)
#undef ENTMAX_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
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
