// alpha-entmax forward (K1/K2) for Hopper (sm_90a) in its register buckets
// (d <= 64): entmax_fwd.cuh's kernel, which this source instantiates in the
// bisection modes (alpha 2, 1.5, 4/3), and entmax_fastpow.cu and
// entmax_newton.cu in the powf modes; entmax_fwd_column.cu takes d > 64,
// entmax_bwd.cu the backward (K3/K4).
//
// Numerics: see entmax_solver.cuh (no --use_fast_math; NaN columns stay
// NaN; __fmul_rn where the plain version rounds on its own).

#include "entmax_fwd.cuh"

using namespace armnet;

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
