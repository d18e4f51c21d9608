// alpha-entmax forward (K1/K2) for Hopper (sm_90a) in its register buckets
// (d <= 64): entmax_fwd.cuh's kernels, the wide route's and the packed
// route's, which this source instantiates in the bisection modes (alpha 2,
// 1.5, 4/3), and entmax_fastpow.cu, entmax_newton.cu (wide) and
// entmax_packed_fastpow.cu, entmax_packed_newton.cu (packed) in the powf
// modes; entmax_fwd_column.cu takes d > 64, entmax_bwd.cu the backward
// (K3/K4).
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

// *blocks = blocks per SM of the wide route's kernel in a bisection mode and
// register bucket (the occupancy calculator). Returns the cudaError_t.
extern "C" int armnet_entmax_fwd_blocks_per_sm(int bucket, int mode,
                                               int* blocks) {
  switch (mode) {
    case BISECT1: return (int)fwd_blocks_per_sm<BISECT1>(bucket, blocks);
    case BISECT2: return (int)fwd_blocks_per_sm<BISECT2>(bucket, blocks);
    case BISECT3: return (int)fwd_blocks_per_sm<BISECT3>(bucket, blocks);
    default: return (int)cudaErrorInvalidValue;
  }
}

// y = entmax over the middle axis of the contiguous (outer, d, inner) view
// of x on the packed route (entmax_fwd.cuh: lanes threads a column, bucket
// registers a lane), in a bisection mode (any other is refused). Returns
// the cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_fwd_packed(const float* x, float* y,
                                        long long outer, int d,
                                        long long inner, int bucket,
                                        int lanes, int mode, int n_iter,
                                        float am1, float inv_am1, float c_hi,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
#define ENTMAX_MODE(M)                                                      \
  case M:                                                                   \
    return (int)launch_fwd_packed<M>(x, y, outer, d, inner, bucket, lanes,  \
                                     n_iter, am1, inv_am1, c_hi, s);
    ENTMAX_MODE(BISECT1)
    ENTMAX_MODE(BISECT2)
    ENTMAX_MODE(BISECT3)
#undef ENTMAX_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// *blocks = blocks per SM of the packed route's kernel in a bisection mode
// at (d, inner, bucket, lanes). Returns the cudaError_t.
extern "C" int armnet_entmax_fwd_packed_blocks_per_sm(int d, int inner,
                                                      int bucket, int lanes,
                                                      int mode,
                                                      int* blocks) {
  switch (mode) {
#define ENTMAX_MODE(M)                                                      \
  case M:                                                                   \
    return (int)fwd_packed_blocks_per_sm<M>(d, inner, bucket, lanes,        \
                                            blocks);
    ENTMAX_MODE(BISECT1)
    ENTMAX_MODE(BISECT2)
    ENTMAX_MODE(BISECT3)
#undef ENTMAX_MODE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
