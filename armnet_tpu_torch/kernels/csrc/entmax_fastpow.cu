// The entmax forward (K1/K2) in FASTPOW mode (alpha < 2 other than 1.5
// and 4/3): a source of its own so that nvcc builds it beside the others
// (see entmax_fwd.cuh).

#include "entmax_fwd.cuh"

// y = the forward of the contiguous (outer, d, inner) view of x in register
// bucket `bucket`, as entmax.cu's armnet_entmax_fwd; takes mode FASTPOW
// only. Returns the cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_fwd_fastpow(const float* x, float* y,
                                         long long outer, int d,
                                         long long inner, int bucket,
                                         int mode, int n_iter, float am1,
                                         float inv_am1, float c_hi,
                                         void* stream) {
  if (mode != armnet::FASTPOW) return (int)cudaErrorInvalidValue;
  return (int)armnet::launch_fwd<armnet::FASTPOW>(
      x, y, outer, d, inner, bucket, n_iter, am1, inv_am1, c_hi,
      static_cast<cudaStream_t>(stream));
}

// *blocks = blocks per SM of the wide route's kernel in FASTPOW mode and
// register bucket `bucket`; any other mode is refused. Returns the
// cudaError_t.
extern "C" int armnet_entmax_fwd_fastpow_blocks_per_sm(int bucket, int mode,
                                                       int* blocks) {
  if (mode != armnet::FASTPOW) return (int)cudaErrorInvalidValue;
  return (int)armnet::fwd_blocks_per_sm<armnet::FASTPOW>(bucket, blocks);
}
