// The entmax forward's packed route (K1, and K2 at few channels) in
// NEWTON mode (alpha > 2): a source of its own so that nvcc builds it
// beside the others (see entmax_fwd.cuh).

#include "entmax_fwd.cuh"

// y = the forward of the contiguous (outer, d, inner) view of x on the
// packed route, as entmax.cu's armnet_entmax_fwd_packed; takes mode
// NEWTON only. Returns the cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_fwd_packed_newton(
    const float* x, float* y, long long outer, int d, long long inner,
    int bucket, int lanes, int mode, int n_iter, float am1, float inv_am1,
    float c_hi, void* stream) {
  if (mode != armnet::NEWTON) return (int)cudaErrorInvalidValue;
  return (int)armnet::launch_fwd_packed<armnet::NEWTON>(
      x, y, outer, d, inner, bucket, lanes, n_iter, am1, inv_am1, c_hi,
      static_cast<cudaStream_t>(stream));
}

// *blocks = blocks per SM of the packed route's kernel in NEWTON mode at
// (d, inner, bucket, lanes). Returns the cudaError_t.
extern "C" int armnet_entmax_fwd_packed_newton_blocks_per_sm(
    int d, int inner, int bucket, int lanes, int mode, int* blocks) {
  if (mode != armnet::NEWTON) return (int)cudaErrorInvalidValue;
  return (int)armnet::fwd_packed_blocks_per_sm<armnet::NEWTON>(
      d, inner, bucket, lanes, blocks);
}
