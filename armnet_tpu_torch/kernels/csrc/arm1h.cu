// The fused ARM-1h forward (K5) for Hopper (sm_90a); see arm1h.cuh.

#include "arm1h.cuh"

namespace {

using namespace armnet;

template <int MAXF, int MODE>
__global__ void __launch_bounds__(kThreads)
arm1h_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ wk,
                 const float* __restrict__ q, const float* __restrict__ vt,
                 float* __restrict__ out, int F, int E, int DK, int O,
                 int n_iter, float scale, float am1, float inv_am1,
                 float c_hi) {
  extern __shared__ float smem[];
  float* emb_s = smem;                // [F, E]
  float* keys_s = emb_s + F * E;      // [F, DK]
  float* out_s = keys_s + F * DK;     // [O, E]
  const int64_t b = blockIdx.x;

  const float* eb = emb + b * F * E;
  for (int i = threadIdx.x; i < F * E; i += kThreads) emb_s[i] = eb[i];
  __syncthreads();
  block_keys(emb_s, wk, keys_s, F, E, DK);
  __syncthreads();

  for (int o = threadIdx.x; o < O; o += kThreads) {
    float v[MAXF];
    gate_column<MAXF>(v, keys_s, q + (int64_t)o * DK, F, DK, scale, am1);
    entmax_column<MAXF, MODE>(v, F, n_iter, inv_am1, c_hi);
#pragma unroll
    for (int f = 0; f < MAXF; ++f)                 // w = y * vt[:, o]
      if (f < F) v[f] = __fmul_rn(v[f], vt[f * O + o]);
    for (int e = 0; e < E; ++e) {
      float z = 0.0f;
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) z += v[f] * emb_s[f * E + e];
      out_s[o * E + e] = expf(z);
    }
  }
  __syncthreads();
  float* ob = out + b * O * E;
  for (int i = threadIdx.x; i < O * E; i += kThreads) ob[i] = out_s[i];
}

size_t fwd_smem(int F, int E, int DK, int O) {
  return sizeof(float) * ((size_t)F * E + (size_t)F * DK + (size_t)O * E);
}

template <int MAXF>
cudaError_t launch_fwd(int mode, const float* emb, const float* wk,
                       const float* q, const float* vt, float* out, int B,
                       int F, int E, int DK, int O, int n_iter, float scale,
                       float am1, float inv_am1, float c_hi,
                       cudaStream_t stream) {
  decltype(&arm1h_fwd_kernel<MAXF, BISECT1>) kernel = nullptr;
  switch (mode) {
    case BISECT1: kernel = arm1h_fwd_kernel<MAXF, BISECT1>; break;
    case BISECT2: kernel = arm1h_fwd_kernel<MAXF, BISECT2>; break;
    case BISECT3: kernel = arm1h_fwd_kernel<MAXF, BISECT3>; break;
    case FASTPOW: kernel = arm1h_fwd_kernel<MAXF, FASTPOW>; break;
    case NEWTON: kernel = arm1h_fwd_kernel<MAXF, NEWTON>; break;
    default: return cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem(F, E, DK, O);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(emb, wk, q, vt, out, F, E, DK, O,
                                        n_iter, scale, am1, inv_am1, c_hi);
  return cudaGetLastError();
}

}  // namespace

// out [B, O, E] = the fused ARM-1h forward of emb [B, F, E], wk [E, DK],
// q [O, DK], vt [F, O]; one block per row. Returns the cudaError_t of the
// launch (0 on success). F <= 40.
extern "C" int armnet_arm1h_fwd(const float* emb, const float* wk,
                                const float* q, const float* vt, float* out,
                                int B, int F, int E, int DK, int O, int mode,
                                int n_iter, float scale, float am1,
                                float inv_am1, float c_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(B, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  if (F <= 16)
    return (int)launch_fwd<16>(mode, emb, wk, q, vt, out, B, F, E, DK, O,
                               n_iter, scale, am1, inv_am1, c_hi, s);
  return (int)launch_fwd<40>(mode, emb, wk, q, vt, out, B, F, E, DK, O,
                             n_iter, scale, am1, inv_am1, c_hi, s);
}
