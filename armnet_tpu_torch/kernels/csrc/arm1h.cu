// The fused ARM-1h forward (K5) for Hopper (sm_90a); see arm1h.cuh.

#include "arm1h.cuh"

namespace {

using namespace armnet;

// blocks per SM that ptxas must leave registers for: 7 (72 registers a
// thread) in the bisection modes, 6 (80) in the powf modes, whose solve
// needs more. (FASTPOW spills 8 bytes at 80 and at 96 registers, as the
// kernel before this bound did; at 126, with 4 blocks, it spills nothing
// but ran 5% slower: PERF.md.)
constexpr int fwd_min_blocks(int mode) { return is_bisect(mode) ? 7 : 6; }

template <int MAXF, int MODE>
__global__ void __launch_bounds__(kThreads, fwd_min_blocks(MODE))
arm1h_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ wk,
                 const float* __restrict__ q, const float* __restrict__ vt,
                 float* __restrict__ out, int F, int E, int DK, int O,
                 int n_iter, float scale, float am1, float inv_am1,
                 float c_hi) {
  constexpr bool kPad = is_bisect(MODE);
  extern __shared__ __align__(16) float smem[];
  const int ep = pad4(E);
  float* emb_s = smem;                    // [F, pad4(E)]
  float* keys_s = emb_s + F * ep;         // [F, pad4(DK)]
  float* out_s = keys_s + F * pad4(DK);   // [O, E]
  const int64_t b = blockIdx.x;

  stage_rows(emb_s, emb + b * F * E, F, E);
  __syncthreads();
  block_keys(emb_s, wk, keys_s, F, E, DK);
  __syncthreads();

  for (int o = threadIdx.x; o < O; o += kThreads) {
    float v[MAXF];
    gate_column<MAXF>(v, keys_s, q + (int64_t)o * DK, F, DK, scale, am1,
                      kPad ? -INFINITY : 0.0f);
    entmax_column<MAXF, MODE, kPad>(v, F, n_iter, inv_am1, c_hi);
#pragma unroll
    for (int f = 0; f < MAXF; ++f)                 // w = y * vt[:, o]
      if (f < F) v[f] = __fmul_rn(v[f], vt[f * O + o]);
    // z[e] = sum_f w[f] emb[f, e], 4 e at a time to spare registers
    for (int h = 0; h < E; h += 4) {
      float z[4] = {};
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          const float4 x =
              *reinterpret_cast<const float4*>(emb_s + f * ep + h);
          z[0] = fmaf(v[f], x.x, z[0]);
          z[1] = fmaf(v[f], x.y, z[1]);
          z[2] = fmaf(v[f], x.z, z[2]);
          z[3] = fmaf(v[f], x.w, z[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (h + j < E) out_s[o * E + h + j] = expf(z[j]);
    }
  }
  __syncthreads();
  float* ob = out + b * O * E;
  for (int i = threadIdx.x; i < O * E; i += kThreads) ob[i] = out_s[i];
}

size_t fwd_smem(int F, int E, int DK, int O) {
  return sizeof(float) *
         ((size_t)F * pad4(E) + (size_t)F * pad4(DK) + (size_t)O * E);
}

template <int MAXF>
decltype(&arm1h_fwd_kernel<MAXF, BISECT1>) pick_fwd(int mode) {
  switch (mode) {
    case BISECT1: return arm1h_fwd_kernel<MAXF, BISECT1>;
    case BISECT2: return arm1h_fwd_kernel<MAXF, BISECT2>;
    case BISECT3: return arm1h_fwd_kernel<MAXF, BISECT3>;
    case FASTPOW: return arm1h_fwd_kernel<MAXF, FASTPOW>;
    case NEWTON: return arm1h_fwd_kernel<MAXF, NEWTON>;
    default: return nullptr;
  }
}

// the kernel of F's register bucket (16 or 40) and the solver mode
decltype(&arm1h_fwd_kernel<16, BISECT1>) pick_fwd(int F, int mode) {
  return F <= 16 ? pick_fwd<16>(mode) : pick_fwd<kMaxF>(mode);
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
  if (!dims_ok(B, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  const auto kernel = pick_fwd(F, mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(F, E, DK, O);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, wk, q, vt, out, F, E, DK, O, n_iter, scale, am1, inv_am1, c_hi);
  return (int)cudaGetLastError();
}

// *blocks = the blocks of the forward kernel that one SM holds at these
// shapes and this solver mode. Returns the cudaError_t (0 on success).
extern "C" int armnet_arm1h_fwd_blocks_per_sm(int F, int E, int DK, int O,
                                              int mode, int* blocks) {
  if (!dims_ok(1, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  const auto kernel = pick_fwd(F, mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)blocks_per_sm(kernel, fwd_smem(F, E, DK, O), blocks);
}
