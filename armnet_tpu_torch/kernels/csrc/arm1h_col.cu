// The fused ARM-1h forward (K5) for Hopper (sm_90a) past the register
// buckets (F > 40), such as the 43 fields of the Diabetes130 recipe; see
// arm1h.cuh. A build unit of its own, so that arm1h.cu's buckets keep
// their code and registers.
//
// The same work as arm1h.cu's kernel, one block per row and one thread per
// neuron, except that thread o's gate column lives in shared memory,
// [F][128] so that thread o reads bank o: gate_column_strided forms it and
// entmax_column_strided solves it, the same operations in the same order
// as the register buckets, so the gates and y keep their bits. F is
// bounded by the block's shared memory only (arm_cuda.fwd_smem_bytes):
// emb, keys, the row's outputs and the columns.

#include "arm1h.cuh"

namespace {

using namespace armnet;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
arm1h_fwd_col_kernel(const float* __restrict__ emb,
                     const float* __restrict__ wk,
                     const float* __restrict__ q,
                     const float* __restrict__ vt, float* __restrict__ out,
                     int F, int E, int DK, int O, int n_iter, float scale,
                     float am1, float inv_am1, float c_hi) {
  extern __shared__ __align__(16) float smem[];
  const int ep = pad4(E);
  float* emb_s = smem;                    // [F, pad4(E)]
  float* keys_s = emb_s + F * ep;         // [F, pad4(DK)]
  float* out_s = keys_s + F * pad4(DK);   // [O, E]
  float* col = out_s + O * E + threadIdx.x;   // [F, 128], this column
  const int64_t b = blockIdx.x;

  stage_rows(emb_s, emb + b * F * E, F, E);
  __syncthreads();
  block_keys(emb_s, wk, keys_s, F, E, DK);
  __syncthreads();

  for (int o = threadIdx.x; o < O; o += kThreads) {
    gate_column_strided(col, kThreads, keys_s, q + (int64_t)o * DK, F, DK,
                        scale, am1);
    entmax_column_strided<MODE>(col, kThreads, F, n_iter, inv_am1, c_hi);
    for (int f = 0; f < F; ++f)                    // w = y * vt[:, o]
      col[f * kThreads] = __fmul_rn(col[f * kThreads], vt[f * O + o]);
    // z[e] = sum_f w[f] emb[f, e], 4 e at a time
    for (int h = 0; h < E; h += 4) {
      float z[4] = {};
      for (int f = 0; f < F; ++f) {
        const float w = col[f * kThreads];
        const float4 x = *reinterpret_cast<const float4*>(emb_s + f * ep + h);
        z[0] = fmaf(w, x.x, z[0]);
        z[1] = fmaf(w, x.y, z[1]);
        z[2] = fmaf(w, x.z, z[2]);
        z[3] = fmaf(w, x.w, z[3]);
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

size_t col_smem(int F, int E, int DK, int O) {
  return sizeof(float) * ((size_t)F * pad4(E) + (size_t)F * pad4(DK) +
                          (size_t)O * E + (size_t)F * kThreads);
}

decltype(&arm1h_fwd_col_kernel<BISECT1>) pick_col(int mode) {
  switch (mode) {
    case BISECT1: return arm1h_fwd_col_kernel<BISECT1>;
    case BISECT2: return arm1h_fwd_col_kernel<BISECT2>;
    case BISECT3: return arm1h_fwd_col_kernel<BISECT3>;
    case FASTPOW: return arm1h_fwd_col_kernel<FASTPOW>;
    case NEWTON: return arm1h_fwd_col_kernel<NEWTON>;
    default: return nullptr;
  }
}

}  // namespace

// out [B, O, E] = the fused ARM-1h forward, as arm1h.cu's entry of the same
// name, for any F whose columns fit a block's shared memory (col_smem; a
// larger plan is refused by allow_smem). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int armnet_arm1h_fwd(const float* emb, const float* wk,
                                const float* q, const float* vt, float* out,
                                int B, int F, int E, int DK, int O, int mode,
                                int n_iter, float scale, float am1,
                                float inv_am1, float c_hi, void* stream) {
  if (!dims_ok(B, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  const auto kernel = pick_col(mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem(F, E, DK, O);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      emb, wk, q, vt, out, F, E, DK, O, n_iter, scale, am1, inv_am1, c_hi);
  return (int)cudaGetLastError();
}

// *blocks = the blocks of this forward kernel that one SM holds at these
// shapes and this solver mode; 0 where its shared memory does not fit a
// block. Returns the cudaError_t (0 on success).
extern "C" int armnet_arm1h_fwd_blocks_per_sm(int F, int E, int DK, int O,
                                              int mode, int* blocks) {
  if (!dims_ok(1, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  const auto kernel = pick_col(mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = col_smem(F, E, DK, O);
  if (smem > smem_optin()) {
    *blocks = 0;
    return (int)cudaSuccess;
  }
  return (int)blocks_per_sm(kernel, smem, blocks);
}
