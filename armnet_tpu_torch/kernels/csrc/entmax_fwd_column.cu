// The entmax forward (K1/K2) past the register buckets (d > 64): one
// thread per column, the column in shared memory or, where even 32 columns
// of it do not fit a block's, in the output itself (global memory, through
// L1 and L2). A source of its own, beside entmax_fwd.cuh's register
// buckets, which keep their instantiations and so their registers (a
// runtime branch to another path cost the narrow kernels 3-10%, PERF.md).
//
// The column solve is entmax_solver.cuh's entmax_column_strided: the
// operations and the order of entmax_column, so the kernel solves the
// plain version's bits at any d. What bounds it: as the register buckets,
// operations (the solve's f(tau) passes over d entries) with bytes close
// behind; here each pass reads the column from shared memory, [d][threads]
// so that thread t reads bank t, and a block holds threads = 128, 64 or 32
// columns, the most that shared memory allows (entmax_cuda.route_for
// chooses; d <= 454 at 128). Past 1816 entries (32 columns in 227 KB) the
// column is solved in y, each thread on its own column.

#include "entmax_solver.cuh"

namespace {

using namespace armnet;

constexpr int kMaxColThreads = 128;

template <int MODE, bool SHARED>
__global__ void __launch_bounds__(kMaxColThreads)
entmax_fwd_column_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int64_t outer, int d, int64_t inner, int n_iter,
                         float am1, float inv_am1, float c_hi) {
  extern __shared__ float smem[];
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= outer * inner) return;          // no barrier follows
  const int64_t o = col / inner;
  const int64_t base = o * d * inner + (col - o * inner);
  float* c = SHARED ? smem + threadIdx.x : y + base;
  const int64_t stride = SHARED ? (int64_t)blockDim.x : inner;
  for (int k = 0; k < d; ++k)
    c[k * stride] = __fmul_rn(x[base + k * inner], am1);
  entmax_column_strided<MODE>(c, stride, d, n_iter, inv_am1, c_hi);
  if (SHARED)
    for (int k = 0; k < d; ++k) y[base + k * inner] = c[k * stride];
}

using ColKernel = decltype(&entmax_fwd_column_kernel<BISECT1, true>);

template <bool SHARED>
ColKernel pick(int mode) {
  switch (mode) {
    case BISECT1: return entmax_fwd_column_kernel<BISECT1, SHARED>;
    case BISECT2: return entmax_fwd_column_kernel<BISECT2, SHARED>;
    case BISECT3: return entmax_fwd_column_kernel<BISECT3, SHARED>;
    case FASTPOW: return entmax_fwd_column_kernel<FASTPOW, SHARED>;
    case NEWTON: return entmax_fwd_column_kernel<NEWTON, SHARED>;
    default: return nullptr;
  }
}

}  // namespace

// y = entmax in `mode` (any solver mode) over the middle axis of the
// contiguous (outer, d, inner) view of x, blocks of `threads` columns (32,
// 64 or 128); with `shared` each column sits in shared memory (d * threads
// floats a block, which must fit the block's maximum), else it is solved
// in y. Returns the cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_fwd_column(const float* x, float* y,
                                        long long outer, int d,
                                        long long inner, int threads,
                                        int shared, int mode, int n_iter,
                                        float am1, float inv_am1, float c_hi,
                                        void* stream) {
  if (d < 1 || outer * inner < 1 ||
      (threads != 32 && threads != 64 && threads != 128))
    return (int)cudaErrorInvalidValue;
  const ColKernel kernel = shared ? pick<true>(mode) : pick<false>(mode);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  // past what a block may use, the attribute is refused
  const size_t smem = shared ? sizeof(float) * (size_t)d * threads : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned grid = (unsigned)((outer * inner + threads - 1) / threads);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, y, outer, d, inner, n_iter, am1, inv_am1, c_hi);
  return (int)cudaGetLastError();
}
