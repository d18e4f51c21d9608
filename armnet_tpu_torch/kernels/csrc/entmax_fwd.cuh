// alpha-entmax forward for Hopper (sm_90a): one thread per column.
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
// else, and issues as few dead slots as it can:
//   - each column's d values stay in registers for the whole solve, in a
//     compile-time MAXD bucket chosen by the caller in steps of 8
//     (entmax_cuda.bucket_for): d = 39 runs in 40 and d = 10 in 16, so a
//     fully unrolled loop over the column issues at most 7 masked slots;
//   - neighbouring threads take neighbouring columns, so each of the d
//     loads and stores is coalesced across the warp;
//   - in the bisection modes (alpha 2, 1.5, 4/3) the bucket's entries past
//     d hold -inf and each bisection clamps with one instruction
//     (entmax_column, PAD), and __launch_bounds__ asks ptxas for 7 blocks
//     of 128 per SM where the bucket is at most 40 (72 registers, which
//     bucket 40 fits without a spill); FASTPOW and NEWTON, whose powf
//     would spill under that bound and which padding slows (it adds dead
//     powf terms), keep the d test, no minimum and blocks of 256 threads.
//     Two and four columns a thread, and blocks of 256 in the bisection
//     modes, measured slower (PERF.md).
//
// The kernel is instantiated in three sources, so that nvcc builds them in
// parallel: entmax.cu (the bisection modes, beside the backward),
// entmax_fastpow.cu and entmax_newton.cu (one powf mode each; their fully
// unrolled powf solves take most of the build's time).

#pragma once

#include "entmax_solver.cuh"

namespace armnet {

// threads per block: 128 in the bisection modes, 256 in FASTPOW and NEWTON
// (each the faster there)
__host__ __device__ constexpr int fwd_threads(int mode) {
  return is_bisect(mode) ? 128 : 256;
}

// blocks per SM that ptxas must leave registers for: 7 (72 registers a
// thread) in a bisection mode with a bucket of at most 40, else 1
constexpr int fwd_min_blocks(int maxd, int mode) {
  return is_bisect(mode) && maxd <= 40 ? 7 : 1;
}

template <int MAXD, int MODE>
__global__ void __launch_bounds__(fwd_threads(MODE),
                                  fwd_min_blocks(MAXD, MODE))
entmax_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                  int64_t outer, int d, int64_t inner, int n_iter, float am1,
                  float inv_am1, float c_hi) {
  constexpr bool kPad = is_bisect(MODE);
  const int64_t col = (int64_t)blockIdx.x * fwd_threads(MODE) + threadIdx.x;
  const int64_t o = col / inner;
  // a column past the end solves zeros and is not stored (an early return
  // instead costs the powf modes 30 registers a thread and a block per SM)
  const int64_t base =
      col < outer * inner ? o * d * inner + (col - o * inner) : -1;
  float v[MAXD];
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    v[k] = k >= d       ? (kPad ? -INFINITY : 0.0f)
           : base >= 0 ? __fmul_rn(x[base + k * inner], am1)
                       : 0.0f;
  entmax_column<MAXD, MODE, kPad>(v, d, n_iter, inv_am1, c_hi);
  if (base >= 0) {
#pragma unroll
    for (int k = 0; k < MAXD; ++k)
      if (k < d) y[base + k * inner] = v[k];
  }
}

// y = entmax in MODE over the middle axis of the contiguous (outer, d,
// inner) view of x, in the register bucket `bucket` (a multiple of 8 from 8
// to 64, d <= bucket; any other is refused with cudaErrorInvalidValue).
template <int MODE>
cudaError_t launch_fwd(const float* x, float* y, int64_t outer, int d,
                       int64_t inner, int bucket, int n_iter, float am1,
                       float inv_am1, float c_hi, cudaStream_t stream) {
  if (d < 1 || d > bucket || outer * inner < 1) return cudaErrorInvalidValue;
  constexpr int threads = fwd_threads(MODE);
  const unsigned grid = (unsigned)((outer * inner + threads - 1) / threads);
  switch (bucket) {
#define ENTMAX_BUCKET(B)                                                    \
  case B:                                                                   \
    entmax_fwd_kernel<B, MODE><<<grid, threads, 0, stream>>>(               \
        x, y, outer, d, inner, n_iter, am1, inv_am1, c_hi);                 \
    break;
    ENTMAX_BUCKET(8)
    ENTMAX_BUCKET(16)
    ENTMAX_BUCKET(24)
    ENTMAX_BUCKET(32)
    ENTMAX_BUCKET(40)
    ENTMAX_BUCKET(48)
    ENTMAX_BUCKET(56)
    ENTMAX_BUCKET(64)
#undef ENTMAX_BUCKET
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace armnet
