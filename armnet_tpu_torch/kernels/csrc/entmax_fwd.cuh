// alpha-entmax forward for Hopper (sm_90a) over an (outer, d, inner) view
// of a contiguous tensor: the normalized axis has length d and stride
// `inner`, with no relayout on either side. Two routes, chosen by shape in
// Python (entmax_cuda.route_for), replace the Pallas TPU kernels of
// armnet_tpu/kernels/entmax_pallas.py:
//   - the packed route (inner <= 16, or up to 32 where a column takes 2 or
//     4 lanes) replaces `_fwd_kernel`, the general [d, rows] entry (K1),
//     as the last axis of [B, K, O, F] is (B*K*O, F, 1); it takes K2 at
//     few channels too;
//   - the wide route replaces `_mid_fwd_kernel`, the [B, d, C] mid-axis
//     entry (K2): outer = B, d = F, inner = C.
// Past d = 64 entmax_fwd_column.cu takes either.
//
// What it computes: exactly armnet_tpu_torch/kernels/entmax_common.py
// `solve_entmax_axis0` at its production budgets, through the column solve
// of entmax_solver.cuh (MODE picks the solver branch; see there).
//
// What bounds it on an H100: operations, with bytes close behind. At the
// armnet_1h serving shape [4096, 39, 128] f32 it must read 81.8 MB and
// write 81.8 MB: 163.6 MB at 3.35 TB/s is about 49 us; the alpha=2
// bisection adds about 31 x 39 subtract/max/add per column (~2.2e9 f32
// instructions, ~66 us at 33.5e12 non-FMA f32 instructions/s). Both routes
// do the one read and one write of device memory and issue as few dead
// slots as they can:
//   - each column's d values stay in registers for the whole solve, in a
//     compile-time MAXD bucket chosen by the caller in steps of 8: d = 39
//     runs in 40 and d = 10 in 16, so a fully unrolled loop over the column
//     issues at most 7 masked slots (in steps of 4 a lane where a column
//     takes several lanes);
//   - in the bisection modes (alpha 2, 1.5, 4/3) the bucket's entries past
//     d hold -inf and each bisection clamps with one instruction
//     (entmax_column, PAD), and __launch_bounds__ asks ptxas for 7 blocks
//     of 128 per SM where the bucket is at most 40 (72 registers, which
//     bucket 40 fits without a spill); FASTPOW and NEWTON, whose powf
//     would spill under that bound and which padding slows (it adds dead
//     powf terms), keep the d test and no minimum.
//
// The wide route: neighbouring threads take neighbouring columns of an
// outer index, so where inner spans a warp each of the d loads and stores
// is coalesced; blocks of 128 threads in the bisection modes, 256 in the
// powf modes (two and four columns a thread, and blocks of 256 in the
// bisection modes, measured slower: PERF.md).
//
// The packed route: at a small inner the wide route's lanes read addresses
// d * inner * 4 bytes apart (156 B at the last axis, d = 39), and its
// blocks of 128 columns of one outer index leave threads idle. Here a
// block takes whole outer indices, whose span of x is contiguous: it stages
// the span in shared memory with coalesced 16-byte loads (a column d + 1
// floats apart at inner 1 and an even d, so that the threads' reads fall
// in 32 banks), each thread solves its column from registers as the wide
// route does (the same bits at one lane a column), and the block stores
// the span coalesced. Where the view has too few columns to fill the card
// (db_armnet's [1024, 43, 32]: 32,768 columns, 8 warps an SM, latency
// bound) a column is spread over 2 or 4 adjacent lanes, each holding every
// LANES-th entry, its sums and max taken across the group by warp shuffles
// (another order of the sums, within the forward's 5e-6 of the plain
// version; not in NEWTON mode, alpha > 2, where the other order moved an
// entry at the support's edge 1.07e-5 from it, past the 1e-5 it is held
// to). Readings (kernels/bench.py entmax_routes, PERF.md; NVIDIA H100
// 80GB HBM3 at 700 W, device ms): the last axis (1048576, 39, 1) at alpha
// 2 0.239 on the packed route against 0.988 on the wide one (bound 0.133,
// operations); db_armnet at alpha 1.7 0.0700 with 4 lanes (0.064 with the
// per-lane buckets in steps of 4), 0.0771 with 2, 0.104-0.107 with one
// lane and blocks of 128, 64 or 32 threads (smaller blocks gained nothing
// and were deleted), 0.105 on the wide route; with enough columns the
// packed route reads 1.01x the wide one at inner 16 and 0.97x at 32, so
// one lane stops at 16.
//
// The wide route is instantiated in three sources, so that nvcc builds them
// in parallel: entmax.cu (the bisection modes, beside the packed route's),
// entmax_fastpow.cu and entmax_newton.cu (one powf mode each; their fully
// unrolled powf solves take most of the build's time); the packed route's
// powf modes in entmax_packed_fastpow.cu and entmax_packed_newton.cu.

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

// blocks per SM of the wide route's kernel in `bucket` (occupancy
// calculator), or cudaErrorInvalidValue for a bucket it lacks
template <int MODE>
cudaError_t fwd_blocks_per_sm(int bucket, int* blocks) {
  switch (bucket) {
#define ENTMAX_BUCKET(B)                                                    \
  case B:                                                                   \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
        blocks, entmax_fwd_kernel<B, MODE>, fwd_threads(MODE), 0);
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


// ---- the packed route (small inner: K1, and K2 at few channels) ----------

constexpr int kPackedThreads = 128;

// where element g of a block's span sits in shared memory: at g, or at
// g + g / d where the span is padded (inner = 1 and an even d: a column
// d + 1 floats apart, so that the threads' reads of their columns fall in
// 32 banks). g < 8192 and d <= 64, so the float quotient truncates to g / d
// exactly (its error, < 1e-3, is under the 0.5 / d the + 0.5 leaves)
__device__ __forceinline__ int span_index(int g, bool padded, float inv_d) {
  return padded ? g + __float2int_rz(__fmul_rn((float)g + 0.5f, inv_d)) : g;
}

// span <-> n floats of device memory at p, by all threads of the block, each
// warp on consecutive addresses, 16 bytes a thread where p is 16-byte
// aligned; TO_SHARED: span = p[...], else p[...] = span
template <bool TO_SHARED>
__device__ __forceinline__ void copy_span(float* span, float* p, int n,
                                          bool padded, float inv_d) {
  int g0 = 0;
  if (((uintptr_t)p & 15) == 0) {
    float4* p4 = reinterpret_cast<float4*>(p);
    for (int q = threadIdx.x; q < n / 4; q += blockDim.x) {
      const int g = 4 * q;
      float* s[4] = {span + span_index(g, padded, inv_d),
                     span + span_index(g + 1, padded, inv_d),
                     span + span_index(g + 2, padded, inv_d),
                     span + span_index(g + 3, padded, inv_d)};
      if (TO_SHARED) {
        const float4 v = p4[q];
        *s[0] = v.x;
        *s[1] = v.y;
        *s[2] = v.z;
        *s[3] = v.w;
      } else {
        p4[q] = make_float4(*s[0], *s[1], *s[2], *s[3]);
      }
    }
    g0 = n / 4 * 4;
  }
  for (int g = g0 + threadIdx.x; g < n; g += blockDim.x) {
    float* s = span + span_index(g, padded, inv_d);
    if (TO_SHARED)
      *s = p[g];
    else
      p[g] = *s;
  }
}

// A block takes `per_block` = 128 / (LANES * inner) consecutive outer
// indices, per_block * inner columns of LANES threads each: their
// per_block * d * inner floats are one contiguous span of x, which the
// block stages in shared memory with coalesced loads (copy_span). Each
// column's LANES adjacent threads copy its entries into registers (lane j
// the entries j, j + LANES, ...; MAXD a lane), solve it with
// entmax_column (at LANES = 1 the wide route's solve, so the same bits),
// write it back, and the block stores the span coalesced. Threads past the
// last column solve zeros and store nothing (all lanes of a warp must meet
// at the group's shuffles).
template <int MAXD, int MODE, int LANES>
__global__ void __launch_bounds__(kPackedThreads, fwd_min_blocks(MAXD, MODE))
entmax_fwd_packed_kernel(const float* __restrict__ x, float* __restrict__ y,
                         int64_t outer, int d, int inner, int per_block,
                         int n_iter, float am1, float inv_am1, float c_hi) {
  extern __shared__ float span[];
  constexpr bool kPad = is_bisect(MODE);
  const int64_t o0 = (int64_t)blockIdx.x * per_block;
  const int nt = (int)min((int64_t)per_block, outer - o0);
  const int n = nt * d * inner;
  const int64_t base = o0 * d * inner;
  const bool padded = inner == 1 && d % 2 == 0;
  const int slab = padded ? d + 1 : d * inner;   // floats of an outer index
  const float inv_d = 1.0f / (float)d;
  copy_span<true>(span, const_cast<float*>(x) + base, n, padded, inv_d);
  __syncthreads();
  const int c = threadIdx.x / LANES, j = threadIdx.x % LANES;
  const bool live = c < nt * inner;
  const int o = c / inner;
  float* col = span + o * slab + (c - o * inner);   // entry k at k * inner
  float v[MAXD];
#pragma unroll
  for (int m = 0; m < MAXD; ++m) {
    const int k = j + m * LANES;
    v[m] = k >= d ? (kPad ? -INFINITY : 0.0f)
           : live ? __fmul_rn(col[k * inner], am1)
                  : 0.0f;
  }
  // entries of this lane: those k = j + m * LANES below d
  entmax_column<MAXD, MODE, kPad, LANES>(v, (d - j + LANES - 1) / LANES,
                                         n_iter, inv_am1, c_hi);
  if (live) {
#pragma unroll
    for (int m = 0; m < MAXD; ++m) {
      const int k = j + m * LANES;
      if (k < d) col[k * inner] = v[m];
    }
  }
  __syncthreads();
  copy_span<false>(span, y + base, n, padded, inv_d);
}

// the packed route's instantiations: (lanes, bucket a lane) with lanes *
// bucket <= 64, the bucket a multiple of 8 at one lane (the wide route's)
// and of 4 from 8 at more (d = 43 over 4 lanes holds 11 a lane: 12, not
// 16); one lane alone in NEWTON mode (entmax_cuda.FILL_COLUMNS says why)
#define ENTMAX_ONE_LANE_CASES(X)                                            \
  X(1, 8) X(1, 16) X(1, 24) X(1, 32) X(1, 40) X(1, 48) X(1, 56) X(1, 64)
#define ENTMAX_LANES_CASES(X)                                               \
  X(2, 8) X(2, 12) X(2, 16) X(2, 20) X(2, 24) X(2, 28) X(2, 32) X(4, 8)     \
  X(4, 12) X(4, 16)

// outer indices, shared memory and threads (whole warps) of a packed block
inline int packed_per_block(int inner, int lanes) {
  return kPackedThreads / (lanes * inner);
}

inline size_t packed_smem(int d, int inner, int lanes) {
  return sizeof(float) * (size_t)packed_per_block(inner, lanes) *
         (inner == 1 && d % 2 == 0 ? d + 1 : (size_t)d * inner);
}

inline int packed_threads(int inner, int lanes) {
  return (packed_per_block(inner, lanes) * inner * lanes + 31) / 32 * 32;
}

// y = entmax in MODE over the middle axis of the contiguous (outer, d,
// inner) view of x on the packed route: `lanes` threads a column, `bucket`
// registers a lane (d <= lanes * bucket, lanes * inner <= 128, a pair of
// the mode's cases above; anything else is refused with
// cudaErrorInvalidValue).
template <int MODE>
cudaError_t launch_fwd_packed(const float* x, float* y, int64_t outer, int d,
                              int64_t inner, int bucket, int lanes,
                              int n_iter, float am1, float inv_am1,
                              float c_hi, cudaStream_t stream) {
  if (d < 1 || outer < 1 || inner < 1 || lanes < 1 || d > lanes * bucket ||
      lanes * inner > kPackedThreads)
    return cudaErrorInvalidValue;
  const int per_block = packed_per_block((int)inner, lanes);
  const unsigned grid = (unsigned)((outer + per_block - 1) / per_block);
  const size_t smem = packed_smem(d, (int)inner, lanes);
#define ENTMAX_PACKED(L, B)                                                 \
  if (lanes == L && bucket == B) {                                          \
    entmax_fwd_packed_kernel<B, MODE, L>                                    \
        <<<grid, packed_threads((int)inner, lanes), smem, stream>>>(        \
            x, y, outer, d, (int)inner, per_block, n_iter, am1, inv_am1,    \
            c_hi);                                                          \
    return cudaGetLastError();                                              \
  }
  ENTMAX_ONE_LANE_CASES(ENTMAX_PACKED)
  if constexpr (MODE != NEWTON) {
    ENTMAX_LANES_CASES(ENTMAX_PACKED)
  }
#undef ENTMAX_PACKED
  return cudaErrorInvalidValue;
}

// blocks per SM of the packed route's kernel (occupancy calculator)
template <int MODE>
cudaError_t fwd_packed_blocks_per_sm(int d, int inner, int bucket, int lanes,
                                     int* blocks) {
  if (lanes * inner > kPackedThreads) return cudaErrorInvalidValue;
#define ENTMAX_PACKED(L, B)                                                 \
  if (lanes == L && bucket == B)                                            \
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(                   \
        blocks, entmax_fwd_packed_kernel<B, MODE, L>,                       \
        packed_threads(inner, lanes), packed_smem(d, inner, lanes));
  ENTMAX_ONE_LANE_CASES(ENTMAX_PACKED)
  if constexpr (MODE != NEWTON) {
    ENTMAX_LANES_CASES(ENTMAX_PACKED)
  }
#undef ENTMAX_PACKED
  return cudaErrorInvalidValue;
}

}  // namespace armnet
