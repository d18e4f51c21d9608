// alpha-entmax backward (K3/K4) for Hopper (sm_90a) over the (outer, d,
// inner) view of the forward: g = y^(2-alpha) on the support (y > 0),
// dx = dy*g - (sum(dy*g) / sum(g)) * g, exactly as
// entmax_common.entmax_bwd_axis0, the two sums taken in index order. GMODE
// picks g: G_ONE (alpha = 2, g = 1), G_SQRT (alpha = 1.5, g = sqrt(y)),
// G_POW (any other alpha, g = powf(max(y, 1e-38), 2 - alpha)). The NaN rule
// of the plain version holds without a special case: y > 0 is false for
// NaN, so a NaN column has sum(g) = 0 and dx = 0 - (0/0)*0 = NaN.
//
// Two routes, chosen by shape in Python (entmax_cuda.bwd_route_for),
// replace the Pallas kernels of armnet_tpu/kernels/entmax_pallas.py:
//   - the packed route (inner < 128) replaces `_bwd_kernel`, the general
//     [d, rows] entry (K3; the last axis is inner = 1), and takes K4 at
//     few channels;
//   - the staged route (inner >= 128) replaces `_mid_bwd_kernel`, the
//     [B, d, C] mid-axis entry (K4).
// Both compute each column with the same operations in the same order, so
// they give the same bits.
//
// What bounds it: bytes. It must read y and dy and write dx, 12 bytes an
// element (245 MB at [4096, 39, 128], 73 us at 3.35 TB/s); g, the products
// and the sums are a few f32 instructions an element, and a powf 18 slots
// (bounds.entmax_bwd_ops_per_element). Its first design held each column
// in a register bucket (g[64] and t[64] at d = 39, no occupancy floor) and
// ran at 2.3-6x the bound. Neither route holds a per-thread array, so both
// take any d, and both keep the card's memory busy:
//
// `entmax_bwd_staged_kernel`: a block of 128 threads takes
// 128 columns of one outer index and stages its [rows, 128] slabs of y and
// dy in shared memory with bulk asynchronous copies (cp.async.bulk, one
// 512-byte row each, completing on an mbarrier), issued by one thread, so
// the whole slab is in flight at once without a register per load. Where
// the column fits one stage (d <= kStageRows) g and dy*g are computed once
// into the slabs, summed, and dx written from them with streaming stores:
// 12 bytes an element of device memory. A longer column goes in stages of
// kStageRows rows, twice: the sums, then dx (the second reads of y and dy
// come from L2 where they can). A slab whose rows are not 16-byte aligned
// (inner not a multiple of 4) is loaded by the threads themselves. A
// stage's rows arrive on kParts mbarriers, a quarter each, so that the
// threads compute g (a powf each, away from alpha 2 and 1.5) on the first
// rows while the rest are in flight; the loops over a column are unrolled
// 4 deep, 4 g in flight a thread; the sums still add in index order. 32
// registers; shared memory sets the blocks per SM (5 at d = 39, 16 at
// d = 10). Measured (PERF.md): two streaming passes per column (y and dy
// read twice, g computed twice, ~30 registers, 16 blocks per SM) were
// slower at every alpha and shape; one mbarrier a stage 4-7% slower in
// the powf modes, 8 a stage 3-7% slower than 4.
//
// `entmax_bwd_packed_kernel`: below 128 columns an outer index the staged
// route leaves threads idle (at inner 1 a block of 128 threads has one
// live thread: 1,048,576 blocks for the last axis of [4096, 4, 64, 39],
// 7.74 ms against a 0.146 ms bound) and loads each column by its own
// thread. Here a block takes whole outer indices, so that every thread owns
// a column, and stages their contiguous spans of y and dy with one bulk
// copy each (see the kernel). Readings (kernels/bench.py entmax_routes,
// PERF.md; NVIDIA H100 80GB HBM3 at 700 W, device ms, the staged route in
// brackets): the last axis, alpha 2, 0.166 [7.74] against its 0.146
// bound; db_armnet [1024, 43, 32], alpha 1.7, 0.0171 [0.0317]; av_armnet
// [4096, 22, 32] 0.0132 [0.0296]; av_armnet+ [4096, 22, 64] 0.0283
// [0.0300]; frappe_armnet+ [4096, 10, 16] 0.0084 [0.0173]; half as many
// outer indices a block read within 8%.
//
// Numerics: see entmax_solver.cuh (no --use_fast_math, __fmul_rn where
// the plain version rounds on its own).

#include "entmax_solver.cuh"

namespace {

using namespace armnet;

constexpr int kCols = 128;          // columns (threads) of a block
// rows of a stage: a slab pair of kStageRows x 128 floats is 64 KB, so 3
// blocks share an SM; a column of at most kStageRows is read once
constexpr int kStageRows = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also expects `bytes` of bulk copies on the barrier
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// global -> shared, `bytes` a multiple of 16, both addresses 16-aligned
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a stage's rows come in on kParts mbarriers, a part each, so that the
// threads work on the first rows while the rest arrive
constexpr int kParts = 4;

template <int GMODE>
__global__ void __launch_bounds__(kCols)
entmax_bwd_staged_kernel(const float* __restrict__ y,
                         const float* __restrict__ dy, float* __restrict__ dx,
                         int d, int64_t inner, int64_t chunks, int rows,
                         int bulk, float e) {
  extern __shared__ __align__(128) float slab[];    // ys, then dys
  __shared__ __align__(8) uint64_t bar[kParts];
  float* ys = slab;
  float* dys = slab + rows * kCols;
  const int tid = threadIdx.x;
  const int64_t o = blockIdx.x / chunks;
  const int64_t c0 = (blockIdx.x - o * chunks) * kCols;
  const int nc = (int)min((int64_t)kCols, inner - c0);
  const int64_t base = o * d * inner + c0;
  const float* yb = y + base;
  const float* dyb = dy + base;
  float* dxb = dx + base;
  if (bulk && tid == 0)
    for (int p = 0; p < kParts; ++p) mbar_init(&bar[p]);
  __syncthreads();

  const int stages = (d + rows - 1) / rows;
  const bool once = stages == 1;
  uint32_t parity = 0;
  float sum_t = 0.0f, sum_g = 0.0f, q = 0.0f;
  float* yc = ys + tid;
  float* dyc = dys + tid;
  for (int pass = once ? 1 : 0; pass < 2; ++pass) {
    for (int s = 0; s < stages; ++s) {
      const int k0 = s * rows, kr = min(rows, d - k0);
      const int per = (kr + kParts - 1) / kParts;  // rows of a part
      if (bulk && tid == 0) {
        const uint32_t bytes = (uint32_t)nc * sizeof(float);
        for (int p = 0; p < kParts; ++p) {   // every barrier completes once
          const int ka = min(p * per, kr), kb = min(ka + per, kr);
          mbar_expect(&bar[p], 2u * (kb - ka) * bytes);
          for (int k = ka; k < kb; ++k) {
            bulk_load(ys + k * kCols, yb + (k0 + k) * inner, bytes, &bar[p]);
            bulk_load(dys + k * kCols, dyb + (k0 + k) * inner, bytes,
                      &bar[p]);
          }
        }
      } else if (!bulk && tid < nc) {   // each thread its own column
        for (int k = 0; k < kr; ++k) {
          ys[k * kCols + tid] = yb[(k0 + k) * inner + tid];
          dys[k * kCols + tid] = dyb[(k0 + k) * inner + tid];
        }
      }
      for (int p = 0; p < kParts; ++p) {
        const int ka = min(p * per, kr), kb = min(ka + per, kr);
        if (bulk) mbar_wait(&bar[p], parity);
        if (tid < nc && (pass == 0 || once)) {   // the sums, in index order
#pragma unroll 4
          for (int k = ka; k < kb; ++k) {
            const float g = gppr<GMODE>(yc[k * kCols], e);
            const float t = __fmul_rn(dyc[k * kCols], g);
            sum_t += t;
            sum_g += g;
            if (once) {
              yc[k * kCols] = g;
              dyc[k * kCols] = t;
            }
          }
        }
      }
      parity ^= 1u;
      if (tid < nc && pass == 1) {
        if (s == 0) q = sum_t / sum_g;
#pragma unroll 4
        for (int k = 0; k < kr; ++k) {
          float g, t;
          if (once) {
            g = yc[k * kCols];
            t = dyc[k * kCols];
          } else {
            g = gppr<GMODE>(yc[k * kCols], e);
            t = __fmul_rn(dyc[k * kCols], g);
          }
          __stcs(dxb + (k0 + k) * inner + tid, __fsub_rn(t, __fmul_rn(q, g)));
        }
      }
      __syncthreads();             // the slabs are free for the next stage
    }
  }
}

// The packed route (inner < 128 columns): a block of 128 threads takes
// `per_block` consecutive outer indices, per_block * inner <= 128 columns,
// one a thread. Their spans of y and dy (per_block * d * inner floats each,
// contiguous) come into shared memory with one bulk copy each on one
// mbarrier where the span is 16-byte aligned (`aligned`: y, dy and dx are;
// the block's base and length are multiples of 4 floats), else with
// coalesced loads by all threads. Each thread takes its column's sums in
// index order, leaving g and dy*g in the slabs, then dx in dy's slab, and
// the block streams dx out coalesced: 12 bytes an element of device memory.
template <int GMODE>
__global__ void __launch_bounds__(kCols)
entmax_bwd_packed_kernel(const float* __restrict__ y,
                         const float* __restrict__ dy, float* __restrict__ dx,
                         int64_t outer, int d, int inner, int per_block,
                         int room, int aligned, float e) {
  extern __shared__ __align__(128) float slab[];   // y's span; dy's at room
  __shared__ __align__(8) uint64_t bar;
  float* ys = slab;
  float* dys = slab + room;
  const int tid = threadIdx.x;
  const int64_t o0 = (int64_t)blockIdx.x * per_block;
  const int nt = (int)min((int64_t)per_block, outer - o0);
  const int n = nt * d * inner;
  const int64_t base = o0 * d * inner;
  const bool bulk = aligned && base % 4 == 0 && n % 4 == 0;
  if (bulk) {
    if (tid == 0) mbar_init(&bar);
    __syncthreads();
    if (tid == 0) {
      mbar_expect(&bar, 8u * (uint32_t)n);
      bulk_load(ys, y + base, 4u * (uint32_t)n, &bar);
      bulk_load(dys, dy + base, 4u * (uint32_t)n, &bar);
    }
    mbar_wait(&bar, 0);
  } else {
    for (int g = tid; g < n; g += kCols) {
      ys[g] = y[base + g];
      dys[g] = dy[base + g];
    }
    __syncthreads();
  }
  if (tid < nt * inner) {
    const int o = tid / inner;
    const int off = o * d * inner + (tid - o * inner);
    float* yc = ys + off;
    float* tc = dys + off;
    float sum_t = 0.0f, sum_g = 0.0f;
#pragma unroll 4
    for (int k = 0; k < d; ++k) {       // the sums, in index order
      const float g = gppr<GMODE>(yc[k * inner], e);
      const float t = __fmul_rn(tc[k * inner], g);
      sum_t += t;
      sum_g += g;
      yc[k * inner] = g;
      tc[k * inner] = t;
    }
    const float q = sum_t / sum_g;
#pragma unroll 4
    for (int k = 0; k < d; ++k)
      tc[k * inner] = __fsub_rn(tc[k * inner], __fmul_rn(q, yc[k * inner]));
  }
  __syncthreads();
  if (bulk) {
    float4* out = reinterpret_cast<float4*>(dx + base);
    const float4* src = reinterpret_cast<const float4*>(dys);
    for (int q = tid; q < n / 4; q += kCols) __stcs(out + q, src[q]);
  } else {
    for (int g = tid; g < n; g += kCols) __stcs(dx + base + g, dys[g]);
  }
}

using StagedKernel = decltype(&entmax_bwd_staged_kernel<G_ONE>);
using PackedKernel = decltype(&entmax_bwd_packed_kernel<G_ONE>);

StagedKernel pick_staged(int gmode) {
  switch (gmode) {
    case G_ONE: return entmax_bwd_staged_kernel<G_ONE>;
    case G_SQRT: return entmax_bwd_staged_kernel<G_SQRT>;
    case G_POW: return entmax_bwd_staged_kernel<G_POW>;
    default: return nullptr;
  }
}

PackedKernel pick_packed(int gmode) {
  switch (gmode) {
    case G_ONE: return entmax_bwd_packed_kernel<G_ONE>;
    case G_SQRT: return entmax_bwd_packed_kernel<G_SQRT>;
    case G_POW: return entmax_bwd_packed_kernel<G_POW>;
    default: return nullptr;
  }
}

// rows of a stage, and the block's dynamic shared memory
int stage_rows(int d) { return d < kStageRows ? d : kStageRows; }

size_t staged_smem(int d) {
  return 2 * sizeof(float) * (size_t)stage_rows(d) * kCols;
}

// floats of a packed block's y slab (dy's starts there, 128-byte aligned)
int packed_room(int d, int inner, int per_block) {
  return (per_block * d * inner + 31) / 32 * 32;
}

size_t packed_smem(int d, int inner, int per_block) {
  return 2 * sizeof(float) * (size_t)packed_room(d, inner, per_block);
}

// the kernel with its dynamic shared memory limit raised to smem past the
// default 48 KB (never lowered: that would refuse a later launch that needs
// more); nullptr where there is no kernel or the limit is refused
template <typename Kernel>
Kernel with_smem(Kernel kernel, size_t smem) {
  if (kernel == nullptr) return nullptr;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return nullptr;
  return kernel;
}

}  // namespace

// dx = the entmax VJP over the middle axis of the contiguous (outer, d,
// inner) views of y and dy; e = 2 - alpha; any d >= 1. per_block 0 takes
// the staged route (a block per 128 columns of an outer index); per_block
// >= 1 the packed route (per_block * inner <= 128, the two spans within a
// block's shared memory). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int armnet_entmax_bwd(const float* y, const float* dy, float* dx,
                                 long long outer, int d, long long inner,
                                 int per_block, int gmode, float e,
                                 void* stream) {
  if (d < 1 || outer < 1 || inner < 1 || per_block < 0 ||
      (long long)per_block * inner > kCols)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_block == 0) {
    const size_t smem = staged_smem(d);
    const StagedKernel kernel = with_smem(pick_staged(gmode), smem);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    // bulk copies where rows are 16-byte aligned
    const long long chunks = (inner + kCols - 1) / kCols;
    const int bulk = inner % 4 == 0 && (uintptr_t)y % 16 == 0 &&
                     (uintptr_t)dy % 16 == 0;
    kernel<<<(unsigned)(outer * chunks), kCols, smem, s>>>(
        y, dy, dx, d, inner, chunks, stage_rows(d), bulk, e);
    return (int)cudaGetLastError();
  }
  const size_t smem = packed_smem(d, (int)inner, per_block);
  const PackedKernel kernel = with_smem(pick_packed(gmode), smem);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int aligned = (uintptr_t)y % 16 == 0 && (uintptr_t)dy % 16 == 0 &&
                      (uintptr_t)dx % 16 == 0;
  kernel<<<(unsigned)((outer + per_block - 1) / per_block), kCols, smem, s>>>(
      y, dy, dx, outer, d, (int)inner, per_block,
      packed_room(d, (int)inner, per_block), aligned, e);
  return (int)cudaGetLastError();
}

// *blocks = the blocks of the backward kernel on a route (per_block as in
// armnet_entmax_bwd) that one SM holds at (d, inner): its registers and
// shared memory, as the occupancy calculator gives it. Returns the
// cudaError_t (0 on success).
extern "C" int armnet_entmax_bwd_blocks_per_sm(int d, int inner,
                                               int per_block, int gmode,
                                               int* blocks) {
  if (d < 1 || inner < 1 || per_block < 0) return (int)cudaErrorInvalidValue;
  if (per_block == 0) {
    const size_t smem = staged_smem(d);
    const StagedKernel kernel = with_smem(pick_staged(gmode), smem);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                             kCols, smem);
  }
  const size_t smem = packed_smem(d, inner, per_block);
  const PackedKernel kernel = with_smem(pick_packed(gmode), smem);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kCols, smem);
}
