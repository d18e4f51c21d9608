// alpha-entmax backward (K3/K4) for Hopper (sm_90a).
//
// Replaces the Pallas `_bwd_kernel` (general entry, K3) and
// `_mid_bwd_kernel` (mid-axis entry, K4) of
// armnet_tpu/kernels/entmax_pallas.py with one kernel over the (outer, d,
// inner) view of the forward: g = y^(2-alpha) on the support (y > 0),
// dx = dy*g - (sum(dy*g) / sum(g)) * g, exactly as
// entmax_common.entmax_bwd_axis0, the two sums taken in index order. GMODE
// picks g: G_ONE (alpha = 2, g = 1), G_SQRT (alpha = 1.5, g = sqrt(y)),
// G_POW (any other alpha, g = powf(max(y, 1e-38), 2 - alpha)). The NaN rule
// of the plain version holds without a special case: y > 0 is false for
// NaN, so a NaN column has sum(g) = 0 and dx = 0 - (0/0)*0 = NaN.
//
// What bounds it: bytes. It must read y and dy and write dx, 12 bytes an
// element (245 MB at [4096, 39, 128], 73 us at 3.35 TB/s); g, the products
// and the sums are a few f32 instructions an element, and a powf 18 slots
// (bounds.entmax_bwd_ops_per_element). Its first design held each column
// in a register bucket (g[64] and t[64] at d = 39, no occupancy floor) and
// ran at 2.3-6x the bound. This design holds no per-thread array, so it
// takes any d, and keeps the card's memory busy:
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
// d = 10).
//
// Measured (PERF.md): two streaming passes per column (y and dy
// read twice, g computed twice, ~30 registers, 16 blocks per SM) were
// slower at every alpha and shape; one mbarrier a stage 4-7% slower in
// the powf modes, 8 a stage 3-7% slower than 4.
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

using StagedKernel = decltype(&entmax_bwd_staged_kernel<G_ONE>);

StagedKernel pick_staged(int gmode) {
  switch (gmode) {
    case G_ONE: return entmax_bwd_staged_kernel<G_ONE>;
    case G_SQRT: return entmax_bwd_staged_kernel<G_SQRT>;
    case G_POW: return entmax_bwd_staged_kernel<G_POW>;
    default: return nullptr;
  }
}

// rows of a stage, and the block's dynamic shared memory
int stage_rows(int d) { return d < kStageRows ? d : kStageRows; }

size_t staged_smem(int d) {
  return 2 * sizeof(float) * (size_t)stage_rows(d) * kCols;
}

// launch the staged kernel on the (outer, d, inner) view: one block per 128
// columns of an outer index; bulk copies where rows are 16-byte aligned
int launch_staged(StagedKernel kernel, const float* y, const float* dy,
                  float* dx, long long outer, int d, long long inner,
                  float e, void* stream) {
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const size_t smem = staged_smem(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long chunks = (inner + kCols - 1) / kCols;
  const int bulk = inner % 4 == 0 && (uintptr_t)y % 16 == 0 &&
                   (uintptr_t)dy % 16 == 0;
  kernel<<<(unsigned)(outer * chunks), kCols, smem,
           static_cast<cudaStream_t>(stream)>>>(
      y, dy, dx, d, inner, chunks, stage_rows(d), bulk, e);
  return (int)cudaGetLastError();
}

}  // namespace

// dx = the entmax VJP over the middle axis of the contiguous (outer, d,
// inner) views of y and dy; e = 2 - alpha; any d >= 1. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int armnet_entmax_bwd(const float* y, const float* dy, float* dx,
                                 long long outer, int d, long long inner,
                                 int gmode, float e, void* stream) {
  if (d < 1 || outer < 1 || inner < 1) return (int)cudaErrorInvalidValue;
  const StagedKernel kernel = pick_staged(gmode);
  return launch_staged(kernel, y, dy, dx, outer, d, inner, e, stream);
}

// *blocks = the blocks of the backward kernel that one SM holds at d (its
// registers and shared memory), as the occupancy calculator gives it.
// Returns the cudaError_t (0 on success).
extern "C" int armnet_entmax_bwd_blocks_per_sm(int d, int gmode,
                                               int* blocks) {
  const StagedKernel kernel = pick_staged(gmode);
  if (d < 1 || kernel == nullptr) return (int)cudaErrorInvalidValue;
  // raise the kernel's limit only past the default 48 KB, as the launch
  // does: setting it lower would refuse a later launch that needs more
  const size_t smem = staged_smem(d);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                           kCols, smem);
}
