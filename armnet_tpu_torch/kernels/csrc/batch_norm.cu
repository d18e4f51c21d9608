// Batch normalisation's train-mode forward and backward for Hopper (sm_90a),
// with masked batch statistics (K9).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is XLA ops
// (armnet_tpu/ops/layers.py `BatchNorm`), and the port composed it from
// PyTorch's generic ops, which launch about 24 passes over the tensor a
// step: reductions over a non-contiguous pair of axes and broadcasting
// elementwise ops, each a read (and most a write) of the whole tensor.
//
// The input is viewed as x [N, C, S]: rows, channels, and the product of
// the axes after the channel (ARM-Net's arm_bn over [B, O, E]: S = E; an
// MLP's BatchNorm over [B, C]: S = 1). A row is L = C * S contiguous
// floats. w [N] is the rows' mask (1 real, 0 pad) or absent (every row
// counts); n = max(sum w, 1) * spatial, or spatial itself without a mask.
//
//   forward   sx = sum_rows w x, mu = sx / n          (bn_sums_kernel, mode
//             sq = sum_rows w (x - mu)^2, var = sq / n  0 then 1, each with
//             r = rsqrt(var + eps)                      bn_fold_kernel)
//             running mean and variance updated    (bn_stats_kernel)
//             y = (x - mu) * (r * gamma) + beta, every row (bn_apply_kernel)
//   backward  s1 = sum_rows dy, p = sum_rows dy (x - mu), over every row,
//             pad rows too (their outputs depend on mu and r): dbeta = s1,
//             dgamma = r p                      (bn_sums_kernel mode 2, fold)
//             dx = gamma r (dy - w (s1 / n + (x - mu) r^2 p / n))
//                                                          (bn_dx_kernel)
//
// The variance is centred (two reads of x): the ARM cells' input is
// exp(.) near 1 with a spread near 1e-3, where sum x^2 - (sum x)^2 / n in
// float32 keeps no digit of the variance.
//
// What bounds it on an H100: bytes. Each pass streams the tensor once at a
// few operations a float; the whole forward and backward read x four times
// and dy twice and write y and dx once, 8 tensor-sizes, against the 5 that
// reading each input and writing each output once would take. The design:
// each thread owns up to kGroups fixed groups of VEC columns of a row (a
// float4 where rows are 16-byte aligned), walks down a slab of rows with
// coalesced loads and keeps its sums in registers; a block sums its row
// lanes in a fixed order in shared memory and writes one float64 partial a
// column and slab; bn_fold_kernel sums a channel's slabs and its S columns
// in a fixed order. No atomics: two calls give the same bits. Every sum is
// float64 (each term exact: a float32 difference squared or times dy), so
// the statistics are those of the plain version's float64 sums, and the
// card's float64 rate (half the float32 one) stays under the bytes' time.
// The channel sums come back to the host's
// stream between passes, so a data-parallel group can all-reduce them
// there ([C] vectors) and keep global statistics.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;   // threads a block, at most
constexpr int kGroups = 2;         // column groups a thread owns, at most
constexpr int kBlocksPerSm = 4;    // blocks of a pass per SM, aimed at
constexpr int kFoldThreads = 256;

enum Mode { kSum = 0, kSquares = 1, kGrads = 2 };

struct Plan {
  int vec;         // floats a column group: 4 where rows are float4-aligned
  int q;           // column groups a row: C * S / vec
  int span;        // column groups a block takes across the row
  int tx, ty;      // block: tx threads across the groups, ty down the rows
  int tiles;       // blocks across a row (grid.x)
  int slabs;       // blocks down the rows (grid.y)
  long long rows;  // rows a slab
};

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || sms <= 0)
    sms = 132;
  return sms;
}

Plan make_plan(long long n, long long l, int vec) {
  Plan p;
  p.vec = vec;
  p.q = static_cast<int>(l / vec);
  p.tiles = (p.q + kMaxThreads * kGroups - 1) / (kMaxThreads * kGroups);
  p.span = (p.q + p.tiles - 1) / p.tiles;
  p.tx = ((p.span + kGroups - 1) / kGroups + 31) / 32 * 32;
  p.ty = kMaxThreads / p.tx > 1 ? kMaxThreads / p.tx : 1;
  long long want = static_cast<long long>(sm_count()) * kBlocksPerSm / p.tiles;
  if (want < 1) want = 1;
  long long per = (n + want - 1) / want;
  p.rows = (per + p.ty - 1) / p.ty * p.ty;
  p.slabs = static_cast<int>((n + p.rows - 1) / p.rows);
  return p;
}

bool aligned(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<unsigned long long>(ptr) % 16 == 0;
}

int vec_for(long long l, const void* a, const void* b, const void* c) {
  return l % 4 == 0 && aligned(a) && aligned(b) && aligned(c) ? 4 : 1;
}

template <int VEC>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ double count_n(const float* count, double spatial) {
  return count ? fmax(static_cast<double>(*count), 1.0) * spatial : spatial;
}

// the batch mean of channel ch from its sum sx[ch]: bn_sums_kernel's mode 1
// and bn_stats_kernel take the same float
__device__ __forceinline__ float batch_mean(const double* sx, int ch, double n) {
  return static_cast<float>(sx[ch] / n);
}

// Partial sums of a slab of rows (grid.y) over a tile of column groups
// (grid.x): part[slab][k][col], k < K, in float64. Mode 0: w x; mode 1:
// w (x - mu)^2, mu from sx; mode 2: dy, and dy (x - mean), over every row.
template <int VEC, int MODE>
__global__ void __launch_bounds__(kMaxThreads)
bn_sums_kernel(const float* __restrict__ x, const float* __restrict__ dy,
               const float* __restrict__ w, const float* __restrict__ count,
               double spatial, const double* __restrict__ sx,
               const float* __restrict__ mean, double* __restrict__ part,
               long long n, int s, Plan p) {
  constexpr int K = MODE == kGrads ? 2 : 1;
  __shared__ double red[K * kGroups * VEC * kMaxThreads];
  const long long l = static_cast<long long>(p.q) * VEC;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int g0 = blockIdx.x * p.span;
  const int g1 = min(p.q, g0 + p.span);
  const long long r0 = blockIdx.y * p.rows;
  const long long r1 = min(n, r0 + p.rows);

  float centre[kGroups][VEC];
  double acc[K][kGroups][VEC];
  const double nn = count_n(count, spatial);
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = g0 + i * p.tx + tx;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int ch = (g < g1 ? g * VEC + v : 0) / s;
      centre[i][v] = MODE == kSum ? 0.f
                     : MODE == kSquares ? batch_mean(sx, ch, nn) : mean[ch];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[k][i][v] = 0.0;
    }
  }

#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += p.ty) {
    const float wr = (MODE != kGrads && w) ? w[r] : 1.f;
    const float* xr = x + r * l;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = g0 + i * p.tx + tx;
      if (g < g1) {
        float xv[VEC];
        load<VEC>(xr + static_cast<long long>(g) * VEC, xv);
        if constexpr (MODE == kGrads) {
          float gv[VEC];
          load<VEC>(dy + r * l + static_cast<long long>(g) * VEC, gv);
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[0][i][v] += gv[v];
            acc[K - 1][i][v] += static_cast<double>(gv[v]) *
                                (xv[v] - centre[i][v]);
          }
        } else if constexpr (MODE == kSum) {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[0][i][v] += static_cast<double>(wr) * xv[v];
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            const double d = xv[v] - centre[i][v];
            acc[0][i][v] += static_cast<double>(wr) * d * d;
          }
        }
      }
    }
  }

  // the block's row lanes, summed in lane order
  const int lanes = p.tx * p.ty, me = ty * p.tx + tx;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < kGroups; ++i)
#pragma unroll
      for (int v = 0; v < VEC; ++v)
        red[((k * kGroups + i) * VEC + v) * lanes + me] = acc[k][i][v];
  __syncthreads();
  if (ty != 0) return;
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = g0 + i * p.tx + tx;
    if (g >= g1) continue;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const double* lane = red + ((k * kGroups + i) * VEC + v) * lanes + tx;
        double t = 0.0;
        for (int y = 0; y < p.ty; ++y) t += lane[y * p.tx];
        part[(static_cast<long long>(blockIdx.y) * K + k) * l +
             static_cast<long long>(g) * VEC + v] = t;
      }
  }
}

// out[k][ch] = the sum of channel ch's S columns over every slab
// (blockIdx.x = ch, blockIdx.y = k), in a fixed order; with dgamma, dbeta
// (mode 2) also dbeta = s1 and dgamma = rstd * p as floats.
__global__ void __launch_bounds__(kFoldThreads)
bn_fold_kernel(const double* __restrict__ part, int slabs, int c, int s,
               double* __restrict__ out, const float* __restrict__ rstd,
               float* __restrict__ dgamma, float* __restrict__ dbeta) {
  __shared__ double red[kFoldThreads];
  const int ch = blockIdx.x, k = blockIdx.y, kk = gridDim.y;
  const long long l = static_cast<long long>(c) * s;
  const long long m = static_cast<long long>(slabs) * s;
  double t = 0.0;
  for (long long e = threadIdx.x; e < m; e += kFoldThreads) {
    const long long slab = e / s;
    t += part[(slab * kk + k) * l + static_cast<long long>(ch) * s + e % s];
  }
  red[threadIdx.x] = t;
  __syncthreads();
  for (int h = kFoldThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  out[k * c + ch] = red[0];
  if (dbeta != nullptr && k == 0) dbeta[ch] = static_cast<float>(red[0]);
  if (dgamma != nullptr && k == 1)
    dgamma[ch] = static_cast<float>(static_cast<double>(rstd[ch]) * red[0]);
}

// mean, rstd and the running statistics of each channel from its sums
__global__ void bn_stats_kernel(const double* __restrict__ sx,
                                const double* __restrict__ sq,
                                const float* __restrict__ count,
                                double spatial, float eps, float keep,
                                float take, float* __restrict__ mean,
                                float* __restrict__ rstd,
                                float* __restrict__ running_mean,
                                float* __restrict__ running_var, int c) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const double nn = count_n(count, spatial);
  const float mu = batch_mean(sx, ch, nn);
  const float var = static_cast<float>(sq[ch] / nn);
  const float unbias = static_cast<float>(nn / fmax(nn - 1.0, 1.0));
  mean[ch] = mu;
  rstd[ch] = rsqrtf(var + eps);
  running_mean[ch] = keep * running_mean[ch] + take * mu;
  running_var[ch] = keep * running_var[ch] + take * var * unbias;
}

// Mode 0: y = (x - mean) (rstd gamma) + beta. Mode 1: dx = gamma rstd (dy -
// w (s1 / n + (x - mean) rstd^2 p / n)), sums = [s1 | p] ([2, C]).
template <int VEC, bool BWD>
__device__ __forceinline__ void bn_rows(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ w, const float* __restrict__ count,
    double spatial, const double* __restrict__ sums,
    const float* __restrict__ mean, const float* __restrict__ rstd,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    float* __restrict__ out, long long n, int c, int s, const Plan& p) {
  const long long l = static_cast<long long>(p.q) * VEC;
  const int g0 = blockIdx.x * p.span;
  const int g1 = min(p.q, g0 + p.span);
  const long long r0 = blockIdx.y * p.rows;
  const long long r1 = min(n, r0 + p.rows);
  const double nn = count_n(count, spatial);
  float mu[kGroups][VEC], a[kGroups][VEC], b[kGroups][VEC], cc[kGroups][VEC];
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = g0 + i * p.tx + threadIdx.x;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int ch = (g < g1 ? g * VEC + v : 0) / s;
      const float r = rstd[ch];
      mu[i][v] = mean[ch];
      a[i][v] = r * gamma[ch];
      if constexpr (BWD) {
        b[i][v] = static_cast<float>(sums[ch] / nn);
        cc[i][v] = static_cast<float>(static_cast<double>(r) * r *
                                      sums[c + ch] / nn);
      } else {
        b[i][v] = beta[ch];
        cc[i][v] = 0.f;
      }
    }
  }
#pragma unroll 4
  for (long long r = r0 + threadIdx.y; r < r1; r += p.ty) {
    const float wr = (BWD && w) ? w[r] : 1.f;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) {
      const int g = g0 + i * p.tx + threadIdx.x;
      if (g < g1) {
        const long long at = r * l + static_cast<long long>(g) * VEC;
        float xv[VEC], o[VEC];
        load<VEC>(x + at, xv);
        if constexpr (BWD) {
          float gv[VEC];
          load<VEC>(dy + at, gv);
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            o[v] = a[i][v] *
                   (gv[v] - wr * (b[i][v] + (xv[v] - mu[i][v]) * cc[i][v]));
        } else {
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            o[v] = (xv[v] - mu[i][v]) * a[i][v] + b[i][v];
        }
        store<VEC>(out + at, o);
      }
    }
  }
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bn_apply_kernel(const float* __restrict__ x, const float* __restrict__ mean,
                const float* __restrict__ rstd,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, float* __restrict__ y,
                long long n, int c, int s, Plan p) {
  bn_rows<VEC, false>(x, nullptr, nullptr, nullptr, 0.0, nullptr, mean, rstd,
                      gamma, beta, y, n, c, s, p);
}

template <int VEC>
__global__ void __launch_bounds__(kMaxThreads)
bn_dx_kernel(const float* __restrict__ x, const float* __restrict__ dy,
             const float* __restrict__ w, const float* __restrict__ count,
             double spatial, const double* __restrict__ sums,
             const float* __restrict__ mean, const float* __restrict__ rstd,
             const float* __restrict__ gamma, float* __restrict__ dx,
             long long n, int c, int s, Plan p) {
  bn_rows<VEC, true>(x, dy, w, count, spatial, sums, mean, rstd, gamma,
                     nullptr, dx, n, c, s, p);
}

dim3 grid_of(const Plan& p) { return dim3(p.tiles, p.slabs); }
dim3 block_of(const Plan& p) { return dim3(p.tx, p.ty); }

bool bad_sizes(long long n, int c, int s) {
  return n < 1 || c < 1 || s < 1 || static_cast<long long>(c) * s >= (1LL << 31);
}

long long partial_bytes(long long n, int c, int s, int k) {
  const int vecs[2] = {1, 4};
  long long most = 0;
  for (int vec : vecs) {
    const long long l = static_cast<long long>(c) * s;
    if (l % vec) continue;
    const Plan p = make_plan(n, l, vec);
    const long long b = static_cast<long long>(p.slabs) * k * l * 8;
    if (b > most) most = b;
  }
  return most;
}

template <int VEC, int MODE>
void launch_sums(const float* x, const float* dy, const float* w,
                 const float* count, double spatial, const double* sx,
                 const float* mean, double* part, long long n, int s,
                 const Plan& p, cudaStream_t st) {
  bn_sums_kernel<VEC, MODE><<<grid_of(p), block_of(p), 0, st>>>(
      x, dy, w, count, spatial, sx, mean, part, n, s, p);
}

template <int MODE>
void sums_for(const float* x, const float* dy, const float* w,
              const float* count, double spatial, const double* sx,
              const float* mean, double* part, long long n, int s,
              const Plan& p, cudaStream_t st) {
  if (p.vec == 4)
    launch_sums<4, MODE>(x, dy, w, count, spatial, sx, mean, part, n, s, p,
                         st);
  else
    launch_sums<1, MODE>(x, dy, w, count, spatial, sx, mean, part, n, s, p,
                         st);
}

}  // namespace

extern "C" {

// bytes of scratch armnet_bn_sums needs at [N, C, S] with K sums a column
long long armnet_bn_scratch_bytes(long long n, int c, int s, int k) {
  if (bad_sizes(n, c, s) || k < 1 || k > 2) return 0;
  return partial_bytes(n, c, s, k);
}

// Channel sums of x [N, C, S] into out (float64): mode 0 sum w x ([C]),
// mode 1 sum w (x - sx / n)^2 ([C]), mode 2 sum dy and sum dy (x - mean)
// over every row ([2, C]; with dgamma and dbeta also dbeta = s1, dgamma =
// rstd p). w and count may be null (no mask). Two launches; 0 or the
// cudaError_t of the launches.
int armnet_bn_sums(int mode, const float* x, const float* dy, const float* w,
                   const float* count, double spatial, const double* sx,
                   const float* mean, const float* rstd, float* dgamma,
                   float* dbeta, double* out, void* scratch, long long n,
                   int c, int s, void* stream) {
  if (bad_sizes(n, c, s) || mode < kSum || mode > kGrads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long l = static_cast<long long>(c) * s;
  const Plan p = make_plan(n, l, vec_for(l, x, dy, nullptr));
  double* part = static_cast<double*>(scratch);
  switch (mode) {
    case kSum:
      sums_for<kSum>(x, dy, w, count, spatial, sx, mean, part, n, s, p, st);
      break;
    case kSquares:
      sums_for<kSquares>(x, dy, w, count, spatial, sx, mean, part, n, s, p,
                         st);
      break;
    default:
      sums_for<kGrads>(x, dy, w, count, spatial, sx, mean, part, n, s, p, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_fold_kernel<<<dim3(c, mode == kGrads ? 2 : 1), kFoldThreads, 0, st>>>(
      part, p.slabs, c, s, out, rstd, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}

// mean, rstd = rsqrt(var + eps) and the running statistics (running = keep
// running + take batch; the variance unbiased by n / (n - 1)) from the
// channel sums sx = sum w x and sq = sum w (x - mean)^2
int armnet_bn_stats(const double* sx, const double* sq, const float* count,
                    double spatial, float eps, float keep, float take,
                    float* mean, float* rstd, float* running_mean,
                    float* running_var, int c, void* stream) {
  if (c < 1) return static_cast<int>(cudaErrorInvalidValue);
  bn_stats_kernel<<<(c + 255) / 256, 256, 0, static_cast<cudaStream_t>(
                                                  stream)>>>(
      sx, sq, count, spatial, eps, keep, take, mean, rstd, running_mean,
      running_var, c);
  return static_cast<int>(cudaGetLastError());
}

// y = (x - mean) (rstd gamma) + beta over x [N, C, S]
int armnet_bn_apply(const float* x, const float* mean, const float* rstd,
                    const float* gamma, const float* beta, float* y,
                    long long n, int c, int s, void* stream) {
  if (bad_sizes(n, c, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long l = static_cast<long long>(c) * s;
  const Plan p = make_plan(n, l, vec_for(l, x, y, nullptr));
  if (p.vec == 4)
    bn_apply_kernel<4><<<grid_of(p), block_of(p), 0, st>>>(
        x, mean, rstd, gamma, beta, y, n, c, s, p);
  else
    bn_apply_kernel<1><<<grid_of(p), block_of(p), 0, st>>>(
        x, mean, rstd, gamma, beta, y, n, c, s, p);
  return static_cast<int>(cudaGetLastError());
}

// dx over x [N, C, S] from dy, the rows' mask w (or null), count and the
// sums [s1 | p] of armnet_bn_sums mode 2 (all-reduced where the statistics
// are a group's)
int armnet_bn_dx(const float* x, const float* dy, const float* w,
                 const float* count, double spatial, const double* sums,
                 const float* mean, const float* rstd, const float* gamma,
                 float* dx, long long n, int c, int s, void* stream) {
  if (bad_sizes(n, c, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long l = static_cast<long long>(c) * s;
  const Plan p = make_plan(n, l, vec_for(l, x, dy, dx));
  if (p.vec == 4)
    bn_dx_kernel<4><<<grid_of(p), block_of(p), 0, st>>>(
        x, dy, w, count, spatial, sums, mean, rstd, gamma, dx, n, c, s, p);
  else
    bn_dx_kernel<1><<<grid_of(p), block_of(p), 0, st>>>(
        x, dy, w, count, spatial, sums, mean, rstd, gamma, dx, n, c, s, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
