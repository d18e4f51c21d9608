// One CIN layer (xDeepFM's compressed interaction network, Lian et al.,
// KDD'18) for Hopper (sm_90a), forward and backward, with the outer product
// of each example's fields kept on chip.
//
// Replaces no TPU kernel: the JAX package computes the layer as XLA ops
// (armnet_tpu/ops/interaction.py `compressed_interaction_step`), which
// materialise h[b, f*C + c, e] = x0[b, f, e] * xk[b, c, e] in device memory.
// At 65,536 rows, F 39, C 200 and E 10 that h is 20.4 GB a layer, and the
// backward needs it and its gradient: more than the card holds. Here h is
// formed tile by tile in shared memory and never reaches HBM.
//
// Layout (E before the channels): rows are m = b*E + e, so each operand is
// a row-major matrix: x0 [M, F], xk [M, C], out [M, N], W [F*C, N] (row
// f*C + c, the layer's filter as the port's module holds it). The caller
// passes [B, E, *] tensors, which the port's CIN keeps its layer outputs
// in, so no transpose of xk is made from the second layer on.
//
//   forward   out[m, n] = relu(sum_{f,c} x0[m, f] xk[m, c] W[f*C + c, n]):
//             a GEMM with M = B*E, N, K = F*C whose A tile is the product
//             x0[m, f] * xk[m, c0..c0+8) formed in registers from the rows'
//             xk chunk (loaded once per chunk of c and kept over every f)
//             and x0[m, f], and stored to shared memory; ReLU (NaN kept)
//             in the epilogue.
//   backward  g = dout where out > 0, else 0 (cin_bwd_mask_kernel); then
//             dW[f*C + c, n] = sum_m x0[m, f] xk[m, c] g[m, n]
//               (cin_bwd_dw_kernel: the transposed A tile formed as in the
//               forward; M cut into slices whose [K, N] partials are summed
//               in slice order by cin_bwd_sum_kernel, as K6's scratch rows
//               are, so two runs give the same bits);
//             P_f = g W_f^T [M, C] for each f, tile by tile on chip, and
//               dxk[m, c] = sum_f x0[m, f] P_f[m, c] (shared memory),
//               dx0[m, f] = sum_c xk[m, c] P_f[m, c] (a row sum of the tile,
//               ordered through shared memory; summed over column tiles in
//               tile order where C spans more than one)
//               (cin_bwd_dx_kernel).
//             P_f is never written: the backward costs two GEMMs, not three.
//
// What bounds it on an H100: float32 FMAs (TF32 off, as the configurations
// run). At F 39, C 200, N 200, E 10 a layer is 31.2 MFLOP an example
// forward and twice that backward; bytes are a few per FLOP's hundred. So
// the design is a SIMT SGEMM: 8x8 outputs a thread (two 4x4 halves, so a
// warp's float4 reads of a shared-memory row are conflict-free), k chunks
// of 8 double-buffered through shared memory with the next chunk's global
// loads in flight during the current chunk's FMAs, one barrier a chunk.
// Each thread works out its elements' offsets once; a chunk adds a base
// (W's and g's rows load as float4s where N is a multiple of 4). Tile
// shapes follow the output's width, so that a width of 200 (the published
// CIN maps) or 39 (the fields) wastes little: 80 x 200 (10 x 25 threads)
// past 128 columns, 128 x 128 (16 x 16) up to 128; dx, whose width is C,
// takes 200 x 80 (25 x 10) up to 40 columns with two fields a pass, one in
// each half of the tile (layer 0's C = F = 39 fills 78 of its 80 columns).
// Every edge is masked (any B, F, C, N). Two blocks an SM (128 registers a
// thread). Tried on the card and dropped (PERF.md): k chunks of 16 or 20,
// one block an SM, a warp spanning the short side of the thread grid, dx
// reading a transposed copy of W, a 400 x 40 dx tile for narrow C (it
// spilled at two blocks an SM, and ran slower than the plain version at
// one): none was faster.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kBK = 8;                    // k a chunk

template <int THM_, int THN_>
struct Tile {
  static constexpr int THM = THM_, THN = THN_;
  static constexpr int kThreads = THM * THN;
  static constexpr int BM = 8 * THM;      // rows a block
  static constexpr int BN = 8 * THN;      // columns a block
  static constexpr int kA = (BM * kBK + kThreads - 1) / kThreads;
  static constexpr int kB = (BN * kBK + kThreads - 1) / kThreads;
};

// the block row (or column) of a thread's i-th output: two halves of 4
__device__ __forceinline__ int half_index(int t, int i, int half) {
  return i < 4 ? t * 4 + i : half + t * 4 + (i - 4);
}

// acc += As[k, rows of the thread] x Bs[k, columns of the thread], k < kBK
template <int BM, int BN>
__device__ __forceinline__ void mma_chunk(const float* __restrict__ as,
                                          const float* __restrict__ bs,
                                          int mt, int nt, float (&acc)[8][8]) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * BM + mt * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(as + kk * BM + BM / 2 + mt * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * BN + nt * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(bs + kk * BN + BN / 2 + nt * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ float relu_keep_nan(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// A [kBK, BN] tile of row-major rows (`ld` floats apart) staged through
// registers into shared memory: the rows at base + kk * ld for kk < the
// rows a chunk has left, columns col0.. up to ncols, zero elsewhere. Each
// element's offset is worked out once (-1 where it lies outside the tile);
// a chunk adds its base. VEC: float4 elements (ld and col0 multiples of 4).
template <int BN, int NT, bool VEC>
struct RowTile {
  static constexpr int kW = VEC ? 4 : 1;
  static constexpr int kElems = BN * kBK / kW;
  static constexpr int kPer = (kElems + NT - 1) / NT;
  using Elem = typename std::conditional<VEC, float4, float>::type;
  int off[kPer];
  Elem r[kPer];

  __device__ __forceinline__ void init(int tid, int ld, int col0, int ncols) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * NT;
      const int kk = e / (BN / kW), col = col0 + (e % (BN / kW)) * kW;
      off[q] = (e < kElems && col < ncols) ? kk * ld + col : -1;
    }
  }
  // rows: those left from base on (at most kBK are read)
  __device__ __forceinline__ void load(const float* __restrict__ base,
                                       long long rows, int ld) {
    const unsigned lim =
        static_cast<unsigned>((rows < kBK ? rows : kBK) * ld);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const bool ok = static_cast<unsigned>(off[q]) < lim;
      if constexpr (VEC)
        r[q] = ok ? *reinterpret_cast<const float4*>(base + off[q])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        r[q] = ok ? base[off[q]] : 0.f;
    }
  }
  __device__ __forceinline__ void store(int tid, float* __restrict__ bs) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = tid + q * NT;
      if (e < kElems) reinterpret_cast<Elem*>(bs)[e] = r[q];
    }
  }
};

// out [M, N] = relu(A W), A[m, f*C + c] = x0[m, f] xk[m, c]. Chunks run c
// outer, f inner, so a thread's xk values stay in registers over the F
// chunks of one c chunk.
template <int THM, int THN, bool VEC>
__global__ void __launch_bounds__(THM * THN, 2)
cin_fwd_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
               const float* __restrict__ w, float* __restrict__ out,
               int m_rows, int nf, int nc, int nn) {
  using T = Tile<THM, THN>;
  constexpr int BM = T::BM, BN = T::BN, NT = T::kThreads;
  __shared__ __align__(16) float as[2][kBK * BM];
  __shared__ __align__(16) float bs[2][kBK * BN];
  const int tid = threadIdx.x, mt = tid / THN, nt = tid % THN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int total = ((nc + kBK - 1) / kBK) * nf;

  // this thread's A elements: row m0 + e / kBK, k offset e % kBK (k
  // fastest: a row's 8 floats); x0's row offset (-1 past the rows) and
  // xk's offset of the element in the first c chunk
  int x0o[T::kA], xko[T::kA];
#pragma unroll
  for (int q = 0; q < T::kA; ++q) {
    const int e = tid + q * NT;
    const long long m = m0 + e / kBK;
    const bool ok = e < BM * kBK && m < m_rows;
    x0o[q] = ok ? static_cast<int>(m * nf) : -1;
    xko[q] = ok ? static_cast<int>(m * nc) + e % kBK : 0;
  }
  RowTile<BN, NT, VEC> wt;
  wt.init(tid, nn, n0, nn);
  float xv[T::kA], ra[T::kA];
  int f = 0, c0 = 0;                      // the chunk load() reads next
  auto load = [&]() {
    const int rem = nc - c0;
#pragma unroll
    for (int q = 0; q < T::kA; ++q) {
      const bool ok = x0o[q] >= 0 && (tid + q * NT) % kBK < rem;
      if (f == 0) xv[q] = ok ? xk[xko[q] + c0] : 0.f;
      ra[q] = ok ? x0[x0o[q] + f] * xv[q] : 0.f;
    }
    wt.load(w + static_cast<long long>(f * nc + c0) * nn, rem, nn);
    if (++f == nf) {
      f = 0;
      c0 += kBK;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < T::kA; ++q) {
      const int e = tid + q * NT;
      if (e < BM * kBK) as[buf][(e % kBK) * BM + e / kBK] = ra[q];
    }
    wt.store(tid, bs[buf]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  load();
  store(0);
  __syncthreads();
  for (int t = 0; t < total; ++t) {
    const int cur = t & 1;
    if (t + 1 < total) load();
    mma_chunk<BM, BN>(as[cur], bs[cur], mt, nt, acc);
    if (t + 1 < total) store(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long m = m0 + half_index(mt, i, BM / 2);
    if (m >= m_rows) continue;
    float* row = out + m * nn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + half_index(nt, 4 * h, BN / 2);
      if (VEC && n < nn) {
        *reinterpret_cast<float4*>(row + n) = make_float4(
            relu_keep_nan(acc[i][4 * h]), relu_keep_nan(acc[i][4 * h + 1]),
            relu_keep_nan(acc[i][4 * h + 2]),
            relu_keep_nan(acc[i][4 * h + 3]));
      } else if (!VEC) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < nn) row[n + j] = relu_keep_nan(acc[i][4 * h + j]);
      }
    }
  }
}

// g = dout where out > 0, else 0 (the ReLU's gradient; NaN outputs give 0)
__global__ void cin_bwd_mask_kernel(const float* __restrict__ out,
                                    const float* __restrict__ dout,
                                    float* __restrict__ g, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride)
    g[i] = out[i] > 0.f ? dout[i] : 0.f;
}

// out[i] = sum over p of parts[p * len + i], p in order
__global__ void cin_bwd_sum_kernel(const float* __restrict__ parts,
                                   float* __restrict__ out, int nparts,
                                   long long len) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < len; i += stride) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += parts[p * len + i];
    out[i] = s;
  }
}

// For the column tile c of blockIdx.y and each f: P = g [BM rows, N] x
// W_f^T [N, tile], then dxk += x0[:, f] * P (summed over f in shared
// memory, so that P alone holds registers and two blocks fit an SM) and dx0
// part [blockIdx.y, m, f] = sum over the tile's c of xk[m, c] P[m, c].
// PAIR (C at most half the tile): two fields a pass, f in the tile's first
// half of columns and f + 1 in its second (a thread's columns lie 4 in each
// half), so that a narrow C fills the tile; dxk sums the halves at the end.
template <int THM, int THN, bool PAIR>
__global__ void __launch_bounds__(THM * THN, 2)
cin_bwd_dx_kernel(const float* __restrict__ g, const float* __restrict__ x0,
                  const float* __restrict__ xk, const float* __restrict__ w,
                  float* __restrict__ dxk, float* __restrict__ dx0,
                  int m_rows, int nf, int nc, int nn) {
  using T = Tile<THM, THN>;
  constexpr int BM = T::BM, BN = T::BN, NT = T::kThreads, HALF = BN / 2;
  constexpr int G = PAIR ? 2 : 1;         // fields a pass
  __shared__ __align__(16) float as[2][kBK * BM];
  __shared__ __align__(16) float bs[2][kBK * BN];
  __shared__ float red[G * THN * BM];
  extern __shared__ __align__(16) float accs[];   // [BM][BN]
  const int tid = threadIdx.x, mt = tid / THN, nt = tid % THN;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int cb = blockIdx.y * BN;
  for (int i = tid; i < BM * BN; i += NT) accs[i] = 0.f;
  const int total = ((nn + kBK - 1) / kBK) * ((nf + G - 1) / G);

  // offsets of this thread's elements: A, g's row m0 + e / kBK at k e %
  // kBK; B, W's row f*C + cb + e / kBK (PAIR: (f + half)*C + the column in
  // its half) at k e % kBK, from the pass's first field (-1: outside)
  int go[T::kA], wo[T::kB];
#pragma unroll
  for (int q = 0; q < T::kA; ++q) {
    const int e = tid + q * NT;
    const long long m = m0 + e / kBK;
    go[q] = (e < BM * kBK && m < m_rows)
                ? static_cast<int>(m * nn) + e % kBK : -1;
  }
#pragma unroll
  for (int q = 0; q < T::kB; ++q) {
    const int e = tid + q * NT, col = e / kBK;
    const int c = PAIR ? col % HALF : cb + col;
    const int row = PAIR ? (col / HALF) * nc + c : c;
    wo[q] = (e < BN * kBK && c < nc) ? row * nn + e % kBK : -1;
  }
  float ra[T::kA], rb[T::kB];
  int f = 0, k0 = 0;                      // the chunk load() reads next
  auto load = [&]() {
    const int rem = nn - k0;
    // PAIR: W's rows of the pass's fields (one where one is left)
    const int wlim = PAIR ? (nf - f < 2 ? 1 : 2) * nc * nn : 0;
    const float* gb = g + k0;
    const float* wb = w + static_cast<long long>(f) * nc * nn + k0;
#pragma unroll
    for (int q = 0; q < T::kA; ++q)
      ra[q] = (go[q] >= 0 && (tid + q * NT) % kBK < rem) ? gb[go[q]] : 0.f;
#pragma unroll
    for (int q = 0; q < T::kB; ++q)
      rb[q] = (wo[q] >= 0 && (!PAIR || wo[q] < wlim) &&
               (tid + q * NT) % kBK < rem) ? wb[wo[q]] : 0.f;
    k0 += kBK;
    if (k0 >= nn) {
      k0 = 0;
      f += G;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < T::kA; ++q) {
      const int e = tid + q * NT;
      if (e < BM * kBK) as[buf][(e % kBK) * BM + e / kBK] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < T::kB; ++q) {
      const int e = tid + q * NT;
      if (e < BN * kBK) bs[buf][(e % kBK) * BN + e / kBK] = rb[q];
    }
  };
  float p[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) p[i][j] = 0.f;
  load();
  store(0);
  __syncthreads();
  int fc = 0, kc = 0;                     // the chunk being multiplied
  for (int t = 0; t < total; ++t) {
    const int cur = t & 1;
    const bool last = kc + kBK >= nn;
    if (t + 1 < total) load();
    mma_chunk<BM, BN>(as[cur], bs[cur], mt, nt, p);
    if (last) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = half_index(mt, i, BM / 2);
        const long long m = m0 + r;
        const bool row_ok = m < m_rows;
        float x0v[G], s[G];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          x0v[h] = row_ok && (!PAIR || fc + h < nf) ? x0[m * nf + fc + h]
                                                    : 0.f;
          s[h] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int hf = PAIR ? h : 0;
          const int cl = half_index(nt, 4 * h, HALF);
          float4* a4 = reinterpret_cast<float4*>(accs + r * BN + cl);
          float4 a = *a4;
          a.x = fmaf(x0v[hf], p[i][4 * h], a.x);
          a.y = fmaf(x0v[hf], p[i][4 * h + 1], a.y);
          a.z = fmaf(x0v[hf], p[i][4 * h + 2], a.z);
          a.w = fmaf(x0v[hf], p[i][4 * h + 3], a.w);
          *a4 = a;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = PAIR ? nt * 4 + j : cb + cl + j;
            if (row_ok && c < nc)
              s[hf] = fmaf(xk[m * nc + c], p[i][4 * h + j], s[hf]);
            p[i][4 * h + j] = 0.f;
          }
        }
#pragma unroll
        for (int h = 0; h < G; ++h) red[(h * THN + nt) * BM + r] = s[h];
      }
    }
    if (t + 1 < total) store(cur ^ 1);
    __syncthreads();
    if (last) {
      for (int idx = tid; idx < G * BM; idx += NT) {
        const int h = idx / BM, r = idx % BM;
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < THN; ++k) s += red[(h * THN + k) * BM + r];
        const long long m = m0 + r;
        if (m < m_rows && (!PAIR || fc + h < nf))
          dx0[(static_cast<long long>(blockIdx.y) * m_rows + m) * nf + fc +
              h] = s;
      }
      __syncthreads();
      kc = 0;
      fc += G;
    } else {
      kc += kBK;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = half_index(mt, i, BM / 2);
    const long long m = m0 + r;
    if (m >= m_rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int cl = half_index(nt, j, HALF);
      if (PAIR) {
        if (j < 4 && cl < nc)
          dxk[m * nc + cl] = accs[r * BN + cl] + accs[r * BN + HALF + cl];
      } else if (cb + cl < nc) {
        dxk[m * nc + cb + cl] = accs[r * BN + cl];
      }
    }
  }
}

// The dW partial of the row slice blockIdx.z: part[z, r, n] = sum over the
// slice's m of A[m, r] g[m, n], r = f*C + c, tile rows r0.. and columns n0..
template <int THM, int THN, bool VEC>
__global__ void __launch_bounds__(THM * THN, 2)
cin_bwd_dw_kernel(const float* __restrict__ x0, const float* __restrict__ xk,
                  const float* __restrict__ g, float* __restrict__ part,
                  int m_rows, int nf, int nc, int nn, int slice_rows) {
  using T = Tile<THM, THN>;
  constexpr int BM = T::BM, BN = T::BN, NT = T::kThreads;
  __shared__ __align__(16) float as[2][kBK * BM];
  __shared__ __align__(16) float bs[2][kBK * BN];
  const int tid = threadIdx.x, mt = tid / THN, nt = tid % THN;
  const int nk = nf * nc;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long ms = static_cast<long long>(blockIdx.z) * slice_rows;
  const long long me = ms + slice_rows < m_rows ? ms + slice_rows : m_rows;
  const int total = me > ms ? static_cast<int>((me - ms + kBK - 1) / kBK) : 0;

  // this thread's A elements: output row r0 + e % BM (r fastest, so a
  // warp reads a run of xk's row), row m e / BM of the chunk; their x0 and
  // xk offsets from the chunk's first row (-1: outside)
  int a0o[T::kA], ako[T::kA];
#pragma unroll
  for (int q = 0; q < T::kA; ++q) {
    const int e = tid + q * NT;
    const int r = r0 + e % BM, kk = e / BM;
    const bool ok = e < BM * kBK && r < nk;
    a0o[q] = ok ? kk * nf + r / nc : -1;
    ako[q] = ok ? kk * nc + r % nc : 0;
  }
  RowTile<BN, NT, VEC> gt;
  gt.init(tid, nn, n0, nn);
  float ra[T::kA];
  long long mb = ms;                      // the chunk load() reads next
  auto load = [&]() {
    const long long rows = me - mb;
    const float* x0b = x0 + mb * nf;
    const float* xkb = xk + mb * nc;
#pragma unroll
    for (int q = 0; q < T::kA; ++q)
      ra[q] = (a0o[q] >= 0 && (tid + q * NT) / BM < rows)
                  ? x0b[a0o[q]] * xkb[ako[q]]
                  : 0.f;
    gt.load(g + mb * nn, rows, nn);
    mb += kBK;
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < T::kA; ++q) {
      const int e = tid + q * NT;
      if (e < BM * kBK) as[buf][e] = ra[q];
    }
    gt.store(tid, bs[buf]);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  if (total > 0) {
    load();
    store(0);
    __syncthreads();
  }
  for (int t = 0; t < total; ++t) {
    const int cur = t & 1;
    if (t + 1 < total) load();
    mma_chunk<BM, BN>(as[cur], bs[cur], mt, nt, acc);
    if (t + 1 < total) store(cur ^ 1);
    __syncthreads();
  }
  float* out = part + static_cast<long long>(blockIdx.z) * nk * nn;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + half_index(mt, i, BM / 2);
    if (r >= nk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + half_index(nt, j, BN / 2);
      if (n < nn) out[static_cast<long long>(r) * nn + n] = acc[i][j];
    }
  }
}

// the tile shape for an output `cols` wide: 0 = 80 x 200, 1 = 128 x 128;
// dx's for C columns, also 2 = 200 x 80 with two fields a pass (PAIR)
int shape_for(int cols) { return cols <= 128 ? 1 : 0; }
int dx_shape_for(int cols) { return cols <= 40 ? 2 : shape_for(cols); }

int block_cols(int shape) { return shape == 1 ? 128 : 200; }
int block_rows(int shape) { return shape == 1 ? 128 : 80; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// row slices of the dW GEMM: enough blocks for ~8 waves of 264 (2 a SM on
// 132 SMs), each slice at least 128 rows, at most 64 slices
int dw_slices(int m_rows, int nf, int nc, int nn) {
  const int s = shape_for(nn);
  const long long tiles =
      ceil_div(static_cast<long long>(nf) * nc, block_rows(s)) *
      ceil_div(nn, block_cols(s));
  long long want = ceil_div(8 * 264, tiles);
  const long long most = m_rows / 128 > 0 ? m_rows / 128 : 1;
  if (want > most) want = most;
  if (want > 64) want = 64;
  return want < 1 ? 1 : static_cast<int>(want);
}

int dw_slice_rows(int m_rows, int slices) {
  return static_cast<int>(ceil_div(ceil_div(m_rows, slices), kBK) * kBK);
}

struct BwdPlan {
  int shape_dx, ctiles, shape_dw, slices, slice_rows;
  long long g_floats, dx0_floats, dw_floats;
};

BwdPlan plan(int m_rows, int nf, int nc, int nn) {
  BwdPlan p;
  p.shape_dx = dx_shape_for(nc);
  p.ctiles = p.shape_dx == 2
                 ? 1 : static_cast<int>(ceil_div(nc, block_cols(p.shape_dx)));
  p.shape_dw = shape_for(nn);
  p.slices = dw_slices(m_rows, nf, nc, nn);
  p.slice_rows = dw_slice_rows(m_rows, p.slices);
  p.g_floats = static_cast<long long>(m_rows) * nn;
  p.dx0_floats = p.ctiles > 1 ? static_cast<long long>(p.ctiles) * m_rows * nf
                              : 0;
  p.dw_floats = p.slices > 1
                    ? static_cast<long long>(p.slices) * nf * nc * nn
                    : 0;
  return p;
}

int launch_sum(const float* parts, float* out, int nparts, long long len,
               cudaStream_t st) {
  const int threads = 256;
  long long blocks = ceil_div(len, threads);
  if (blocks > 132 * 16) blocks = 132 * 16;
  cin_bwd_sum_kernel<<<static_cast<int>(blocks), threads, 0, st>>>(
      parts, out, nparts, len);
  return static_cast<int>(cudaGetLastError());
}

// float4 loads of the rows of N where N is a multiple of 4
template <class T>
int launch_fwd(const float* x0, const float* xk, const float* w, float* out,
               int m, int f, int c, int n, cudaStream_t st) {
  dim3 grid(static_cast<unsigned>(ceil_div(m, T::BM)),
            static_cast<unsigned>(ceil_div(n, T::BN)));
  if (n % 4 == 0)
    cin_fwd_kernel<T::THM, T::THN, true><<<grid, T::kThreads, 0, st>>>(
        x0, xk, w, out, m, f, c, n);
  else
    cin_fwd_kernel<T::THM, T::THN, false><<<grid, T::kThreads, 0, st>>>(
        x0, xk, w, out, m, f, c, n);
  return static_cast<int>(cudaGetLastError());
}

template <class T, bool PAIR>
int launch_dx(const float* g, const float* x0, const float* xk,
              const float* w, float* dxk, float* dx0, int m, int f, int c,
              int n, cudaStream_t st) {
  dim3 grid(static_cast<unsigned>(ceil_div(m, T::BM)),
            PAIR ? 1u : static_cast<unsigned>(ceil_div(c, T::BN)));
  constexpr int bytes = 4 * T::BM * T::BN;
  int e0 = static_cast<int>(cudaFuncSetAttribute(
      cin_bwd_dx_kernel<T::THM, T::THN, PAIR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (e0) return e0;
  cin_bwd_dx_kernel<T::THM, T::THN, PAIR><<<grid, T::kThreads, bytes, st>>>(
      g, x0, xk, w, dxk, dx0, m, f, c, n);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int launch_dw(const float* x0, const float* xk, const float* g, float* part,
              int m, int f, int c, int n, int slices, int slice_rows,
              cudaStream_t st) {
  dim3 grid(static_cast<unsigned>(ceil_div(static_cast<long long>(f) * c,
                                           T::BM)),
            static_cast<unsigned>(ceil_div(n, T::BN)),
            static_cast<unsigned>(slices));
  if (n % 4 == 0)
    cin_bwd_dw_kernel<T::THM, T::THN, true><<<grid, T::kThreads, 0, st>>>(
        x0, xk, g, part, m, f, c, n, slice_rows);
  else
    cin_bwd_dw_kernel<T::THM, T::THN, false><<<grid, T::kThreads, 0, st>>>(
        x0, xk, g, part, m, f, c, n, slice_rows);
  return static_cast<int>(cudaGetLastError());
}

using Wide = Tile<10, 25>;
using Square = Tile<16, 16>;
using Pair = Tile<25, 10>;

bool bad_sizes(int m, int f, int c, int n) {
  const long long widest = f > c ? (f > n ? f : n) : (c > n ? c : n);
  return m <= 0 || f <= 0 || c <= 0 || n <= 0 ||
         static_cast<long long>(m) * widest >= (1LL << 31) ||
         static_cast<long long>(f) * c * n >= (1LL << 31);
}

}  // namespace

extern "C" {

// out [M, N] = relu(sum_{f,c} x0[m, f] xk[m, c] w[f*C + c, n]); 0 or the
// cudaError_t of the launch (cudaErrorInvalidValue for sizes it refuses)
int armnet_cin_fwd(const float* x0, const float* xk, const float* w,
                   float* out, int m, int f, int c, int n, void* stream) {
  if (bad_sizes(m, f, c, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shape_for(n)) {
    case 1: return launch_fwd<Square>(x0, xk, w, out, m, f, c, n, st);
    default: return launch_fwd<Wide>(x0, xk, w, out, m, f, c, n, st);
  }
}

// bytes of scratch armnet_cin_bwd needs: g, dx0's column-tile parts where C
// spans more than one tile, dW's row-slice parts where M is cut
long long armnet_cin_bwd_scratch(int m, int f, int c, int n) {
  if (bad_sizes(m, f, c, n)) return 0;
  const BwdPlan p = plan(m, f, c, n);
  return 4 * (p.g_floats + p.dx0_floats + p.dw_floats);
}

// dx0 [M, F], dxk [M, C], dw [F*C, N] of the layer, from its inputs, its
// output and dout [M, N]; scratch of armnet_cin_bwd_scratch bytes
int armnet_cin_bwd(const float* x0, const float* xk, const float* w,
                   const float* out, const float* dout, float* dx0,
                   float* dxk, float* dw, void* scratch, int m, int f, int c,
                   int n, void* stream) {
  if (bad_sizes(m, f, c, n)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BwdPlan p = plan(m, f, c, n);
  float* g = static_cast<float*>(scratch);
  float* dx0_parts = p.ctiles > 1 ? g + p.g_floats : dx0;
  float* dw_parts = p.slices > 1 ? g + p.g_floats + p.dx0_floats : dw;

  {
    long long blocks = ceil_div(p.g_floats, 256);
    if (blocks > 132 * 16) blocks = 132 * 16;
    cin_bwd_mask_kernel<<<static_cast<int>(blocks), 256, 0, st>>>(
        out, dout, g, p.g_floats);
    const int err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  int err;
  switch (p.shape_dx) {
    case 2: err = launch_dx<Pair, true>(g, x0, xk, w, dxk, dx0_parts, m, f,
                                        c, n, st); break;
    case 1: err = launch_dx<Square, false>(g, x0, xk, w, dxk, dx0_parts, m,
                                           f, c, n, st); break;
    default: err = launch_dx<Wide, false>(g, x0, xk, w, dxk, dx0_parts, m, f,
                                          c, n, st);
  }
  if (err) return err;
  if (p.ctiles > 1) {
    err = launch_sum(dx0_parts, dx0, p.ctiles,
                     static_cast<long long>(m) * f, st);
    if (err) return err;
  }
  switch (p.shape_dw) {
    case 1: err = launch_dw<Square>(x0, xk, g, dw_parts, m, f, c, n,
                                    p.slices, p.slice_rows, st); break;
    default: err = launch_dw<Wide>(x0, xk, g, dw_parts, m, f, c, n, p.slices,
                                   p.slice_rows, st);
  }
  if (err) return err;
  if (p.slices > 1)
    err = launch_sum(dw_parts, dw, p.slices, static_cast<long long>(f) * c * n,
                     st);
  return err;
}

// launches armnet_cin_bwd makes at these sizes (for the wrappers' counts)
int armnet_cin_bwd_launches(int m, int f, int c, int n) {
  if (bad_sizes(m, f, c, n)) return 0;
  const BwdPlan p = plan(m, f, c, n);
  return 3 + (p.ctiles > 1) + (p.slices > 1);
}

}  // extern "C"
