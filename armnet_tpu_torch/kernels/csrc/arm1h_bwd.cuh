// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a): its
// kernel, the ordered sum of the blocks' batch sums and the C entries; see
// arm1h.cuh for the design. A source that includes this header defines
// armnet::pick_bwd for the solver modes and widths it instantiates:
// arm1h_bwd.cu the bisection modes, arm1h_bwd_fastpow.cu and
// arm1h_bwd_newton.cu one powf mode each, all for E and dk <= kMaxED;
// arm1h_bwd_wide.cu and arm1h_bwd_wide_powf.cu the same modes for wider
// rows; arm1h_bwd_col.cu and arm1h_bwd_col_powf.cu both widths past 40
// fields, with MAXF = 0: the thread's column y in shared memory. The width
// and the column's place are template arguments so that the narrow kernels
// keep their registers: a runtime branch to the wide code, in the same
// kernel, spilled in bucket 40 and slowed it 3-10% (PERF.md).

#pragma once

#include "arm1h.cuh"

namespace armnet {

// resident blocks per SM that ptxas must leave registers for (128 a
// thread), and that bwd_layout's shared memory allows at the cr_armnet1h
// shapes
constexpr int kBwdMinBlocks = 4;
// the same for the wide build, whose shared memory (sized by O, E and dk)
// rarely leaves room for more; at 4 it spilled 16-48 B (PERF.md)
constexpr int kBwdWideMinBlocks = 3;
constexpr int kTile = kThreads + 1;    // row stride of the [F, 129] tile

// K6's shared memory, offsets in floats (each a multiple of 4):
//   emb    [F, pad4(E)]     the row's embeddings
//   keys   [F, pad4(DK)]    its keys
//   q      [QR, pad4(DK)]   the chunk's query rows, then dkeys
//   dz     [R, pad4(E)]     the chunk's dz rows
//   tile   [F, 129]         dg, then w, of the chunk's columns
//   part_a [G, F, pad4(DK)] the contraction groups' partial dkeys / s
//   part_b [G, F, pad4(E)]  their partial sums of w dz
//   col    [F, C]           past 40 fields, the threads' columns y (C 128)
// total floats in `total`. The narrow build: R = QR = 128, G = 128 / F.
// The wide one (bwd_wide_layout) sizes R by O, and G by what fits. Past 40
// fields QR is at least F (dkeys [F, DK] takes the query rows' place).
struct BwdLayout {
  int ep, dp, groups, keys, q, dz, tile, part_a, part_b, col, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int F, int E, int DK, int QR,
                                                int R, int G, int C = 0) {
  BwdLayout l;
  l.ep = pad4(E);
  l.dp = pad4(DK);
  l.groups = G;
  l.keys = F * l.ep;
  l.q = l.keys + F * l.dp;
  l.dz = l.q + QR * l.dp;
  l.tile = l.dz + R * l.ep;
  l.part_a = l.tile + pad4(F * kTile);
  l.part_b = l.part_a + G * F * l.dp;
  l.col = l.part_b + G * F * l.ep;
  l.total = l.col + F * C;
  return l;
}

// the narrow build's layout past 40 fields: 128 chunk rows, at least F
// query rows, G groups, the threads' columns
__host__ __device__ inline BwdLayout bwd_col_layout(int F, int E, int DK,
                                                    int G) {
  return bwd_layout(F, E, DK, F > kThreads ? F : kThreads, kThreads, G,
                    kThreads);
}

// the wide build's layout: R = min(O, 128) columns a chunk, the query rows
// at least F (dkeys [F, DK] takes their place), G groups
__host__ __device__ inline BwdLayout bwd_wide_layout(int F, int E, int DK,
                                                     int O, int G,
                                                     int C = 0) {
  const int rows = O < kThreads ? O : kThreads;
  return bwd_layout(F, E, DK, rows > F ? rows : F, rows, G, C);
}

// *groups = the wide build's contraction groups at these shapes on the
// current device: at most 128 / F (at least 1) and the chunk's columns,
// and as many as leave kBwdWideMinBlocks blocks room on an SM; where even
// one does not, as many as one block holds; 0 where not even one fits.
// C: the columns' floats a field (kThreads past 40 fields, else 0)
inline cudaError_t bwd_wide_groups(int F, int E, int DK, int O, int C,
                                   int* groups) {
  int dev = 0, optin = 0, per_sm = 0, reserved = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
  if (err != cudaSuccess) return err;
  const BwdLayout fixed = bwd_wide_layout(F, E, DK, O, 0, C);
  const int64_t per_group = (int64_t)F * (fixed.ep + fixed.dp);
  const auto fit = [&](int64_t bytes) -> int64_t {
    const int64_t room = bytes / (int64_t)sizeof(float) - fixed.total;
    return room < per_group ? 0 : room / per_group;
  };
  int64_t g = fit(per_sm / kBwdWideMinBlocks - reserved);
  if (g < 1) g = fit(optin);
  int64_t cap = F < kThreads ? kThreads / F : 1;
  if (O < cap) cap = O;
  *groups = (int)(g < cap ? g : cap);
  return cudaSuccess;
}

// (groups, shared memory bytes) of a K6 block: the narrow build's fixed
// layout, or the wide one's, each with the threads' columns past 40
// fields; groups 0 where the plan does not fit a block
inline cudaError_t bwd_plan(int F, int E, int DK, int O, bool wide,
                            int* groups, size_t* smem) {
  const bool col = F > kMaxF;
  BwdLayout l;
  if (wide) {
    const cudaError_t err =
        bwd_wide_groups(F, E, DK, O, col ? kThreads : 0, groups);
    if (err != cudaSuccess) return err;
    l = bwd_wide_layout(F, E, DK, O, *groups, col ? kThreads : 0);
  } else if (col) {
    *groups = F < kThreads ? kThreads / F : 1;
    l = bwd_col_layout(F, E, DK, *groups);
    if (sizeof(float) * (size_t)l.total > smem_optin()) *groups = 0;
  } else {
    *groups = kThreads / F;
    l = bwd_layout(F, E, DK, kThreads, kThreads, *groups);
  }
  *smem = sizeof(float) * (size_t)l.total;
  return cudaSuccess;
}

// sum over e < n of a[e] b[e], one FMA chain in index order, both rows in
// shared memory padded to float4s (the wide path's dw)
__device__ __forceinline__ float dot_rows(const float* a, const float* b,
                                          int n) {
  float s = 0.0f;
  for (int c = 0; c < n; c += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + c);
    const float4 r = *reinterpret_cast<const float4*>(b + c);
    s = fmaf(x.x, r.x, s);
    s = fmaf(x.y, r.y, s);
    s = fmaf(x.z, r.z, s);
    s = fmaf(x.w, r.w, s);
  }
  return s;
}

// part[grp, f, :n] (+)= sum over this group's columns k of tile[f, k]
// m[k, :n] (m's rows padded to `mp`): one of the two contractions over
// the chunk's kc columns, the thread being field f of group grp; rows of
// at most kMaxED in one pass, or (WIDE) any width 4 columns at a time
template <int WIDE>
__device__ __forceinline__ void contract(const float* tile, const float* m,
                                         int mp, int n, int kc, int groups,
                                         int grp, int F, int f, float* part,
                                         bool first) {
  if constexpr (!WIDE) {
    float acc[kMaxED] = {};
    const int k1 = (grp + 1) * kc / groups;
    const float* tr = tile + f * kTile;
    for (int k = grp * kc / groups; k < k1; ++k)
      axpy_row(acc, tr[k], m + k * mp, n);
    float* pr = part + (grp * F + f) * mp;
#pragma unroll
    for (int c = 0; c < kMaxED; c += 4) {
      if (c < n) {
        float4 v = make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
        if (!first) {
          const float4 p = *reinterpret_cast<const float4*>(pr + c);
          v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
        }
        *reinterpret_cast<float4*>(pr + c) = v;
      }
    }
    return;
  }
  const int k0 = grp * kc / groups, k1 = (grp + 1) * kc / groups;
  const float* tr = tile + f * kTile;
  float* pr = part + (grp * F + f) * mp;
  for (int c = 0; c < n; c += 4) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = k0; k < k1; ++k) {
      const float x = tr[k];
      const float4 r = *reinterpret_cast<const float4*>(m + k * mp + c);
      v = make_float4(fmaf(x, r.x, v.x), fmaf(x, r.y, v.y),
                      fmaf(x, r.z, v.z), fmaf(x, r.w, v.w));
    }
    if (!first) {
      const float4 p = *reinterpret_cast<const float4*>(pr + c);
      v = make_float4(p.x + v.x, p.y + v.y, p.z + v.z, p.w + v.w);
    }
    *reinterpret_cast<float4*>(pr + c) = v;
  }
}

// WIDE 0 takes E, DK <= kMaxED, with the per-column sums of e and d in
// registers; WIDE 1 any width, those sums 4 at a time through shared
// memory (the tile and the thread's dz row). MAXF 16 or 40 holds the
// thread's column y in registers; MAXF 0, past 40 fields, in the layout's
// `col` region, solved by entmax_column_strided (every loop over f then
// has F trips and is not unrolled).
template <int MAXF, int MODE, int GMODE, int WIDE>
__global__ void __launch_bounds__(kThreads,
                                  WIDE ? kBwdWideMinBlocks : kBwdMinBlocks)
arm1h_bwd_kernel(const float* __restrict__ emb,
                 const float* __restrict__ dout,
                 const float* __restrict__ wk, const float* __restrict__ q,
                 const float* __restrict__ vt, float* __restrict__ de,
                 float* __restrict__ partial, int B, int F, int E, int DK,
                 int O, int groups, int n_iter, float scale, float am1,
                 float inv_am1, float c_hi, float ge) {
  constexpr bool kPad = is_bisect(MODE);
  extern __shared__ __align__(16) float smem[];
  constexpr int kCol = MAXF ? 0 : kThreads;
  const BwdLayout L =
      WIDE   ? bwd_wide_layout(F, E, DK, O, groups, kCol)
      : MAXF ? bwd_layout(F, E, DK, kThreads, kThreads, kThreads / F)
             : bwd_col_layout(F, E, DK, groups);
  float* emb_s = smem;
  float* keys_s = smem + L.keys;
  float* q_s = smem + L.q;
  float* dz_s = smem + L.dz;
  float* tile = smem + L.tile;
  float* part_a = smem + L.part_a;
  float* part_b = smem + L.part_b;
  const int tid = threadIdx.x;
  // the contractions: field cf of column group grp (threads past
  // groups * F idle; past 128 fields, MAXF 0, threads take several)
  const int grp = tid / F, cf = tid - grp * F;
  const int nf = MAXF ? MAXF : F;      // the trip count of a loop over f
  // this block's batch sums, its row of `partial`: dWk [E, DK], dq [O, DK]
  // (unscaled until the end), dvt [F, O]; each element has one owner thread
  const int P = E * DK + O * DK + F * O;
  float* acc_dwk = partial + (int64_t)blockIdx.x * P;
  float* acc_dq = acc_dwk + E * DK;
  float* acc_dvt = acc_dq + O * DK;
  for (int i = tid; i < P; i += kThreads) acc_dwk[i] = 0.0f;

  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();        // the last row's readers are done, sums zeroed
    stage_rows(emb_s, emb + b * F * E, F, E);
    __syncthreads();
    block_keys(emb_s, wk, keys_s, F, E, DK);
    __syncthreads();

    for (int c0 = 0; c0 < O; c0 += kThreads) {
      const int kc = min(kThreads, O - c0);
      const int o = c0 + tid;
      const float* vto = vt + o;         // vt[f, o] at vto[f * O]
      float* tcol = tile + tid;          // this thread's column of the tile
      float y[MAXF ? MAXF : 1];
      float* ycol = smem + L.col + tid;
      auto Y = [&](int f) -> float& {    // y[f] of the thread's column
        if constexpr (MAXF > 0) return y[f];
        else return ycol[f * kThreads];
      };
      if (tid < kc) {
        // the query row, padded, for the gates and the dkeys contraction
        float* qr = q_s + tid * L.dp;
        for (int d = 0; d < L.dp; ++d) qr[d] = d < DK ? q[o * DK + d] : 0.0f;
        if constexpr (MAXF > 0) {
          gate_column<MAXF>(y, keys_s, qr, F, DK, scale, am1,
                            kPad ? -INFINITY : 0.0f);
          entmax_column<MAXF, MODE, kPad>(y, F, n_iter, inv_am1, c_hi);
        } else {
          gate_column_strided(ycol, kThreads, keys_s, qr, F, DK, scale, am1);
          entmax_column_strided<MODE>(ycol, kThreads, F, n_iter, inv_am1,
                                      c_hi);
        }
        // z[e] = sum_f w[f] emb[f, e], w = y vt; dz = dout exp(z), kept in
        // registers (narrow) or, 4 e at a time with w from the tile, in
        // the thread's row of dz_s (WIDE)
        const float* dob = dout + (b * O + o) * E;
        float* dzr = dz_s + tid * L.ep;
        float dz[kMaxED] = {};
        if constexpr (!WIDE) {
#pragma unroll
          for (int f = 0; f < nf; ++f)
            if (f < F) axpy_row(dz, __fmul_rn(Y(f), vto[f * O]),
                                emb_s + f * L.ep, E);
#pragma unroll
          for (int e = 0; e < kMaxED; ++e)
            if (e < E) dz[e] = __fmul_rn(dob[e], expf(dz[e]));
#pragma unroll
          for (int c = 0; c < kMaxED; c += 4)
            if (c < E)
              *reinterpret_cast<float4*>(dzr + c) =
                  make_float4(dz[c], dz[c + 1], dz[c + 2], dz[c + 3]);
        } else {
#pragma unroll
          for (int f = 0; f < nf; ++f)
            if (f < F) tcol[f * kTile] = __fmul_rn(Y(f), vto[f * O]);
          for (int h = 0; h < E; h += 4) {
            float z[4] = {};
            for (int f = 0; f < F; ++f) {
              const float w = tcol[f * kTile];
              const float4 x =
                  *reinterpret_cast<const float4*>(emb_s + f * L.ep + h);
              z[0] = fmaf(w, x.x, z[0]);
              z[1] = fmaf(w, x.y, z[1]);
              z[2] = fmaf(w, x.z, z[2]);
              z[3] = fmaf(w, x.w, z[3]);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
              z[j] = h + j < E ? __fmul_rn(dob[h + j], expf(z[j])) : 0.0f;
            *reinterpret_cast<float4*>(dzr + h) =
                make_float4(z[0], z[1], z[2], z[3]);
          }
        }
        // dw[f] = sum_e dz[e] emb[f, e]; the dvt sum += dw y; t = dw vt g
        // waits in the tile for the VJP's dg = t - (sum t / sum g) g
        float sum_t = 0.0f, sum_g = 0.0f;
#pragma unroll
        for (int f = 0; f < nf; ++f) {
          if (f < F) {
            const float* er = emb_s + f * L.ep;
            float s = 0.0f;      // dw[f]; dz and emb are 0 past E
            if constexpr (!WIDE) {
#pragma unroll
              for (int c = 0; c < kMaxED; c += 4) {
                if (c < E) {
                  const float4 x = *reinterpret_cast<const float4*>(er + c);
                  s = fmaf(dz[c], x.x, s);
                  s = fmaf(dz[c + 1], x.y, s);
                  s = fmaf(dz[c + 2], x.z, s);
                  s = fmaf(dz[c + 3], x.w, s);
                }
              }
            } else {
              s = dot_rows(dzr, er, E);
            }
            acc_dvt[f * O + o] += __fmul_rn(s, Y(f));
            const float g = gppr<GMODE>(Y(f), ge);
            const float t = __fmul_rn(__fmul_rn(s, vto[f * O]), g);
            tcol[f * kTile] = t;
            sum_t += t;
            sum_g += g;
          }
        }
        const float qq = sum_t / sum_g;
        // the dq sum += dg^T keys: in registers (narrow) or 4 d at a time
        // with dg from the tile (WIDE)
        float dq[kMaxED] = {};
#pragma unroll
        for (int f = 0; f < nf; ++f) {
          if (f < F) {
            const float g = gppr<GMODE>(Y(f), ge);
            const float dg = __fsub_rn(tcol[f * kTile], __fmul_rn(qq, g));
            tcol[f * kTile] = dg;
            if constexpr (!WIDE) axpy_row(dq, dg, keys_s + f * L.dp, DK);
          }
        }
        float* aq = acc_dq + o * DK;
        if constexpr (!WIDE) {
#pragma unroll
          for (int d = 0; d < kMaxED; ++d)
            if (d < DK) aq[d] += dq[d];
        } else {
          for (int d0 = 0; d0 < DK; d0 += 4) {
            float a[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[j] = d0 + j < DK ? aq[d0 + j] : 0.0f;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (int f = 0; f < F; ++f) {
              const float x = tcol[f * kTile];
              const float4 r =
                  *reinterpret_cast<const float4*>(keys_s + f * L.dp + d0);
              v = make_float4(fmaf(x, r.x, v.x), fmaf(x, r.y, v.y),
                              fmaf(x, r.z, v.z), fmaf(x, r.w, v.w));
            }
            const float v4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (d0 + j < DK) aq[d0 + j] = a[j] + v4[j];
          }
        }
      }
      __syncthreads();                   // dg, q and dz of the chunk ready
      if constexpr (MAXF > 0) {
        if (grp < L.groups)              // dkeys / s = dg q
          contract<WIDE>(tile, q_s, L.dp, DK, kc, L.groups, grp, F, cf,
                         part_a, c0 == 0);
      } else {
        for (int i = tid; i < L.groups * F; i += kThreads)
          contract<WIDE>(tile, q_s, L.dp, DK, kc, L.groups, i / F, F, i % F,
                         part_a, c0 == 0);
      }
      __syncthreads();
      if (tid < kc) {
#pragma unroll
        for (int f = 0; f < nf; ++f)
          if (f < F) tcol[f * kTile] = __fmul_rn(Y(f), vto[f * O]);
      }
      __syncthreads();                   // w of the chunk ready
      if constexpr (MAXF > 0) {
        if (grp < L.groups)              // the first term of de, w dz
          contract<WIDE>(tile, dz_s, L.ep, E, kc, L.groups, grp, F, cf,
                         part_b, c0 == 0);
      } else {
        for (int i = tid; i < L.groups * F; i += kThreads)
          contract<WIDE>(tile, dz_s, L.ep, E, kc, L.groups, i / F, F, i % F,
                         part_b, c0 == 0);
      }
      __syncthreads();
    }

    // dkeys [F, DK] = s * the groups' sums in group order, where the
    // query rows were (read by no one until the next row's first chunk)
    float* dkeys_s = q_s;
    for (int i = tid; i < F * DK; i += kThreads) {
      const int f = i / DK, d = i - f * DK;
      float s = 0.0f;
      for (int g = 0; g < L.groups; ++g) s += part_a[(g * F + f) * L.dp + d];
      dkeys_s[i] = __fmul_rn(s, scale);
    }
    __syncthreads();
    // de[f, e] = sum_o w dz + sum_d dkeys[f, d] wk[e, d]
    float* deb = de + b * F * E;
    for (int i = tid; i < F * E; i += kThreads) {
      const int f = i / E, e = i - f * E;
      float s = 0.0f, s2 = 0.0f;
      for (int g = 0; g < L.groups; ++g) s += part_b[(g * F + f) * L.ep + e];
      if constexpr (!WIDE) {
        for (int d = 0; d < DK; ++d) s2 += dkeys_s[f * DK + d] * wk[e * DK + d];
      } else {       // four chains, so that wk's loads overlap
        const float* dkr = dkeys_s + f * DK;
        const float* wkr = wk + e * DK;
        float t[4] = {};
        int d = 0;
        for (; d + 4 <= DK; d += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) t[j] += dkr[d + j] * wkr[d + j];
        }
        for (; d < DK; ++d) t[0] += dkr[d] * wkr[d];
        s2 = (t[0] + t[1]) + (t[2] + t[3]);
      }
      deb[i] = s + s2;
    }
    // dWk[e, d] += sum_f emb[f, e] dkeys[f, d]; wide, four owners' round
    // trips to L2 in flight at once
    if constexpr (!WIDE) {
      for (int i = tid; i < E * DK; i += kThreads) {
        const int e = i / DK, d = i - e * DK;
        float s = 0.0f;
        for (int f = 0; f < F; ++f)
          s += emb_s[f * L.ep + e] * dkeys_s[f * DK + d];
        acc_dwk[i] += s;
      }
    } else {
      for (int i0 = tid; i0 < E * DK; i0 += 4 * kThreads) {
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j * kThreads;
          a[j] = i < E * DK ? acc_dwk[i] : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = i0 + j * kThreads;
          if (i < E * DK) {
            const int e = i / DK, d = i - e * DK;
            float s = 0.0f;
            for (int f = 0; f < F; ++f)
              s += emb_s[f * L.ep + e] * dkeys_s[f * DK + d];
            acc_dwk[i] = a[j] + s;
          }
        }
      }
    }
  }
  // dq = s * the sums, each by its owner
  for (int i = tid; i < O; i += kThreads)
    for (int d = 0; d < DK; ++d)
      acc_dq[i * DK + d] = __fmul_rn(acc_dq[i * DK + d], scale);
}

constexpr int kSumCols = 32, kSumGroups = 8;

// out[j] = the sum over the rows k of partial [rows, P]: each of 8 row
// groups (k = group mod 8) sums its rows in order, then the 8 are added in
// group order; deterministic
__global__ void __launch_bounds__(kSumCols * kSumGroups)
sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int rows, int P) {
  __shared__ float s[kSumGroups][kSumCols];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int j = blockIdx.x * kSumCols + tx;
  float v = 0.0f;
  if (j < P) {
#pragma unroll 4
    for (int k = ty; k < rows; k += kSumGroups)
      v += partial[(int64_t)k * P + j];
  }
  s[ty][tx] = v;
  __syncthreads();
  if (ty == 0 && j < P) {
    for (int g = 1; g < kSumGroups; ++g) v += s[g][tx];
    out[j] = v;
  }
}

using BwdKernel = decltype(&arm1h_bwd_kernel<16, BISECT1, G_ONE, 0>);

// the kernel of F's register bucket, the solver and g modes and the width
// class (wide: E or DK > kMaxED); nullptr for a pair that one alpha does
// not give, or for what this source does not build
BwdKernel pick_bwd(int F, int mode, int gmode, bool wide);

}  // namespace armnet

// The fused ARM-1h backward: de [B, F, E] and grads = [dWk [E, DK] | dq
// [O, DK] | dvt [F, O]] flat, from the forward's inputs and dout [B, O, E].
// `blocks` persistent blocks (at most B; armnet_arm1h_bwd_blocks_per_sm
// times the SM count fill the card) each keep their batch sums in one
// row of `partial` ([blocks, E*DK + O*DK + F*O]), which a second kernel
// sums in block order into grads. Returns the cudaError_t of the launches
// (0 on success). F, E and DK such that K6's shared memory fits a block
// (bwd_plan; at F = 39 and O >= 128, E = DK <= 128); the library of the
// width class and of F's side of 40 fields (pick_bwd).
extern "C" int armnet_arm1h_bwd(const float* emb, const float* dout,
                                const float* wk, const float* q,
                                const float* vt, float* de, float* partial,
                                float* grads, int B, int F, int E, int DK,
                                int O, int blocks, int mode, int gmode,
                                int n_iter, float scale, float am1,
                                float inv_am1, float c_hi, float ge,
                                void* stream) {
  using namespace armnet;
  if (!dims_ok(B, F, E, DK, O) || blocks < 1 || blocks > B)
    return (int)cudaErrorInvalidValue;
  const bool wide = E > kMaxED || DK > kMaxED;
  const BwdKernel kernel = pick_bwd(F, mode, gmode, wide);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int groups = 0;
  size_t smem = 0;
  cudaError_t err = bwd_plan(F, E, DK, O, wide, &groups, &smem);
  if (err != cudaSuccess) return (int)err;
  if (groups < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, s>>>(emb, dout, wk, q, vt, de, partial, B,
                                        F, E, DK, O, groups, n_iter, scale,
                                        am1, inv_am1, c_hi, ge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int P = E * DK + O * DK + F * O;
  sum_rows_kernel<<<(P + kSumCols - 1) / kSumCols, kSumCols * kSumGroups, 0,
                    s>>>(partial, grads, blocks, P);
  return (int)cudaGetLastError();
}

// *blocks = the blocks of the backward kernel that one SM of the current
// device holds at these shapes and modes (registers and bwd_layout's
// shared memory), as the occupancy calculator gives it; 0 where E and DK
// are too wide for a block's shared memory. Returns the cudaError_t (0 on
// success).
extern "C" int armnet_arm1h_bwd_blocks_per_sm(int F, int E, int DK, int O,
                                              int mode, int gmode,
                                              int* blocks) {
  using namespace armnet;
  if (!dims_ok(1, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  const bool wide = E > kMaxED || DK > kMaxED;
  const BwdKernel kernel = pick_bwd(F, mode, gmode, wide);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  int groups = 0;
  size_t smem = 0;
  const cudaError_t err = bwd_plan(F, E, DK, O, wide, &groups, &smem);
  if (err != cudaSuccess) return (int)err;
  if (groups < 1) {
    *blocks = 0;
    return (int)cudaSuccess;
  }
  return (int)blocks_per_sm(kernel, smem, blocks);
}
