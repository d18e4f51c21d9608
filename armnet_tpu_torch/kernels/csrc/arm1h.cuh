// The fused ARM-1h interaction for Hopper (sm_90a): forward (K5) and its
// recompute backward (K6), with nothing of size [B, F, O] in device memory.
//
// Replaces the Pallas TPU kernels armnet_tpu/kernels/arm_pallas.py
// `_fwd_kernel` (through `_fwd_call`, K5) and `_bwd_kernel` (through
// `_bwd_call`, K6). What they compute, per batch row b, with emb [B, F, E],
// wk [E, dk], q [O, dk], vt [F, O] and s = dk^-1/2:
//   keys = emb[b] wk                 [F, dk]
//   g    = s keys q^T                [F, O]  (gates)
//   y    = entmax_alpha(g) over F            (the column solve of
//                                             entmax_solver.cuh)
//   w    = y * vt                    [F, O]
//   out  = exp(w^T emb[b])           [O, E]
// and backward from dout [B, O, E]: dz = dout * out, dw = emb dz^T
// [F, O], dg = the entmax VJP of dw * vt over F, dkeys = s dg q [F, dk],
// de = w dz + dkeys wk^T [F, E], and the batch sums dWk = sum emb^T dkeys,
// dq = s sum dg^T keys, dvt = sum dw * y.
// Exactly arm_cuda.arm1h_fwd_plain / arm1h_bwd_plain, up to the order of
// the sums after the solve.
//
// What bounds it on an H100: operations. At the cr_armnet1h step (B 4096,
// F 39, E = dk = 10, O 128, alpha 2) K5 must read emb (6.4 MB) and write
// out (21 MB), 8 us at 3.35 TB/s, but the entmax solve alone is ~31 x 39
// subtract/max/add per column: with the gates, w and the exp-cross about
// 2.7e9 f32 instruction slots, 81 us at 33.5e12/s; K6 replays that and adds
// the VJP and five more contractions, 113 us (bounds.fused_arm_bounds).
// The solve is a dependent chain per column (f(tau) adds its F terms in
// index order, so that kernel and plain version solve the same bits), so
// the kernels are held back by latency unless many warps are resident.
//
// What the design does about it. The work is per (row, neuron) column: a
// block of 128 threads takes a row, one thread per neuron o. emb[b] and
// keys sit in shared memory with rows padded to a multiple of 4 floats
// (zeros), so a thread reads a row of either as float4 broadcasts. Thread o
// forms its gate column in registers (a compile-time MAXF bucket, 16 or
// 40) and runs the column solve there; in the bisection modes the bucket's
// entries past F hold -inf and each step clamps with one instruction
// (entmax_column's PAD), as the entmax forward does. E and dk take any
// width: K5 sums 4 of them at a time; K6 keeps a column's sums over e and
// d in registers up to kMaxED (16, the presets' 10 included) and has a
// build of its own for the wider embeddings of an nemb sweep (30-120),
// which goes 4 at a time through shared memory.
//
// K5: one block per row, 7 blocks per SM in the bisection modes (72
// registers) and 6 in the powf modes (80); it stages exp(z) [O, E] in
// shared memory and writes the row's O*E outputs once, coalesced.
//
// K6: a persistent grid of as many blocks per SM as the occupancy
// calculator allows at the launch's shapes: 4 (16 warps) at the
// cr_armnet1h widths, where its parent held 2 (80.7 KB of shared memory
// and 168 registers a thread). Each block loops over rows and over chunks
// of 128 neurons. Thread o replays its column and keeps y in registers;
// dz goes to shared memory; dw, the VJP and the column's batch sums of dvt
// and dq follow. The two contractions over o (dkeys = dg q, and w dz for
// de) go through ONE padded [F, 129] tile, dg first and then w, each read
// by all 128 threads as (field, group of neurons) pairs whose partial sums
// are added in group order; shared memory is 46.3 KB at those widths and
// does not grow with O. (The wide build sizes its query and dz rows by
// min(O, 128) and its groups by what fits: bwd_wide_layout.) The block's
// batch sums live in its own row of the
// scratch `partial` (L2, not shared memory), each element read, added and
// written by one owner thread, and a second kernel sums the rows in block
// order, 32 columns by 8 row groups a block: deterministic run to run, no
// atomics. Measured (PERF.md): K6 0.51 ms at alpha 2 against its
// parent's 1.20 and the composed path's 1.10; K5 0.22 against 0.32.
// Loading the dvt sums before the solve, and 5 blocks per SM with q read
// through L1, spilled and ran slower.
//
// Numerics: see entmax_solver.cuh. The gates are bit for bit the plain
// version's (see block_keys); the contractions after the solve are f32 FMA
// sums in an order of their own. The tolerances against the plain version
// are the JAX package's for its fused kernel (forward 2e-5, the four
// gradients rtol 5e-4 / atol 5e-5).
//
// K5 is built from arm1h.cu, K6 from arm1h_bwd.cu (the bisection modes),
// arm1h_bwd_fastpow.cu and arm1h_bwd_newton.cu (one powf mode each), and
// for wide rows arm1h_bwd_wide.cu and arm1h_bwd_wide_powf.cu, so that nvcc
// builds them in parallel; this header holds what they share,
// arm1h_bwd.cuh K6's kernel.

#pragma once

#include "entmax_solver.cuh"

namespace armnet {

constexpr int kThreads = 128;
constexpr int kMaxF = 40;              // the largest register bucket
constexpr int kMaxED = 16;             // E and dk K6 sums in one pass
constexpr size_t kDefaultSmem = 48 * 1024;

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

// dst [n, pad4(w)] = src [n, w] with zeros in the padding
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int n, int w) {
  const int wp = pad4(w);
  for (int i = threadIdx.x; i < n * wp; i += blockDim.x) {
    const int r = i / wp, c = i - r * wp;
    dst[i] = c < w ? src[r * w + c] : 0.0f;
  }
}

// The gates are summed product by product in index order, each product
// and sum rounded on its own, exactly as arm_cuda._gates sums them: kernel
// and plain version then solve the same gates bit for bit. (At alpha > 2
// the solver's Newton budget leaves rare columns unconverged, and there
// one ulp of a gate moves y by up to ~1e-2.)

// keys_s [F, pad4(DK)] = emb_s [F, pad4(E)] wk, shared by the block's
// threads; zeros in the padding
__device__ __forceinline__ void block_keys(const float* emb_s,
                                           const float* __restrict__ wk,
                                           float* keys_s, int F, int E,
                                           int DK) {
  const int ep = pad4(E), dp = pad4(DK);
  for (int i = threadIdx.x; i < F * dp; i += blockDim.x) {
    const int f = i / dp, d = i - f * dp;
    float s = 0.0f;
    if (d < DK) {
      const float* er = emb_s + f * ep;
      s = __fmul_rn(er[0], wk[d]);
      for (int e = 1; e < E; ++e)
        s = __fadd_rn(s, __fmul_rn(er[e], wk[e * DK + d]));
    }
    keys_s[i] = s;
  }
}

// v[f] = (sum_d keys_s[f, d] qo[d]) * scale * (alpha - 1) for f < F: the
// gate column of neuron o, multiplied by alpha-1 as the solve takes it;
// v[f] = pad past F
template <int MAXF>
__device__ __forceinline__ void gate_column(float (&v)[MAXF],
                                            const float* keys_s,
                                            const float* __restrict__ qo,
                                            int F, int DK, float scale,
                                            float am1, float pad) {
  const int dp = pad4(DK);
#pragma unroll
  for (int f = 0; f < MAXF; ++f) v[f] = 0.0f;
  for (int c = 0; c < dp; c += 4) {
    float q4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) q4[j] = c + j < DK ? qo[c + j] : 0.0f;
#pragma unroll
    for (int f = 0; f < MAXF; ++f) {
      if (f < F) {
        const float4 k =
            *reinterpret_cast<const float4*>(keys_s + f * dp + c);
        const float p = __fmul_rn(k.x, q4[0]);
        float s = c == 0 ? p : __fadd_rn(v[f], p);
        if (c + 1 < DK) s = __fadd_rn(s, __fmul_rn(k.y, q4[1]));
        if (c + 2 < DK) s = __fadd_rn(s, __fmul_rn(k.z, q4[2]));
        if (c + 3 < DK) s = __fadd_rn(s, __fmul_rn(k.w, q4[3]));
        v[f] = s;
      }
    }
  }
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    v[f] = f < F ? __fmul_rn(__fmul_rn(v[f], scale), am1) : pad;
}

// acc[e] += x * row[e] for e < min(n, kMaxED), row padded to float4s
__device__ __forceinline__ void axpy_row(float (&acc)[kMaxED], float x,
                                         const float* row, int n) {
#pragma unroll
  for (int c = 0; c < kMaxED; c += 4) {
    if (c < n) {
      const float4 r = *reinterpret_cast<const float4*>(row + c);
      acc[c] = fmaf(x, r.x, acc[c]);
      acc[c + 1] = fmaf(x, r.y, acc[c + 1]);
      acc[c + 2] = fmaf(x, r.z, acc[c + 2]);
      acc[c + 3] = fmaf(x, r.w, acc[c + 3]);
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline bool dims_ok(int B, int F, int E, int DK, int O) {
  return B >= 1 && F >= 1 && F <= kMaxF && E >= 1 && DK >= 1 && O >= 1;
}

// *blocks = the blocks of `kernel` that one SM holds with `smem` bytes of
// dynamic shared memory, as the occupancy calculator gives it
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, size_t smem, int* blocks) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       kThreads, smem);
}

}  // namespace armnet
