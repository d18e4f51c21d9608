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
// the sums.
//
// What bounds it on an H100: operations. At the cr_armnet1h step (B 4096,
// F 39, E = dk = 10, O 128, alpha 2) K5 must read emb (6.4 MB) and write
// out (21 MB), 8 us at 3.35 TB/s, but the entmax solve alone is ~31 x 39
// subtract/max/add per column: with the gates, w and the exp-cross about
// 2.7e9 f32 instruction slots, 81 us at 33.5e12/s; K6 replays that and adds
// the VJP and five more contractions, 113 us (chip_smoke.fused_arm_bounds).
//
// What the design does about it. The work is per (row, neuron) column, as
// in the entmax kernel: a block takes a row, one thread per neuron o
// (128 threads; a thread loops over o when O > 128). emb[b] ([F, E], 1.6 KB)
// and keys go to shared memory; thread o forms its gate column g[:, o] in
// registers (a compile-time MAXF bucket, 16 or 40, with a masked tail),
// runs the entmax column solve there operation for operation as
// entmax.cu does, and reads emb from shared memory by broadcast. Only emb
// and the weights come in and only out (K5) or de and the weight-gradient
// partials (K6) go out.
//
// K5 stages exp(z) [O, E] in shared memory and writes the row's O*E
// outputs once, coalesced.
//
// K6 replays g, y and z in registers, then dz = dout * exp(z) (dout staged
// in shared memory with emb), dw (registers), the dvt partial, the VJP in
// the entmax.cu backward's arithmetic and the dq partial; w and dg go to
// shared [F, O+1] tiles (padded so a warp reading across f hits distinct
// banks) for the two contractions over o (dkeys, then de), which the block
// shares out over (f, d) and (f, e). The batch sums: blocks run in no order,
// so the grid is persistent (a few blocks per SM, each looping over rows)
// and each block keeps its partial dWk, dq and dvt in shared memory, one
// owner thread per element, and writes them to a scratch row once. A second
// small kernel sums the scratch rows in block order, so the result is
// deterministic run to run; there are no atomics.
//
// Numerics: see entmax_solver.cuh. The gates are bit for bit the plain
// version's (see block_keys); the contractions after the solve are f32 FMA
// sums in an order of their own. The tolerances against the plain version
// are the JAX package's for its fused kernel (forward 2e-5, the four
// gradients rtol 5e-4 / atol 5e-5).
//
// K5 is built from arm1h.cu and K6 from arm1h_bwd.cu, so that nvcc builds
// the two in parallel; this header holds what they share.

#pragma once

#include "entmax_solver.cuh"

namespace armnet {

constexpr int kThreads = 128;
constexpr size_t kDefaultSmem = 48 * 1024;

// The gates are summed product by product in index order, each product
// and sum rounded on its own, exactly as arm_cuda._gates sums them: kernel
// and plain version then solve the same gates bit for bit. (At alpha > 2
// the solver's Newton budget leaves rare columns unconverged, and there
// one ulp of a gate moves y by up to ~1e-2.)

// keys_s[f, d] = sum_e emb_s[f, e] wk[e, d], shared by the block's threads
__device__ __forceinline__ void block_keys(const float* emb_s,
                                           const float* __restrict__ wk,
                                           float* keys_s, int F, int E,
                                           int DK) {
  for (int i = threadIdx.x; i < F * DK; i += kThreads) {
    const int f = i / DK, d = i - f * DK;
    float s = __fmul_rn(emb_s[f * E], wk[d]);
    for (int e = 1; e < E; ++e)
      s = __fadd_rn(s, __fmul_rn(emb_s[f * E + e], wk[e * DK + d]));
    keys_s[i] = s;
  }
}

// v[f] = (sum_d keys_s[f, d] q[o, d]) * scale * (alpha - 1): the gate
// column of neuron o, multiplied by alpha-1 as the solve takes it
template <int MAXF>
__device__ __forceinline__ void gate_column(float (&v)[MAXF],
                                            const float* keys_s,
                                            const float* __restrict__ qo,
                                            int F, int DK, float scale,
                                            float am1) {
  const float q0 = qo[0];
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) v[f] = __fmul_rn(keys_s[f * DK], q0);
  for (int d = 1; d < DK; ++d) {
    const float qd = qo[d];
#pragma unroll
    for (int f = 0; f < MAXF; ++f)
      if (f < F) v[f] = __fadd_rn(v[f], __fmul_rn(keys_s[f * DK + d], qd));
  }
#pragma unroll
  for (int f = 0; f < MAXF; ++f)
    if (f < F) v[f] = __fmul_rn(__fmul_rn(v[f], scale), am1);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

inline bool dims_ok(int B, int F, int E, int DK, int O) {
  return B >= 1 && F >= 1 && F <= 40 && E >= 1 && DK >= 1 && O >= 1;
}

}  // namespace armnet
