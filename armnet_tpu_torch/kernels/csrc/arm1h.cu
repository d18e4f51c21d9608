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

#include "entmax_solver.cuh"

namespace {

using namespace armnet;

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

template <int MAXF, int MODE>
__global__ void __launch_bounds__(kThreads)
arm1h_fwd_kernel(const float* __restrict__ emb, const float* __restrict__ wk,
                 const float* __restrict__ q, const float* __restrict__ vt,
                 float* __restrict__ out, int F, int E, int DK, int O,
                 int n_iter, float scale, float am1, float inv_am1,
                 float c_hi) {
  extern __shared__ float smem[];
  float* emb_s = smem;                // [F, E]
  float* keys_s = emb_s + F * E;      // [F, DK]
  float* out_s = keys_s + F * DK;     // [O, E]
  const int64_t b = blockIdx.x;

  const float* eb = emb + b * F * E;
  for (int i = threadIdx.x; i < F * E; i += kThreads) emb_s[i] = eb[i];
  __syncthreads();
  block_keys(emb_s, wk, keys_s, F, E, DK);
  __syncthreads();

  for (int o = threadIdx.x; o < O; o += kThreads) {
    float v[MAXF];
    gate_column<MAXF>(v, keys_s, q + (int64_t)o * DK, F, DK, scale, am1);
    entmax_column<MAXF, MODE>(v, F, n_iter, inv_am1, c_hi);
#pragma unroll
    for (int f = 0; f < MAXF; ++f)                 // w = y * vt[:, o]
      if (f < F) v[f] = __fmul_rn(v[f], vt[f * O + o]);
    for (int e = 0; e < E; ++e) {
      float z = 0.0f;
#pragma unroll
      for (int f = 0; f < MAXF; ++f)
        if (f < F) z += v[f] * emb_s[f * E + e];
      out_s[o * E + e] = expf(z);
    }
  }
  __syncthreads();
  float* ob = out + b * O * E;
  for (int i = threadIdx.x; i < O * E; i += kThreads) ob[i] = out_s[i];
}

template <int MAXF, int MODE, int GMODE>
__global__ void __launch_bounds__(kThreads)
arm1h_bwd_kernel(const float* __restrict__ emb,
                 const float* __restrict__ dout,
                 const float* __restrict__ wk, const float* __restrict__ q,
                 const float* __restrict__ vt, float* __restrict__ de,
                 float* __restrict__ partial, int B, int F, int E, int DK,
                 int O, int n_iter, float scale, float am1, float inv_am1,
                 float c_hi, float ge) {
  extern __shared__ float smem[];
  const int OP = O + 1;               // padded row of the [F, O] tiles
  float* emb_s = smem;                // [F, E]
  float* keys_s = emb_s + F * E;      // [F, DK]
  float* dkeys_s = keys_s + F * DK;   // [F, DK]
  float* q_s = dkeys_s + F * DK;      // [O, DK]
  float* dz_s = q_s + O * DK;         // [O, E]: dout, then dz
  float* w_s = dz_s + O * E;          // [F, O+1]
  float* dg_s = w_s + F * OP;         // [F, O+1]
  float* dvt_acc = dg_s + F * OP;     // [F, O]   this block's batch sums
  float* dq_acc = dvt_acc + F * O;    // [DK, O]
  float* dwk_acc = dq_acc + DK * O;   // [E, DK]
  const int tid = threadIdx.x;

  for (int i = tid; i < O * DK; i += kThreads) q_s[i] = q[i];
  // each accumulator element has one owner thread for the whole kernel
  for (int o = tid; o < O; o += kThreads) {
    for (int f = 0; f < F; ++f) dvt_acc[f * O + o] = 0.0f;
    for (int d = 0; d < DK; ++d) dq_acc[d * O + o] = 0.0f;
  }
  for (int i = tid; i < E * DK; i += kThreads) dwk_acc[i] = 0.0f;

  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    __syncthreads();                  // the last row's readers are done
    const float* eb = emb + b * F * E;
    const float* dob = dout + b * O * E;
    for (int i = tid; i < F * E; i += kThreads) emb_s[i] = eb[i];
    for (int i = tid; i < O * E; i += kThreads) dz_s[i] = dob[i];
    __syncthreads();
    block_keys(emb_s, wk, keys_s, F, E, DK);
    __syncthreads();

    for (int o = tid; o < O; o += kThreads) {
      float y[MAXF], t[MAXF];
      gate_column<MAXF>(y, keys_s, q_s + o * DK, F, DK, scale, am1);
      entmax_column<MAXF, MODE>(y, F, n_iter, inv_am1, c_hi);
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) w_s[f * OP + o] = __fmul_rn(y[f], vt[f * O + o]);
        t[f] = 0.0f;
      }
      // z[e] = sum_f w emb, dz = dout * exp(z), dw[f] += dz emb[f, e]
      for (int e = 0; e < E; ++e) {
        float z = 0.0f;
#pragma unroll
        for (int f = 0; f < MAXF; ++f)
          if (f < F) z += w_s[f * OP + o] * emb_s[f * E + e];
        const float dz = __fmul_rn(dz_s[o * E + e], expf(z));
        dz_s[o * E + e] = dz;
#pragma unroll
        for (int f = 0; f < MAXF; ++f)
          if (f < F) t[f] += dz * emb_s[f * E + e];
      }
      // t = dw: the dvt partial, then t = ds * g and the entmax VJP (g
      // waits in this thread's dg_s column)
      float sum_t = 0.0f, sum_g = 0.0f;
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          dvt_acc[f * O + o] += __fmul_rn(t[f], y[f]);
          const float g = gppr<GMODE>(y[f], ge);
          dg_s[f * OP + o] = g;
          t[f] = __fmul_rn(__fmul_rn(t[f], vt[f * O + o]), g);
          sum_t += t[f];
          sum_g += g;
        }
      }
      const float qq = sum_t / sum_g;
#pragma unroll
      for (int f = 0; f < MAXF; ++f) {
        if (f < F) {
          t[f] = __fsub_rn(t[f], __fmul_rn(qq, dg_s[f * OP + o]));
          dg_s[f * OP + o] = t[f];
        }
      }
      for (int d = 0; d < DK; ++d) {            // dq partial (unscaled)
        float s = 0.0f;
#pragma unroll
        for (int f = 0; f < MAXF; ++f)
          if (f < F) s += t[f] * keys_s[f * DK + d];
        dq_acc[d * O + o] += s;
      }
    }
    __syncthreads();

    for (int i = tid; i < F * DK; i += kThreads) {   // dkeys = s dg q
      const int f = i / DK, d = i - f * DK;
      float s = 0.0f;
      for (int o = 0; o < O; ++o) s += dg_s[f * OP + o] * q_s[o * DK + d];
      dkeys_s[i] = __fmul_rn(s, scale);
    }
    __syncthreads();

    float* deb = de + b * F * E;
    for (int i = tid; i < F * E; i += kThreads) {
      const int f = i / E, e = i - f * E;
      float s = 0.0f, s2 = 0.0f;
      for (int o = 0; o < O; ++o) s += dz_s[o * E + e] * w_s[f * OP + o];
      for (int d = 0; d < DK; ++d) s2 += dkeys_s[f * DK + d] * wk[e * DK + d];
      deb[i] = s + s2;
    }
    for (int i = tid; i < E * DK; i += kThreads) {
      const int e = i / DK, d = i - e * DK;
      float s = 0.0f;
      for (int f = 0; f < F; ++f) s += emb_s[f * E + e] * dkeys_s[f * DK + d];
      dwk_acc[i] += s;
    }
  }
  __syncthreads();

  // this block's scratch row: dWk [E, DK], dq [O, DK], dvt [F, O]
  float* pb = partial + (int64_t)blockIdx.x * (E * DK + O * DK + F * O);
  for (int i = tid; i < E * DK; i += kThreads) pb[i] = dwk_acc[i];
  for (int i = tid; i < O * DK; i += kThreads) {
    const int o = i / DK, d = i - o * DK;
    pb[E * DK + i] = __fmul_rn(dq_acc[d * O + o], scale);
  }
  for (int i = tid; i < F * O; i += kThreads)
    pb[E * DK + O * DK + i] = dvt_acc[i];
}

// out[j] = sum over the scratch rows k = 0, 1, ... of partial[k, j]
__global__ void __launch_bounds__(kThreads)
sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                int rows, int P) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= P) return;
  float s = 0.0f;
#pragma unroll 8
  for (int k = 0; k < rows; ++k) s += partial[(int64_t)k * P + j];
  out[j] = s;
}

size_t fwd_smem(int F, int E, int DK, int O) {
  return sizeof(float) * ((size_t)F * E + (size_t)F * DK + (size_t)O * E);
}

size_t bwd_smem(int F, int E, int DK, int O) {
  return sizeof(float) *
         ((size_t)F * E + 2 * (size_t)F * DK + (size_t)O * DK +
          (size_t)O * E + 2 * (size_t)F * (O + 1) + (size_t)F * O +
          (size_t)DK * O + (size_t)E * DK);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int MAXF>
cudaError_t launch_fwd(int mode, const float* emb, const float* wk,
                       const float* q, const float* vt, float* out, int B,
                       int F, int E, int DK, int O, int n_iter, float scale,
                       float am1, float inv_am1, float c_hi,
                       cudaStream_t stream) {
  decltype(&arm1h_fwd_kernel<MAXF, BISECT1>) kernel = nullptr;
  switch (mode) {
    case BISECT1: kernel = arm1h_fwd_kernel<MAXF, BISECT1>; break;
    case BISECT2: kernel = arm1h_fwd_kernel<MAXF, BISECT2>; break;
    case BISECT3: kernel = arm1h_fwd_kernel<MAXF, BISECT3>; break;
    case FASTPOW: kernel = arm1h_fwd_kernel<MAXF, FASTPOW>; break;
    case NEWTON: kernel = arm1h_fwd_kernel<MAXF, NEWTON>; break;
    default: return cudaErrorInvalidValue;
  }
  const size_t smem = fwd_smem(F, E, DK, O);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, stream>>>(emb, wk, q, vt, out, F, E, DK, O,
                                        n_iter, scale, am1, inv_am1, c_hi);
  return cudaGetLastError();
}

template <int MAXF>
cudaError_t launch_bwd(int mode, int gmode, const float* emb,
                       const float* dout, const float* wk, const float* q,
                       const float* vt, float* de, float* partial,
                       float* grads, int B, int F, int E, int DK, int O,
                       int blocks, int n_iter, float scale, float am1,
                       float inv_am1, float c_hi, float ge,
                       cudaStream_t stream) {
  decltype(&arm1h_bwd_kernel<MAXF, BISECT1, G_ONE>) kernel = nullptr;
  // the solver branch and g follow from one alpha: these pairs only
  if (mode == BISECT1 && gmode == G_ONE)
    kernel = arm1h_bwd_kernel<MAXF, BISECT1, G_ONE>;
  else if (mode == BISECT2 && gmode == G_SQRT)
    kernel = arm1h_bwd_kernel<MAXF, BISECT2, G_SQRT>;
  else if (mode == BISECT3 && gmode == G_POW)
    kernel = arm1h_bwd_kernel<MAXF, BISECT3, G_POW>;
  else if (mode == FASTPOW && gmode == G_POW)
    kernel = arm1h_bwd_kernel<MAXF, FASTPOW, G_POW>;
  else if (mode == NEWTON && gmode == G_POW)
    kernel = arm1h_bwd_kernel<MAXF, NEWTON, G_POW>;
  else
    return cudaErrorInvalidValue;
  const size_t smem = bwd_smem(F, E, DK, O);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(
      emb, dout, wk, q, vt, de, partial, B, F, E, DK, O, n_iter, scale, am1,
      inv_am1, c_hi, ge);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = E * DK + O * DK + F * O;
  sum_rows_kernel<<<(P + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, grads, blocks, P);
  return cudaGetLastError();
}

bool dims_ok(int B, int F, int E, int DK, int O) {
  return B >= 1 && F >= 1 && F <= 40 && E >= 1 && DK >= 1 && O >= 1;
}

}  // namespace

// out [B, O, E] = the fused ARM-1h forward of emb [B, F, E], wk [E, DK],
// q [O, DK], vt [F, O]; one block per row. Returns the cudaError_t of the
// launch (0 on success). F <= 40.
extern "C" int armnet_arm1h_fwd(const float* emb, const float* wk,
                                const float* q, const float* vt, float* out,
                                int B, int F, int E, int DK, int O, int mode,
                                int n_iter, float scale, float am1,
                                float inv_am1, float c_hi, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(B, F, E, DK, O)) return (int)cudaErrorInvalidValue;
  if (F <= 16)
    return (int)launch_fwd<16>(mode, emb, wk, q, vt, out, B, F, E, DK, O,
                               n_iter, scale, am1, inv_am1, c_hi, s);
  return (int)launch_fwd<40>(mode, emb, wk, q, vt, out, B, F, E, DK, O,
                             n_iter, scale, am1, inv_am1, c_hi, s);
}

// The fused ARM-1h backward: de [B, F, E] and grads = [dWk [E, DK] | dq
// [O, DK] | dvt [F, O]] flat, from the forward's inputs and dout [B, O, E].
// `blocks` persistent blocks each write one scratch row of `partial`
// ([blocks, E*DK + O*DK + F*O]), which a second kernel sums in block order
// into grads. Returns the cudaError_t of the launches (0 on success).
// F <= 40.
extern "C" int armnet_arm1h_bwd(const float* emb, const float* dout,
                                const float* wk, const float* q,
                                const float* vt, float* de, float* partial,
                                float* grads, int B, int F, int E, int DK,
                                int O, int blocks, int mode, int gmode,
                                int n_iter, float scale, float am1,
                                float inv_am1, float c_hi, float ge,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!dims_ok(B, F, E, DK, O) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (F <= 16)
    return (int)launch_bwd<16>(mode, gmode, emb, dout, wk, q, vt, de, partial,
                               grads, B, F, E, DK, O, blocks, n_iter, scale,
                               am1, inv_am1, c_hi, ge, s);
  return (int)launch_bwd<40>(mode, gmode, emb, dout, wk, q, vt, de, partial,
                             grads, B, F, E, DK, O, blocks, n_iter, scale,
                             am1, inv_am1, c_hi, ge, s);
}
