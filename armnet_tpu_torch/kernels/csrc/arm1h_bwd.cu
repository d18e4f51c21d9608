// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a); see
// arm1h.cuh.

#include "arm1h.cuh"

namespace {

using namespace armnet;

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

size_t bwd_smem(int F, int E, int DK, int O) {
  return sizeof(float) *
         ((size_t)F * E + 2 * (size_t)F * DK + (size_t)O * DK +
          (size_t)O * E + 2 * (size_t)F * (O + 1) + (size_t)F * O +
          (size_t)DK * O + (size_t)E * DK);
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

}  // namespace

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
