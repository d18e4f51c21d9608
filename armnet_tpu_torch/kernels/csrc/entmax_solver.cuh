// The alpha-entmax column solve and the pieces of its VJP, shared by the
// entmax kernels (entmax_fwd.cuh, entmax.cu) and the fused ARM-1h kernels
// (arm1h.cu, arm1h_bwd.cu).
//
// What it computes: exactly armnet_tpu_torch/kernels/entmax_common.py
// `solve_entmax_axis0` (itself a copy of the JAX solver) at its production
// budgets, one column of d <= MAXD values held in registers. MODE picks
// the branch:
//   BISECT1/2/3  1/(alpha-1) in {1,2,3}: plain bisection, n_iter <= 30 steps,
//                pow is 0-2 multiplies (alpha=2 and 1.5 cost no
//                transcendentals);
//   FASTPOW      other alpha <= 2: 12 bisections on a bit-trick pow, then 4
//                safeguarded Newton steps on the exact powf;
//   NEWTON       alpha > 2: 8 exact bisections, then 6 Newton steps.
// Constants (alpha-1, 1/(alpha-1), (1/d)^(alpha-1)) come from the host,
// computed in double and rounded to float as the JAX package does.
//
// Numerics: build without --use_fast_math (FTZ and approximate powf break
// the 1e-20/1e-30 clamps). A NaN in a column makes the whole column NaN, as
// in the plain version: the max and the clamps keep NaN. Products that the
// plain version rounds on their own use __fmul_rn/__fadd_rn so nvcc cannot
// contract them into FMAs; the bit-trick pow then matches the plain version
// bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace armnet {

enum Mode { BISECT1 = 0, BISECT2 = 1, BISECT3 = 2, FASTPOW = 3, NEWTON = 4 };
enum GMode { G_ONE = 0, G_SQRT = 1, G_POW = 2 };

__host__ __device__ constexpr bool is_bisect(int mode) {
  return mode == BISECT1 || mode == BISECT2 || mode == BISECT3;
}

constexpr int kFastBisect = 12;
constexpr int kPolish = 4;
constexpr int kBisect = 8;
constexpr int kNewton = 6;
constexpr float kTiny = 1e-30f;
constexpr int kFastK = 1064975337;           // int((127 - 0.0450466) * 2^23)
constexpr float kFastKf = 1064975360.0f;     // float32(kFastK)

// max that keeps a NaN, as torch.amax/clamp_min and jnp.maximum do (fmaxf
// would drop it): one max.NaN instruction on sm_80 and later
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float clamp0(float z) { return max_nan(z, 0.0f); }

// a - b rounded, then clamped to [0, 1]: one instruction
__device__ __forceinline__ float sub_sat(float a, float b) {
  float r;
  asm("sub.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// z^(1/(alpha-1)) for z >= 0
template <int MODE>
__device__ __forceinline__ float pow_pos(float z, float inv_am1) {
  if (MODE == BISECT1) return z;
  if (MODE == BISECT2) return __fmul_rn(z, z);
  if (MODE == BISECT3) return __fmul_rn(__fmul_rn(z, z), z);
  return powf(z, inv_am1);
}

template <int MODE>
__device__ __forceinline__ float pow_inv(float z, float inv_am1) {
  return pow_pos<MODE>(clamp0(z), inv_am1);
}

// Blinn fast-pow, as entmax_common._fast_pow: clamp in f32 before the
// truncating int conversion; 0 where z <= 0.
__device__ __forceinline__ float fast_pow(float z, float inv_am1) {
  const int bits = __float_as_int(fmaxf(z, 1e-20f));
  float pb = __fadd_rn(__fmul_rn(inv_am1, __int2float_rn(bits - kFastK)),
                       kFastKf);
  pb = fminf(fmaxf(pb, 0.0f), 2.1e9f);
  return z > 0.0f ? __int_as_float(__float2int_rz(pb)) : 0.0f;
}

// alpha-entmax of one column. On entry v[k], k < d, holds the column
// already multiplied by alpha-1; on return it holds the entmax output.
//
// PAD: v[k] for d <= k < MAXD holds -inf, and the loops run over all MAXD
// entries with no test of k < d. A padded entry changes nothing: it never
// wins the max, and every term it adds is pow_inv(-inf - tau) = +0 (or
// fast_pow's 0, or z = 0 in Newton's sums), and s + 0.0f == s for the sums
// here, which start at +0 and add terms >= 0. Where tau is not finite the
// column's real entries are NaN already.
// With PAD the bisection branches also take max(v - tau, 0) as sub_sat(v,
// tau), one instruction instead of two, where fl(mx - tau_lo) <= 1: every
// tau they try is >= tau_lo and every v <= mx, so fl(v - tau) <=
// fl(mx - tau_lo) <= 1 (rounding is monotone), and the clamp at 1 never
// bites; the bits are those of the max. A column with a NaN or an infinity
// fails the test and keeps the max.
template <int MAXD, int MODE, bool PAD = false>
__device__ __forceinline__ void entmax_column(float (&v)[MAXD], int d,
                                              int n_iter, float inv_am1,
                                              float c_hi) {
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (PAD || k < d) mx = max_nan(mx, v[k]);
  float tau_lo = mx - 1.0f;     // f(tau_lo) >= 0
  float tau_hi = mx - c_hi;     // f(tau_hi) <= 0
  const bool sat = PAD && mx - tau_lo <= 1.0f;

  // f(tau) = sum pow_inv(v - tau) - 1
  auto f_val = [&](float tau) {
    float s = 0.0f;
    if (sat) {
#pragma unroll
      for (int k = 0; k < MAXD; ++k)
        s += pow_pos<MODE>(sub_sat(v[k], tau), inv_am1);
    } else {
#pragma unroll
      for (int k = 0; k < MAXD; ++k)
        if (PAD || k < d) s += pow_inv<MODE>(v[k] - tau, inv_am1);
    }
    return s - 1.0f;
  };

  float tau;
  if (MODE == BISECT1 || MODE == BISECT2 || MODE == BISECT3) {
    const float f_lo0 = f_val(tau_lo);
    float dm = tau_hi - tau_lo;
    float t_lo = tau_lo;
    tau = tau_lo;
#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) {
      dm = dm * 0.5f;
      tau = t_lo + dm;
      if (f_val(tau) * f_lo0 >= 0.0f) t_lo = tau;
    }
  } else {
    if (MODE == FASTPOW) {
      // the fast bracket only seeds tau; Newton keeps the exact bracket
      float a = tau_lo, b = tau_hi;
#pragma unroll 1
      for (int it = 0; it < kFastBisect; ++it) {
        const float m = 0.5f * (a + b);
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < MAXD; ++k)
          if (PAD || k < d) s += fast_pow(v[k] - m, inv_am1);
        const bool pos = s - 1.0f >= 0.0f;
        a = pos ? m : a;
        b = pos ? b : m;
      }
      tau = 0.5f * (a + b);
    } else {
#pragma unroll 1
      for (int it = 0; it < kBisect; ++it) {
        const float m = 0.5f * (tau_lo + tau_hi);
        const bool pos = f_val(m) >= 0.0f;
        tau_lo = pos ? m : tau_lo;
        tau_hi = pos ? tau_hi : m;
      }
      tau = 0.5f * (tau_lo + tau_hi);
    }
    const int n_polish = MODE == FASTPOW ? kPolish : kNewton;
#pragma unroll 1
    for (int it = 0; it < n_polish; ++it) {
      float s = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (PAD || k < d) {
          const float z = clamp0(v[k] - tau);
          const float p = pow_inv<MODE>(z, inv_am1);
          s += p;
          s2 += z > 0.0f ? p / fmaxf(z, kTiny) : 0.0f;
        }
      }
      const float s1 = s - 1.0f;
      const bool pos = s1 >= 0.0f;
      tau_lo = pos ? tau : tau_lo;
      tau_hi = pos ? tau_hi : tau;
      const float t_n = tau + s1 / __fmul_rn(inv_am1, fmaxf(s2, kTiny));
      // non-strict bounds keep a converged iterate
      tau = (t_n >= tau_lo && t_n <= tau_hi) ? t_n : 0.5f * (tau_lo + tau_hi);
    }
  }

  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < MAXD; ++k) {
    if (PAD || k < d) {
      v[k] = pow_inv<MODE>(v[k] - tau, inv_am1);
      sum += v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < MAXD; ++k)
    if (PAD || k < d) v[k] = v[k] / sum;
}

// g = y^(2-alpha) on the support (y > 0) of the entmax VJP
// dx = dy*g - (sum(dy*g) / sum(g)) * g; e = 2 - alpha. GMODE: G_ONE
// (alpha = 2), G_SQRT (alpha = 1.5), G_POW (any other alpha).
template <int GMODE>
__device__ __forceinline__ float gppr(float y, float e) {
  if (!(y > 0.0f)) return 0.0f;
  if (GMODE == G_ONE) return 1.0f;
  if (GMODE == G_SQRT) return sqrtf(y);
  return powf(fmaxf(y, 1e-38f), e);
}

}  // namespace armnet
