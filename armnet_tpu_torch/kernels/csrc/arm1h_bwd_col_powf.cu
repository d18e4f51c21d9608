// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in the powf
// modes (FASTPOW, NEWTON) past 40 fields, narrow and wide rows: MAXF = 0,
// each thread's column y in shared memory; see arm1h.cuh and
// arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

template <int WIDE>
BwdKernel pick_width(int mode) {
  if (mode == FASTPOW) return arm1h_bwd_kernel<0, FASTPOW, G_POW, WIDE>;
  if (mode == NEWTON) return arm1h_bwd_kernel<0, NEWTON, G_POW, WIDE>;
  return nullptr;
}

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (F <= kMaxF || gmode != G_POW) return nullptr;
  return wide ? pick_width<1>(mode) : pick_width<0>(mode);
}

}  // namespace armnet
