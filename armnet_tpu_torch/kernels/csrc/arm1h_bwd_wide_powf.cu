// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in the powf
// modes (FASTPOW, NEWTON) for E or dk > 16; one register bucket (40) for
// every F; see arm1h.cuh and arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (!wide || F > kMaxF || gmode != G_POW) return nullptr;
  if (mode == FASTPOW) return arm1h_bwd_kernel<kMaxF, FASTPOW, G_POW, 1>;
  if (mode == NEWTON) return arm1h_bwd_kernel<kMaxF, NEWTON, G_POW, 1>;
  return nullptr;
}

}  // namespace armnet
