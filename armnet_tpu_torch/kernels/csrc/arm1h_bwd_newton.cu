// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in one powf
// mode (NEWTON: alpha > 2), E and dk <= 16, built apart from the other
// modes so that nvcc builds them in parallel; see arm1h.cuh and
// arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (wide || F > kMaxF || mode != NEWTON || gmode != G_POW)
    return nullptr;
  return F <= 16 ? arm1h_bwd_kernel<16, NEWTON, G_POW, 0>
                 : arm1h_bwd_kernel<kMaxF, NEWTON, G_POW, 0>;
}

}  // namespace armnet
