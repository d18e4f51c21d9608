// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in the
// bisection modes (alpha 2, 1.5, 4/3) for E or dk > 16, such as the wider
// embeddings of an nemb sweep; one register bucket (40) for every F; see
// arm1h.cuh and arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (!wide || F > kMaxF) return nullptr;
  // the solver branch and g follow from one alpha: these pairs only
  if (mode == BISECT1 && gmode == G_ONE)
    return arm1h_bwd_kernel<kMaxF, BISECT1, G_ONE, 1>;
  if (mode == BISECT2 && gmode == G_SQRT)
    return arm1h_bwd_kernel<kMaxF, BISECT2, G_SQRT, 1>;
  if (mode == BISECT3 && gmode == G_POW)
    return arm1h_bwd_kernel<kMaxF, BISECT3, G_POW, 1>;
  return nullptr;
}

}  // namespace armnet
