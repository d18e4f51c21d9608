// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in the
// bisection modes (alpha 2, 1.5, 4/3) past 40 fields, narrow and wide
// rows: MAXF = 0, each thread's column y in shared memory; see arm1h.cuh
// and arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

template <int WIDE>
BwdKernel pick_width(int mode, int gmode) {
  // the solver branch and g follow from one alpha: these pairs only
  if (mode == BISECT1 && gmode == G_ONE)
    return arm1h_bwd_kernel<0, BISECT1, G_ONE, WIDE>;
  if (mode == BISECT2 && gmode == G_SQRT)
    return arm1h_bwd_kernel<0, BISECT2, G_SQRT, WIDE>;
  if (mode == BISECT3 && gmode == G_POW)
    return arm1h_bwd_kernel<0, BISECT3, G_POW, WIDE>;
  return nullptr;
}

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (F <= kMaxF) return nullptr;
  return wide ? pick_width<1>(mode, gmode) : pick_width<0>(mode, gmode);
}

}  // namespace armnet
