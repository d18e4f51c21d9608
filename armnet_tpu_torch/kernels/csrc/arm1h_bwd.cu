// The fused ARM-1h recompute backward (K6) for Hopper (sm_90a) in the
// bisection modes (alpha 2, 1.5, 4/3), E and dk <= 16; see arm1h.cuh and
// arm1h_bwd.cuh.

#include "arm1h_bwd.cuh"

namespace armnet {

template <int MAXF>
BwdKernel pick_bucket(int mode, int gmode) {
  // the solver branch and g follow from one alpha: these pairs only
  if (mode == BISECT1 && gmode == G_ONE)
    return arm1h_bwd_kernel<MAXF, BISECT1, G_ONE, 0>;
  if (mode == BISECT2 && gmode == G_SQRT)
    return arm1h_bwd_kernel<MAXF, BISECT2, G_SQRT, 0>;
  if (mode == BISECT3 && gmode == G_POW)
    return arm1h_bwd_kernel<MAXF, BISECT3, G_POW, 0>;
  return nullptr;
}

BwdKernel pick_bwd(int F, int mode, int gmode, bool wide) {
  if (wide) return nullptr;
  return F <= 16 ? pick_bucket<16>(mode, gmode)
                 : pick_bucket<kMaxF>(mode, gmode);
}

}  // namespace armnet
