"""% of its roofline that the table gradient (K7: kernels/scatter_cuda.py,
its radix sort, zero fill and segmented sums) reaches per train step: the
least time of the dense gradient of rows x fields gathered rows of width
nemb into the nfeat-row table (yardstick) over the device time of the
kernels KERNELS names."""

from portbench import yardstick
from portbench.metrics._common import traced_steps

KERNELS = (r"\b(radix_count|radix_scan|radix_scatter|long_segment|segment"
           r"|zero)_kernel\b")


def read(w):
    n = traced_steps(w)
    if not n:
        return None
    cfg = w.config
    least = yardstick.table_grad_bound_s(
        cfg["nfeat"], w.rows_per_step * cfg["nfield"], cfg["nemb"])
    return yardstick.share(least, w.trace.kernel_s(KERNELS) / n)
