"""% of its roofline that the CIN's kernels (K8: kernels/cin_cuda.py, its
forward, ReLU mask, dx, dW and ordered sums) reach per train step: the
least time of the CIN's forward and backward at the step's rows (the
reference's count: FLOPs over the f32 peak or bytes over HBM's rate,
whichever is larger) over the device time of the kernels KERNELS names."""

from portbench import yardstick
from portbench.metrics._common import traced_steps

KERNELS = r"\bcin_\w*_kernel\b"


def read(w):
    n = traced_steps(w)
    count = getattr(w.reference, "cin_flops_per_example", None)
    if not n or count is None:
        return None
    rows = w.rows_per_step
    least = max(sum(count(w.config)) * rows / yardstick.F32_FLOPS,
                w.reference.cin_bytes(w.config, rows)
                / yardstick.HBM_BYTES_PER_S)
    return yardstick.share(least, w.trace.kernel_s(KERNELS) / n)
