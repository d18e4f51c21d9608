"""% of its roofline that the entmax forward and backward kernels (K2,
K4: kernels/entmax_cuda.py) reach per train step: the least time of both
passes at the configuration's [rows, fields, channels] (yardstick) over
the device time of the kernels KERNELS names."""

from portbench.metrics._common import entmax_share

KERNELS = r"entmax_(fwd|bwd)\w*_kernel"


def read(w):
    return None if w.trace is None else entmax_share(w, KERNELS,
                                                     ("fwd", "bwd"))
