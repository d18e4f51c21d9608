"""Seconds from the process's start to the window's first step: imports,
the device's start, the rows and weights, the kernels' build where the
checkout has none, and the warm-up (the check's first steps in a train
cell)."""


def read(w):
    return w.setup_s
