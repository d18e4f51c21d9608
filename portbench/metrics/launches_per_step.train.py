"""Device kernels launched per step: every kernel of the trace in the
window (the program's own and torch's), over the traced steps."""

from portbench.metrics._common import traced_steps


def read(w):
    n = traced_steps(w)
    return len(w.trace.kernels()) / n if n else None
