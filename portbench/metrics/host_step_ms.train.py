"""Host ms per step inside the program's train step call (enqueueing the
forward, backward, clamp, Adam and meters): the benchmark's
`portbench.step` span, over the traced window's steps."""

from portbench.metrics._common import per_step_ms


def read(w):
    return None if w.trace is None else per_step_ms(w, "portbench.step")
