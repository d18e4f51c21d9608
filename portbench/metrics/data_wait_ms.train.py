"""Host ms per step spent taking the next batch from the program's
BatchIterator (its host assembly and the lookahead's copy): the
benchmark's `portbench.data` span, over the traced window's steps."""

from portbench.metrics._common import per_step_ms


def read(w):
    return None if w.trace is None else per_step_ms(w, "portbench.data")
