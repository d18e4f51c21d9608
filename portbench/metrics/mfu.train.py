"""% of the cards' float32 peak (67 TFLOP/s each, no tensor cores: the
precision the configurations run) that the train step's model FLOPs reach:
the reference's product FLOPs per example times 3 (forward and backward)
at the traced window's examples per second."""

from portbench.metrics._common import mfu


def read(w):
    return mfu(w, 3)
