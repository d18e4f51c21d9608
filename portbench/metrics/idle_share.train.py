"""% of the traced window in which no operation ran on the device: one
less the union of the device operations' intervals over the window."""

from portbench.metrics._common import idle_share


def read(w):
    return idle_share(w)
