"""Examples trained per second: every step of the window times the batch,
over the window's host-clock seconds (the last step waited for)."""


def read(w):
    return w.rows_per_s
