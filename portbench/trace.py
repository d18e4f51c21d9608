"""The device trace of a window and the host spans beside it.

A traced run wraps its window in one torch.profiler session with CUDA
activity alone: recording every host operator as well slowed the host
side of a 65,536-row train step from about 45 to 57 ms and left the card
idle for a quarter of the window, which an untraced run is not. The
benchmark's own spans around its calls into the program (`Spans`, names
`portbench.*`) are kept on the host's real-time clock in nanoseconds,
the clock the profiler converts the device's timestamps to, so an idle
gap on the device can be named by what the host was doing. `Trace` holds
only what the readers use: the device operations (kernels, copies,
fills) and the spans, each as (start_ns, end_ns), clipped to the window.
"""

import contextlib
import re
import time

__all__ = ["SPAN_PREFIX", "WINDOW_SPAN", "Spans", "Trace", "from_profiler",
           "union", "gaps"]

SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.window"


class Spans:
    """Host spans of one run: `with spans("portbench.step"): ...` keeps
    (name, start_ns, end_ns) on the real-time clock."""

    def __init__(self):
        self.kept = []

    @contextlib.contextmanager
    def __call__(self, name):
        start = time.time_ns()
        try:
            yield
        finally:
            self.kept.append((name, start, time.time_ns()))

    def by_name(self):
        out = {}
        for name, s, e in self.kept:
            out.setdefault(name, []).append((s, e))
        return out


def union(intervals):
    """Merged, sorted (start, end) of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def gaps(merged, lo, hi):
    """(start, end) of the stretches of [lo, hi) that `merged` leaves
    uncovered."""
    out, at = [], lo
    for s, e in merged:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [g for g in out if g[1] > g[0]]


class Trace:
    """A window's device operations and host spans.

    ops: [(name, kind, start_ns, end_ns)] with kind 'kernel', 'gpu_memcpy'
    or 'gpu_memset'; spans: {name: [(start_ns, end_ns)]}; window: (start,
    end) ns. Everything outside the window is dropped and what straddles
    it is clipped."""

    def __init__(self, ops, spans, window):
        self.window = window
        lo, hi = window
        self.ops = [(n, k, max(s, lo), min(e, hi)) for n, k, s, e in ops
                    if e > lo and s < hi]
        self.spans = {name: [(max(s, lo), min(e, hi)) for s, e in v
                             if e > lo and s < hi]
                      for name, v in spans.items()}

    @property
    def window_s(self):
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self):
        """Seconds of the window in which some operation ran on the
        device."""
        return sum(e - s for s, e in union(
            (s, e) for _, _, s, e in self.ops)) / 1e9

    def kernels(self, pattern=None):
        """Kernel launches whose name matches the regular expression
        `pattern` (every kernel without one)."""
        rx = None if pattern is None else re.compile(pattern)
        return [op for op in self.ops if op[1] == "kernel"
                and (rx is None or rx.search(op[0]))]

    def kernel_s(self, pattern):
        return sum(e - s for _, _, s, e in self.kernels(pattern)) / 1e9

    def span_count(self, name):
        return len(self.spans.get(name, []))

    def span_s(self, name):
        return sum(e - s for s, e in self.spans.get(name, [])) / 1e9

    def top_ops(self, n=10):
        """[[name, seconds]] of the n device operations that took most time,
        summed by name."""
        total = {}
        for name, _, s, e in self.ops:
            total[name] = total.get(name, 0) + (e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:96], t / 1e9] for name, t in top]

    def idle_gaps(self, n=10):
        """[[span, seconds]] of the n longest stretches of the window with
        nothing on the device, each named by the innermost benchmark span
        that holds the stretch's middle on the host ('none' if none)."""
        merged = union((s, e) for _, _, s, e in self.ops)
        found = sorted(gaps(merged, *self.window),
                       key=lambda g: g[0] - g[1])[:n]
        inner = sorted(((e - s, s, e, name)
                        for name, v in self.spans.items()
                        if name != WINDOW_SPAN for s, e in v))
        out = []
        for s, e in found:
            mid = (s + e) // 2
            name = next((nm for _, a, b, nm in inner if a <= mid < b), "none")
            out.append([name, (e - s) / 1e9])
        return out


def _kind(name):
    """'gpu_memcpy', 'gpu_memset' or 'kernel' by a device event's name."""
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def from_profiler(prof, spans, device_type=None):
    """The Trace of a finished torch.profiler session over a window that
    `spans` (a Spans) holds as WINDOW_SPAN, or None where the session
    recorded no device operation or `spans` no window. Device operations
    are the events of `device_type` (CUDA by default) that are not
    annotations."""
    from torch.autograd import DeviceType

    device_type = DeviceType.CUDA if device_type is None else device_type
    ops = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == device_type and not ev.is_user_annotation():
            name = ev.name()
            ops.append((name, _kind(name), ev.start_ns(),
                        ev.start_ns() + ev.duration_ns()))
    found = spans.by_name()
    windows = found.get(WINDOW_SPAN)
    if not ops or not windows:
        return None
    return Trace(ops, found, windows[-1])
