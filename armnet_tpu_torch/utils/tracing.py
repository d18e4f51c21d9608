"""Named spans at the port's layer boundaries: the feed (data/libsvm.py's
BatchIterator), the train step (train/step.py) and the CIN layer
(ops/interaction.py), and counters of what a layer chose.

    with span("armnet.step.forward", step=state.step):
        ...

With no recorder installed, span() returns one shared object that does
nothing: the whole cost of a span site is one test of a module-level
None, with no allocation, no clock read and no device work. recording()
installs a Recorder for the length of a `with` block:

    with recording() as rec:
        ...
    rec.spans   # [Span], in the order they closed

A recorded span keeps its name, start and end in nanoseconds on
time.time_ns() (the clock torch.profiler converts the device's timestamps
to, so program spans and device operations share one timeline), the span
enclosing it on the same thread, the thread's name, and its ids: the step
index for the step's spans, the epoch and batch index for the feed's (a
batch gathered inside the next() that returns the one before it is
matched to its batch by them), the layer index for the CIN's. Under an
active torch.profiler a recorded
span also enters torch.profiler.record_function(name), so a profile shows
the same names. A span adds no host-device sync and no device operation.

Whoever installs the recorder writes its spans out, after the block.

count(name, n) adds n to a process-wide counter (a dict add: counters are
always on, so a trainer can log them once a run) and, where a recorder is
installed, to its own `counters`, which then hold what the block counted.
counts(prefix) returns the process-wide counters whose names start with
prefix.
"""

import collections
import contextlib
import threading
import time

import torch

__all__ = ["Span", "Recorder", "recording", "span", "count", "counts"]

_RECORDER = None
_COUNTS = collections.Counter()


class _NoSpan:
    """What span() returns where no recorder is installed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class Span:
    """One recorded span: name, start_ns, end_ns (time.time_ns()), parent
    (the Span enclosing it on its thread, or None), thread (the thread's
    name) and ids ({'step': ...}, {'epoch': ..., 'batch': ...} or
    {'layer': ...})."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "thread", "ids",
                 "_recorder", "_annotation")

    def __init__(self, recorder, name, ids):
        self.name, self.ids, self._recorder = name, ids, recorder
        self.start_ns = self.end_ns = self.parent = self._annotation = None
        self.thread = threading.current_thread().name

    def __enter__(self):
        stack = self._recorder._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        if torch.autograd.profiler._is_profiler_enabled:
            self._annotation = torch.autograd.profiler.record_function(
                self.name)
            self._annotation.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        if self._annotation is not None:
            self._annotation.__exit__(*exc)
        self._recorder._stack().pop()
        self._recorder.spans.append(self)
        return False


class Recorder:
    """The spans closed while the recorder was installed (`spans`, in the
    order they closed), each thread's spans nested on a stack of its own,
    and what count() counted meanwhile (`counters`)."""

    def __init__(self):
        self.spans = []
        self.counters = collections.Counter()
        self._local = threading.local()

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack


@contextlib.contextmanager
def recording():
    """`with recording() as rec:` installs a Recorder for the block; one
    recorder at a time."""
    global _RECORDER
    if _RECORDER is not None:
        raise RuntimeError("a span recorder is already installed")
    _RECORDER = Recorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = None


def span(name, step=None, epoch=None, batch=None, layer=None):
    """A context manager around one stretch of work named `name`: the
    shared no-op where no recorder is installed, else a Span that the
    recorder keeps when it closes. `step`, `epoch`, `batch` and `layer`
    are the ids it carries (those given)."""
    recorder = _RECORDER
    if recorder is None:
        return _NO_SPAN
    ids = {k: v for k, v in (("step", step), ("epoch", epoch),
                             ("batch", batch), ("layer", layer))
           if v is not None}
    return Span(recorder, name, ids)


def count(name, n=1):
    """Add n to the counter `name` (and to the installed recorder's)."""
    _COUNTS[name] += n
    recorder = _RECORDER
    if recorder is not None:
        recorder.counters[name] += n


def counts(prefix=""):
    """{name: value} of the process-wide counters named prefix..."""
    return {k: v for k, v in _COUNTS.items() if k.startswith(prefix)}
