"""The port's spans (armnet_tpu_torch/utils/tracing.py): the no-op with no
recorder, nesting and ids under one, and the spans of the feed
(BatchIterator, on its streaming and resident paths) and of the train
step, which change no batch, meter or parameter; the kernels' one launch
path (kernels/build.launch, with a stand-in for the C entry), the ledger
of kernel calls it adds to, and the one list of the wrappers that count
there (build.KERNELS). One test needs the card
(marked `cuda`; on a GPU machine: `python -m pytest --noconftest -q
tests/test_torch_tracing.py`): the feed's take spans, or its pin and copy
spans, and the kernels a step launches, the same with the recorder and
without.
"""

import contextlib
import ctypes
import glob
import importlib
import os
import re
import threading

import numpy as np
import pytest
import torch

from armnet_tpu_torch.data import libsvm
from armnet_tpu_torch.data.libsvm import BatchIterator
from armnet_tpu_torch.kernels import build
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from armnet_tpu_torch.utils import tracing
from armnet_tpu_torch.utils.tracing import recording, span

NFIELD, NFEAT, BSZ = 4, 50, 16
STEP_SPANS = ["armnet.step.forward", "armnet.step.backward",
              "armnet.step.meters", "armnet.step.update"]


class Rows:
    """An in-memory dataset as BatchIterator reads one."""

    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, NFEAT, (n, NFIELD)).astype(np.int32)
        self.values = rng.uniform(0.1, 1.0, (n, NFIELD)).astype(np.float32)
        self.labels = (rng.rand(n) < 0.4).astype(np.float32)
        self.nfield = NFIELD

    def __len__(self):
        return self.labels.shape[0]


def _names(rec):
    return [s.name for s in rec.spans]


def _epochs(it, n):
    return [[{k: v.clone() for k, v in b.items()} for b in it]
            for _ in range(n)]


@pytest.mark.parametrize("call", ["table_grad", None])
@pytest.mark.parametrize("err", [0, 2, 700])
def test_launch_raises_on_an_error_and_counts_a_call_only_on_success(
        monkeypatch, err, call):
    """build.launch calls the entry with the current stream appended and,
    where it returns 0, counts `call` once in the ledger (the process's and
    the recorder's); a non-zero cudaError raises a RuntimeError that names
    the entry and the error, and counts nothing. A device index of -1
    makes torch.cuda.device a no-op, so the CPU runs the launch path."""
    seen = []

    def entry(*args):
        seen.append(args)
        return err

    def function(source, name, argtypes):
        assert (source, name) == ("table_grad", "armnet_fake_entry")
        assert argtypes == [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        return entry

    monkeypatch.setattr(build, "function", function)
    monkeypatch.setattr(build, "raw_stream", lambda device: 0xBEEF)
    before = tracing.counts("armnet.kernel.")
    with recording() as rec:
        launch = contextlib.nullcontext() if err == 0 else pytest.raises(
            RuntimeError, match=f"armnet_fake_entry failed: cudaError {err}")
        with launch:
            build.launch("table_grad", "armnet_fake_entry",
                         [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], -1,
                         1234, 7, call=call)
    assert seen == [(1234, 7, 0xBEEF)]
    counted = {} if err or call is None else {f"armnet.kernel.{call}": 1}
    assert dict(rec.counters) == counted
    after = tracing.counts("armnet.kernel.")
    assert {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)} == counted


# every call= that a kernel wrapper passes to build.launch
CALLS_IN_SOURCES = sorted(
    m for path in glob.glob(os.path.join(os.path.dirname(build.__file__),
                                         "*.py"))
    for m in re.findall(r'\bcall="(\w+)"', open(path).read()))


@pytest.mark.parametrize("entry", build.KERNELS, ids=build.KERNEL_CALLS)
def test_kernel_list_names_each_wrapper_and_its_call(entry):
    """Each entry of build.KERNELS names a wrapper and a plain version of
    its module, and its call name is passed to build.launch there, once in
    the kernels' sources; every call name the sources pass is listed, so
    that what the wrappers count is what kernel_calls and the smoke read."""
    mod, wrapper, plain, call = entry
    module = importlib.import_module(f"armnet_tpu_torch.kernels.{mod}")
    assert callable(getattr(module, wrapper))
    assert callable(getattr(module, plain))
    assert f'call="{call}"' in open(module.__file__).read()
    assert CALLS_IN_SOURCES.count(call) == 1
    assert CALLS_IN_SOURCES == sorted(build.KERNEL_CALLS)


def test_no_recorder_returns_the_shared_no_op():
    assert tracing._RECORDER is None
    a, b = span("armnet.x"), span("armnet.y", step=3)
    assert a is b is tracing._NO_SPAN
    with a as inside:
        assert inside is a
    with recording() as rec:
        pass
    assert rec.spans == [] and tracing._RECORDER is None


def test_spans_nest_by_thread_and_carry_their_ids():
    with recording() as rec:
        with span("armnet.outer", step=7) as outer:
            with span("armnet.inner", epoch=1, batch=2) as inner:
                pass
            with span("armnet.sibling"):
                pass
            worker = threading.Thread(
                target=lambda: span("armnet.worker").__enter__().__exit__(),
                name="tracing-test")
            worker.start()
            worker.join(timeout=10)
        assert not worker.is_alive()
        with pytest.raises(RuntimeError, match="already installed"):
            with recording():
                pass
    assert tracing._RECORDER is None
    got = {s.name: s for s in rec.spans}
    assert _names(rec) == ["armnet.inner", "armnet.sibling",
                           "armnet.worker", "armnet.outer"]
    assert inner.parent is outer and got["armnet.sibling"].parent is outer
    assert outer.parent is None and outer.ids == {"step": 7}
    assert inner.ids == {"epoch": 1, "batch": 2}
    # the worker's stack is its own: no parent from the main thread
    assert got["armnet.worker"].parent is None
    assert got["armnet.worker"].thread == "tracing-test"
    assert outer.thread == threading.current_thread().name
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def _traced_epochs(rows, n, **kw):
    """n epochs of a shuffled iterator under the recorder, its last
    ahead-drawn order awaited inside the block; (batches, spans by name)."""
    with recording() as rec:
        it = BatchIterator(rows, BSZ, shuffle=True, seed=5, **kw)
        batches = _epochs(it, n)
        it._ahead.thread.join(timeout=10)
        assert not it._ahead.thread.is_alive()
    by = {}
    for s in rec.spans:
        by.setdefault(s.name, []).append(s)
    return it, batches, by


def _assert_same(plain, traced):
    for pe, te in zip(plain, traced):
        assert len(pe) == len(te) == 5
        for p, t in zip(pe, te):
            assert p.keys() == t.keys()
            for k in p:
                assert torch.equal(p[k], t[k])


def _assert_order_spans(by):
    """The epoch's wait for its order once an epoch; the next epoch's draw
    once an epoch, on the order worker."""
    assert [s.ids for s in by["armnet.feed.order"]] == [{"epoch": 0},
                                                        {"epoch": 1}]
    assert [s.ids for s in by["armnet.feed.order_draw"]] == [{"epoch": 1},
                                                             {"epoch": 2}]
    assert {s.thread for s in by["armnet.feed.order_draw"]} == {
        "armnet-order"}


@pytest.mark.parametrize("threaded", [False, True])
def test_feed_spans_leave_the_batches_bit_identical(monkeypatch, threaded):
    """Two shuffled epochs of 5 batches (the last padded) with and without
    the recorder: the same batches; order once an epoch, gather and free
    once a batch, with its epoch and batch, on the worker thread where
    there is one; release once an epoch; the next epoch's order drawn on
    the order worker."""
    if threaded:
        monkeypatch.setenv("ARMNET_PREFETCH_THREAD", "1")
    rows = Rows(70)
    plain = _epochs(BatchIterator(rows, BSZ, shuffle=True, seed=5), 2)
    it, traced, by = _traced_epochs(rows, 2)
    _assert_same(plain, traced)
    assert not it.resident
    assert set(by) == {"armnet.feed.order", "armnet.feed.order_draw",
                       "armnet.feed.gather", "armnet.feed.free",
                       "armnet.feed.release"}
    _assert_order_spans(by)
    assert [s.ids for s in by["armnet.feed.release"]] == [{"epoch": 0},
                                                          {"epoch": 1}]
    for name in ("armnet.feed.gather", "armnet.feed.free"):
        assert [s.ids for s in by[name]] == [
            {"epoch": e, "batch": b} for e in range(2) for b in range(5)]
    thread = "armnet-prefetch" if threaded else "MainThread"
    assert {s.thread for s in by["armnet.feed.gather"]} == {thread}


def test_resident_feed_spans_leave_the_batches_bit_identical(monkeypatch):
    """The resident path, driven on CPU tensors: the streaming path's
    batches; upload once an iterator, take once a batch with its epoch and
    batch, the order spans as streaming; no host gather, pin, copy or
    release."""
    rows = Rows(70)
    plain = _epochs(BatchIterator(rows, BSZ, shuffle=True, seed=5), 2)
    monkeypatch.setattr(libsvm, "resident_fits", lambda ds, device: True)
    it, traced, by = _traced_epochs(rows, 2)
    _assert_same(plain, traced)
    assert it.resident
    assert set(by) == {"armnet.feed.upload", "armnet.feed.order",
                       "armnet.feed.order_draw", "armnet.feed.take"}
    assert [s.ids for s in by["armnet.feed.upload"]] == [{}]
    _assert_order_spans(by)
    assert [s.ids for s in by["armnet.feed.take"]] == [
        {"epoch": e, "batch": b} for e in range(2) for b in range(5)]


def _train(steps, batches):
    cfg = ModelConfig(model="armnet_1h", nfeat=NFEAT, nfield=NFIELD, nemb=4,
                      h=8, mlp_nlayer=1, mlp_nhid=8, alpha=2.0, dropout=0.1)
    state = create_train_state(create_model(cfg, seed=1), 0.01)
    step = make_train_step("binary", 1.0, torch.Generator().manual_seed(3))
    meters = init_meters("cpu")
    for _, batch in zip(range(steps), batches):
        meters = step(state, meters, batch)
    params = {k: v.detach().clone()
              for k, v in state.model.named_parameters()}
    return meters, params, state.step


def test_train_step_spans_leave_meters_and_parameters_bit_identical():
    """Three CPU steps (dropout drawn from the step's generator) with and
    without the recorder: the same meters and parameters, bit for bit,
    and the four phases once a step, in order, each with its step."""
    batches = _epochs(BatchIterator(Rows(64, seed=2), BSZ), 1)[0]
    m0, p0, n0 = _train(3, batches)
    with recording() as rec:
        m1, p1, n1 = _train(3, batches)
    assert n0 == n1 == 3
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert _names(rec) == STEP_SPANS * 3
    assert [s.ids for s in rec.spans] == [{"step": k} for k in range(3)
                                          for _ in STEP_SPANS]
    assert all(s.parent is None for s in rec.spans)
    ends = [(s.start_ns, s.end_ns) for s in rec.spans]
    assert all(a[1] <= b[0] for a, b in zip(ends, ends[1:]))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _kernels(prof):
    """Kernels of a CUDA-activity profile (not copies, fills or
    annotations)."""
    from torch.autograd import DeviceType

    return [e.name() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA
            and not e.is_user_annotation()
            and not e.name().startswith(("Memcpy", "Memset"))]


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True])
def test_recorder_adds_no_kernel_on_the_card(cuda, monkeypatch, resident):
    """On the card, the feed records a take for every batch where its rows
    are resident (uploaded once, in the warm epoch), and pin and copy for
    every batch where they stream (RESIDENT_SHARE 0); 4 profiled train
    steps launch the same kernels with the recorder as without it."""
    from torch.profiler import ProfilerActivity, profile

    if not resident:
        monkeypatch.setattr(libsvm, "RESIDENT_SHARE", 0.0)

    cfg = ModelConfig(model="armnet_1h", nfeat=NFEAT, nfield=NFIELD, nemb=4,
                      h=8, mlp_nlayer=1, mlp_nhid=8, alpha=2.0)
    state = create_train_state(create_model(cfg, seed=1, device=cuda), 0.01)
    step = make_train_step("binary", 1.0)
    it = BatchIterator(Rows(BSZ * 4), BSZ, shuffle=True, seed=1, device=cuda)
    meters = init_meters(cuda)
    for batch in it:                         # warm: kernels built, Adam set
        meters = step(state, meters, batch)
    torch.cuda.synchronize(cuda)
    counts = []
    for traced in (False, True, False):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with recording() if traced else contextlib.nullcontext() as rec:
                for batch in it:
                    meters = step(state, meters, batch)
            torch.cuda.synchronize(cuda)
        counts.append(len(_kernels(prof)))
        if traced:
            names = _names(rec)
    assert counts[0] == counts[1] == counts[2] > 0
    assert it.resident is resident
    fed = (["armnet.feed.take"] if resident else
           ["armnet.feed.gather", "armnet.feed.pin", "armnet.feed.copy",
            "armnet.feed.free"])
    for name in fed:
        assert names.count(name) == 4, name
    for name in ("armnet.feed.take", "armnet.feed.gather", "armnet.feed.pin",
                 "armnet.feed.copy", "armnet.feed.free",
                 "armnet.feed.upload"):
        if name not in fed:
            assert name not in names, name
    for name in STEP_SPANS:
        assert names.count(name) == 4, name
