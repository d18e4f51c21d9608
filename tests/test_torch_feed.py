"""The train feed's epoch order and resident rows (armnet_tpu_torch/data/
libsvm.py, data/native.py), on the CPU:

  * the native order is numpy's legacy RandomState(seed).permutation(n)
    bit for bit, refuses the seeds numpy refuses with numpy's error, and
    falls back to numpy, warned, where its library cannot be built;
  * the iterator's orders drawn ahead are RandomState(seed + epoch)'s over
    three epochs, after an early break, and after `seed` and `epoch` are
    reset as the trainer resets them;
  * the resident path, driven on CPU tensors (resident_fits patched), yields
    the streaming path's batches bit for bit: shuffled and in order, the
    padded last batch, data-parallel slices, local_shard_total, and a UCI
    set whose ids are a broadcast view (kept as two rows).
"""

import warnings

import numpy as np
import pytest
import torch

from armnet_tpu_torch.data import libsvm, native
from armnet_tpu_torch.data.libsvm import (BatchIterator, draw_order,
                                          resident_bytes, resident_fits)
from armnet_tpu_torch.data.uci import UCIDataset

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 32 - 1, 12345 + 1, 12345 + 2, 777 + 9]
SIZES = [0, 1, 2, 3, 1000, 65_537, 4_194_304]


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("seed", SEEDS)
def test_native_order_is_numpys_permutation(seed, n):
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # the native route, no fallback
        got = draw_order(seed, n)
    want = np.random.RandomState(seed).permutation(n)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [2 ** 32, 2 ** 40, -1])
def test_seed_numpy_refuses_raises_numpys_error(seed):
    with pytest.raises(ValueError) as want:
        np.random.RandomState(seed).permutation(5)
    with pytest.raises(ValueError) as got:
        draw_order(seed, 5)
    assert str(got.value) == str(want.value)


def test_failed_build_warns_and_gives_numpys_order(tmp_path, monkeypatch):
    def no_compiler(out, source):
        raise RuntimeError(f"g++ failed for {source}")

    monkeypatch.setattr(native, "_order_lib", None)
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_build", no_compiler)
    with pytest.warns(UserWarning, match="native epoch order failed"):
        got = draw_order(11, 1000)
    np.testing.assert_array_equal(
        got, np.random.RandomState(11).permutation(1000))


def test_native_order_refuses_a_wrong_buffer():
    with pytest.raises(ValueError, match="contiguous int64"):
        native.permutation(1, 10, np.empty(10, np.int32))


# --- the iterator -----------------------------------------------------------

class Rows:
    """An in-memory dataset as BatchIterator reads one."""

    def __init__(self, n, nfield=3, seed=0):
        rng = np.random.RandomState(seed)
        self.ids = rng.randint(0, 50, (n, nfield)).astype(np.int32)
        self.values = rng.uniform(0.1, 1.0, (n, nfield)).astype(np.float32)
        self.labels = (rng.rand(n) < 0.4).astype(np.float32)
        self.nfield = nfield

    def __len__(self):
        return self.labels.shape[0]


def _batches(it):
    return [{k: v.clone() for k, v in b.items()} for b in it]


def _expected(ds, bsz, order):
    """The batches of one epoch in `order`, padded as the schema says."""
    out = []
    for lo in range(0, len(order), bsz):
        take = order[lo:lo + bsz]
        pad = bsz - len(take)
        out.append({
            "id": np.concatenate([ds.ids[take],
                                  np.zeros((pad, ds.nfield), np.int32)]),
            "value": np.concatenate([ds.values[take],
                                     np.ones((pad, ds.nfield), np.float32)]),
            "y": np.concatenate([ds.labels[take], np.zeros(pad, np.float32)]),
            "mask": np.concatenate([np.ones(len(take), np.float32),
                                    np.zeros(pad, np.float32)])})
    return out


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == ["id", "value", "y", "mask"]
        for k in g:
            w_k = torch.as_tensor(np.asarray(w[k]))
            assert g[k].dtype == w_k.dtype and g[k].is_contiguous(), k
            assert torch.equal(g[k], w_k), k


def _join_ahead(it):
    it._ahead.thread.join(timeout=10)
    assert not it._ahead.thread.is_alive()


def test_orders_drawn_ahead_are_the_epochs_permutations():
    """Three epochs: the first draws at its start, the next two take the
    order their predecessor drew ahead, each RandomState(seed + epoch)."""
    ds = Rows(70)
    it = BatchIterator(ds, 16, shuffle=True, seed=5)
    for epoch in range(3):
        _assert_same(_batches(it), _expected(
            ds, 16, np.random.RandomState(5 + epoch).permutation(70)))
        _join_ahead(it)
        assert it._ahead.key == (5, epoch + 1, 70)
    assert (it.orders_ahead, it.orders_at_start) == (2, 1)


def test_order_drawn_ahead_survives_an_early_break():
    ds = Rows(70)
    it = BatchIterator(ds, 16, shuffle=True, seed=8)
    for i, _ in enumerate(it):
        if i == 1:
            break
    _assert_same(_batches(it), _expected(
        ds, 16, np.random.RandomState(8 + 1).permutation(70)))
    assert (it.orders_ahead, it.orders_at_start) == (1, 1)


def test_reset_seed_and_epoch_redraw_at_the_epochs_start():
    """The trainer sets `seed` and `epoch` after construction (and its
    constructor advances `epoch`): a stale order drawn ahead is dropped."""
    ds = Rows(70)
    it = BatchIterator(ds, 16, shuffle=True, seed=2)
    _batches(it)
    it.seed, it.epoch = 9, 0
    _assert_same(_batches(it), _expected(
        ds, 16, np.random.RandomState(9).permutation(70)))
    it.epoch += 1                        # as Trainer's constructor does
    _assert_same(_batches(it), _expected(
        ds, 16, np.random.RandomState(9 + 2).permutation(70)))
    _assert_same(_batches(it), _expected(
        ds, 16, np.random.RandomState(9 + 3).permutation(70)))
    assert (it.orders_ahead, it.orders_at_start) == (1, 3)


def test_a_failed_draw_ahead_is_redrawn_and_raised_on_the_epoch(monkeypatch):
    """A seed numpy refuses for the next epoch: the worker keeps the error,
    and that epoch draws at its start and raises numpy's ValueError."""
    ds = Rows(20)
    it = BatchIterator(ds, 8, shuffle=True, seed=2 ** 32 - 1)
    _assert_same(_batches(it), _expected(
        ds, 8, np.random.RandomState(2 ** 32 - 1).permutation(20)))
    _join_ahead(it)
    assert isinstance(it._ahead.error, ValueError)
    with pytest.raises(ValueError, match="Seed must be between"):
        next(iter(it))


@pytest.fixture
def on_device(monkeypatch):
    """The resident path engaged on the CPU."""
    monkeypatch.setattr(libsvm, "resident_fits", lambda ds, device: True)


def _streamed_and_resident(monkeypatch, make, epochs=2):
    it = make()
    streamed = [_batches(it) for _ in range(epochs)]
    monkeypatch.setattr(libsvm, "resident_fits", lambda ds, device: True)
    it = make()
    resident = [_batches(it) for _ in range(epochs)]
    assert it.resident
    return streamed, resident, it


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("n", [64, 70, 5, 0])
def test_resident_batches_are_the_streamed_ones(monkeypatch, shuffle, n,
                                                device):
    """In order and shuffled, whole and padded last batches, a dataset
    smaller than a batch and an empty one."""
    ds = Rows(n)
    streamed, resident, it = _streamed_and_resident(
        monkeypatch, lambda: BatchIterator(ds, 16, shuffle, seed=4,
                                           device=device))
    for s, r in zip(streamed, resident):
        _assert_same(r, s)
    assert it._rows_on_device.values.shape == (n + 1, 3)


@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_resident_data_parallel_slices(monkeypatch, index):
    ds = Rows(70)
    streamed, resident, _ = _streamed_and_resident(
        monkeypatch, lambda: BatchIterator(ds, 16, True, seed=6,
                                           data_parallel=(index, 4)))
    for s, r in zip(streamed, resident):
        _assert_same(r, s)
        assert all(b["id"].shape == (4, 3) for b in r)


@pytest.mark.parametrize("total", [160, 140, 100])
@pytest.mark.parametrize("shuffle", [False, True])
def test_resident_local_shard(monkeypatch, shuffle, total):
    """A global total whose batches (8 local rows each) run past the 70
    local rows (whole pad batches at 160, one partial at 140), or stop
    short of them (a surplus at 100, warned once an iterator)."""
    ds = Rows(70)

    def make():
        return BatchIterator(ds, 16, shuffle, seed=1,
                             local_shard_total=total, data_parallel=(1, 2))

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        streamed, resident, _ = _streamed_and_resident(monkeypatch, make)
    surplus = [x for x in w if "more rows" in str(x.message)]
    assert len(surplus) == (2 if total == 100 else 0)   # one an iterator
    for s, r in zip(streamed, resident):
        _assert_same(r, s)


@pytest.mark.parametrize("shuffle", [False, True])
def test_resident_broadcast_ids_stay_two_rows(monkeypatch, shuffle):
    """A UCI set's ids (a broadcast view of arange(nfield)) go as the pad's
    zero row and the broadcast row, not as N rows."""
    rng = np.random.RandomState(3)
    ds = UCIDataset(rng.randn(37, 5), rng.randint(0, 3, 37))
    streamed, resident, it = _streamed_and_resident(
        monkeypatch, lambda: BatchIterator(ds, 16, shuffle, seed=2))
    for s, r in zip(streamed, resident):
        _assert_same(r, s)
    assert it._rows_on_device.ids.shape == (2, 5)
    assert resident_bytes(ds) < resident_bytes(Rows(37, nfield=5))


def test_resident_is_chosen_once_a_dataset(on_device):
    ds, other = Rows(40), Rows(24, seed=1)
    it = BatchIterator(ds, 16)
    _batches(it)
    first = it._rows_on_device
    _batches(it)
    assert it._rows_on_device is first
    it.ds = other
    _assert_same(_batches(it), _expected(other, 16, np.arange(24)))
    assert it._rows_on_device is not first


def test_rows_stream_off_cuda():
    ds = Rows(40)
    assert not resident_fits(ds, None)
    assert not resident_fits(ds, torch.device("cpu"))
    it = BatchIterator(ds, 16, device="cpu")
    _batches(it)
    assert not it.resident and it._rows_on_device is None
    assert resident_bytes(ds) == 41 * (3 * 4 * 2 + 4 + 4) + 40 * 8


def test_resident_rows_read_a_read_only_memmap(tmp_path, monkeypatch):
    """Row caches past MMAP_BYTES load as read-only memmaps: the upload
    reads them without a warning and yields the streamed batches."""
    ds = Rows(40)
    for name in ("ids", "values", "labels"):
        np.save(tmp_path / f"{name}.npy", getattr(ds, name))
    mapped = Rows(0)
    for name in ("ids", "values", "labels"):
        setattr(mapped, name, np.load(tmp_path / f"{name}.npy",
                                      mmap_mode="r"))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        streamed, resident, _ = _streamed_and_resident(
            monkeypatch, lambda: BatchIterator(mapped, 16, True, seed=3))
    for s, r in zip(streamed, resident):
        _assert_same(r, s)
