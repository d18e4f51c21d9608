"""The port's data path (armnet_tpu_torch/data/) against the JAX package's
armnet_tpu/data/libsvm.py, on the CPU:

  * the native parser (the port's own build of its copy of the C++
    source) gives the JAX parse's arrays, malformed lines included;
  * byte ranges partition the rows exactly for 1-5 shards on every route,
    with the boundary cases of tests/test_data.py;
  * the row cache: a round trip, the JAX package's cache read back, a
    corrupt cache re-parsed, an atomic publish, the route recorded;
  * BatchIterator's batches equal the JAX iterator's under shuffle,
    padding, local_shard_total and the surplus warning, and the
    data-parallel rows of a global batch;
  * the threaded prefetch yields the serial batches, raises a worker's
    exception, and reaps its thread on an early break.
"""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

import armnet_tpu.data.libsvm as jax_libsvm
from armnet_tpu.data.libsvm import BatchIterator as JaxBatchIterator
from armnet_tpu.data.libsvm import LibsvmDataset as JaxLibsvmDataset
from armnet_tpu_torch.data import libsvm, native
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          parse_libsvm, parse_routed,
                                          shard_byte_range)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARSERS = {"native": libsvm._parse_native,
           "numpy_fast": libsvm._parse_numpy_fast,
           "numpy_robust": libsvm._parse_numpy_robust}


@pytest.fixture(autouse=True)
def cache_dir(tmp_path, monkeypatch):
    """Every test's row cache lives in its own tmp directory."""
    d = tmp_path / "cache"
    monkeypatch.setenv("ARMNET_CACHE_DIR", str(d))
    return d


def write_rows(path, n, f, seed, malformed=False):
    rng = np.random.RandomState(seed)
    with open(path, "w") as fh:
        for i in range(n):
            pairs = " ".join(f"{rng.randint(0, 50)}:{rng.rand():.3f}"
                             for _ in range(f))
            fh.write(f"{rng.randint(0, 2)} {pairs}\n")
            if malformed and i % 17 == 3:
                fh.write("1 3:0.5\n")                  # too few fields
            if malformed and i % 23 == 5:
                fh.write("0 x:1 " + pairs.split(" ", 1)[1] + "\n")
    return path


def assert_arrays_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_native_parse_equals_jax_with_malformed_lines(tmp_path):
    p = write_rows(str(tmp_path / "m.libsvm"), 120, 4, 0, malformed=True)
    with pytest.warns(UserWarning, match=r"skipped 12 malformed line"):
        got, route = parse_routed(p, 4, use_cache=False)
    assert route == "native"
    assert got[0].shape == (120, 4)
    assert_arrays_equal(got, jax_libsvm._parse_numpy_robust(p, 4))
    assert_arrays_equal(got, jax_libsvm.parse_libsvm(p, 4, use_cache=False))


def test_native_library_is_the_ports_own_build():
    path = native.library_path()
    assert path.startswith(os.path.join(REPO, "build", "armnet_tpu_torch"))
    assert native.SOURCE == os.path.join(
        REPO, "armnet_tpu_torch", "data", "csrc", "libsvm_parser.cc")
    with open(native.SOURCE, "rb") as a, open(
            os.path.join(REPO, "csrc", "libsvm_parser.cc"), "rb") as b:
        assert a.read() == b.read()                  # a verbatim copy
    assert native.load()._name == path
    assert "-march=native" not in native.CXX_FLAGS


@pytest.mark.parametrize("nshards", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("route", list(PARSERS))
def test_byte_ranges_partition_the_rows(tmp_path, route, nshards):
    p = write_rows(str(tmp_path / "tr.libsvm"), 103, 4, 1)
    full = jax_libsvm.parse_libsvm(p, 4, use_cache=False)
    parts = [PARSERS[route](p, 4, shard_byte_range(p, i, nshards))
             for i in range(nshards)]
    for k in range(3):
        np.testing.assert_array_equal(
            np.concatenate([pt[k] for pt in parts]), full[k])


@pytest.mark.parametrize("route", ["native", "numpy_robust"])
def test_byte_ranges_partition_malformed_rows(tmp_path, route):
    p = write_rows(str(tmp_path / "m.libsvm"), 60, 3, 2, malformed=True)
    full = jax_libsvm.parse_libsvm(p, 3, use_cache=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for nshards in (2, 5):
            parts = [PARSERS[route](p, 3, shard_byte_range(p, i, nshards))
                     for i in range(nshards)]
            for k in range(3):
                np.testing.assert_array_equal(
                    np.concatenate([pt[k] for pt in parts]), full[k])


@pytest.mark.parametrize("route", list(PARSERS))
def test_byte_range_boundary_cases(tmp_path, route):
    """Boundaries on newlines, mid-line and past a final line without a
    newline neither drop nor duplicate rows (tests/test_data.py's case)."""
    p = str(tmp_path / "t.libsvm")
    with open(p, "w") as fh:
        fh.write("1 0:1 1:1\n0 2:1 3:1\n1 4:1 5:1")
    size = os.path.getsize(p)
    for nshards in range(1, size + 1):
        parts = [PARSERS[route](p, 2, shard_byte_range(p, i, nshards))
                 for i in range(nshards)]
        np.testing.assert_array_equal(
            np.concatenate([pt[2] for pt in parts]), [1.0, 0.0, 1.0],
            err_msg=f"nshards={nshards}")
        np.testing.assert_array_equal(
            np.concatenate([pt[0] for pt in parts]).reshape(-1),
            np.arange(6))


def test_cache_round_trip_and_route(tmp_path, cache_dir):
    p = write_rows(str(tmp_path / "c.libsvm"), 50, 4, 3)
    first = LibsvmDataset(p, 4)
    assert first.route == "native" and first.parse_seconds >= 0.0
    assert len(list(cache_dir.glob("libsvm_*.npy"))) == 3
    second = LibsvmDataset(p, 4)
    assert second.route == "cache"
    assert_arrays_equal((second.ids, second.values, second.labels),
                        (first.ids, first.values, first.labels))
    shard = LibsvmDataset(p, 4, shard=(1, 2))       # its own key
    assert shard.route == "native" and 0 < len(shard) < 50
    assert LibsvmDataset(p, 4, use_cache=False).route == "native"
    assert len(list(cache_dir.glob("libsvm_*.npy"))) == 6


def test_cache_is_the_jax_packages(tmp_path, cache_dir, monkeypatch):
    """Both packages key the same arrays the same way: a cache the JAX
    package wrote is read back by the port."""
    monkeypatch.setattr(jax_libsvm, "_CACHE_DIR", str(cache_dir))
    p = write_rows(str(tmp_path / "j.libsvm"), 40, 3, 4)
    want = jax_libsvm.parse_libsvm(p, 3, byte_range=(0, 500))
    got, route = parse_routed(p, 3, byte_range=(0, 500))
    assert route == "cache"
    assert_arrays_equal(got, want)


def test_corrupt_cache_is_reparsed(tmp_path, cache_dir):
    p = write_rows(str(tmp_path / "x.libsvm"), 30, 4, 5)
    want = parse_libsvm(p, 4)
    ids_file = next(iter(cache_dir.glob("libsvm_*.ids.npy")))
    data = ids_file.read_bytes()
    ids_file.write_bytes(data[:len(data) // 2])      # truncated
    with pytest.warns(UserWarning, match="re-parsing"):
        got, route = parse_routed(p, 4)
    assert route == "native"
    assert_arrays_equal(got, want)
    assert parse_routed(p, 4)[1] == "cache"          # published again


def test_cache_publish_is_atomic(tmp_path, cache_dir, monkeypatch):
    """A write that fails half way leaves no file under a cache name (and
    no temporary file), so no run loads half an array."""
    p = write_rows(str(tmp_path / "a.libsvm"), 30, 4, 6)
    real_save = np.save

    def failing_save(f, arr):
        f.write(b"\x93NUMPY partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", failing_save)
    with pytest.warns(UserWarning, match="cache not written"):
        assert parse_routed(p, 4)[1] == "native"
    assert list(cache_dir.iterdir()) == []
    monkeypatch.setattr(np, "save", real_save)
    replaced = []
    real_replace = os.replace

    def spy(src, dst):
        replaced.append((src, dst))
        real_replace(src, dst)

    monkeypatch.setattr(os, "replace", spy)
    parse_routed(p, 4)
    assert len(replaced) == 3
    assert all(src == f"{dst}.{os.getpid()}.tmp" for src, dst in replaced)


def test_fallback_routes_are_recorded(tmp_path, monkeypatch, capsys):
    p = write_rows(str(tmp_path / "f.libsvm"), 40, 4, 7)
    bad = write_rows(str(tmp_path / "b.libsvm"), 40, 4, 7, malformed=True)

    def broken(*a):
        raise OSError("no library")

    monkeypatch.setattr(native, "parse_file", broken)
    with pytest.warns(UserWarning, match="native libsvm parser failed"):
        ds = LibsvmDataset(p, 4, use_cache=False)
    assert ds.route == "numpy_fast"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        ds_bad = LibsvmDataset(bad, 4, use_cache=False)
    assert ds_bad.route == "numpy_robust" and len(ds_bad) == 40
    assert any("skipped 5 malformed line" in str(x.message) for x in w)
    assert capsys.readouterr().out.count("incorrect data format") == 5


# --- the iterator -----------------------------------------------------------

def _collect(it, epochs=2):
    return [[{k: np.asarray(v) for k, v in b.items()} for b in it]
            for _ in range(epochs)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for eg, ew in zip(got, want):
        assert len(eg) == len(ew)
        for bg, bw in zip(eg, ew):
            for k in ("id", "value", "y", "mask"):
                assert bg[k].dtype == np.asarray(bw[k]).dtype
                np.testing.assert_array_equal(bg[k], bw[k])


@pytest.mark.parametrize("shuffle", [False, True])
def test_batches_equal_the_jax_iterator(tmp_path, shuffle):
    p = write_rows(str(tmp_path / "i.libsvm"), 70, 4, 8)
    got = _collect(BatchIterator(LibsvmDataset(p, 4), 16, shuffle, seed=3))
    want = _collect(JaxBatchIterator(JaxLibsvmDataset(p, 4, use_cache=False),
                                     16, shuffle, seed=3, device_put=False))
    _assert_same_batches(got, want)
    assert got[0][-1]["mask"].sum() == 70 - 4 * 16   # padded last batch


@pytest.mark.parametrize("shuffle", [False, True])
def test_local_shard_batches_and_surplus_warning(tmp_path, shuffle):
    """A byte-range shard with local_shard_total below its rows: the same
    batches and the same surplus warning as the JAX iterator."""
    p = write_rows(str(tmp_path / "s.libsvm"), 90, 4, 9)
    ds = LibsvmDataset(p, 4, shard=(0, 2))
    jds = JaxLibsvmDataset(p, 4, use_cache=False, shard=(0, 2))
    total = len(ds) - 13                 # 13 rows past the epoch's batches
    it = BatchIterator(ds, 8, shuffle, seed=1, local_shard_total=total)
    with pytest.warns(UserWarning, match=r"holds \d+ more rows") as w:
        got = _collect(it)
    jit = JaxBatchIterator(jds, 8, shuffle, seed=1, device_put=False,
                           local_shard_total=total)
    with pytest.warns(UserWarning, match=r"holds \d+ more rows") as jw:
        want = _collect(jit)
    assert [str(x.message) for x in w] == [str(x.message) for x in jw]
    assert len(w) == 1                   # once per iterator
    _assert_same_batches(got, want)


def test_data_parallel_rows_of_the_global_batch(tmp_path):
    """data_parallel=(i, P): rows [i B/P, (i+1) B/P) of each global batch
    of the whole dataset; with local_shard_total, B/P rows a batch from the
    local shard, padded where it runs out."""
    p = write_rows(str(tmp_path / "d.libsvm"), 50, 3, 10)
    ds = LibsvmDataset(p, 3)
    whole = _collect(BatchIterator(ds, 8, True, seed=2))
    for i in range(2):
        part = _collect(BatchIterator(ds, 8, True, seed=2,
                                      data_parallel=(i, 2)))
        _assert_same_batches(part, [[{k: v[4 * i:4 * i + 4]
                                      for k, v in b.items()} for b in ep]
                                    for ep in whole])
    local = LibsvmDataset(p, 3, shard=(1, 2))
    it = BatchIterator(local, 8, False, local_shard_total=50,
                       data_parallel=(1, 2))
    batches = _collect(it, 1)[0]
    assert len(batches) == 7 and all(b["id"].shape == (4, 3)
                                     for b in batches)
    real = np.concatenate([b["y"][b["mask"] > 0] for b in batches])
    np.testing.assert_array_equal(real, local.labels[:len(real)])
    assert len(real) == min(len(local), 28)
    with pytest.raises(ValueError, match="must divide"):
        next(iter(BatchIterator(ds, 8, data_parallel=(0, 3))))


def test_device_cpu_hands_over_cpu_tensors(tmp_path):
    p = write_rows(str(tmp_path / "c.libsvm"), 20, 3, 11)
    for device in (None, "cpu"):
        b = next(iter(BatchIterator(LibsvmDataset(p, 3), 8, device=device)))
        assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
                   for v in b.values())


def test_threaded_prefetch_yields_the_serial_batches(tmp_path, monkeypatch):
    p = write_rows(str(tmp_path / "t.libsvm"), 100, 4, 12)
    ds = LibsvmDataset(p, 4)
    serial = _collect(BatchIterator(ds, 16, True, seed=4), 3)
    monkeypatch.setenv("ARMNET_PREFETCH_THREAD", "1")
    it = BatchIterator(ds, 16, True, seed=4)
    threaded = _collect(it, 3)
    assert it.thread is not None and it.thread.name == "armnet-prefetch"
    _assert_same_batches(threaded, serial)
    it.thread.join(timeout=5)
    assert not it.thread.is_alive()


def test_threaded_prefetch_raises_a_workers_exception(tmp_path, monkeypatch):
    monkeypatch.setenv("ARMNET_PREFETCH_THREAD", "1")
    p = write_rows(str(tmp_path / "e.libsvm"), 100, 4, 13)
    it = BatchIterator(LibsvmDataset(p, 4), 16)
    real_rows, calls = it._rows, []

    def failing(*a):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("bad row")
        return real_rows(*a)

    it._rows = failing
    seen = 0
    with pytest.raises(RuntimeError, match="bad row"):
        for _ in it:
            seen += 1
    assert seen == 2 and set(calls) == {"armnet-prefetch"}
    it.thread.join(timeout=5)
    assert not it.thread.is_alive()


def test_threaded_prefetch_reaps_its_thread_on_an_early_break(
        tmp_path, monkeypatch):
    """The trainer's eval_freq break leaves the worker blocked on a full
    queue; the iterator drains it and joins the thread."""
    monkeypatch.setenv("ARMNET_PREFETCH_THREAD", "1")
    p = write_rows(str(tmp_path / "r.libsvm"), 400, 4, 14)
    it = BatchIterator(LibsvmDataset(p, 4), 8)
    for i, _ in enumerate(it):
        if i == 1:
            break
    assert not it.thread.is_alive()
    assert len(list(it)) == 50                       # the next epoch whole
