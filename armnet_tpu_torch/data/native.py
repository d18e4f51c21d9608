"""ctypes bindings of the port's two native libraries: the libsvm parser
(data/csrc/libsvm_parser.cc, the port's own copy of the JAX package's
parser) and the shuffled feed's epoch order (data/csrc/legacy_order.cc).

Each library is built at first use with g++ and the flags below (no
-march=native: a host-specific ISA would raise SIGILL on another machine,
a signal no fallback can catch) into build/armnet_tpu_torch/ at the
repository root, named by a hash of the flags and the source, through a
pid-suffixed temporary file and os.replace, so processes that build at
once never load a half-written library. Nothing is built at import time.
A ctypes call releases the GIL while the C function runs.

The parser's four C functions: libsvm_count_rows, libsvm_parse, and their
byte-range forms libsvm_count_rows_range, libsvm_parse_range (the rows
whose first byte lies in [lo, hi)). Malformed lines are skipped and
counted; the count comes back as a warning.

The order's one C function, legacy_permutation, is numpy's legacy
RandomState(seed).permutation(n) bit for bit (MT19937 seeded by
init_genrand, Fisher-Yates from n - 1 down to 1 with numpy's
random_interval). BatchIterator draws the next epoch's order with it in a
worker thread, which the main thread's launches run beside: numpy's own
shuffle holds the GIL. Both callers fall back to numpy, with a warning,
where a library cannot be built or loaded.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings

import numpy as np

__all__ = ["SOURCE", "ORDER_SOURCE", "library_path", "order_library_path",
           "load", "load_order", "parse_file", "parse_file_range",
           "permutation"]

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCE = os.path.join(_CSRC, "libsvm_parser.cc")
ORDER_SOURCE = os.path.join(_CSRC, "legacy_order.cc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "armnet_tpu_torch")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None
_order_lib = None
_order_lock = threading.Lock()       # the main thread and the order worker
_P64 = ctypes.POINTER(ctypes.c_int64)
_PI32 = ctypes.POINTER(ctypes.c_int32)
_PF32 = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "libsvm_count_rows": [ctypes.c_char_p],
    "libsvm_parse": [ctypes.c_char_p, ctypes.c_int64, _PI32, _PF32, _PF32,
                     ctypes.c_int64, _P64],
    "libsvm_count_rows_range": [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_int64],
    "libsvm_parse_range": [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int64, _PI32, _PF32, _PF32,
                           ctypes.c_int64, _P64],
}


def _library_path(source):
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as f:
        h.update(f.read())
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(_BUILD_DIR, f"{stem}.{h.hexdigest()[:12]}.so")


def library_path():
    """Where the parser library of the current source and flags lives."""
    return _library_path(SOURCE)


def order_library_path():
    """Where the order library of the current source and flags lives."""
    return _library_path(ORDER_SOURCE)


def _build(out, source):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, source], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ failed for {source}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open(path, source):
    if not os.path.exists(path):
        _build(path, source)
    return ctypes.CDLL(path)


def load():
    """The parser library, built first where its file is missing."""
    global _lib
    if _lib is None:
        lib = _open(library_path(), SOURCE)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _parse(path, nfield, count, parse):
    nrows = count()
    if nrows < 0:
        raise OSError(f"cannot read {path}")
    # one spare row: a zero-row range still hands the parser valid buffers
    ids = np.empty((nrows + 1, nfield), np.int32)
    values = np.empty((nrows + 1, nfield), np.float32)
    labels = np.empty((nrows + 1,), np.float32)
    skipped = ctypes.c_int64(0)
    got = parse(ids.ctypes.data_as(_PI32), values.ctypes.data_as(_PF32),
                labels.ctypes.data_as(_PF32), nrows, ctypes.byref(skipped))
    if got < 0:
        raise OSError(f"native parse failed for {path}")
    if skipped.value:
        warnings.warn(f"{path}: skipped {skipped.value} malformed line(s)")
    return ids[:got], values[:got], labels[:got]


def parse_file(path, nfield):
    """(ids [N, F] int32, values [N, F] f32, labels [N] f32) of a file."""
    lib, b = load(), os.fsencode(path)
    return _parse(path, nfield, lambda: lib.libsvm_count_rows(b),
                  lambda *out: lib.libsvm_parse(b, nfield, *out))


def parse_file_range(path, nfield, lo, hi):
    """The same for the rows whose first byte lies in [lo, hi)."""
    lib, b = load(), os.fsencode(path)
    return _parse(path, nfield,
                  lambda: lib.libsvm_count_rows_range(b, lo, hi),
                  lambda *out: lib.libsvm_parse_range(b, nfield, lo, hi,
                                                      *out))


def load_order():
    """The order library, built first where its file is missing."""
    global _order_lib
    with _order_lock:
        if _order_lib is None:
            lib = _open(order_library_path(), ORDER_SOURCE)
            lib.legacy_permutation.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                               _P64]
            lib.legacy_permutation.restype = ctypes.c_int64
            _order_lib = lib
    return _order_lib


def permutation(seed, n, out):
    """Fill `out` (int64 [n], C-contiguous) with numpy's legacy
    RandomState(seed).permutation(n); seed in [0, 2^32 - 1], n at most
    2^32. The GIL is released while it runs."""
    if not (out.dtype == np.int64 and out.shape == (n,)
            and out.flags.c_contiguous and out.flags.writeable):
        raise ValueError(f"out must be a writable contiguous int64 [{n}]")
    if not 0 <= seed <= 0xFFFFFFFF:
        raise ValueError(f"seed {seed} is not in [0, 2^32 - 1]")
    if load_order().legacy_permutation(seed, n, out.ctypes.data_as(_P64)):
        raise RuntimeError(f"no native permutation of {n} rows")
    return out
