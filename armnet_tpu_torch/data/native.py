"""ctypes binding of the port's native libsvm parser (data/csrc/
libsvm_parser.cc, the port's own copy of the JAX package's parser).

The library is built at first use with g++ and the flags below (no
-march=native: a host-specific ISA would raise SIGILL on another machine,
a signal no fallback can catch) into build/armnet_tpu_torch/ at the
repository root, named by a hash of the flags and the source, through a
pid-suffixed temporary file and os.replace, so processes that build at
once never load a half-written library. Nothing is built at import time.

The four C functions: libsvm_count_rows, libsvm_parse, and their byte-range
forms libsvm_count_rows_range, libsvm_parse_range (the rows whose first
byte lies in [lo, hi)). Malformed lines are skipped and counted; the count
comes back as a warning.
"""

import ctypes
import hashlib
import os
import subprocess
import warnings

import numpy as np

__all__ = ["SOURCE", "library_path", "load", "parse_file",
           "parse_file_range"]

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                      "libsvm_parser.cc")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "armnet_tpu_torch")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib = None
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


def library_path():
    """Where the library of the current source and flags lives."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD_DIR, f"libsvm_parser.{h.hexdigest()[:12]}.so")


def _build(out):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, out)
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load():
    """The library, built first where its file is missing."""
    global _lib
    if _lib is None:
        path = library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
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
