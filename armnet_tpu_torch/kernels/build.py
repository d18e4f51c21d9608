"""Build the port's CUDA sources (kernels/csrc/*.cu) with nvcc and load them.

Each source becomes its own shared library with a plain C interface,
loaded with ctypes: no PyTorch headers, so a build takes seconds. Libraries
go to build/armnet_tpu_torch/ at the repository root, named by a hash of
the source and flags, and are built at first use (`load`) or all at once,
one nvcc process per source in parallel (`build_all`). Nothing here runs
at import time.
"""

import ctypes
import glob
import hashlib
import os
import subprocess
import time

__all__ = ["CSRC_DIR", "BUILD_DIR", "sources", "build_all", "build_log",
           "load", "function", "raw_stream"]

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "armnet_tpu_torch")
# no --use_fast_math: FTZ and approximate powf break the kernels' parity
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded = {}


def sources():
    """Kernel names: one per csrc/<name>.cu."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME to a CUDA toolkit); the port's "
            "kernels are built from source at first use")
    return path


def _lib_path(name):
    """The library's path, named by a hash of the flags, the source and
    every header in csrc/ (which the source may include)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    for path in [os.path.join(CSRC_DIR, f"{name}.cu")] + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}.{h.hexdigest()[:12]}.so")


def _start(name):
    """Start nvcc for one source, its output going to a log file; None if
    its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    with open(tmp + ".log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name, job):
    """Keep an ended nvcc's log beside the library; raise if it failed."""
    proc, tmp, out = job
    os.replace(tmp + ".log", out + ".log")
    with open(out + ".log") as f:
        log = f.read()
    if proc.wait() != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=None):
    """Build every kernel library that is not built yet, one nvcc per source
    in parallel. Returns {name: seconds} (0.0 for one already built)."""
    names = sources() if names is None else names
    t0 = time.perf_counter()
    jobs = {n: _start(n) for n in names}
    secs = {n: 0.0 for n, job in jobs.items() if job is None}
    try:
        while len(secs) < len(jobs):          # each in the order it ends
            for n, job in jobs.items():
                if n not in secs and job[0].poll() is not None:
                    secs[n] = time.perf_counter() - t0
                    _finish(n, job)
            time.sleep(0.05)
    finally:
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
    return secs


def build_log(name):
    """nvcc's output for a built library (ptxas register/spill report)."""
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def load(name):
    """ctypes handle of csrc/<name>.cu's library, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(_lib_path(name))
    return lib


def function(source, name, argtypes, restype=ctypes.c_int):
    """ctypes function `name` of csrc/<source>.cu with its argument and
    return types set (an int, the cudaError_t, unless said otherwise);
    built at first use."""
    fn = getattr(load(source), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def raw_stream(device):
    """The handle (an int) of PyTorch's current CUDA stream on `device`,
    without making a torch.cuda.Stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
