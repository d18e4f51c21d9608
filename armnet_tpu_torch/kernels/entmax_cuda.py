"""Wrappers of the CUDA alpha-entmax kernels: the forward (csrc/entmax_fwd.cuh,
built in csrc/entmax.cu and, for the powf modes, entmax_fastpow.cu and
entmax_newton.cu), port of the Pallas entries `_fwd2d` and `_entmax_mid`,
and the backward (csrc/entmax.cu), port of `_bwd2d` and `_entmax_mid_bwd`
(armnet_tpu/kernels/entmax_pallas.py).

`entmax_kernel` and `entmax_bwd_kernel` launch their kernel on CUDA tensors
or raise; nothing falls back to the plain PyTorch versions (`entmax_plain`
and `entmax_bwd_plain`, over kernels/entmax_common). ops/entmax picks
between the two by the tensor's device.

Both kernels read the normalized axis through an (outer, d, inner) view of
the contiguous input, so any axis is taken without a relayout: the
fields-major armnet_1h gates [B, F, O] on axis 1 are (B, F, O).
"""

import ctypes
import math

import torch

from armnet_tpu_torch.kernels import build
from armnet_tpu_torch.kernels.entmax_common import (bisect_steps,
                                                    entmax_bwd_axis0,
                                                    solve_entmax_axis0,
                                                    solver_mode)

__all__ = ["entmax_kernel", "entmax_plain", "entmax_bwd_kernel",
           "entmax_bwd_plain", "mode_id", "g_mode_id", "bucket_for",
           "fwd_function", "fwd_args", "FWD_ARGTYPES", "LAUNCHES", "BWD_LAUNCHES", "MAX_D"]

# kernel launches since the count was last set to 0 (the one place that
# adds to LAUNCHES is entmax_kernel, to BWD_LAUNCHES entmax_bwd_kernel,
# each right after a successful launch)
LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_D = 64       # largest compile-time register bucket of the kernels
# argument types of the forward's C entries (fwd_args' order)
FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
_MODE = {"fastpow": 3, "newton": 4}
_BISECT_MODE = {1.0: 0, 2.0: 1, 3.0: 2}
_G_MODE = {0.0: 0, 0.5: 1}          # g = 1, sqrt(y); 2 = powf
# the source and C entry of the forward in the powf modes, each built apart
# so that nvcc builds them in parallel; the bisection modes are in entmax.cu
_FWD_ENTRY = {3: ("entmax_fastpow", "armnet_entmax_fwd_fastpow"),
              4: ("entmax_newton", "armnet_entmax_fwd_newton")}


def entmax_plain(x, alpha, axis=-1, n_iter=50):
    """Plain PyTorch alpha-entmax along `axis` (any device)."""
    return solve_entmax_axis0(x.movedim(axis, 0), alpha, n_iter).movedim(
        0, axis)


def entmax_bwd_plain(y, dy, alpha, axis=-1):
    """Plain PyTorch entmax VJP along `axis` from the output y (any
    device)."""
    return entmax_bwd_axis0(y.movedim(axis, 0), dy.movedim(axis, 0),
                            alpha).movedim(0, axis)


def mode_id(alpha):
    """The solver branch of csrc/entmax_solver.cuh (Mode) for a static
    alpha."""
    mode = solver_mode(alpha)
    return _BISECT_MODE[1.0 / (alpha - 1.0)] if mode == "bisect" else \
        _MODE[mode]


def g_mode_id(alpha):
    """The VJP's g of csrc/entmax_solver.cuh (GMode) for a static alpha."""
    return _G_MODE.get(2.0 - alpha, 2)


def bucket_for(d):
    """The forward kernel's register bucket for a normalized axis of d
    entries: the least multiple of 8 that holds d (d = 39 runs in 40,
    d = 10 in 16). Raises past MAX_D."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"the entmax kernels take 1 to {MAX_D} entries on "
                         f"the normalized axis, got {d}")
    return -(-d // 8) * 8


def fwd_function(alpha):
    """The forward's ctypes entry for a static alpha (FWD_ARGTYPES), built
    at first use."""
    return build.function(*_FWD_ENTRY.get(
        mode_id(alpha), ("entmax", "armnet_entmax_fwd")), FWD_ARGTYPES)


def fwd_args(x, y, alpha, outer, d, inner, bucket, n_iter=50):
    """The forward entry's arguments (FWD_ARGTYPES) for y = entmax of the
    (outer, d, inner) view of x in register bucket `bucket`, on the current
    stream."""
    am1 = alpha - 1.0
    return (x.data_ptr(), y.data_ptr(), outer, d, inner, bucket,
            mode_id(alpha), bisect_steps(n_iter), am1, 1.0 / am1,
            (1.0 / d) ** am1, build.raw_stream(x.device))


def _view(x, alpha, axis, who, *more):
    """Checks shared by both kernels; returns (outer, d, inner)."""
    for t in (x, *more):
        if not t.is_cuda:
            raise ValueError(f"{who} needs a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who} needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who} needs a contiguous tensor")
        if t.shape != x.shape:
            raise ValueError(f"{who}: shapes {tuple(x.shape)} and "
                             f"{tuple(t.shape)} differ")
    if not alpha > 1.0:
        raise ValueError(f"{who} needs alpha > 1 (softmax at 1)")
    axis = axis % x.ndim
    d = x.shape[axis]
    if d > MAX_D:
        raise ValueError(f"{who} takes at most {MAX_D} entries on the "
                         f"normalized axis, got {d}")
    return math.prod(x.shape[:axis]), d, math.prod(x.shape[axis + 1:])


def entmax_kernel(x, alpha, axis=-1, n_iter=50):
    """alpha-entmax along `axis` of a contiguous CUDA float32 tensor, on the
    current stream. Raises on what the kernel does not take."""
    global LAUNCHES
    alpha = float(alpha)
    outer, d, inner = _view(x, alpha, axis, "entmax_kernel")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = fwd_function(alpha)
    with torch.cuda.device(x.device):
        err = fn(*fwd_args(x, y, alpha, outer, d, inner, bucket_for(d),
                           n_iter))
    if err != 0:
        raise RuntimeError(f"entmax kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return y


def entmax_bwd_kernel(y, dy, alpha, axis=-1):
    """The entmax VJP along `axis` from the output y and the cotangent dy,
    contiguous CUDA float32 tensors of one shape, on the current stream.
    Raises on what the kernel does not take."""
    global BWD_LAUNCHES
    alpha = float(alpha)
    outer, d, inner = _view(y, alpha, axis, "entmax_bwd_kernel", dy)
    dx = torch.empty_like(y)
    if y.numel() == 0:
        return dx
    fn = build.function(
        "entmax", "armnet_entmax_bwd",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), dy.data_ptr(), dx.data_ptr(), outer, d, inner,
                 g_mode_id(alpha), 2.0 - alpha, build.raw_stream(y.device))
    if err != 0:
        raise RuntimeError(
            f"entmax backward kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    return dx

