"""Wrappers of the CUDA alpha-entmax kernels: the forward (csrc/entmax_fwd.cuh,
built in csrc/entmax.cu and, for the powf modes, entmax_fastpow.cu and
entmax_newton.cu, for d <= 64; csrc/entmax_fwd_column.cu past 64), port of
the Pallas entries `_fwd2d` and `_entmax_mid`, and the backward
(csrc/entmax_bwd.cu, any d), port of `_bwd2d` and `_entmax_mid_bwd`
(armnet_tpu/kernels/entmax_pallas.py).

`entmax_kernel` and `entmax_bwd_kernel` launch their kernel on CUDA tensors
or raise; nothing falls back to the plain PyTorch versions (`entmax_plain`
and `entmax_bwd_plain`, over kernels/entmax_common). ops/entmax picks
between the two by the tensor's device.

Both kernels read the normalized axis through an (outer, d, inner) view of
the contiguous input, so any axis is taken without a relayout: the
fields-major armnet_1h gates [B, F, O] on axis 1 are (B, F, O). Neither
refuses a length of the axis: the forward's route (`route_for`) holds a
column of d <= 64 in a register bucket, a longer one in shared memory or,
past 1816 entries, in the output itself.
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
           "entmax_bwd_plain", "mode_id", "g_mode_id", "route_for",
           "fwd_function", "fwd_args", "bwd_blocks_per_sm", "FWD_ARGTYPES",
           "LAUNCHES", "BWD_LAUNCHES", "REGISTER_D", "SMEM_BYTES"]

# kernel launches since the count was last set to 0 (the one place that
# adds to LAUNCHES is entmax_kernel, to BWD_LAUNCHES entmax_bwd_kernel,
# each right after a successful launch)
LAUNCHES = 0
BWD_LAUNCHES = 0
REGISTER_D = 64  # largest compile-time register bucket of the forward
SMEM_BYTES = 232_448       # shared memory a block can use on Hopper
# argument types of the forward's C entries (fwd_args' order): a register
# bucket's, and the column entry's (threads and shared where the bucket is)
FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
COLUMN_ARGTYPES = FWD_ARGTYPES[:6] + [ctypes.c_int] + FWD_ARGTYPES[6:]
BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
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


def mode_id(alpha, solver="fastpow"):
    """The solver branch of csrc/entmax_solver.cuh (Mode) for a static
    alpha under `solver` (entmax_common.SOLVERS)."""
    mode = solver_mode(alpha, solver)
    return _BISECT_MODE[1.0 / (alpha - 1.0)] if mode == "bisect" else \
        _MODE[mode]


def g_mode_id(alpha):
    """The VJP's g of csrc/entmax_solver.cuh (GMode) for a static alpha."""
    return _G_MODE.get(2.0 - alpha, 2)


def route_for(d):
    """Where the forward kernel holds a column of d entries (d >= 1):
    ("register", bucket) up to REGISTER_D, the bucket the least multiple of
    8 that holds d (d = 39 runs in 40, d = 10 in 16); past it ("shared",
    threads), blocks of 128, 64 or 32 columns, the most whose columns fit
    a block's shared memory; ("global", 128) where not even 32 do."""
    if d < 1:
        raise ValueError(f"entmax needs at least one entry on the "
                         f"normalized axis, got {d}")
    if d <= REGISTER_D:
        return "register", -(-d // 8) * 8
    for threads in (128, 64, 32):
        if 4 * d * threads <= SMEM_BYTES:
            return "shared", threads
    return "global", 128


def fwd_function(alpha, route, solver="fastpow"):
    """The forward's ctypes entry for a static alpha on a route (route_for),
    built at first use: a register bucket's entry of alpha's solver mode
    (FWD_ARGTYPES), or the column entry of every mode (COLUMN_ARGTYPES)."""
    if route[0] != "register":
        return build.function("entmax_fwd_column", "armnet_entmax_fwd_column",
                              COLUMN_ARGTYPES)
    return build.function(*_FWD_ENTRY.get(
        mode_id(alpha, solver), ("entmax", "armnet_entmax_fwd")),
        FWD_ARGTYPES)


def fwd_args(x, y, alpha, outer, d, inner, route, n_iter=50,
             solver="fastpow"):
    """The forward entry's arguments for y = entmax of the (outer, d,
    inner) view of x on `route` (route_for; a register route's argument is
    its bucket, FWD_ARGTYPES; the others' their threads and where the
    column lives, COLUMN_ARGTYPES), on the current stream."""
    am1 = alpha - 1.0
    where, n = route
    place = (n,) if where == "register" else (n, int(where == "shared"))
    return (x.data_ptr(), y.data_ptr(), outer, d, inner, *place,
            mode_id(alpha, solver), bisect_steps(n_iter), am1, 1.0 / am1,
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
    return (math.prod(x.shape[:axis]), x.shape[axis],
            math.prod(x.shape[axis + 1:]))


def entmax_kernel(x, alpha, axis=-1, n_iter=50, solver="fastpow"):
    """alpha-entmax along `axis` of a contiguous CUDA float32 tensor, on the
    current stream; solver="newton" launches the newton build at any
    generic alpha (entmax_common.solver_mode). Raises on what the kernel
    does not take."""
    global LAUNCHES
    alpha = float(alpha)
    outer, d, inner = _view(x, alpha, axis, "entmax_kernel")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    route = route_for(d)
    fn = fwd_function(alpha, route, solver)
    with torch.cuda.device(x.device):
        err = fn(*fwd_args(x, y, alpha, outer, d, inner, route, n_iter,
                           solver))
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
    fn = build.function("entmax_bwd", "armnet_entmax_bwd", BWD_ARGTYPES)
    with torch.cuda.device(y.device):
        err = fn(y.data_ptr(), dy.data_ptr(), dx.data_ptr(), outer, d, inner,
                 g_mode_id(alpha), 2.0 - alpha, build.raw_stream(y.device))
    if err != 0:
        raise RuntimeError(
            f"entmax backward kernel launch failed: cudaError {err}")
    BWD_LAUNCHES += 1
    return dx



def bwd_blocks_per_sm(d, alpha):
    """Blocks of the backward kernel that one SM of the current device
    holds at d entries and alpha (its registers and shared memory), as the
    occupancy calculator gives it."""
    fn = build.function("entmax_bwd", "armnet_entmax_bwd_blocks_per_sm",
                        [ctypes.c_int, ctypes.c_int,
                         ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(d, g_mode_id(float(alpha)), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"armnet_entmax_bwd_blocks_per_sm failed: "
                           f"cudaError {err}")
    return n.value
