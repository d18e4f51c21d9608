"""Wrappers of the CUDA alpha-entmax kernels: the forward (csrc/entmax_fwd.cuh,
built in csrc/entmax.cu and, for the powf modes, entmax_fastpow.cu,
entmax_newton.cu, entmax_packed_fastpow.cu and entmax_packed_newton.cu, for
d <= 64; csrc/entmax_fwd_column.cu past 64), port of the Pallas entries
`_fwd2d` and `_entmax_mid`, and the backward (csrc/entmax_bwd.cu, any d),
port of `_bwd2d` and `_entmax_mid_bwd` (armnet_tpu/kernels/entmax_pallas.py).

`entmax_kernel` and `entmax_bwd_kernel` launch their kernel on CUDA tensors
or raise; nothing falls back to the plain PyTorch versions (`entmax_plain`
and `entmax_bwd_plain`, over kernels/entmax_common). ops/entmax picks
between the two by the tensor's device.

Both kernels read the normalized axis through an (outer, d, inner) view of
the contiguous input, so any axis is taken without a relayout: the
fields-major armnet_1h gates [B, F, O] on axis 1 are (B, F, O), the last
axis of [B, K, O, F] is (B*K*O, F, 1). Each picks a route by shape
(`route_for`, `bwd_route_for`): where inner is small (the normalized axis
minor, or a few channels) a block stages a span of whole outer indices in
shared memory, so that every access to device memory is coalesced and
every thread owns a column (the packed routes); where inner is wide,
neighbouring threads take neighbouring columns of one outer index. Neither
refuses a length of the axis.
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
           "bwd_route_for", "bucket_for", "fwd_entry", "fwd_args",
           "fwd_blocks_per_sm", "bwd_blocks_per_sm", "FWD_ARGTYPES",
           "BWD_ARGTYPES", "REGISTER_D", "SMEM_BYTES", "PACKED_THREADS",
           "PACKED_FWD_INNER", "PACKED_LANES_INNER", "PACKED_BWD_INNER",
           "PACKED_BWD_SMEM", "FILL_COLUMNS"]

REGISTER_D = 64  # largest compile-time register bucket of the forward
SMEM_BYTES = 232_448       # shared memory a block can use on Hopper
PACKED_THREADS = 128       # threads of a packed block (both directions)
# the packed routes take inner up to these: the forward with one lane a
# column (its wide route reads whole rows of a warp's columns from there
# on and its solve, not its loads, bounds it: the packed route 4.1x the
# wide one at inner 1, 1.01x at 16, 0.97x at 32; PERF.md), with
# 2 or 4 lanes up to PACKED_LANES_INNER (a column's 4 lanes at inner 32
# fill a block of 128); the backward's staged route leaves threads idle
# below 128 (the packed one 1.06-46x faster at inner 1-64)
PACKED_FWD_INNER = 16
PACKED_LANES_INNER = 32
PACKED_BWD_INNER = 127
# the packed backward's two spans stay within this much shared memory a
# block (3 blocks an SM, as the staged route's 64-row stages), packing fewer
# outer indices where they would not
PACKED_BWD_SMEM = 65_536
# below this many columns the packed forward spreads a column over 4 lanes
# (LANES of csrc/entmax_fwd.cuh; 2 where a lane would hold 8 entries or
# fewer), so that the card holds enough threads to hide the solve's latency
# (db_armnet's 32,768 columns: 0.070 ms at 4 lanes, 0.077 at 2, 0.104 at
# 1 and 0.105 on the wide route; PERF.md). Not in the newton mode
# (alpha > 2): there the lanes' other order of the sums moved an entry at
# the support's edge 1.07e-5 from the plain version, past the 1e-5 it is
# held to, so it keeps one lane (and has no other build)
FILL_COLUMNS = 65_536
# argument types of the forward's C entries (fwd_args' order, then the
# stream): a register bucket's, and the column entry's (threads and shared
# where the bucket is)
FWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p]
COLUMN_ARGTYPES = FWD_ARGTYPES[:6] + [ctypes.c_int] + FWD_ARGTYPES[6:]
# the packed entry's: its lanes after the bucket (the column entry's types)
PACKED_ARGTYPES = COLUMN_ARGTYPES
BWD_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
_MODE = {"fastpow": 3, "newton": 4}
_BISECT_MODE = {1.0: 0, 2.0: 1, 3.0: 2}
_G_MODE = {0.0: 0, 0.5: 1}          # g = 1, sqrt(y); 2 = powf
# the source and C entry of the forward in the powf modes, each built apart
# so that nvcc builds them in parallel; the bisection modes are in entmax.cu
_FWD_ENTRY = {3: ("entmax_fastpow", "armnet_entmax_fwd_fastpow"),
              4: ("entmax_newton", "armnet_entmax_fwd_newton")}
_PACKED_ENTRY = {3: ("entmax_packed_fastpow",
                     "armnet_entmax_fwd_packed_fastpow"),
                 4: ("entmax_packed_newton", "armnet_entmax_fwd_packed_newton")}


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


def bucket_for(d, lanes=1):
    """The register bucket of a thread that holds d entries over `lanes`
    threads: the least multiple of 8 that holds d at one lane, of 4 (at
    least 8) that holds ceil(d / lanes) at more (csrc/entmax_fwd.cuh's
    instantiations)."""
    if lanes == 1:
        return -(-d // 8) * 8
    return max(8, -(-(-(-d // lanes)) // 4) * 4)


def route_for(d, inner, outer, alpha, solver="fastpow"):
    """Where the forward kernel takes the (outer, d, inner) view (d >= 1)
    at a static alpha under `solver`.

    - ("packed", bucket, lanes) where d <= REGISTER_D and inner <=
      PACKED_FWD_INNER, or <= PACKED_LANES_INNER where lanes > 1: a block
      of 128 threads stages 128 / (lanes * inner) whole outer indices in
      shared memory, `lanes` threads a column, each holding its share in a
      register bucket of `bucket` (lanes * bucket >= d). Lanes are 1 in
      the newton mode and wherever the view has FILL_COLUMNS columns
      (outer * inner) or more; else 4, halved while half as many would
      still hold more than 8 entries a lane.
    - ("register", bucket) where d <= REGISTER_D and inner is wider:
      neighbouring threads take neighbouring columns of an outer index,
      bucket the least multiple of 8 that holds d (d = 39 runs in 40, d =
      10 in 16).
    - ("shared", threads) past REGISTER_D: blocks of 128, 64 or 32
      columns, the most whose columns fit a block's shared memory; or
      ("global", 128) where not even 32 do. Their columns go through
      shared memory or the output a thread each at any inner (the packed
      route's span would not fit the register buckets)."""
    if d < 1:
        raise ValueError(f"entmax needs at least one entry on the "
                         f"normalized axis, got {d}")
    lanes = 1 if (outer * inner >= FILL_COLUMNS or inner > PACKED_LANES_INNER
                  or solver_mode(alpha, solver) == "newton") else 4
    while lanes > 1 and -(-d // (lanes // 2)) <= 8:
        lanes //= 2           # more than 8 entries a lane
    if d <= REGISTER_D and (inner <= PACKED_FWD_INNER or lanes > 1):
        return "packed", bucket_for(d, lanes), lanes
    if d <= REGISTER_D:
        return "register", bucket_for(d)
    for threads in (128, 64, 32):
        if 4 * d * threads <= SMEM_BYTES:
            return "shared", threads
    return "global", 128


def bwd_route_for(d, inner):
    """Where the backward kernel takes the (outer, d, inner) view:
    ("packed", per_block) where inner <= PACKED_BWD_INNER and the spans of
    y and dy of one outer index fit PACKED_BWD_SMEM: a block of 128 threads
    stages per_block whole outer indices, per_block * inner <= 128 columns
    a thread each, as many as fit, made a multiple of 4 / gcd(4, d * inner)
    where that leaves one, so that each block's span starts 16-byte aligned
    (its bulk copies); else ("staged", 0): a block per 128 columns of one
    outer index, the column in stages of 64 rows."""
    if d < 1:
        raise ValueError(f"entmax needs at least one entry on the "
                         f"normalized axis, got {d}")
    per_block = min(PACKED_THREADS // inner,
                    PACKED_BWD_SMEM // (8 * d * inner)) \
        if inner <= PACKED_BWD_INNER else 0
    step = 4 // math.gcd(4, d * inner)
    if per_block >= step:
        per_block -= per_block % step
    return ("packed", per_block) if per_block >= 1 else ("staged", 0)


def fwd_entry(alpha, route, solver="fastpow"):
    """(source, C entry, argument types) of the forward for a static alpha
    on a route (route_for), build.launch's first three arguments: a
    register bucket's entry of alpha's solver mode (FWD_ARGTYPES), the
    packed route's of that mode (PACKED_ARGTYPES), or the column entry of
    every mode (COLUMN_ARGTYPES)."""
    mode = mode_id(alpha, solver)
    if route[0] == "packed":
        return (*_PACKED_ENTRY.get(mode, ("entmax",
                                          "armnet_entmax_fwd_packed")),
                PACKED_ARGTYPES)
    if route[0] != "register":
        return ("entmax_fwd_column", "armnet_entmax_fwd_column",
                COLUMN_ARGTYPES)
    return (*_FWD_ENTRY.get(mode, ("entmax", "armnet_entmax_fwd")),
            FWD_ARGTYPES)


def fwd_args(x, y, alpha, outer, d, inner, route, n_iter=50,
             solver="fastpow"):
    """The forward entry's arguments for y = entmax of the (outer, d,
    inner) view of x on `route` (route_for: a register route's argument is
    its bucket, FWD_ARGTYPES; the packed route's its bucket and lanes,
    PACKED_ARGTYPES; the others' their threads and where the column lives,
    COLUMN_ARGTYPES), without the stream, which build.launch appends."""
    am1 = alpha - 1.0
    where, *place = route
    if where in ("shared", "global"):
        place = (place[0], int(where == "shared"))
    return (x.data_ptr(), y.data_ptr(), outer, d, inner, *place,
            mode_id(alpha, solver), bisect_steps(n_iter), am1, 1.0 / am1,
            (1.0 / d) ** am1)


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
    does not take. Counted in the ledger as armnet.kernel.entmax_fwd
    (build.launch)."""
    alpha = float(alpha)
    outer, d, inner = _view(x, alpha, axis, "entmax_kernel")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    route = route_for(d, inner, outer, alpha, solver)
    build.launch(*fwd_entry(alpha, route, solver), x.device,
                 *fwd_args(x, y, alpha, outer, d, inner, route, n_iter,
                           solver), call="entmax_fwd")
    return y


def entmax_bwd_kernel(y, dy, alpha, axis=-1):
    """The entmax VJP along `axis` from the output y and the cotangent dy,
    contiguous CUDA float32 tensors of one shape, on the current stream.
    Raises on what the kernel does not take. Counted in the ledger as
    armnet.kernel.entmax_bwd (build.launch)."""
    alpha = float(alpha)
    outer, d, inner = _view(y, alpha, axis, "entmax_bwd_kernel", dy)
    dx = torch.empty_like(y)
    if y.numel() == 0:
        return dx
    build.launch("entmax_bwd", "armnet_entmax_bwd", BWD_ARGTYPES, y.device,
                 y.data_ptr(), dy.data_ptr(), dx.data_ptr(), outer, d, inner,
                 bwd_route_for(d, inner)[1], g_mode_id(alpha), 2.0 - alpha,
                 call="entmax_bwd")
    return dx


def _blocks(source, entry, argtypes, *args):
    fn = build.function(source, entry,
                        argtypes + [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return n.value


def fwd_blocks_per_sm(d, inner, outer, alpha, solver="fastpow", route=None):
    """Blocks of the forward kernel on `route` (None: route_for's) that one
    SM of the current device holds at alpha (its registers and shared
    memory), as the occupancy calculator gives it; None on the column
    routes (d > 64), which report none."""
    route = route or route_for(d, inner, outer, alpha, solver)
    mode = mode_id(float(alpha), solver)
    if route[0] == "packed":
        source, entry = _PACKED_ENTRY.get(mode, ("entmax",
                                                 "armnet_entmax_fwd_packed"))
        return _blocks(source, entry + "_blocks_per_sm", [ctypes.c_int] * 5,
                       d, inner, *route[1:], mode)
    if route[0] == "register":
        source, entry = _FWD_ENTRY.get(mode, ("entmax", "armnet_entmax_fwd"))
        return _blocks(source, entry + "_blocks_per_sm", [ctypes.c_int] * 2,
                       route[1], mode)
    return None


def bwd_blocks_per_sm(d, alpha, inner, per_block=None):
    """Blocks of the backward kernel that one SM of the current device
    holds at d entries, alpha and inner (its registers and shared memory),
    as the occupancy calculator gives it, on its route (per_block as
    bwd_route_for gives it where None; 0 the staged route)."""
    if per_block is None:
        per_block = bwd_route_for(d, inner)[1]
    return _blocks("entmax_bwd", "armnet_entmax_bwd_blocks_per_sm",
                   [ctypes.c_int] * 4, d, inner, per_block,
                   g_mode_id(float(alpha)))
