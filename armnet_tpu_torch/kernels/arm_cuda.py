"""Wrappers of the fused ARM-1h CUDA kernels: the forward (csrc/arm1h.cu),
port of the Pallas `_fwd_call` -> `_fwd_kernel` (K5), and the recompute
backward (csrc/arm1h_bwd.cuh, built in arm1h_bwd.cu, arm1h_bwd_fastpow.cu
and arm1h_bwd_newton.cu for E and dk <= 16, arm1h_bwd_wide.cu and
arm1h_bwd_wide_powf.cu for wider rows), port of `_bwd_call` ->
`_bwd_kernel` (K6), of armnet_tpu/kernels/arm_pallas.py.

  arm1h_fwd_kernel / arm1h_fwd_plain   emb [B, F, E], wk [E, dk], q [O, dk],
                                       vt [F, O] -> exp-cross out [B, O, E]
  arm1h_bwd_kernel / arm1h_bwd_plain   the same and dout [B, O, E] ->
                                       (de, dwk, dq, dvt)

The plain versions are the math of the Pallas kernels (`_replay`,
`_fwd_kernel`, `_bwd_kernel`) in PyTorch, over the entmax solver and VJP
of kernels/entmax_common, so they take the entmax kernel's solver
branches and budgets. The kernel wrappers launch on CUDA tensors or raise;
nothing falls back to the plain versions. ops/interaction picks between
the two by the tensor's device.
"""

import ctypes

import torch

from armnet_tpu_torch.kernels import build
from armnet_tpu_torch.kernels.entmax_common import (bisect_steps,
                                                    entmax_bwd_axis0,
                                                    solve_entmax_axis0,
                                                    solver_mode)
from armnet_tpu_torch.kernels.entmax_cuda import g_mode_id, mode_id

__all__ = ["arm1h_fwd_kernel", "arm1h_fwd_plain", "arm1h_bwd_kernel",
           "arm1h_bwd_plain", "fwd_smem_bytes", "fwd_blocks_per_sm",
           "bwd_blocks_per_sm", "bwd_grid", "LAUNCHES", "BWD_LAUNCHES",
           "MAX_F"]

# kernel launches since the count was last set to 0 (the one place that
# adds to LAUNCHES is arm1h_fwd_kernel, to BWD_LAUNCHES arm1h_bwd_kernel,
# each right after a successful launch)
LAUNCHES = 0
BWD_LAUNCHES = 0
MAX_F = 40                 # largest register bucket of the kernels
NARROW_ED = 16             # E and dk of K6's narrow builds (csrc kMaxED)
SMEM_BYTES = 232_448       # shared memory a block can use on Hopper


def _gates(emb, wk, q):
    """(keys [B, F, dk], gates [B, F, O]), each summed product by product
    in index order, as csrc/arm1h.cuh sums them, so that the kernels solve
    the same gates bit for bit: at alpha > 2 the solver's Newton budget
    leaves rare columns unconverged, and there one ulp of a gate moves y
    by up to ~1e-2."""
    keys = emb[..., 0, None] * wk[0]
    for e in range(1, wk.shape[0]):
        keys = keys + emb[..., e, None] * wk[e]
    g = keys[..., 0, None] * q[:, 0]
    for d in range(1, q.shape[1]):
        g = g + keys[..., d, None] * q[:, d]
    return keys, g * (q.shape[-1] ** -0.5)


def _replay(emb, wk, q, vt, alpha, n_iter):
    """(keys, y, w): the shared forward chain, gates and entmax over F."""
    keys, g = _gates(emb, wk, q)
    y = solve_entmax_axis0(g.movedim(1, 0), alpha, n_iter).movedim(0, 1)
    return keys, y, y * vt[None]


def arm1h_fwd_plain(emb, wk, q, vt, alpha, n_iter=50):
    """Plain PyTorch fused forward (any device): exp(w^T emb) [B, O, E]."""
    _, _, w = _replay(emb, wk, q, vt, alpha, n_iter)
    return torch.exp(torch.einsum("bfo,bfe->boe", w, emb))


def arm1h_bwd_plain(emb, wk, q, vt, dout, alpha, n_iter=50):
    """Plain PyTorch recompute backward (any device): (de [B, F, E],
    dwk [E, dk], dq [O, dk], dvt [F, O]), the weights' gradients summed
    over the batch."""
    keys, y, w = _replay(emb, wk, q, vt, alpha, n_iter)
    scale = q.shape[-1] ** -0.5
    dz = dout * torch.exp(torch.einsum("bfo,bfe->boe", w, emb))
    dw = torch.einsum("boe,bfe->bfo", dz, emb)
    dg = entmax_bwd_axis0(y.movedim(1, 0), (dw * vt[None]).movedim(1, 0),
                          alpha).movedim(0, 1)
    dkeys = torch.einsum("bfo,od->bfd", dg, q) * scale
    de = (torch.einsum("boe,bfo->bfe", dz, w)
          + torch.einsum("bfd,ed->bfe", dkeys, wk))
    dwk = torch.einsum("bfe,bfd->ed", emb, dkeys)
    dq = torch.einsum("bfo,bfd->od", dg, keys) * scale
    return de, dwk, dq, (dw * y).sum(0)


def _check(who, emb, wk, q, vt, alpha, dout=None):
    """Checks shared by both kernels; returns (B, F, E, dk, O)."""
    tensors = (emb, wk, q, vt) + (() if dout is None else (dout,))
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{who} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who} needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who} needs contiguous tensors")
        if t.device != emb.device:
            raise ValueError(f"{who} needs its tensors on one device")
    if emb.ndim != 3 or wk.ndim != 2 or q.ndim != 2:
        raise ValueError(f"{who}: emb [B, F, E], wk [E, dk], q [O, dk]; got "
                         f"{tuple(emb.shape)}, {tuple(wk.shape)}, "
                         f"{tuple(q.shape)}")
    b, f, e = emb.shape
    o, dk = q.shape
    if (wk.shape != (e, dk) or vt.shape != (f, o)
            or (dout is not None and dout.shape != (b, o, e))):
        raise ValueError(
            f"{who}: shapes do not fit: emb {tuple(emb.shape)}, wk "
            f"{tuple(wk.shape)}, q {tuple(q.shape)}, vt {tuple(vt.shape)}"
            + ("" if dout is None else f", dout {tuple(dout.shape)}"))
    if not alpha > 1.0:
        raise ValueError(f"{who} needs alpha > 1 (softmax at 1)")
    if not 1 <= f <= MAX_F:
        raise ValueError(f"{who} takes 1 to {MAX_F} fields, got {f}")
    if min(e, dk, o) < 1 or b >= 2 ** 31:
        raise ValueError(f"{who}: empty or oversized dimension in "
                         f"{(b, f, e, dk, o)}")
    return b, f, e, dk, o


def _pad4(n):
    return -(-n // 4) * 4


def fwd_smem_bytes(f, e, dk, o):
    """Shared memory of a K5 block (csrc/arm1h.cu fwd_smem): emb and keys
    with rows padded to 4 floats, and the row's outputs [O, E]."""
    return 4 * (f * _pad4(e) + f * _pad4(dk) + o * e)


def _smem_check(who, nbytes):
    if nbytes > SMEM_BYTES:
        raise ValueError(f"{who} needs {nbytes} bytes of shared memory "
                         f"at these shapes, more than {SMEM_BYTES}")


def _solver_args(alpha, f, n_iter):
    """(mode, n_iter, scale-free solver constants) as the kernels take
    them: alpha-1, 1/(alpha-1), (1/F)^(alpha-1)."""
    am1 = alpha - 1.0
    return (mode_id(alpha), bisect_steps(n_iter), am1, 1.0 / am1,
            (1.0 / f) ** am1)


def _blocks_per_sm(source, entry, args):
    """Blocks of a kernel that one SM holds, from the C entry's occupancy
    query (built at first use)."""
    fn = build.function(source, entry, [ctypes.c_int] * len(args)
                        + [ctypes.POINTER(ctypes.c_int)])
    n = ctypes.c_int(0)
    err = fn(*args, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err}")
    return n.value


def _bwd_source(alpha, e, dk):
    """K6's library, the sources built apart so that nvcc builds them in
    parallel: arm1h_bwd (the bisection modes), arm1h_bwd_fastpow or
    arm1h_bwd_newton for E and dk <= NARROW_ED; arm1h_bwd_wide (the
    bisection modes) or arm1h_bwd_wide_powf for wider rows."""
    mode = solver_mode(alpha)
    if max(e, dk) > NARROW_ED:
        return "arm1h_bwd_wide" + ("" if mode == "bisect" else "_powf")
    return "arm1h_bwd" if mode == "bisect" else f"arm1h_bwd_{mode}"


def fwd_blocks_per_sm(f, e, dk, o, alpha):
    """Blocks of K5 that one SM holds at these shapes and alpha."""
    return _blocks_per_sm("arm1h", "armnet_arm1h_fwd_blocks_per_sm",
                          (f, e, dk, o, mode_id(float(alpha))))


def bwd_blocks_per_sm(f, e, dk, o, alpha):
    """Blocks of K6 that one SM of the current device holds at these shapes
    and alpha; 0 where E and dk are too wide for a block's shared memory
    (csrc/arm1h_bwd.cuh bwd_groups)."""
    alpha = float(alpha)
    return _blocks_per_sm(_bwd_source(alpha, e, dk),
                          "armnet_arm1h_bwd_blocks_per_sm",
                          (f, e, dk, o, mode_id(alpha), g_mode_id(alpha)))


_BWD_GRID = {}      # (device index, F, E, dk, O, mode) -> blocks filling it


def bwd_grid(b, f, e, dk, o, alpha, device):
    """K6's persistent grid on `device`: the blocks its SMs hold at once
    (bwd_blocks_per_sm), at most one per row. Raises where E and dk are
    too wide for a block's shared memory."""
    key = (device.index, f, e, dk, o, mode_id(float(alpha)))
    if key not in _BWD_GRID:
        with torch.cuda.device(device):
            per_sm = bwd_blocks_per_sm(f, e, dk, o, alpha)
        if per_sm < 1:
            raise ValueError(
                f"arm1h_bwd_kernel: E={e}, dk={dk} at F={f} need more "
                f"shared memory than a block has")
        _BWD_GRID[key] = per_sm * \
            torch.cuda.get_device_properties(device).multi_processor_count
    return min(b, _BWD_GRID[key])


def arm1h_fwd_kernel(emb, wk, q, vt, alpha, n_iter=50):
    """The fused ARM-1h forward on the card, on the current stream:
    contiguous CUDA float32 emb [B, F, E], wk [E, dk], q [O, dk],
    vt [F, O] -> [B, O, E]. Raises on what the kernel does not take."""
    global LAUNCHES
    alpha = float(alpha)
    b, f, e, dk, o = _check("arm1h_fwd_kernel", emb, wk, q, vt, alpha)
    _smem_check("arm1h_fwd_kernel", fwd_smem_bytes(f, e, dk, o))
    out = torch.empty((b, o, e), dtype=torch.float32, device=emb.device)
    if b == 0:
        return out
    mode, steps, am1, inv_am1, c_hi = _solver_args(alpha, f, n_iter)
    fn = build.function(
        "arm1h", "armnet_arm1h_fwd",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    with torch.cuda.device(emb.device):
        err = fn(emb.data_ptr(), wk.data_ptr(), q.data_ptr(), vt.data_ptr(),
                 out.data_ptr(), b, f, e, dk, o, mode, steps, dk ** -0.5,
                 am1, inv_am1, c_hi, build.raw_stream(emb.device))
    if err != 0:
        raise RuntimeError(f"arm1h forward kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES += 1
    return out


def arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha, n_iter=50):
    """The fused ARM-1h recompute backward on the card, on the current
    stream: the forward's inputs and dout [B, O, E] -> (de [B, F, E],
    dwk [E, dk], dq [O, dk], dvt [F, O]). The batch sums are deterministic:
    a persistent grid (bwd_grid) whose blocks each sum their rows, the
    blocks' sums then added in block order. Raises on what the kernel does
    not take."""
    global BWD_LAUNCHES
    alpha = float(alpha)
    b, f, e, dk, o = _check("arm1h_bwd_kernel", emb, wk, q, vt, alpha, dout)
    dev = emb.device
    de = torch.empty((b, f, e), dtype=torch.float32, device=dev)
    sizes = (e * dk, o * dk, f * o)
    # the kernels write every element; no rows leave the sums 0
    grads = (torch.empty if b else torch.zeros)(sum(sizes),
                                                dtype=torch.float32,
                                                device=dev)
    dwk, dq, dvt = (g.view(shape) for g, shape in zip(
        grads.split(sizes), ((e, dk), (o, dk), (f, o))))
    if b == 0:
        return de, dwk, dq, dvt
    blocks = bwd_grid(b, f, e, dk, o, alpha, dev)
    partial = torch.empty((blocks, sum(sizes)), dtype=torch.float32,
                          device=dev)
    mode, steps, am1, inv_am1, c_hi = _solver_args(alpha, f, n_iter)
    fn = build.function(
        _bwd_source(alpha, e, dk), "armnet_arm1h_bwd",
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
        + [ctypes.c_float] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        err = fn(emb.data_ptr(), dout.data_ptr(), wk.data_ptr(),
                 q.data_ptr(), vt.data_ptr(), de.data_ptr(),
                 partial.data_ptr(), grads.data_ptr(), b, f, e, dk, o,
                 blocks, mode, g_mode_id(alpha), steps, dk ** -0.5, am1,
                 inv_am1, c_hi, 2.0 - alpha, build.raw_stream(dev))
    if err != 0:
        raise RuntimeError(f"arm1h backward kernel launch failed: cudaError "
                           f"{err}")
    BWD_LAUNCHES += 1
    return de, dwk, dq, dvt
