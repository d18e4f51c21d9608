"""One CIN layer (xDeepFM's compressed interaction) on the card: the fused
forward and backward of csrc/cin.cu (K8, new in the port: the JAX package
computes the layer as XLA ops and has no Pallas kernel for it), and their
plain PyTorch versions.

Every tensor is in the E-before-channels layout, rows m = (b, e):

  cin_fwd / cin_fwd_plain   x0t [B, E, F], xkt [B, E, C], w [F*C, N] ->
                            out [B, E, N] = relu(sum_{f,c} x0t[..., f]
                            xkt[..., c] w[f*C + c])
  cin_bwd / cin_bwd_plain   the same, out and dout [B, E, N] ->
                            (dx0t [B, E, F], dxkt [B, E, C], dw [F*C, N])

The kernels form the outer product x0 * xk tile by tile on chip; the plain
versions materialise it for the rows they are given ([rows * E, F * C]),
so ops/interaction calls them over row blocks (the blocked route). The
plain versions follow the inputs' dtypes (a bfloat16 product of bfloat16
inputs, the GEMM in the promoted dtype, as jnp's einsum promotes) and the
float32 matmul precision; the kernels take contiguous float32 CUDA tensors
and compute in full float32, or raise. Nothing falls back.
"""

import ctypes

import torch

from armnet_tpu_torch.kernels import build

__all__ = ["cin_fwd", "cin_bwd", "cin_fwd_plain", "cin_bwd_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _promoted(*tensors):
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def _outer(x0t, xkt):
    """h [rows * E, F * C], h[(b, e), f*C + c] = x0t[b, e, f] xkt[b, e, c]."""
    f, c = x0t.shape[-1], xkt.shape[-1]
    return (x0t[..., :, None] * xkt[..., None, :]).reshape(-1, f * c)


def cin_fwd_plain(x0t, xkt, w):
    """Plain forward (any device): out [B, E, N]."""
    out = torch.relu(torch.matmul(*_promoted(_outer(x0t, xkt), w)))
    return out.view(*x0t.shape[:-1], w.shape[1])


def cin_bwd_plain(x0t, xkt, w, out, dout):
    """Plain backward (any device): (dx0t, dxkt, dw), each in the dtype of
    its input."""
    f, c, n = x0t.shape[-1], xkt.shape[-1], w.shape[1]
    h = _outer(x0t, xkt)
    g = torch.where(out > 0, dout, torch.zeros_like(dout)).reshape(-1, n)
    hp, gp, wp = _promoted(h, g, w)
    dw = torch.matmul(hp.t(), gp).to(w.dtype)
    dh = torch.matmul(gp, wp.t()).to(h.dtype).view(*x0t.shape[:-1], f, c)
    dxk = (dh * x0t[..., :, None].to(h.dtype)).sum(-2).to(xkt.dtype)
    dx0 = (dh * xkt[..., None, :].to(h.dtype)).sum(-1).to(x0t.dtype)
    return dx0, dxk, dw


def _sizes(who, x0t, xkt, w, *more):
    """(M, F, C, N) of contiguous float32 CUDA operands that fit each
    other; raises on anything else."""
    for t in (x0t, xkt, w, *more):
        if not t.is_cuda:
            raise ValueError(f"{who} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who} needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who} needs contiguous tensors")
    f, c = x0t.shape[-1], xkt.shape[-1]
    if (x0t.ndim != 3 or xkt.shape[:-1] != x0t.shape[:-1] or w.ndim != 2
            or w.shape[0] != f * c):
        raise ValueError(f"{who}: x0t {tuple(x0t.shape)}, xkt "
                         f"{tuple(xkt.shape)} and w {tuple(w.shape)} do not "
                         f"fit")
    n = w.shape[1]
    for t in more:
        if t.shape != (*x0t.shape[:-1], n):
            raise ValueError(f"{who}: {tuple(t.shape)} is not "
                             f"{(*x0t.shape[:-1], n)}")
    m = x0t.shape[0] * x0t.shape[1]
    if m * max(f, c, n) >= 2 ** 31 or f * c * n >= 2 ** 31:
        raise ValueError(f"{who} takes fewer than 2^31 entries an operand")
    return m, f, c, n


def cin_fwd(x0t, xkt, w):
    """The fused forward on the card: out [B, E, N] float32. Counted in the
    ledger as armnet.kernel.cin_fwd (build.launch)."""
    m, f, c, n = _sizes("cin_fwd", x0t, xkt, w)
    out = torch.empty((*x0t.shape[:-1], n), dtype=torch.float32,
                      device=x0t.device)
    build.launch("cin", "armnet_cin_fwd", [_P, _P, _P, _P, _I, _I, _I, _I, _P],
                 x0t.device, x0t.data_ptr(), xkt.data_ptr(), w.data_ptr(),
                 out.data_ptr(), m, f, c, n, call="cin_fwd")
    return out


def cin_bwd(x0t, xkt, w, out, dout):
    """The fused backward on the card: (dx0t, dxkt, dw) float32; one call
    in the ledger (armnet.kernel.cin_bwd), whatever kernels it launches
    (the mask, dx, dW and the ordered sums where it cuts them)."""
    m, f, c, n = _sizes("cin_bwd", x0t, xkt, w, out, dout)
    dev = x0t.device
    dx0 = torch.empty_like(x0t)
    dxk = torch.empty_like(xkt)
    dw = torch.empty_like(w)
    nbytes = build.function("cin", "armnet_cin_bwd_scratch", [_I] * 4,
                            ctypes.c_longlong)(m, f, c, n)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    build.launch("cin", "armnet_cin_bwd",
                 [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
                 dev, x0t.data_ptr(), xkt.data_ptr(), w.data_ptr(),
                 out.data_ptr(), dout.data_ptr(), dx0.data_ptr(),
                 dxk.data_ptr(), dw.data_ptr(), scratch.data_ptr(), m, f, c, n,
                 call="cin_bwd")
    return dx0, dxk, dw
