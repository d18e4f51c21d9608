"""alpha-entmax over one axis (port of armnet_tpu/ops/entmax.py).

entmax with alpha in (1, 2] interpolates between softmax (alpha -> 1) and
sparsemax (alpha = 2): it zeroes most of the field axis, so each exponential
neuron models a cross-feature over an adaptively selected field subset.

A static python alpha > 1 dispatches by the tensor's device, forward and
backward alike: a CUDA tensor launches the CUDA kernel
(kernels/entmax_cuda.entmax_kernel, entmax_bwd_kernel) or raises, a CPU
tensor takes the plain PyTorch version (entmax_plain, entmax_bwd_plain).
The backward is a torch.autograd.Function that keeps only the output y, as
the JAX custom VJP does. The solve runs in float32.

A tensor (learned) alpha takes the generic path on every device: the
bisection and the closed-form VJP in torch ops, differentiable in x and in
alpha (the Shannon and Tsallis terms), as the JAX package runs that path in
plain XLA ops on every backend; it has no kernel there or here.
"""

import torch

from armnet_tpu_torch.kernels import entmax_cuda

__all__ = ["entmax_bisect", "sparse_normalizer", "pick"]


def pick(device, kernel, plain, who="entmax"):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"{who} has no path for device {device}")


class _Entmax(torch.autograd.Function):
    """y = entmax(x); dx from y and dy alone."""

    @staticmethod
    def forward(ctx, x, alpha, axis, n_iter):
        y = pick(x.device, entmax_cuda.entmax_kernel,
                 entmax_cuda.entmax_plain)(x, alpha, axis, n_iter)
        ctx.save_for_backward(y)
        ctx.alpha, ctx.axis = alpha, axis
        return y

    @staticmethod
    def backward(ctx, dy):
        (y,) = ctx.saved_tensors
        dx = pick(y.device, entmax_cuda.entmax_bwd_kernel,
                  entmax_cuda.entmax_bwd_plain)(
            y, dy.float().contiguous(), ctx.alpha, ctx.axis)
        return dx, None, None, None


def _p(z, inv_am1):
    """clamp(z, 0) ** (1 / (alpha - 1)), the inverse generating function."""
    return torch.clamp_min(z, 0.0).pow(inv_am1)


def entmax_alpha_forward(x, alpha, n_iter):
    """The generic bisection over the last axis of x (float32) with a tensor
    alpha broadcastable to x[..., :1] (armnet_tpu/ops/entmax.py
    _entmax_forward, iteration for iteration)."""
    am1 = alpha - 1.0
    inv_am1 = 1.0 / am1
    xs = x * am1
    max_val = xs.amax(-1, keepdim=True)
    tau_lo = max_val - 1.0
    tau_hi = max_val - torch.full_like(am1, 1.0 / x.shape[-1]).pow(am1)
    f_lo = _p(xs - tau_lo, inv_am1).sum(-1, keepdim=True) - 1.0
    dm = tau_hi - tau_lo
    tau_m = tau_lo
    for _ in range(n_iter):
        dm = dm * 0.5
        tau_m = tau_lo + dm
        f_m = _p(xs - tau_m, inv_am1).sum(-1, keepdim=True) - 1.0
        tau_lo = torch.where(f_m * f_lo >= 0, tau_m, tau_lo)
    p = _p(xs - tau_m, inv_am1)
    return p / p.sum(-1, keepdim=True)


def entmax_alpha_backward(y, alpha, dy):
    """(dx, dalpha) of y = entmax(x, alpha) over the last axis: dalpha from
    the Shannon and Tsallis terms (arXiv:1905.05702 eq. 14), summed to
    alpha's shape (armnet_tpu/ops/entmax.py _entmax_core_bwd)."""
    am1 = alpha - 1.0
    on = y > 0
    tiny = torch.clamp_min(y, 1e-38)
    gppr = torch.where(on, tiny.pow(1.0 - am1), 0.0)
    gsum = gppr.sum(-1, keepdim=True)
    dx = dy * gppr
    dx = dx - (dx.sum(-1, keepdim=True) / gsum) * gppr
    s = torch.where(on, y * torch.log(tiny), 0.0)
    ent = s.sum(-1, keepdim=True)
    y_skewed = gppr / gsum
    da = dy * (y - y_skewed) / am1.square() - dy * (s - y_skewed * ent) / am1
    return dx, da.sum(-1, keepdim=True).sum_to_size(alpha.shape)


class _EntmaxAlpha(torch.autograd.Function):
    """y = entmax(x, alpha) with a tensor alpha; (dx, dalpha) from y, alpha
    and dy alone."""

    @staticmethod
    def forward(ctx, x, alpha, n_iter):
        y = entmax_alpha_forward(x, alpha, n_iter)
        ctx.save_for_backward(y, alpha)
        return y

    @staticmethod
    def backward(ctx, dy):
        y, alpha = ctx.saved_tensors
        dx, da = entmax_alpha_backward(y, alpha, dy.float())
        return dx, (da if ctx.needs_input_grad[1] else None), None


def entmax_bisect(x, alpha=1.5, axis=-1, n_iter=50):
    """alpha-entmax along `axis`, differentiable in x, and in alpha where it
    is a tensor. A static alpha must be > 1, and `n_iter` is then capped at
    the f32 convergence limit of 30 bisections, as the JAX kernels cap it;
    a tensor alpha (broadcastable to x with `axis` collapsed to 1) runs the
    generic path for `n_iter` bisections. The solve runs in float32 and y
    takes x's dtype."""
    if not isinstance(alpha, (int, float)):
        alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
        last = axis in (-1, x.ndim - 1)
        if alpha.ndim == x.ndim and not last:
            alpha = alpha.movedim(axis, -1)
        xf = x.float()
        y = _EntmaxAlpha.apply(xf if last else xf.movedim(axis, -1), alpha,
                               n_iter)
        return (y if last else y.movedim(-1, axis)).to(x.dtype)
    alpha = float(alpha)
    if alpha <= 1.0:
        raise ValueError("entmax_bisect needs alpha > 1 (use softmax at 1)")
    y = _Entmax.apply(x.float().contiguous(), alpha, axis, n_iter)
    return y.to(x.dtype)


def sparse_normalizer(alpha, axis=-1, n_iter=50):
    """The field-axis normalizer of the ARM layers: softmax at alpha == 1,
    entmax otherwise."""
    if alpha == 1.0:
        return lambda x: torch.softmax(x, dim=axis)
    return lambda x: entmax_bisect(x, alpha=alpha, axis=axis, n_iter=n_iter)
