"""alpha-entmax over one axis (port of the static-alpha path of
armnet_tpu/ops/entmax.py).

entmax with alpha in (1, 2] interpolates between softmax (alpha -> 1) and
sparsemax (alpha = 2): it zeroes most of the field axis, so each exponential
neuron models a cross-feature over an adaptively selected field subset.

A static python alpha > 1 dispatches by the tensor's device, forward and
backward alike: a CUDA tensor launches the CUDA kernel
(kernels/entmax_cuda.entmax_kernel, entmax_bwd_kernel) or raises, a CPU
tensor takes the plain PyTorch version (entmax_plain, entmax_bwd_plain).
The backward is a torch.autograd.Function that keeps only the output y, as
the JAX custom VJP does. The solve runs in float32. Not ported yet
(ROADMAP.md): a learned (tensor) alpha.
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


def entmax_bisect(x, alpha=1.5, axis=-1, n_iter=50):
    """alpha-entmax along `axis`, differentiable in x; `n_iter` is capped at
    the f32 convergence limit of 30 bisections, as the JAX kernels cap it."""
    if isinstance(alpha, torch.Tensor) or not isinstance(alpha, (int, float)):
        raise NotImplementedError(
            "entmax with a tensor (learned) alpha is not ported yet; see "
            "ROADMAP.md")
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
