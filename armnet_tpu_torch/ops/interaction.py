"""ARM-1h interaction (port of the fields-major path of
armnet_tpu/ops/interaction.py and of armnet_tpu/kernels/arm_pallas.py).

  gates   = <emb @ wk, query> * d_k^-0.5        [B, F, O]
  sparse  = entmax_alpha(gates) over fields      (axis 1)
  weight  = sparse * values^T                    (signed exponents)
  out     = exp(sum_f weight[:, f, :] x emb[:, f, :])   [B, O, E]

Two paths compute it. The composed one (kernels 'auto' or 'pallas') runs
GEMMs, the entmax kernel, an einsum and exp. The fused one
('pallas-fused', a static alpha > 1) runs the whole chain as one kernel,
and its backward as one recompute kernel (kernels/arm_cuda.py); a CUDA
tensor launches them, a CPU tensor takes their plain versions.

Weights keep the JAX layout (wk [E, dk], query [O, dk], values [O, F]) so
these functions take the same arguments as their JAX counterparts.
"""

import torch

from armnet_tpu_torch.kernels import arm_cuda
from armnet_tpu_torch.kernels.config import use_fused_arm
from armnet_tpu_torch.ops.entmax import pick, sparse_normalizer

__all__ = ["arm1h_interaction", "arm1h_fused", "arm_exp_cross_fmajor"]


def arm1h_interaction(emb, wk, query, values, alpha, n_iter=50,
                      kernels="auto"):
    """emb [B, F, E] -> exponential neurons [B, O, E]; `kernels` is the
    ExperimentConfig choice ('pallas-fused' takes the fused kernels)."""
    if (use_fused_arm(kernels) and isinstance(alpha, (int, float))
            and float(alpha) > 1.0):
        return arm1h_fused(emb, wk, query, values, alpha, n_iter)
    keys = torch.matmul(emb, wk)                               # [B, F, dk]
    d_k = query.shape[-1]
    gates = torch.matmul(keys, query.t()) * (d_k ** -0.5)      # [B, F, O]
    sparse = sparse_normalizer(alpha, axis=1, n_iter=n_iter)(gates)
    return arm_exp_cross_fmajor(emb, sparse * values.t()[None])


def arm_exp_cross_fmajor(emb, weight):
    """emb [B, F, E], weight [B, F, C] -> exp(sum_f w * e) [B, C, E]."""
    return torch.exp(torch.einsum("bfe,bfc->bce", emb, weight))


class _ARM1hFused(torch.autograd.Function):
    """The fused forward; the backward recomputes it from the inputs, so
    only (emb, wk, query, vt) are kept, as the JAX custom VJP keeps them."""

    @staticmethod
    def forward(ctx, emb, wk, query, vt, alpha, n_iter):
        out = pick(emb.device, arm_cuda.arm1h_fwd_kernel,
                   arm_cuda.arm1h_fwd_plain, "arm1h_fused")(
            emb, wk, query, vt, alpha, n_iter)
        ctx.save_for_backward(emb, wk, query, vt)
        ctx.alpha, ctx.n_iter = alpha, n_iter
        return out

    @staticmethod
    def backward(ctx, dout):
        emb, wk, query, vt = ctx.saved_tensors
        grads = pick(emb.device, arm_cuda.arm1h_bwd_kernel,
                     arm_cuda.arm1h_bwd_plain, "arm1h_fused")(
            emb, wk, query, vt, dout.float().contiguous(), ctx.alpha,
            ctx.n_iter)
        return (*grads, None, None)


def arm1h_fused(emb, wk, query, values, alpha, n_iter=50):
    """Fused ARM-1h interaction: emb [B, F, E], wk [E, dk], query [O, dk],
    values [O, F] -> exp-cross output [B, O, E], computed in float32 and
    returned in emb's dtype. alpha must be a static python float > 1."""
    alpha = float(alpha)
    if alpha <= 1.0:
        raise ValueError("arm1h_fused requires alpha > 1 (softmax path is "
                         "handled by the composed interaction)")
    out = _ARM1hFused.apply(
        emb.float().contiguous(), wk.float().contiguous(),
        query.float().contiguous(), values.float().t().contiguous(), alpha,
        int(n_iter))
    return out.to(emb.dtype)
