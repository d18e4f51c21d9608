"""Feature interactions (port of the fields-major ARM paths and the zoo's
interactions of armnet_tpu/ops/interaction.py, and of
armnet_tpu/kernels/arm_pallas.py).

Zoo interactions, plain PyTorch as in the JAX package (no Pallas kernel
there): `anova_kernel` (HOFM), `cross_layer` (DCN); and
`compressed_interaction_step` (CIN / xDeepFM), which takes one of two
routes by what the call can observe:

  fused    CUDA, float32 activations and filter, full float32 GEMMs
           (matmul precision 'highest', no TF32): the kernel pair of
           kernels/cin_cuda.py (csrc/cin.cu), which forms the outer product
           x0 * xk tile by tile on chip, and recomputes it in the backward
  blocked  everywhere else (the CPU, the TF32 and bfloat16 paths): the
           plain version over row blocks, each block's outer product
           [rows * E, F * C] formed, multiplied and dropped, no block's
           above CIN_BLOCK_BYTES; the backward recomputes it block by
           block. It follows the activations' dtype and the matmul
           precision.

Neither keeps a whole outer product: at 65,536 rows, 39 fields and 200
maps it is 20.4 GB a layer. Both run inside the spans armnet.cin.forward
and armnet.cin.backward (the layer index as their id) and count their
calls (armnet.cin.fused, armnet.cin.blocked) and the blocked route's
blocks (armnet.cin.blocks) through utils/tracing.

ARM-1h:

  gates   = <emb @ wk, query> * d_k^-0.5        [B, F, O]
  sparse  = entmax_alpha(gates) over fields      (axis 1)
  weight  = sparse * values^T                    (signed exponents)
  out     = exp(sum_f weight[:, f, :] x emb[:, f, :])   [B, O, E]

Two paths compute it. The composed one (kernels 'auto' or 'pallas') runs
GEMMs, the entmax kernel, an einsum and exp. The fused one
('pallas-fused', a static alpha > 1) runs the whole chain as one kernel,
and its backward as one recompute kernel (kernels/arm_cuda.py); a CUDA
tensor launches them, a CPU tensor takes their plain versions.

Multi-head ARM (`arm_attention_multihead`, and GC-ARM's gates through
`mh_gate_proj`) folds each head's bilinear and query into one [K*O, E]
projection, so the gates come out as [B, F, K*O] with the channel
k*O + o (k-major) and the entmax over fields (axis 1) runs on them as on
ARM-1h's [B, F, O]; `kernels` never changes that path.

Under --bf16 (a bfloat16 emb) the products land on the JAX functions'
dtypes: wk is cast to emb's dtype, as the JAX chain casts it, and every
other product of an activation and a float32 parameter promotes to float32
(ops.layers.promoted), as jnp.einsum does; the fused path computes in
float32 and returns emb's dtype.

Weights keep the JAX layout (wk [E, dk], query [O, dk], values [O, F];
bilinear_w [K, E, dk], query [K, O, dk], values [K, O, F]) so these
functions take the same arguments as their JAX counterparts.
"""

import torch

from armnet_tpu_torch.kernels import arm_cuda, cin_cuda
from armnet_tpu_torch.kernels.config import use_fused_arm
from armnet_tpu_torch.ops.entmax import pick, sparse_normalizer
from armnet_tpu_torch.ops.layers import promoted
from armnet_tpu_torch.utils.tracing import count, span

__all__ = ["arm1h_interaction", "arm1h_fused", "arm_exp_cross_fmajor",
           "mh_gate_proj", "arm_attention_multihead", "anova_kernel",
           "cross_layer", "compressed_interaction_step", "cin_route",
           "CIN_BLOCK_BYTES"]

# the blocked route's budget for one block's outer product
CIN_BLOCK_BYTES = 1 << 28


def arm1h_interaction(emb, wk, query, values, alpha, n_iter=50,
                      kernels="auto"):
    """emb [B, F, E] -> exponential neurons [B, O, E]; `kernels` is the
    ExperimentConfig choice ('pallas-fused' takes the fused kernels)."""
    if (use_fused_arm(kernels) and isinstance(alpha, (int, float))
            and float(alpha) > 1.0):
        return arm1h_fused(emb, wk, query, values, alpha, n_iter)
    keys = torch.matmul(emb, wk.to(emb.dtype))                 # [B, F, dk]
    d_k = query.shape[-1]
    gates = torch.matmul(*promoted(keys, query.t())) * (d_k ** -0.5)
    sparse = sparse_normalizer(alpha, axis=1, n_iter=n_iter)(gates)
    return arm_exp_cross_fmajor(emb, sparse * values.t()[None])


def mh_gate_proj(bilinear_w, query):
    """bilinear_w [K, E, dk], query [K, O, dk] -> the gate projection
    [K*O, E]: m[k, o, x] = sum_y bilinear_w[k, x, y] * query[k, o, y]."""
    nhead, nemb, _ = bilinear_w.shape
    m = torch.einsum("kxy,koy->kox", bilinear_w, query)
    return m.reshape(nhead * query.shape[1], nemb)


def arm_attention_multihead(emb, bilinear_w, query, values, normalizer):
    """Multi-head sparse field weights [B, F, K*O]: gates emb @ m^T scaled
    by d_k^-0.5, `normalizer` over fields (axis 1), times values [K, O, F]
    as [F, K*O]."""
    d_k = bilinear_w.shape[-1]
    m = mh_gate_proj(bilinear_w, query)
    gates = torch.matmul(*promoted(emb, m.t())) * (d_k ** -0.5)  # [B,F,KO]
    nhead, nhid, nfield = values.shape
    return normalizer(gates) * values.reshape(nhead * nhid, nfield).t()[None]


def arm_exp_cross_fmajor(emb, weight):
    """emb [B, F, E], weight [B, F, C] -> exp(sum_f w * e) [B, C, E]."""
    return torch.exp(torch.einsum("bfe,bfc->bce", *promoted(emb, weight)))


def anova_kernel(x, order):
    """The order-`order` ANOVA kernel of x [B, F, E] -> [B], by the cumsum
    dynamic program over fields: after step t, a[:, j] sums every t-way
    product of the fields before j (the reference HOFM's recurrence)."""
    bsz, _, nemb = x.shape
    a = torch.ones((bsz, x.shape[1] + 1, nemb), dtype=x.dtype,
                   device=x.device)
    for t in range(order):
        upd = x[:, t:, :] * a[:, t:-1, :]
        a = torch.cumsum(torch.cat([x.new_zeros((bsz, t + 1, nemb)), upd],
                                   dim=1), dim=1)
    return a[:, -1, :].sum(-1)


def cross_layer(x0, x, w, b):
    """One DCN cross layer: x0 * (x @ w) + b + x, w [in, 1], b [in]."""
    return x0 * torch.matmul(*promoted(x, w)) + b + x


def cin_route(x0, xk, filt):
    """'fused' where the kernels apply (CUDA, float32 operands, full float32
    GEMMs), else 'blocked'."""
    if (x0.is_cuda and x0.dtype == xk.dtype == filt.dtype == torch.float32
            and torch.get_float32_matmul_precision() == "highest"
            and not torch.backends.cuda.matmul.allow_tf32):
        return "fused"
    return "blocked"


def _block_rows(x0, xk):
    """Rows a block of the blocked route takes: its outer product within
    CIN_BLOCK_BYTES."""
    f, e, c = x0.shape[1], x0.shape[2], xk.shape[1]
    size = torch.promote_types(x0.dtype, xk.dtype).itemsize
    return max(1, CIN_BLOCK_BYTES // (f * c * e * size))


class _CINFused(torch.autograd.Function):
    """The kernels on x0t [B, E, F], xkt [B, E, C] (made contiguous: a copy
    of x0t, none of a previous layer's output) -> out [B, E, N]."""

    @staticmethod
    def forward(ctx, x0t, xkt, filt, layer):
        with span("armnet.cin.forward", layer=layer):
            x0t, xkt = x0t.contiguous(), xkt.contiguous()
            filt = filt.contiguous()
            out = cin_cuda.cin_fwd(x0t, xkt, filt)
        ctx.save_for_backward(x0t, xkt, filt, out)
        ctx.layer = layer
        return out

    @staticmethod
    def backward(ctx, dout):
        x0t, xkt, filt, out = ctx.saved_tensors
        with span("armnet.cin.backward", layer=ctx.layer):
            grads = cin_cuda.cin_bwd(x0t, xkt, filt, out,
                                     dout.float().contiguous())
        return (*grads, None)


class _CINBlocked(torch.autograd.Function):
    """The plain version over blocks of `rows` rows of x0t [B, E, F] and
    xkt [B, E, C] -> out [B, E, N]; the backward recomputes each block's
    outer product and sums the filter's gradient block after block."""

    @staticmethod
    def forward(ctx, x0t, xkt, filt, rows, layer):
        b = x0t.shape[0]
        with span("armnet.cin.forward", layer=layer):
            parts = [cin_cuda.cin_fwd_plain(x0t[s:s + rows], xkt[s:s + rows],
                                            filt)
                     for s in range(0, b, rows)]
            out = parts[0] if len(parts) == 1 else torch.cat(parts)
        count("armnet.cin.blocks", len(parts))
        ctx.save_for_backward(x0t, xkt, filt, out)
        ctx.rows, ctx.layer = rows, layer
        return out

    @staticmethod
    def backward(ctx, dout):
        x0t, xkt, filt, out = ctx.saved_tensors
        rows = ctx.rows
        dx0, dxk, dw = [], [], None
        with span("armnet.cin.backward", layer=ctx.layer):
            for s in range(0, x0t.shape[0], rows):
                d0, dk, dwb = cin_cuda.cin_bwd_plain(
                    x0t[s:s + rows], xkt[s:s + rows], filt, out[s:s + rows],
                    dout[s:s + rows])
                dx0.append(d0)
                dxk.append(dk)
                dw = dwb if dw is None else dw + dwb
        count("armnet.cin.blocks", len(dx0))
        return torch.cat(dx0), torch.cat(dxk), dw, None, None


def compressed_interaction_step(x0, xk, filt, layer=None):
    """One CIN layer: x0 [B, F, E], xk [B, C, E], filt [F*C, nfilter] ->
    relu of the 1x1 convolution over the F*C channels of the outer product
    x0[:, f] * xk[:, c] -> [B, nfilter, E]: a view of a [B, E, nfilter]
    tensor, which the next layer's xk passes to the kernels as it is.
    `layer` is the spans' id."""
    x0t, xkt = x0.transpose(1, 2), xk.transpose(1, 2)
    route = cin_route(x0, xk, filt)
    count(f"armnet.cin.{route}")
    if route == "fused":
        out = _CINFused.apply(x0t, xkt, filt, layer)
    else:
        out = _CINBlocked.apply(x0t, xkt, filt, _block_rows(x0, xk), layer)
    return out.transpose(1, 2)


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
