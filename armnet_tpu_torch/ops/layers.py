"""Shared layers (port of armnet_tpu/ops/layers.py).

  TorchLinear   nn.Linear with its default init, from a torch.Generator;
                bias-free with bias=False
  BatchNorm     torch BatchNorm over a given channel axis; in train mode
                with masked batch statistics under batch_mask_scope, on
                the card as one kernel pair (bn_route)
  Dropout       inverted dropout whose mask comes from the generator of
                the active dropout_scope
  Embedding     value-scaled embedding gather -> [B, F, E]
  FeaturesLinear  first-order term: a per-feature scalar weight times the
                value, summed over fields, plus a bias -> [B]
  fm_pool       0.5 * ((sum_f e)^2 - sum_f e^2) FM pooling
  MLP           [Linear -> BatchNorm -> ReLU -> Dropout] * L -> Linear
  SelfAttnLayer scaled dot-product self-attention over fields (SA-GLU)
  MultiHeadAttention  multi-head attention with residual + LayerNorm
  triu_indices / all_pair_indices / normalize_adj helpers
  promoted      operands cast to their promoted dtype, for the products
                that mix activations and parameters

Parameters are created on the generator's device; move the model with
`.to(device)` afterwards. They stay float32. The activations follow the
JAX package's compute-dtype contract (--bf16): Embedding casts its output
to its `compute_dtype` (set by models.create_model), TorchLinear and
BatchNorm return their input's dtype (BatchNorm's statistics in float32),
and a product of a bfloat16 activation and a float32 parameter promotes to
float32 as jnp.matmul and jnp.einsum do (torch.matmul would raise; the
callers pass their operands through `promoted`).
"""

import math
import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from armnet_tpu_torch.kernels import bn_cuda
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.embedding import embedding_bag
from armnet_tpu_torch.parallel.mesh import all_reduce_sum
from armnet_tpu_torch.utils.tracing import count, span

__all__ = ["TorchLinear", "BatchNorm", "Dropout", "Embedding",
           "FeaturesLinear", "fm_pool", "MLP", "SelfAttnLayer",
           "MultiHeadAttention", "triu_indices", "all_pair_indices",
           "normalize_adj", "batch_mask_scope", "current_batch_mask",
           "dropout_scope", "promoted", "bn_route"]

# The train step enters batch_mask_scope around the forward so BatchNorm
# computes MASKED batch statistics: the loader pads the final partial batch
# to B with mask-0 rows, and statistics over the pad rows would drift the
# running averages that eval uses (the JAX package's r5 finding; the torch
# reference's last batch is genuinely small). dropout_scope hands Dropout
# the step's torch.Generator the same way.
_scope = threading.local()


@contextmanager
def batch_mask_scope(mask, group=None):
    """Expose the batch validity mask [B] to BatchNorm during a forward.
    With a process group (the data group of a data-parallel step) the
    masked statistics are taken over the group's global batch: their sums
    go through a differentiable all-reduce."""
    prev = getattr(_scope, "mask", None), getattr(_scope, "group", None)
    _scope.mask, _scope.group = mask, group
    try:
        yield
    finally:
        _scope.mask, _scope.group = prev


def current_batch_mask():
    return getattr(_scope, "mask", None)


@contextmanager
def dropout_scope(generator):
    """Draw every dropout mask of a forward from `generator`."""
    prev = getattr(_scope, "generator", None)
    _scope.generator = generator
    try:
        yield
    finally:
        _scope.generator = prev


def promoted(*tensors):
    """The tensors cast to their promoted dtype (torch.result_type's rules,
    which are jnp's for these dtypes: bfloat16 with float32 is float32)."""
    dtype = tensors[0].dtype
    for t in tensors[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return tuple(t.to(dtype) for t in tensors)


def triu_indices(n, diag_offset=1, device=None):
    """(i, j) long index tensors of the strict upper triangle of an (n, n)
    grid, row-major (numpy's np.triu_indices order)."""
    i, j = torch.triu_indices(n, n, diag_offset, device=device)
    return i, j


def all_pair_indices(n, device=None):
    """(i, j) long index tensors of all n^2 ordered pairs, i-major."""
    idx = torch.arange(n, device=device)
    return idx.repeat_interleave(n), idx.repeat(n)


def normalize_adj(adj):
    """Symmetric degree normalization D^-1/2 A D^-1/2 in the reference's
    form (A @ D^-1/2, transposed, @ D^-1/2); a row that sums to 0 gets a
    degree factor of 0."""
    rowsum = adj.sum(-1)
    d_inv_sqrt = torch.where(rowsum > 0,
                             torch.rsqrt(torch.clamp_min(rowsum, 1e-12)),
                             torch.zeros_like(rowsum))
    return (adj * d_inv_sqrt[None, :]).t() * d_inv_sqrt[None, :]


class TorchLinear(nn.Module):
    """Dense layer; weight [out, in] (torch layout), default nn.Linear init.
    With bias=False it holds no bias and draws none. Weight and bias are
    cast to the input's dtype, as the JAX layer casts them."""

    def __init__(self, in_features, out_features, generator, bias=True):
        super().__init__()
        self.weight = nn.Parameter(init.torch_linear_uniform(
            (out_features, in_features), in_features, generator))
        self.bias = (nn.Parameter(init.torch_linear_uniform(
            (out_features,), in_features, generator)) if bias else None)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


def bn_route(training, x, ch):
    """'fused' for a train-mode float32 CUDA input with more than one
    element a channel and row after the channel axis `ch` (S > 1 in the
    kernels' [N, C, S] view: ARM-Net's arm_bn over [B, O, E], the other
    BatchNorms over [B, C, E]), the kernel pair of kernels/bn_cuda.py; else
    'composed' (PyTorch ops: the CPU, bfloat16 activations under --bf16,
    eval mode's running statistics, and S = 1, an MLP's [B, C]: there the
    kernels' other rounding moved xdfm_criteo.train's losses past their
    one-ulp limits on the card, PERF.md §6)."""
    if (training and x.is_cuda and x.dtype == torch.float32
            and math.prod(x.shape[ch + 1:]) > 1):
        return "fused"
    return "composed"


class _BatchNormFused(torch.autograd.Function):
    """bn_cuda's kernels on x3 [N, C, S] (contiguous) -> y3; keeps x3, the
    mask, the count, mean and rstd ([C]) for the backward."""

    @staticmethod
    def forward(ctx, x3, weight, bias, rows, cnt, spatial, running_mean,
                running_var, eps, keep, group):
        with span("armnet.bn.forward"):
            y3, mean, rstd = bn_cuda.bn_fwd(
                x3, rows, cnt, spatial, weight, bias, running_mean,
                running_var, eps, keep, group)
        ctx.save_for_backward(x3, weight, rows, cnt, mean, rstd)
        ctx.spatial, ctx.group = spatial, group
        return y3

    @staticmethod
    def backward(ctx, dy3):
        x3, weight, rows, cnt, mean, rstd = ctx.saved_tensors
        with span("armnet.bn.backward"):
            dx, dweight, dbias = bn_cuda.bn_bwd(
                x3, dy3.contiguous(), rows, cnt, ctx.spatial, weight, mean,
                rstd, ctx.group)
        return dx, dweight, dbias, *([None] * 8)


class BatchNorm(nn.Module):
    """BatchNorm with torch defaults (eps 1e-5, momentum 0.1, i.e. keep 0.9
    of the running average) that normalizes over every axis but
    `channel_axis`. Eval mode uses the running mean and variance. Train
    mode normalizes by the batch's mean and biased variance and folds the
    UNBIASED variance (x n/(n-1)) into the running average, as torch does;
    inside batch_mask_scope both statistics take the real rows only (n =
    real rows x the other reduced axes), and an input that is not
    batch-led raises. The statistics are float32; the output takes the
    input's dtype (mean, scale and shift cast to it).

    bn_route picks how: a train-mode float32 CUDA input with S > 1 takes
    the kernel pair of kernels/bn_cuda.py (the input viewed as [N, C, S]:
    the axes before the channel, the channel, the axes after it), inside
    the spans armnet.bn.forward and armnet.bn.backward; everything else
    the composed PyTorch ops. Each call counts its route (armnet.bn.fused,
    armnet.bn.composed) through utils/tracing."""

    momentum = 0.9              # the share of the running average kept

    def __init__(self, num_features, channel_axis=-1, eps=1e-5, device=None):
        super().__init__()
        self.channel_axis = channel_axis
        self.eps = eps
        self.weight = nn.Parameter(init.ones((num_features,), device))
        self.bias = nn.Parameter(init.zeros((num_features,), device))
        self.register_buffer("running_mean",
                             init.zeros((num_features,), device))
        self.register_buffer("running_var", init.ones((num_features,), device))

    def _batch_stats(self, x, ch, mask):
        xf = x.float()
        red = tuple(i for i in range(x.ndim) if i != ch)
        bshape = [x.shape[i] if i == ch else 1 for i in range(x.ndim)]
        if mask is None:
            n = math.prod(x.shape[i] for i in red)
            mean = xf.mean(red)
            var = (xf - mean.view(bshape)).square().mean(red)
            return mean, var, n / max(n - 1, 1)
        group = getattr(_scope, "group", None)
        spatial = math.prod(x.shape[i] for i in red if i != 0)
        w = mask.to(xf.dtype).view([x.shape[0]] + [1] * (x.ndim - 1))
        n = torch.clamp_min(all_reduce_sum(mask.to(xf.dtype).sum(), group),
                            1.0) * spatial
        mean = all_reduce_sum((xf * w).sum(red), group) / n
        var = all_reduce_sum(
            ((xf - mean.view(bshape)).square() * w).sum(red), group) / n
        return mean, var, n / torch.clamp_min(n - 1, 1.0)

    def _fused(self, x, ch, mask):
        rows = math.prod(x.shape[:ch])
        x3 = x.reshape(rows, x.shape[ch], -1).contiguous()
        if mask is None:
            w = cnt = group = None
            spatial = rows * x3.shape[2]
        else:
            group = getattr(_scope, "group", None)
            m = mask.to(torch.float32)
            per = rows // x.shape[0]
            w = (m if per == 1 else m.repeat_interleave(per)).contiguous()
            cnt = all_reduce_sum(m.sum(), group)
            spatial = per * x3.shape[2]
        y3 = _BatchNormFused.apply(x3, self.weight, self.bias, w, cnt,
                                   spatial, self.running_mean,
                                   self.running_var, self.eps, self.momentum,
                                   group)
        return y3.view(x.shape)

    def forward(self, x):
        ch = self.channel_axis % x.ndim
        mask = current_batch_mask() if self.training else None
        if mask is not None and (ch == 0 or mask.shape[0] != x.shape[0]):
            raise ValueError(
                f"batch_mask_scope active (mask {tuple(mask.shape)}) but this "
                f"BatchNorm input {tuple(x.shape)} (channel axis {ch}) is not "
                f"batch-led; masked statistics cannot be applied")
        route = bn_route(self.training, x, ch)
        count(f"armnet.bn.{route}")
        if route == "fused":
            return self._fused(x, ch, mask)
        return self._composed(x, ch, mask)

    def _composed(self, x, ch, mask):
        bshape = [1] * x.ndim
        bshape[ch] = x.shape[ch]
        if self.training:
            mean, var, unbias = self._batch_stats(x, ch, mask)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var * unbias)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(bshape).to(x.dtype))
                * inv.view(bshape).to(x.dtype)
                + self.bias.view(bshape).to(x.dtype))


class Dropout(nn.Module):
    """Inverted dropout in train mode, with the mask drawn from the
    generator of the active dropout_scope (never the global RNG)."""

    def __init__(self, p):
        super().__init__()
        self.p = float(p)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        gen = getattr(_scope, "generator", None)
        if gen is None:
            raise ValueError("Dropout in train mode draws its mask from the "
                             "generator of dropout_scope; none is active")
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= self.p
        return x * keep / (1.0 - self.p)


class Embedding(nn.Module):
    """Value-scaled embedding table [nfeat, nemb], xavier_uniform init; the
    output is cast to `compute_dtype` (float32, or bfloat16 under --bf16),
    the one cast of the compute-dtype contract. The table is gathered
    through `lookup` (embedding_bag; the trainer sets a sharded exchange
    where it row-shards the table, parallel/sharding.py)."""

    table_name = "weight"

    def __init__(self, nfeat, nemb, generator):
        super().__init__()
        self.compute_dtype = torch.float32
        self.lookup = embedding_bag
        self.weight = nn.Parameter(init.xavier_uniform((nfeat, nemb),
                                                       generator))

    def forward(self, ids, values):
        return self.lookup(self.weight, ids, values).to(self.compute_dtype)


class FeaturesLinear(nn.Module):
    """First-order term [B]: weight [nfeat, 1] N(0, 1) (nn.Embedding's
    default, which the reference never re-inits; not xavier) gathered and
    value-scaled by embedding_bag, so its gradient is the table-gradient
    kernel at E = 1 on the card; summed over fields plus a zero-init bias
    [1]. The weight is gathered through `lookup`, as Embedding's table."""

    table_name = "weight"

    def __init__(self, nfeat, generator):
        super().__init__()
        self.lookup = embedding_bag
        self.weight = nn.Parameter(init.normal_unit((nfeat, 1), generator))
        self.bias = nn.Parameter(init.zeros((1,), generator.device))

    def forward(self, ids, values):
        w = self.lookup(self.weight, ids, values)              # [B, F, 1]
        return w[..., 0].sum(1) + self.bias[0]


def fm_pool(x, reduce_dim=True):
    """FM second-order pooling over the field axis of [B, F, E]: [B], or
    [B, E] with reduce_dim=False."""
    fm = x.sum(1).square() - x.square().sum(1)                 # [B, E]
    if reduce_dim:
        fm = fm.sum(1)
    return 0.5 * fm


class MLP(nn.Module):
    """nlayers x [Linear -> BatchNorm -> ReLU -> Dropout] -> Linear(noutput);
    nlayers == 0 is a single Linear."""

    def __init__(self, in_features, nlayers, nhid, dropout, noutput,
                 generator):
        super().__init__()
        widths = [in_features] + [nhid] * nlayers
        self.linears = nn.ModuleList(
            [TorchLinear(a, b, generator) for a, b in zip(widths, widths[1:])]
            + [TorchLinear(widths[-1], noutput, generator)])
        self.norms = nn.ModuleList(
            [BatchNorm(nhid, -1, device=generator.device)
             for _ in range(nlayers)])
        self.dropout = Dropout(dropout)

    def forward(self, x):
        for linear, norm in zip(self.linears, self.norms):
            x = self.dropout(F.relu(norm(linear(x))))
        return self.linears[-1](x)


class SelfAttnLayer(nn.Module):
    """Self-attention over fields [B, F, E] -> ([B, F, E], attn [B, F, F]):
    bias-free q, k, v (linears 0-2), scores q k^T / sqrt(E), softmax over
    the last axis."""

    def __init__(self, nemb, generator):
        super().__init__()
        self.linears = nn.ModuleList(
            [TorchLinear(nemb, nemb, generator, bias=False)
             for _ in range(3)])

    def forward(self, x):
        q, k, v = (linear(x) for linear in self.linears)
        scores = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(x.shape[-1])
        attn = torch.softmax(scores, dim=-1)
        return torch.matmul(attn, v), attn


class MultiHeadAttention(nn.Module):
    """Multi-head attention over [B, L, ninput] with a residual and a
    LayerNorm (eps 1e-6): bias-free q, k, v and output projections
    (linears 0-3), scores scaled by n_k^-0.5, -1e9 where mask == 0 (mask
    [B, L, L] or broadcastable to it, shared by the heads), dropout on the
    projected output; the LayerNorm promotes a bfloat16 input to its
    float32 parameters' dtype, as flax's does. Returns (y [B, L, ninput],
    attn [B, H, L, L]). No zoo model uses it; it is layer API, as in the
    JAX package."""

    def __init__(self, ninput, nhead, n_k, n_v, dropout, generator):
        super().__init__()
        self.nhead, self.n_k, self.n_v = nhead, n_k, n_v
        self.linears = nn.ModuleList(
            [TorchLinear(ninput, nhead * n, generator, bias=False)
             for n in (n_k, n_k, n_v)]
            + [TorchLinear(nhead * n_v, ninput, generator, bias=False)])
        self.layer_norm = nn.LayerNorm(ninput, eps=1e-6,
                                       device=generator.device)
        self.dropout = Dropout(dropout)

    def forward(self, x, mask=None):
        bsz, seq_len, _ = x.shape
        q, k, v = (lin(x).reshape(bsz, seq_len, self.nhead, -1).transpose(1, 2)
                   for lin in self.linears[:3])
        attn = torch.matmul(q / math.sqrt(self.n_k), k.transpose(2, 3))
        if mask is not None:
            attn = attn.masked_fill(mask.unsqueeze(1) == 0, -1e9)
        attn = torch.softmax(attn, dim=-1)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(bsz, seq_len, -1)
        y = self.dropout(self.linears[3](y)) + x
        y, _ = promoted(y, self.layer_norm.weight)
        return self.layer_norm(y), attn
