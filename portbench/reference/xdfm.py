"""xDeepFM (Lian et al., KDD'18, arXiv:1803.05170, section 3) in plain
float32 PyTorch, with the CIN as ARM-Net's models/xdfm.py builds it (ReLU
after each 1x1 convolution, no split-half, sum-pooling over E, a bias-free
affine layer over the pools):

  emb    = table[ids] * values                              [B, F, E]
  X_0    = emb;  X_{k+1}[b, n, e] = relu(sum_{f,c} W_k[f*C_k + c, n]
                                         X_0[b, f, e] X_k[b, c, e])
  logits = sum_f lin[ids] * values + bias                   (first order)
         + affine(concat_k sum_e X_k)                       (CIN)
         + MLP(flatten(emb))                                 [B]

The CIN runs over row blocks, each under torch.utils.checkpoint, so that
no block's outer product X_0 x X_k passes BLOCK_BYTES and the backward
recomputes it block by block; the MLP's BatchNorm sees the whole batch.
Leaves are named and laid out as the program's state dict names them
(filter_k [F * C_k, N], affine.weight [1, K * N]), so the same tensors can
be handed to both sides. The first-order weight is drawn uniform in
+-sqrt(3) (the variance of its published N(0, 1)), as the benchmark draws
only uniform and constant leaves.

Also the CIN's least-time count (cin_flops_per_example, cin_bytes): the
products of every layer forward, and twice that backward (the filter's
gradient and dOut W_f^T); each activation read once and written once.
"""

import math

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.common import (mlp, mlp_flops, mlp_specs,
                                        xavier_bound)

__all__ = ["specs", "forward", "flops_per_example", "cin_flops_per_example",
           "cin_bytes", "BLOCK_BYTES"]

BLOCK_BYTES = 1 << 30


def _widths(cfg):
    """(F, [C_0, C_1, ...], N): the channels each layer reads."""
    f, n = cfg["nfield"], cfg["h"]
    return f, [f] + [n] * (cfg["k"] - 1), n


def specs(cfg):
    """The leaves and their published initialisation (the first-order
    weight as the module docstring says)."""
    f, chans, n = _widths(cfg)
    r, e = cfg["nfeat"], cfg["nemb"]
    out = [("embedding.weight", (r, e), "uniform", xavier_bound((r, e))),
           ("linear.weight", (r, 1), "uniform", math.sqrt(3.0)),
           ("linear.bias", (1,), "const", 0.0)]
    for k, c in enumerate(chans):
        out.append((f"cin.filter_{k}", (f * c, n), "uniform",
                    (f * c) ** -0.5))
    k = len(chans)
    out.append(("cin.affine.weight", (1, k * n), "uniform", (k * n) ** -0.5))
    return out + mlp_specs(f * e, cfg["mlp_nlayer"], cfg["mlp_nhid"])


def _cin_pools(x0, *filters):
    """x0 [b, F, E] -> the layers' pools [b, K * N]."""
    b, _, e = x0.shape
    x0t = x0.transpose(1, 2)                               # [b, E, F]
    xk, pools = x0t, []
    for w in filters:
        h = (x0t[..., :, None] * xk[..., None, :]).reshape(b * e, -1)
        xk = torch.relu(h @ w).view(b, e, -1)              # [b, E, N]
        pools.append(xk.sum(1))
    return torch.cat(pools, 1)


def cin_logit(cfg, p, emb):
    """The CIN's logit [B], over row blocks under checkpoint."""
    filters = [p[f"cin.filter_{k}"] for k in range(cfg["k"])]
    f, chans, _ = _widths(cfg)
    rows = max(1, BLOCK_BYTES // (4 * f * max(chans) * emb.shape[2]))
    pools = torch.cat([checkpoint(_cin_pools, emb[s:s + rows], *filters,
                                  use_reentrant=False)
                       for s in range(0, emb.shape[0], rows)])
    return (pools @ p["cin.affine.weight"].t()).squeeze(-1)


def forward(cfg, p, ids, values, train, mask=None):
    """Logits [B] of a batch; train mode takes the MLP's BatchNorm batch
    statistics (rows whose mask is 1) and updates the running ones."""
    ids = ids.long()
    emb = p["embedding.weight"][ids] * values[..., None]
    first = (p["linear.weight"][ids, 0] * values).sum(1) + p["linear.bias"][0]
    deep = mlp(emb.reshape(emb.shape[0], -1), p, cfg["mlp_nlayer"], train,
               mask)
    return first + cin_logit(cfg, p, emb) + deep


def cin_flops_per_example(cfg):
    """(forward, backward) FLOPs of the CIN's products per example, 2 per
    multiply-add: each layer's sum over F * C_k channels for N maps at E
    positions, and backward the filter's gradient and dOut W_f^T."""
    f, chans, n = _widths(cfg)
    fwd = sum(2 * f * c * n * cfg["nemb"] for c in chans)
    return fwd, 2 * fwd


def cin_bytes(cfg, rows):
    """Least bytes a step of `rows` examples moves through the CIN's
    kernels: forward x0 and x_k read and the output written; backward x0,
    x_k, the output and its gradient read, the inputs' gradients written;
    each filter read twice and its gradient written once."""
    f, chans, n = _widths(cfg)
    e = cfg["nemb"]
    per_row = sum((f + c + n) + (f + c + 2 * n) + (f + c) for c in chans)
    weights = sum(3 * f * c * n for c in chans)
    return 4 * (rows * e * per_row + weights)


def flops_per_example(cfg):
    """Forward FLOPs of the products per example (2 per multiply-add): the
    CIN's layers and affine layer, and the MLP."""
    f, chans, n = _widths(cfg)
    return (cin_flops_per_example(cfg)[0] + 2 * len(chans) * n
            + mlp_flops(f * cfg["nemb"], cfg["mlp_nlayer"], cfg["mlp_nhid"]))
