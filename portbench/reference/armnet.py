"""ARM-Net with K attention heads (ARM-Net, SIGMOD'21, section 3; its
armnet.py), in plain float32 PyTorch. Per head k:

  gates_k = (emb @ W_k) @ query_k^T / sqrt(d_k)             [B, F, O]
  w_k     = entmax_alpha(gates_k over fields) * values_k^T  [B, F, O]

the heads' neurons are concatenated k-major into C = K*O channels, and

  cross   = exp(sum_f w[b, f, c] emb[b, f, :])              [B, C, E]
  logits  = MLP(BatchNorm over C of cross, flattened)        [B]

d_k is the embedding width E. Leaves are named and laid out as the
program's state dict names them (bilinear_w [K, E, d_k], query [K, O,
d_k], values [K, O, F]).
"""

import torch

from portbench.reference.armnet_1h import torch_exp_cross
from portbench.reference.common import (batch_norm, bn_specs, embed, entmax,
                                        mlp, mlp_flops, mlp_specs,
                                        xavier_bound)

__all__ = ["specs", "forward", "flops_per_example", "entmax_shape"]


def specs(cfg):
    """The leaves and their published initialisation (xavier_uniform with
    gain 1.414 over torch's fans of the 3-D tensors)."""
    f, e, o, r = cfg["nfield"], cfg["nemb"], cfg["h"], cfg["nfeat"]
    k = cfg["nattn_head"]
    return ([("embedding.weight", (r, e), "uniform", xavier_bound((r, e)))]
            + [(f"attn_layer.{name}", shape, "uniform",
                xavier_bound(shape, 1.414))
               for name, shape in (("bilinear_w", (k, e, e)),
                                   ("query", (k, o, e)),
                                   ("values", (k, o, f)))]
            + bn_specs("arm_bn.", k * o)
            + mlp_specs(k * o * e, cfg["mlp_nlayer"], cfg["mlp_nhid"]))


def forward(cfg, p, ids, values, train, mask=None):
    """Logits [B] of a batch, as armnet_1h.forward."""
    emb = embed(p["embedding.weight"], ids, values)
    wk, query = p["attn_layer.bilinear_w"], p["attn_layer.query"]
    values_t = p["attn_layer.values"]
    heads = []
    for k in range(wk.shape[0]):
        gates = (emb @ wk[k]) @ query[k].t() * wk.shape[-1] ** -0.5
        heads.append(entmax(gates, cfg["alpha"], dim=1) * values_t[k].t())
    cross = torch_exp_cross(emb, torch.cat(heads, dim=2))
    x = batch_norm(cross, p, "arm_bn.", 1, train, mask)
    return mlp(x.reshape(x.shape[0], -1), p, cfg["mlp_nlayer"], train, mask)


def flops_per_example(cfg):
    """Forward FLOPs of the products per example (2 per multiply-add): per
    head the key and gate projections, then the field cross and the MLP."""
    f, e, o, k = cfg["nfield"], cfg["nemb"], cfg["h"], cfg["nattn_head"]
    c = k * o
    return (k * (2 * f * e * e + 2 * f * e * o) + 2 * f * c * e
            + mlp_flops(c * e, cfg["mlp_nlayer"], cfg["mlp_nhid"]))


def entmax_shape(cfg):
    """(entries normalised, columns) of the entmax per example."""
    return cfg["nfield"], cfg["h"] * cfg["nattn_head"]
