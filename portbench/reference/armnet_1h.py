"""ARM-Net with one shared attention head (ARM-Net, SIGMOD'21, section 3;
its armnet_1h.py), in plain float32 PyTorch:

  emb    = table[ids] * clamp(values, 1e-3, 1)            [B, F, E]
  gates  = (emb @ Wk) @ query^T / sqrt(d_k)               [B, F, O]
  w      = entmax_alpha(gates over fields) * values^T     [B, F, O]
  cross  = exp(sum_f w[b, f, o] emb[b, f, :])             [B, O, E]
  logits = MLP(BatchNorm over O of cross, flattened)      [B]

d_k is the embedding width E. Leaves are named and laid out as the
program's state dict names them (Wk [E, d_k], query [O, d_k], values
[O, F]), so the same tensors can be handed to both sides.
"""

from portbench.reference.common import (batch_norm, bn_specs, embed, entmax,
                                        mlp, mlp_flops, mlp_specs,
                                        xavier_bound)

__all__ = ["specs", "forward", "flops_per_example", "entmax_shape"]


def specs(cfg):
    """The leaves and their published initialisation."""
    f, e, o, r = cfg["nfield"], cfg["nemb"], cfg["h"], cfg["nfeat"]
    return ([("embedding.weight", (r, e), "uniform", xavier_bound((r, e))),
             ("attn_layer.bilinear_w", (e, e), "uniform", e ** -0.5),
             ("attn_layer.query", (o, e), "uniform",
              xavier_bound((o, e), 1.414)),
             ("attn_layer.values", (o, f), "uniform",
              xavier_bound((o, f), 1.414))]
            + bn_specs("arm_bn.", o)
            + mlp_specs(o * e, cfg["mlp_nlayer"], cfg["mlp_nhid"]))


def forward(cfg, p, ids, values, train, mask=None):
    """Logits [B] of a batch; train mode takes BatchNorm's batch
    statistics (rows whose mask is 1) and updates the running ones."""
    emb = embed(p["embedding.weight"], ids, values)
    keys = emb @ p["attn_layer.bilinear_w"]
    gates = keys @ p["attn_layer.query"].t() * keys.shape[-1] ** -0.5
    w = (entmax(gates, cfg["alpha"], dim=1)
         * p["attn_layer.values"].t()[None])
    cross = torch_exp_cross(emb, w)
    x = batch_norm(cross, p, "arm_bn.", 1, train, mask)
    return mlp(x.reshape(x.shape[0], -1), p, cfg["mlp_nlayer"], train, mask)


def torch_exp_cross(emb, w):
    """exp(sum_f w[b, f, c] emb[b, f, e]) -> [B, C, E]."""
    return (w.transpose(1, 2) @ emb).exp()


def flops_per_example(cfg):
    """Forward FLOPs of the products per example (2 per multiply-add): the
    key and gate projections, the field cross and the MLP."""
    f, e, o = cfg["nfield"], cfg["nemb"], cfg["h"]
    return (2 * f * e * e + 2 * f * e * o + 2 * f * o * e
            + mlp_flops(o * e, cfg["mlp_nlayer"], cfg["mlp_nhid"]))


def entmax_shape(cfg):
    """(entries normalised, columns) of the entmax per example."""
    return cfg["nfield"], cfg["h"]
