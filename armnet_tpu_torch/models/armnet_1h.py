"""ARM-Net one-head (port of armnet_tpu/models/armnet_1h.py): a shared
bias-free E->d_k bilinear projection, gates against a [O, d_k] query,
entmax over fields, [O, F] values, exponential-neuron cross product."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (VALUE_CLAMP, DeepEnsemble,
                                            split_batch, squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.interaction import arm1h_interaction
from armnet_tpu_torch.ops.layers import MLP, BatchNorm, Embedding

__all__ = ["SparseAttention", "ARMNet1H"]


class SparseAttention(nn.Module):
    """One-head sparse interaction [B, F, E] -> [B, O, E]. Parameters keep
    the JAX layout: bilinear_w [E, d_k], query [O, d_k], values [O, F].
    `kernels` 'pallas-fused' takes the fused ARM-1h kernels, any other
    choice the composed path (kernels/config.py)."""

    def __init__(self, nfield, d_k, nhid, nemb, alpha, generator,
                 kernels="auto"):
        super().__init__()
        self.alpha = alpha
        self.kernels = kernels
        self.bilinear_w = nn.Parameter(
            init.torch_linear_uniform((nemb, d_k), nemb, generator))
        self.query = nn.Parameter(
            init.xavier_uniform((nhid, d_k), generator, gain=1.414))
        self.values = nn.Parameter(
            init.xavier_uniform((nhid, nfield), generator, gain=1.414))

    def forward(self, x):
        return arm1h_interaction(x, self.bilinear_w, self.query, self.values,
                                 self.alpha, kernels=self.kernels)


class ARMNet1H(nn.Module):
    """Adaptive Relation Modeling Network with a shared bilinear weight."""

    def __init__(self, nfield, nfeat, nemb, alpha, nhid, d_k, mlp_nlayer,
                 mlp_nhid, dropout, ensemble, deep_nlayer, deep_nhid,
                 noutput=1, generator=None, kernels="auto"):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.attn_layer = SparseAttention(nfield, d_k, nhid, nemb, alpha, g,
                                          kernels)
        self.arm_bn = BatchNorm(nhid, channel_axis=1, device=g.device)
        self.mlp = MLP(nhid * nemb, mlp_nlayer, mlp_nhid, dropout, noutput, g)
        self.ensemble = (DeepEnsemble(nfield, nfeat, nemb, deep_nlayer,
                                      deep_nhid, dropout, noutput, g)
                         if ensemble else None)

    def forward(self, batch):
        ids, values = split_batch(batch)
        values = values.clamp(*VALUE_CLAMP)
        emb = self.embedding(ids, values)
        x = self.arm_bn(self.attn_layer(emb))                  # [B, O, E]
        y = self.mlp(x.reshape(x.shape[0], -1))
        if self.ensemble is not None:
            y = self.ensemble(y, ids, values)
        return squeeze_logits(y)
