"""ARM-Net, multi-head (port of armnet_tpu/models/armnet.py): per head a
bilinear E->d_k projection and a [O, d_k] query give the gates, entmax over
fields selects each exponential neuron's field subset, [K, O, F] values
weight it, and exp(sum_f w_f * e_f) crosses the fields."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (VALUE_CLAMP, DeepEnsemble,
                                            split_batch, squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.entmax import sparse_normalizer
from armnet_tpu_torch.ops.interaction import (arm_attention_multihead,
                                              arm_exp_cross_fmajor)
from armnet_tpu_torch.ops.layers import MLP, BatchNorm, Embedding

__all__ = ["SparseAttLayer", "ARMNet"]


class SparseAttLayer(nn.Module):
    """Multi-head sparse field weights [B, F, E] -> [B, F, K*O]. Parameters
    keep the JAX layout, all xavier_uniform with gain 1.414: bilinear_w
    [K, E, d_k], query [K, O, d_k], values [K, O, F]."""

    def __init__(self, nhead, nfield, nemb, d_k, nhid, alpha, generator):
        super().__init__()
        self.alpha = alpha
        self.bilinear_w = nn.Parameter(
            init.xavier_uniform((nhead, nemb, d_k), generator, gain=1.414))
        self.query = nn.Parameter(
            init.xavier_uniform((nhead, nhid, d_k), generator, gain=1.414))
        self.values = nn.Parameter(
            init.xavier_uniform((nhead, nhid, nfield), generator, gain=1.414))

    def forward(self, x):
        return arm_attention_multihead(x, self.bilinear_w, self.query,
                                       self.values,
                                       sparse_normalizer(self.alpha, axis=1))


class ARMNet(nn.Module):
    """Adaptive Relation Modeling Network with K heads of O neurons; d_k
    is nemb, as in the JAX model."""

    def __init__(self, nfield, nfeat, nemb, nhead, alpha, nhid, mlp_nlayer,
                 mlp_nhid, dropout, ensemble, deep_nlayer, deep_nhid,
                 noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.attn_layer = SparseAttLayer(nhead, nfield, nemb, nemb, nhid,
                                         alpha, g)
        self.arm_bn = BatchNorm(nhead * nhid, channel_axis=1, device=g.device)
        self.mlp = MLP(nhead * nhid * nemb, mlp_nlayer, mlp_nhid, dropout,
                       noutput, g)
        self.ensemble = (DeepEnsemble(nfield, nfeat, nemb, deep_nlayer,
                                      deep_nhid, dropout, noutput, g)
                         if ensemble else None)

    def forward(self, batch):
        ids, values = split_batch(batch)
        values = values.clamp(*VALUE_CLAMP)
        emb = self.embedding(ids, values)
        x = arm_exp_cross_fmajor(emb, self.attn_layer(emb))   # [B, K*O, E]
        x = self.arm_bn(x)
        y = self.mlp(x.reshape(x.shape[0], -1))
        if self.ensemble is not None:
            y = self.ensemble(y, ids, values)
        return squeeze_logits(y)
