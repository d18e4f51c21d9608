"""GC-ARM (port of armnet_tpu/models/gc_arm.py): ARM with a global-context
bias on the gates (the field sum of the embeddings through the same
projection), and exp applied to the embeddings BEFORE the weighting: the
cross is a plain weighted sum of BatchNorm'd exp(emb), with no exp after
it."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (VALUE_CLAMP, DeepEnsemble,
                                            split_batch, squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.entmax import sparse_normalizer
from armnet_tpu_torch.ops.interaction import mh_gate_proj
from armnet_tpu_torch.ops.layers import MLP, BatchNorm, Embedding, promoted

__all__ = ["GCSparseAttLayer", "GCARM"]


class GCSparseAttLayer(nn.Module):
    """Sparse field weights with global context, [B, F, E] -> [B, F, K*O];
    no d_k^-0.5 scale. Parameters in the JAX layout, xavier_uniform with
    gain 1.414: query [K, O, E], bilinear [K, E, E], values [K, O, F]."""

    def __init__(self, nhead, nfield, nemb, nhid, alpha, generator):
        super().__init__()
        self.alpha = alpha
        self.query = nn.Parameter(
            init.xavier_uniform((nhead, nhid, nemb), generator, gain=1.414))
        self.bilinear = nn.Parameter(
            init.xavier_uniform((nhead, nemb, nemb), generator, gain=1.414))
        self.values = nn.Parameter(
            init.xavier_uniform((nhead, nhid, nfield), generator, gain=1.414))

    def forward(self, x):
        m = mh_gate_proj(self.bilinear, self.query)              # [K*O, E]
        gates = torch.matmul(*promoted(x, m.t()))                # [B, F, K*O]
        gctx = torch.matmul(*promoted(x.sum(1), m.t()))          # [B, K*O]
        sparse = sparse_normalizer(self.alpha, axis=1)(gates + gctx[:, None])
        nhead, nhid, nfield = self.values.shape
        return sparse * self.values.reshape(nhead * nhid, nfield).t()[None]


class GCARM(nn.Module):
    """ARM + global context. The attention parameters are `attn_layers`,
    as in the JAX tree."""

    def __init__(self, nfield, nfeat, nemb, nhead, alpha, arm_hid,
                 mlp_nlayer, mlp_nhid, dropout, ensemble, deep_nlayer,
                 deep_nhid, noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.emb_bn = BatchNorm(nfield, channel_axis=1, device=g.device)
        self.attn_layers = GCSparseAttLayer(nhead, nfield, nemb, arm_hid,
                                            alpha, g)
        self.arm_bn = BatchNorm(nhead * arm_hid, channel_axis=1,
                                device=g.device)
        self.mlp = MLP(nhead * arm_hid * nemb, mlp_nlayer, mlp_nhid, dropout,
                       noutput, g)
        self.ensemble = (DeepEnsemble(nfield, nfeat, nemb, deep_nlayer,
                                      deep_nhid, dropout, noutput, g)
                         if ensemble else None)

    def forward(self, batch):
        ids, values = split_batch(batch)
        values = values.clamp(*VALUE_CLAMP)
        emb = self.embedding(ids, values)
        x_exp = self.emb_bn(torch.exp(emb))                      # [B, F, E]
        arm = torch.einsum("bfe,bfc->bce",
                           *promoted(x_exp, self.attn_layers(emb)))
        arm = self.arm_bn(arm)                                   # [B, K*O, E]
        y = self.mlp(arm.reshape(arm.shape[0], -1))
        if self.ensemble is not None:
            y = self.ensemble(y, ids, values)
        return squeeze_logits(y)
