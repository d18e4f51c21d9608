"""SA-GLU (port of armnet_tpu/models/sa_glu.py): a gated linear unit over
two self-attention branches, (attn_w(x) + w_b) * sigmoid(attn_v(x) + v_b),
then dropout, the MLP and the optional DNN ensemble. The JAX model has no
emb_bn (the reference declares one and never uses it), and neither has
this one."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (VALUE_CLAMP, DeepEnsemble,
                                            split_batch, squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import (MLP, Dropout, Embedding,
                                         SelfAttnLayer)

__all__ = ["SAGLU"]


class SAGLU(nn.Module):

    def __init__(self, nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                 ensemble, deep_nlayer, deep_nhid, noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.w_b = nn.Parameter(init.zeros((nemb,), g.device))
        self.v_b = nn.Parameter(init.zeros((nemb,), g.device))
        self.self_attn_w = SelfAttnLayer(nemb, g)
        self.self_attn_v = SelfAttnLayer(nemb, g)
        self.dropout = Dropout(dropout)
        self.mlp = MLP(nfield * nemb, mlp_nlayer, mlp_nhid, dropout, noutput,
                       g)
        self.ensemble = (DeepEnsemble(nfield, nfeat, nemb, deep_nlayer,
                                      deep_nhid, dropout, noutput, g)
                         if ensemble else None)

    def forward(self, batch):
        ids, values = split_batch(batch)
        values = values.clamp(*VALUE_CLAMP)
        emb = self.embedding(ids, values)
        xw = self.self_attn_w(emb)[0] + self.w_b
        xv = self.self_attn_v(emb)[0] + self.v_b
        glu = xw * torch.sigmoid(xv)                             # [B, F, E]
        y = self.mlp(self.dropout(glu.reshape(glu.shape[0], -1)))
        if self.ensemble is not None:
            y = self.ensemble(y, ids, values)
        return squeeze_logits(y)
