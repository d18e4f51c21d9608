"""Attentional FM (port of armnet_tpu/models/afm.py): softmax attention
over the F(F-1)/2 hadamard pairs (axis 1), with dropout on the attention
weights and on the pooled vector, plus the first-order term."""

import torch
import torch.nn.functional as F
from torch import nn

from armnet_tpu_torch.models.common import split_batch
from armnet_tpu_torch.ops.layers import (Dropout, Embedding, FeaturesLinear,
                                         TorchLinear)

__all__ = ["AttentionalInteraction", "AFM"]


class AttentionalInteraction(nn.Module):
    """[B, F, E] -> [B]: attn_w (E -> nattn), ReLU, attn_h (nattn -> 1),
    softmax over the pairs, the weighted sum of the pairs, attn_p (E ->
    1)."""

    def __init__(self, nemb, nattn, dropout, generator):
        super().__init__()
        self.attn_w = TorchLinear(nemb, nattn, generator)
        self.attn_h = TorchLinear(nattn, 1, generator)
        self.attn_p = TorchLinear(nemb, 1, generator)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        vi, vj = torch.triu_indices(x.shape[1], x.shape[1], 1,
                                    device=x.device)
        had = x[:, vi] * x[:, vj]                                # [B, P, E]
        w = F.relu(self.attn_w(had))
        w = self.dropout(torch.softmax(self.attn_h(w), dim=1))  # [B, P, 1]
        afm = self.dropout((w * had).sum(1))                     # [B, E]
        return self.attn_p(afm).squeeze(-1)


class AFM(nn.Module):

    def __init__(self, nfeat, nemb, nattn, dropout, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.linear = FeaturesLinear(nfeat, g)
        self.afm = AttentionalInteraction(nemb, nattn, dropout, g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        emb = self.embedding(ids, values)
        return self.linear(ids, values) + self.afm(emb)
