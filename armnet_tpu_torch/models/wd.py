"""Wide & Deep (port of armnet_tpu/models/wd.py): the first-order term
plus the MLP over the flattened embeddings."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (add_first_order, split_batch,
                                            squeeze_logits)
from armnet_tpu_torch.ops.layers import MLP, Embedding, FeaturesLinear

__all__ = ["WideDeep"]


class WideDeep(nn.Module):

    def __init__(self, nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                 noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.linear = FeaturesLinear(nfeat, g)
        self.mlp = MLP(nfield * nemb, mlp_nlayer, mlp_nhid, dropout, noutput,
                       g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        emb = self.embedding(ids, values)
        return add_first_order(self.linear(ids, values), squeeze_logits(
            self.mlp(emb.reshape(emb.shape[0], -1))))
