"""Factorization Machine (port of armnet_tpu/models/fm.py): the
first-order term plus second-order FM pooling."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch
from armnet_tpu_torch.ops.layers import Embedding, FeaturesLinear, fm_pool

__all__ = ["FM"]


class FM(nn.Module):

    def __init__(self, nfeat, nemb, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.linear = FeaturesLinear(nfeat, g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        return self.linear(ids, values) + fm_pool(self.embedding(ids, values))
