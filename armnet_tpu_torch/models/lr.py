"""Logistic regression (port of armnet_tpu/models/lr.py): the first-order
term alone."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch
from armnet_tpu_torch.ops.layers import FeaturesLinear

__all__ = ["LR"]


class LR(nn.Module):

    def __init__(self, nfeat, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.linear = FeaturesLinear(nfeat, g)

    def forward(self, batch):
        return self.linear(*split_batch(batch))
