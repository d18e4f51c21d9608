"""Higher-Order FM (port of armnet_tpu/models/hofm.py): orders 2..k, each
from its own nemb-wide slice of one [nfeat, nemb * (k - 1)] table, order 2
by FM pooling and each higher order by the ANOVA kernel."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch
from armnet_tpu_torch.ops.interaction import anova_kernel
from armnet_tpu_torch.ops.layers import Embedding, FeaturesLinear, fm_pool

__all__ = ["HOFM"]


class HOFM(nn.Module):

    def __init__(self, nfeat, nemb, order, generator=None):
        super().__init__()
        if order < 2:
            raise ValueError(f"HOFM needs order >= 2, got {order}")
        g = generator if generator is not None else torch.Generator()
        self.nemb, self.order = nemb, order
        self.embedding = Embedding(nfeat, nemb * (order - 1), g)
        self.linear = FeaturesLinear(nfeat, g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        emb = self.embedding(ids, values)          # [B, F, nemb*(order-1)]
        y = self.linear(ids, values) + fm_pool(emb[:, :, :self.nemb])
        for i in range(self.order - 2):
            sl = emb[:, :, (i + 1) * self.nemb:(i + 2) * self.nemb]
            y = y + anova_kernel(sl, order=i + 3)
        return y
