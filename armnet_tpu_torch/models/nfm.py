"""Neural FM (port of armnet_tpu/models/nfm.py): vector FM pooling [B, E],
BatchNorm over its channel axis -1 (fm_bn), dropout, the MLP, plus the
first-order term."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (add_first_order, split_batch,
                                            squeeze_logits)
from armnet_tpu_torch.ops.layers import (MLP, BatchNorm, Dropout, Embedding,
                                         FeaturesLinear, fm_pool)

__all__ = ["NFM"]


class NFM(nn.Module):

    def __init__(self, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout, noutput=1,
                 generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.fm_bn = BatchNorm(nemb, channel_axis=-1, device=g.device)
        self.dropout = Dropout(dropout)
        self.linear = FeaturesLinear(nfeat, g)
        self.mlp = MLP(nemb, mlp_nlayer, mlp_nhid, dropout, noutput, g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        bi = fm_pool(self.embedding(ids, values), reduce_dim=False)
        bi = self.dropout(self.fm_bn(bi))                        # [B, E]
        return add_first_order(self.linear(ids, values),
                               squeeze_logits(self.mlp(bi)))
