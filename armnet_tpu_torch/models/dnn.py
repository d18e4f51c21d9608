"""Plain DNN (port of armnet_tpu/models/dnn.py): the flattened embeddings
through the MLP."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch, squeeze_logits
from armnet_tpu_torch.ops.layers import MLP, Embedding

__all__ = ["DNN"]


class DNN(nn.Module):

    def __init__(self, nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                 noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.mlp = MLP(nfield * nemb, mlp_nlayer, mlp_nhid, dropout, noutput,
                       g)

    def forward(self, batch):
        emb = self.embedding(*split_batch(batch))
        return squeeze_logits(self.mlp(emb.reshape(emb.shape[0], -1)))
