"""GCN over the field graph (port of armnet_tpu/models/gcn.py): k graph
convolutions of width h over an adjacency [F, F] (all ones unless given),
normalized D^-1/2 A D^-1/2 on every forward, each followed by dropout and
ReLU, then the MLP (`affine`) over the flattened fields."""

import torch
import torch.nn.functional as F
from torch import nn

from armnet_tpu_torch.models.common import split_batch, squeeze_logits
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import (MLP, Dropout, Embedding,
                                         normalize_adj, promoted)

__all__ = ["GraphConvolution", "GCN"]


class GraphConvolution(nn.Module):
    """adj @ (dropout(x) @ weight) + bias; weight [in, out] xavier_uniform,
    bias [out] zeros."""

    def __init__(self, ninfeat, noutfeat, dropout, generator):
        super().__init__()
        self.weight = nn.Parameter(init.xavier_uniform((ninfeat, noutfeat),
                                                       generator))
        self.bias = nn.Parameter(init.zeros((noutfeat,), generator.device))
        self.dropout = Dropout(dropout)

    def forward(self, x, adj):
        support = torch.matmul(*promoted(self.dropout(x), self.weight))
        return torch.matmul(*promoted(adj, support)) + self.bias


class GCN(nn.Module):

    def __init__(self, nfield, nfeat, nemb, gcn_layers, gcn_hid, mlp_nlayer,
                 mlp_nhid, dropout, noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.nfield, self.gcn_layers = nfield, gcn_layers
        self.embedding = Embedding(nfeat, nemb, g)
        for l in range(gcn_layers):
            self.add_module(f"gcn_{l}", GraphConvolution(
                nemb if l == 0 else gcn_hid, gcn_hid, dropout, g))
        self.dropout = Dropout(dropout)
        self.affine = MLP(nfield * gcn_hid, mlp_nlayer, mlp_nhid, dropout,
                          noutput, g)

    def forward(self, batch, adj=None):
        h = self.embedding(*split_batch(batch))
        if adj is None:
            adj = torch.ones((self.nfield, self.nfield), dtype=h.dtype,
                             device=h.device)
        adj = normalize_adj(adj)
        for l in range(self.gcn_layers):
            h = F.relu(self.dropout(getattr(self, f"gcn_{l}")(h, adj)))
        return squeeze_logits(self.affine(h.reshape(h.shape[0], -1)))
