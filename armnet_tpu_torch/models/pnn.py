"""Product-based NNs (port of armnet_tpu/models/pnn.py): the inner
products of the F(F-1)/2 field pairs (IPNN), or their products through a
learned kernel [E, P, E] (KPNN), concatenated with the flattened
embeddings into the MLP."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch, squeeze_logits
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import MLP, Embedding, promoted

__all__ = ["IPNN", "KPNN"]


class IPNN(nn.Module):

    def __init__(self, nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                 noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        npair = nfield * (nfield - 1) // 2
        self.embedding = Embedding(nfeat, nemb, g)
        self.mlp = MLP(nfield * nemb + npair, mlp_nlayer, mlp_nhid, dropout,
                       noutput, g)

    def pair_products(self, ei, ej):
        return (ei * ej).sum(-1)                                 # [B, P]

    def forward(self, batch):
        emb = self.embedding(*split_batch(batch))
        vi, vj = torch.triu_indices(emb.shape[1], emb.shape[1], 1,
                                    device=emb.device)
        x = torch.cat([emb.reshape(emb.shape[0], -1),
                       self.pair_products(emb[:, vi], emb[:, vj])], dim=1)
        return squeeze_logits(self.mlp(x))


class KPNN(IPNN):
    """IPNN with the pair products through kernel [E, P, E],
    xavier_uniform with torch's fans of that shape."""

    def __init__(self, nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                 noutput=1, generator=None):
        g = generator if generator is not None else torch.Generator()
        super().__init__(nfield, nfeat, nemb, mlp_nlayer, mlp_nhid, dropout,
                         noutput, g)
        npair = nfield * (nfield - 1) // 2
        self.kernel = nn.Parameter(init.xavier_uniform((nemb, npair, nemb),
                                                       g))

    def pair_products(self, ei, ej):
        return torch.einsum("bki,ikj,bkj->bk",
                            *promoted(ei, self.kernel, ej))
