"""AFN (port of armnet_tpu/models/afn.py): the log of a positive embedding,
a learned F -> h linear in log space, exp back, BatchNorm at both ends,
then the MLP and the optional DNN ensemble.

Positivity, as in the reference (torch, in place under no_grad each
forward) and the JAX package: the trainer applies `embedding_positivity`
to the STORED table at the head of every train step and once before each
eval pass, so gradients and Adam act on |W| clamped at 1e-4 with identity
geometry. The forward keeps a clamp-abs, where(|W| >= 1e-4, |W|, 1e-4),
so that a model scored without the trainer sees the same values; `where`
rather than a max gives a weight AT the boundary gradient 1, as torch's
in-place mutation does (a max would split it). The gathered rows come
from that elementwise result, so the table-gradient kernel's dense
gradient flows on through where and abs to the table.

The table is a top-level parameter `embedding` [nfeat, nemb], as in the
JAX tree (flat [nfeat * nemb] there past 512 rows; the bridge reshapes)."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (VALUE_CLAMP, DeepEnsemble,
                                            split_batch, squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.embedding import embedding_bag
from armnet_tpu_torch.ops.layers import MLP, BatchNorm, Dropout

__all__ = ["embedding_positivity", "AFN", "POSITIVE_MIN"]

POSITIVE_MIN = 1e-4


@torch.no_grad()
def embedding_positivity(model):
    """The stored main table becomes max(|W|, 1e-4), in place (the
    ensemble's deep table is untouched, as in the reference)."""
    model.embedding.abs_().clamp_min_(POSITIVE_MIN)


class AFN(nn.Module):

    table_name = "embedding"          # gathered through self.lookup

    def __init__(self, nfield, nfeat, nemb, afn_hid, mlp_nlayer, mlp_nhid,
                 dropout, ensemble, deep_nlayer, deep_nhid, noutput=1,
                 generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = nn.Parameter(init.xavier_uniform((nfeat, nemb), g))
        self.lookup = embedding_bag       # the trainer may shard the table
        self.emb_bn = BatchNorm(nfield, channel_axis=1, device=g.device)
        self.afn_kernel = nn.Parameter(
            init.normal_unit((nfield, afn_hid), g) * 0.1)
        self.afn_bias = nn.Parameter(init.zeros((afn_hid,), g.device))
        self.afn_bn = BatchNorm(afn_hid, channel_axis=1, device=g.device)
        self.dropout = Dropout(dropout)
        self.mlp = MLP(afn_hid * nemb, mlp_nlayer, mlp_nhid, dropout,
                       noutput, g)
        self.ensemble = (DeepEnsemble(nfield, nfeat, nemb, deep_nlayer,
                                      deep_nhid, dropout, noutput, g)
                         if ensemble else None)

    def forward(self, batch):
        ids, values = split_batch(batch)
        values = values.clamp(*VALUE_CLAMP)
        pos_abs = self.embedding.abs()
        table = torch.where(pos_abs >= POSITIVE_MIN, pos_abs, POSITIVE_MIN)
        emb = self.lookup(table, ids, values)                    # [B, F, E]
        x_log = self.emb_bn(torch.log(emb)).transpose(1, 2)      # [B, E, F]
        afn = torch.exp(torch.matmul(x_log, self.afn_kernel) + self.afn_bias)
        afn = self.afn_bn(afn.transpose(1, 2))                   # [B, h, E]
        y = self.mlp(self.dropout(afn.reshape(afn.shape[0], -1)))
        if self.ensemble is not None:
            y = self.ensemble(y, ids, values)
        return squeeze_logits(y)
