"""GAT over the field graph (port of armnet_tpu/models/gat.py): k layers
of multi-head additive attention over all F^2 field pairs, each followed
by dropout and ELU, then the MLP (`affine`) over the flattened fields.

The reference's multiplicative mask is kept: the scores are MULTIPLIED by
where(adj > 0, adj, -9e15), so the default all-ones adjacency leaves them
as they are. The heads are one stacked einsum over W [H, in, out]."""

import torch
import torch.nn.functional as F
from torch import nn

from armnet_tpu_torch.models.common import split_batch, squeeze_logits
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import MLP, Dropout, Embedding, promoted

__all__ = ["GraphAttention", "GAT"]


class GraphAttention(nn.Module):
    """[B, F, in] -> [B, F, H * out]. W [H, in, out]: per head a
    xavier_uniform (gain 1.414) matrix; a [H, 2 * out]: per head the
    bias-free Linear(2 * out -> 1) pair scorer, its first half scoring the
    source field and its second the destination."""

    def __init__(self, ninfeat, noutfeat, nhead, dropout, alpha, generator):
        super().__init__()
        self.alpha = alpha
        self.W = nn.Parameter(init.xavier_uniform_stacked(
            (nhead, ninfeat, noutfeat), generator, gain=1.414))
        self.a = nn.Parameter(init.torch_linear_uniform(
            (nhead, 2 * noutfeat), 2 * noutfeat, generator))
        self.dropout = Dropout(dropout)

    def forward(self, x, adj):
        nout = self.W.shape[-1]
        h = torch.einsum("bfi,hio->bhfo", *promoted(x, self.W))  # [B,H,F,out]
        e_src = torch.einsum("bhfo,ho->bhf", h, self.a[:, :nout])
        e_dst = torch.einsum("bhfo,ho->bhf", h, self.a[:, nout:])
        e = F.leaky_relu(e_src[..., None] + e_dst[:, :, None, :],
                         negative_slope=self.alpha)               # [B,H,F,F]
        mask = torch.where(adj > 0, adj, torch.full_like(adj, -9e15))
        attn = self.dropout(torch.softmax(e * mask, dim=-1))
        out = torch.matmul(attn, h)                               # [B,H,F,out]
        return out.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)


class GAT(nn.Module):

    def __init__(self, nfield, nfeat, nemb, gat_layers, gat_hid, mlp_nlayer,
                 mlp_nhid, dropout, alpha=0.2, nhead=8, noutput=1,
                 generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.nfield, self.gat_layers = nfield, gat_layers
        self.embedding = Embedding(nfeat, nemb, g)
        for l in range(gat_layers):
            self.add_module(f"gat_{l}", GraphAttention(
                nemb if l == 0 else nhead * gat_hid, gat_hid, nhead, dropout,
                alpha, g))
        self.dropout = Dropout(dropout)
        self.affine = MLP(nfield * nhead * gat_hid, mlp_nlayer, mlp_nhid,
                          dropout, noutput, g)

    def forward(self, batch, adj=None):
        h = self.embedding(*split_batch(batch))
        if adj is None:
            adj = torch.ones((self.nfield, self.nfield), dtype=h.dtype,
                             device=h.device)
        for l in range(self.gat_layers):
            h = F.elu(self.dropout(getattr(self, f"gat_{l}")(h, adj)))
        return squeeze_logits(self.affine(h.reshape(h.shape[0], -1)))
