"""CIN and xDeepFM (port of armnet_tpu/models/xdfm.py): the compressed
interaction network, per layer an outer product over fields compressed by
a 1x1 convolution (filter_k [F * C_prev, nfilter], as a matmul) and ReLU
(ops/interaction's compressed_interaction_step: the fused CIN kernels on
the card in full float32, else the blocked plain route), each layer's
output sum-pooled over E and the pools projected by the bias-free
`affine`; plus the first-order term (`cin`), and the MLP over the
flattened embeddings (`xdfm`)."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import (add_first_order, split_batch,
                                            squeeze_logits)
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.interaction import compressed_interaction_step
from armnet_tpu_torch.ops.layers import (MLP, Embedding, FeaturesLinear,
                                         TorchLinear)

__all__ = ["CompressedInteraction", "CIN", "XDeepFM"]


class CompressedInteraction(nn.Module):
    """[B, F, E] -> [B]; filter_k with nn.Linear's (Conv1d's) init over
    its F * C_prev inputs."""

    def __init__(self, nfield, nlayers, nfilter, generator):
        super().__init__()
        self.nlayers = nlayers
        n_prev = nfield
        for k in range(nlayers):
            self.register_parameter(f"filter_{k}", nn.Parameter(
                init.torch_linear_uniform((nfield * n_prev, nfilter),
                                          nfield * n_prev, generator)))
            n_prev = nfilter
        self.affine = TorchLinear(nlayers * nfilter, 1, generator,
                                  bias=False)

    def forward(self, x):
        pooled, xk = [], x
        for k in range(self.nlayers):
            xk = compressed_interaction_step(x, xk,
                                             getattr(self, f"filter_{k}"), k)
            pooled.append(xk.sum(-1))                      # [B, nfilter]
        return self.affine(torch.cat(pooled, dim=1)).squeeze(-1)


class CIN(nn.Module):
    """CIN without the deep tower (registry name `cin`)."""

    def __init__(self, nfield, nfeat, nemb, cin_layers, nfilter,
                 generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.linear = FeaturesLinear(nfeat, g)
        self.cin = CompressedInteraction(nfield, cin_layers, nfilter, g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        emb = self.embedding(ids, values)
        return self.linear(ids, values) + self.cin(emb)


class XDeepFM(nn.Module):
    """xDeepFM: the first-order term + CIN + the MLP (registry name
    `xdfm`)."""

    def __init__(self, nfield, nfeat, nemb, cin_layers, nfilter, mlp_nlayer,
                 mlp_nhid, dropout, noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.linear = FeaturesLinear(nfeat, g)
        self.cin = CompressedInteraction(nfield, cin_layers, nfilter, g)
        self.mlp = MLP(nfield * nemb, mlp_nlayer, mlp_nhid, dropout, noutput,
                       g)

    def forward(self, batch):
        ids, values = split_batch(batch)
        emb = self.embedding(ids, values)
        y = self.linear(ids, values) + self.cin(emb)
        return add_first_order(y, squeeze_logits(
            self.mlp(emb.reshape(emb.shape[0], -1))))
