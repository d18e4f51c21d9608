"""Deep & Cross Network (port of armnet_tpu/models/dcn.py): k cross layers
x0 * (x @ w_l) + b_l + x over the flattened embeddings, without (`dcn`,
CrossNet) and with (`dcn+`, DCN) a parallel MLP. dcn+'s MLP outputs
mlp_nhid, not 1, before the bias-free projection `w` of the
concatenation (reference dcn.py:62)."""

import torch
from torch import nn

from armnet_tpu_torch.models.common import split_batch, squeeze_logits
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.interaction import cross_layer
from armnet_tpu_torch.ops.layers import MLP, Embedding, TorchLinear

__all__ = ["CrossNetwork", "CrossNet", "DCN"]


class CrossNetwork(nn.Module):
    """w_l [ninput, 1] with nn.Linear's init, b_l [ninput] zeros."""

    def __init__(self, ninput, nlayers, generator):
        super().__init__()
        self.nlayers = nlayers
        for l in range(nlayers):
            self.register_parameter(f"w_{l}", nn.Parameter(
                init.torch_linear_uniform((ninput, 1), ninput, generator)))
            self.register_parameter(f"b_{l}", nn.Parameter(
                init.zeros((ninput,), generator.device)))

    def forward(self, x):
        x0 = x
        for l in range(self.nlayers):
            x = cross_layer(x0, x, getattr(self, f"w_{l}"),
                            getattr(self, f"b_{l}"))
        return x


class CrossNet(nn.Module):
    """DCN without the deep tower (registry name `dcn`)."""

    def __init__(self, nfield, nfeat, nemb, cn_layers, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.embedding = Embedding(nfeat, nemb, g)
        self.cross_net = CrossNetwork(nfield * nemb, cn_layers, g)
        self.w = TorchLinear(nfield * nemb, 1, g, bias=False)

    def forward(self, batch):
        emb = self.embedding(*split_batch(batch))
        xl = self.cross_net(emb.reshape(emb.shape[0], -1))
        return squeeze_logits(self.w(xl))


class DCN(nn.Module):
    """DCN with a deep tower (registry name `dcn+`): cross || MLP -> w."""

    def __init__(self, nfield, nfeat, nemb, cn_layers, mlp_nlayer, mlp_nhid,
                 dropout, noutput=1, generator=None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        ninput = nfield * nemb
        self.embedding = Embedding(nfeat, nemb, g)
        self.cross_net = CrossNetwork(ninput, cn_layers, g)
        self.mlp = MLP(ninput, mlp_nlayer, mlp_nhid, dropout, mlp_nhid, g)
        self.w = TorchLinear(ninput + mlp_nhid, noutput, g, bias=False)

    def forward(self, batch):
        emb = self.embedding(*split_batch(batch))
        x = emb.reshape(emb.shape[0], -1)
        y = self.w(torch.cat([self.cross_net(x), self.mlp(x)], dim=1))
        return squeeze_logits(y)
