"""Pieces shared across the model zoo (port of armnet_tpu/models/common.py)."""

import torch
from torch import nn

from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import MLP, Embedding, promoted

__all__ = ["split_batch", "squeeze_logits", "add_first_order", "DeepEnsemble",
           "VALUE_CLAMP"]

# The ARM/AFN family clamps input values into [1e-3, 1] so the exp/log
# interactions stay bounded (reference armnet_1h.py:81).
VALUE_CLAMP = (1e-3, 1.0)


def split_batch(batch):
    """batch {'id': int [B,F], 'value': float [B,F], ...} -> (ids, values)."""
    return batch["id"], batch["value"]


def squeeze_logits(y):
    """[B, 1] -> [B] (the binary head); a [B, C] head is returned as is."""
    return y.squeeze(-1) if y.ndim == 2 and y.shape[-1] == 1 else y


def add_first_order(y_lin, y_deep):
    """The first-order logit [B] plus the deep head: a [B] head elementwise,
    a [B, C] head with the first-order logit broadcast over the classes."""
    return y_lin + y_deep if y_deep.ndim == 1 else y_lin[:, None] + y_deep


class DeepEnsemble(nn.Module):
    """DNN ensemble tower: its own embedding + MLP, whose logit is combined
    with the main logit by a Linear(2*noutput, noutput) initialized to 0.5
    weights and 0 bias. ens_kernel keeps the JAX [in, out] layout."""

    def __init__(self, nfield, nfeat, nemb, nlayer, nhid, dropout, noutput,
                 generator):
        super().__init__()
        self.deep_embedding = Embedding(nfeat, nemb, generator)
        self.deep_mlp = MLP(nfield * nemb, nlayer, nhid, dropout, noutput,
                            generator)
        dev = generator.device
        self.ens_kernel = nn.Parameter(
            init.constant((2 * noutput, noutput), 0.5, dev))
        self.ens_bias = nn.Parameter(init.zeros((noutput,), dev))

    def forward(self, y, ids, values):
        emb = self.deep_embedding(ids, values)
        y_deep = self.deep_mlp(emb.reshape(emb.shape[0], -1))
        both = torch.cat([y, y_deep], dim=-1)               # [B, 2*noutput]
        return torch.matmul(*promoted(both, self.ens_kernel)) + self.ens_bias
