"""Model registry (port of armnet_tpu/models/__init__.py), with the JAX
factory's mapping of config flags to constructor arguments: `--h` is ARM's
neuron count per head and AFN's afn_hid, `--nattn_head` the ARM heads.
Ported: the ARM family (armnet_1h, armnet, gc_arm), sa_glu and afn; every
other name of the JAX zoo raises NotImplementedError."""

import torch

from armnet_tpu_torch.kernels.config import use_fused_arm
from armnet_tpu_torch.models.afn import AFN, embedding_positivity
from armnet_tpu_torch.models.armnet import ARMNet
from armnet_tpu_torch.models.armnet_1h import ARMNet1H
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.models.gc_arm import GCARM
from armnet_tpu_torch.models.sa_glu import SAGLU

__all__ = ["create_model", "param_transform_for", "MODEL_NAMES", "PORTED",
           "ModelConfig"]

# the JAX package's zoo (armnet_tpu/models/__init__.py MODEL_NAMES)
MODEL_NAMES = ("afm", "afn", "armnet", "armnet_1h", "cin", "dcn", "dcn+",
               "dfm", "dnn", "fm", "gat", "gc_arm", "gcn", "hofm", "ipnn",
               "kpnn", "lr", "nfm", "sa_glu", "wd", "xdfm")

_REGISTRY = {
    "afn": lambda c, g, kernels: AFN(
        c.nfield, c.nfeat, c.nemb, c.h, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.ensemble, c.dnn_nlayer, c.dnn_nhid, c.noutput, generator=g),
    "armnet": lambda c, g, kernels: ARMNet(
        c.nfield, c.nfeat, c.nemb, c.nattn_head, c.alpha, c.h, c.mlp_nlayer,
        c.mlp_nhid, c.dropout, c.ensemble, c.dnn_nlayer, c.dnn_nhid,
        c.noutput, generator=g),
    "armnet_1h": lambda c, g, kernels: ARMNet1H(
        c.nfield, c.nfeat, c.nemb, c.alpha, c.h, c.nemb, c.mlp_nlayer,
        c.mlp_nhid, c.dropout, c.ensemble, c.dnn_nlayer, c.dnn_nhid,
        c.noutput, generator=g, kernels=kernels),
    "gc_arm": lambda c, g, kernels: GCARM(
        c.nfield, c.nfeat, c.nemb, c.nattn_head, c.alpha, c.h, c.mlp_nlayer,
        c.mlp_nhid, c.dropout, c.ensemble, c.dnn_nlayer, c.dnn_nhid,
        c.noutput, generator=g),
    "sa_glu": lambda c, g, kernels: SAGLU(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.ensemble, c.dnn_nlayer, c.dnn_nhid, c.noutput, generator=g),
}
PORTED = tuple(sorted(_REGISTRY))

# stored-parameter mutations that the trainer applies at the head of every
# train step and once before each eval pass (the JAX package's
# param_transform_for; the reference mutates .data each forward)
_PARAM_TRANSFORMS = {"afn": embedding_positivity}


def param_transform_for(name):
    """The in-place mutation model -> None for a model name, or None."""
    return _PARAM_TRANSFORMS.get(name)


def create_model(config, seed=0, device="cpu", kernels="auto"):
    """Build a model from a ModelConfig. Parameters are drawn on the CPU from
    torch.Generator().manual_seed(seed), then moved to `device`. `kernels`
    is the kernel choice (kernels/config.py BACKENDS; ExperimentConfig
    .kernels): 'pallas-fused' runs armnet_1h's interaction through the
    fused kernels; the other models take the per-op kernels under every
    choice, as in the JAX package. It adds no parameter, so a state_dict
    loads under either choice."""
    use_fused_arm(kernels)                     # raises on an unknown name
    name = config.model
    if name not in _REGISTRY:
        if name in MODEL_NAMES:
            raise NotImplementedError(
                f"model {name!r} is not ported yet, see ROADMAP.md "
                f"(ported: {PORTED})")
        raise ValueError(f"unknown model {name!r}; known: {MODEL_NAMES}")
    g = torch.Generator().manual_seed(int(seed))
    return _REGISTRY[name](config, g, kernels).to(device)
