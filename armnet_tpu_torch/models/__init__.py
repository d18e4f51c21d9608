"""Model registry (port of armnet_tpu/models/__init__.py). Only armnet_1h is
ported; every other name of the JAX zoo raises NotImplementedError."""

import torch

from armnet_tpu_torch.kernels.config import use_fused_arm
from armnet_tpu_torch.models.armnet_1h import ARMNet1H
from armnet_tpu_torch.models.config import ModelConfig

__all__ = ["create_model", "MODEL_NAMES", "PORTED", "ModelConfig"]

# the JAX package's zoo (armnet_tpu/models/__init__.py MODEL_NAMES)
MODEL_NAMES = ("afm", "afn", "armnet", "armnet_1h", "cin", "dcn", "dcn+",
               "dfm", "dnn", "fm", "gat", "gc_arm", "gcn", "hofm", "ipnn",
               "kpnn", "lr", "nfm", "sa_glu", "wd", "xdfm")

_REGISTRY = {
    "armnet_1h": lambda c, g, kernels: ARMNet1H(
        c.nfield, c.nfeat, c.nemb, c.alpha, c.h, c.nemb, c.mlp_nlayer,
        c.mlp_nhid, c.dropout, c.ensemble, c.dnn_nlayer, c.dnn_nhid,
        c.noutput, generator=g, kernels=kernels),
}
PORTED = tuple(sorted(_REGISTRY))


def create_model(config, seed=0, device="cpu", kernels="auto"):
    """Build a model from a ModelConfig. Parameters are drawn on the CPU from
    torch.Generator().manual_seed(seed), then moved to `device`. `kernels`
    is the kernel choice (kernels/config.py BACKENDS; ExperimentConfig
    .kernels): 'pallas-fused' runs armnet_1h's interaction through the
    fused kernels. It adds no parameter, so a state_dict loads under
    either choice."""
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
