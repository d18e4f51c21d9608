"""Model registry (port of armnet_tpu/models/__init__.py): every name of
the JAX zoo, with the JAX factory's mapping of config flags to constructor
arguments: `--h` is ARM's neuron count per head, AFN's afn_hid, AFM's
attention width, CIN's nfilter and the hidden width of GCN and GAT; `--k`
is HOFM's order and the depth of DCN, CIN, GCN and GAT; `--nattn_head` is
the ARM and GAT heads (GAT's LeakyReLU slope is fixed at 0.2). The models
whose head is a scalar (lr, fm, hofm, afm, dcn, cin) raise ValueError at
noutput > 1."""

import torch

from armnet_tpu_torch.kernels.config import use_fused_arm
from armnet_tpu_torch.models.afm import AFM
from armnet_tpu_torch.models.afn import AFN, embedding_positivity
from armnet_tpu_torch.models.armnet import ARMNet
from armnet_tpu_torch.models.armnet_1h import ARMNet1H
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.models.dcn import DCN, CrossNet
from armnet_tpu_torch.models.dfm import DeepFM
from armnet_tpu_torch.models.dnn import DNN
from armnet_tpu_torch.models.fm import FM
from armnet_tpu_torch.models.gat import GAT
from armnet_tpu_torch.models.gc_arm import GCARM
from armnet_tpu_torch.models.gcn import GCN
from armnet_tpu_torch.models.hofm import HOFM
from armnet_tpu_torch.models.lr import LR
from armnet_tpu_torch.models.nfm import NFM
from armnet_tpu_torch.models.pnn import IPNN, KPNN
from armnet_tpu_torch.models.sa_glu import SAGLU
from armnet_tpu_torch.models.wd import WideDeep
from armnet_tpu_torch.models.xdfm import CIN, XDeepFM
from armnet_tpu_torch.ops.layers import Embedding

__all__ = ["create_model", "param_transform_for", "MODEL_NAMES", "PORTED",
           "ModelConfig"]

# the JAX package's zoo (armnet_tpu/models/__init__.py MODEL_NAMES)
MODEL_NAMES = ("afm", "afn", "armnet", "armnet_1h", "cin", "dcn", "dcn+",
               "dfm", "dnn", "fm", "gat", "gc_arm", "gcn", "hofm", "ipnn",
               "kpnn", "lr", "nfm", "sa_glu", "wd", "xdfm")

_REGISTRY = {
    "lr": lambda c, g, kernels: LR(c.nfeat, generator=g),
    "fm": lambda c, g, kernels: FM(c.nfeat, c.nemb, generator=g),
    "hofm": lambda c, g, kernels: HOFM(c.nfeat, c.nemb, c.k, generator=g),
    "afm": lambda c, g, kernels: AFM(c.nfeat, c.nemb, c.h, c.dropout,
                                     generator=g),
    "dcn": lambda c, g, kernels: CrossNet(c.nfield, c.nfeat, c.nemb, c.k,
                                          generator=g),
    "cin": lambda c, g, kernels: CIN(c.nfield, c.nfeat, c.nemb, c.k, c.h,
                                     generator=g),
    "dnn": lambda c, g, kernels: DNN(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "gcn": lambda c, g, kernels: GCN(
        c.nfield, c.nfeat, c.nemb, c.k, c.h, c.mlp_nlayer, c.mlp_nhid,
        c.dropout, c.noutput, generator=g),
    "gat": lambda c, g, kernels: GAT(
        c.nfield, c.nfeat, c.nemb, c.k, c.h, c.mlp_nlayer, c.mlp_nhid,
        c.dropout, 0.2, c.nattn_head, c.noutput, generator=g),
    "wd": lambda c, g, kernels: WideDeep(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "ipnn": lambda c, g, kernels: IPNN(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "kpnn": lambda c, g, kernels: KPNN(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "nfm": lambda c, g, kernels: NFM(
        c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout, c.noutput,
        generator=g),
    "dfm": lambda c, g, kernels: DeepFM(
        c.nfield, c.nfeat, c.nemb, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "dcn+": lambda c, g, kernels: DCN(
        c.nfield, c.nfeat, c.nemb, c.k, c.mlp_nlayer, c.mlp_nhid, c.dropout,
        c.noutput, generator=g),
    "xdfm": lambda c, g, kernels: XDeepFM(
        c.nfield, c.nfeat, c.nemb, c.k, c.h, c.mlp_nlayer, c.mlp_nhid,
        c.dropout, c.noutput, generator=g),
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

# models whose head is structurally a scalar (first/second-order sums with
# no MLP): binary only, as in the JAX package
_SCALAR_ONLY = frozenset({"lr", "fm", "hofm", "afm", "dcn", "cin"})

# stored-parameter mutations that the trainer applies at the head of every
# train step and once before each eval pass (the JAX package's
# param_transform_for; the reference mutates .data each forward)
_PARAM_TRANSFORMS = {"afn": embedding_positivity}


def param_transform_for(name):
    """The in-place mutation model -> None for a model name, or None."""
    return _PARAM_TRANSFORMS.get(name)


def create_model(config, seed=0, device="cpu", kernels="auto",
                 dtype=torch.float32):
    """Build a model from a ModelConfig. Parameters are drawn on the CPU from
    torch.Generator().manual_seed(seed), then moved to `device`. `kernels`
    is the kernel choice (kernels/config.py BACKENDS; ExperimentConfig
    .kernels): 'pallas-fused' runs armnet_1h's interaction through the
    fused kernels; the other models take the per-op kernels under every
    choice, as in the JAX package. `dtype` is the activation dtype
    (utils.config.compute_dtype: bfloat16 under --bf16): every Embedding
    casts its output to it and the layers below follow their inputs, as
    the JAX package's compute dtype does; parameters stay float32.
    Neither adds a parameter, so a state_dict loads under every choice."""
    use_fused_arm(kernels)                     # raises on an unknown name
    name = config.model
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}; known: {MODEL_NAMES}")
    if config.noutput > 1 and name in _SCALAR_ONLY:
        raise ValueError(
            f"model {name!r} has a scalar head and does not support "
            f"noutput={config.noutput} (multi-class); pick an MLP-headed "
            f"model (e.g. dnn/armnet/armnet_1h/...)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is not float32 or bfloat16")
    g = torch.Generator().manual_seed(int(seed))
    model = _REGISTRY[name](config, g, kernels)
    for m in model.modules():
        if isinstance(m, Embedding):
            m.compute_dtype = dtype
    return model.to(device)
