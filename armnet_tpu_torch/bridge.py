"""Weight bridge from the JAX package's flax trees to the port's state_dict.

`flat` maps flax keys joined by '/' ('params/mlp/TorchLinear_0/kernel',
'batch_stats/arm_bn/BatchNorm_0/mean', ...) to numpy arrays. The renames:

  TorchLinear_i/kernel [in, out]   -> linears.i.weight [out, in] (transposed)
  <linear>/kernel [in, out]        -> <linear>.weight [out, in] (a TorchLinear
                                      named in the JAX model: dcn's `w`,
                                      afm's attn_*, cin's `affine`)
  BatchNorm_i/BatchNorm_0/...      -> norms.i.{weight, bias, running_*}
  <bn>/BatchNorm_0/scale|mean|var  -> <bn>.weight|running_mean|running_var
  <table>/embedding [R*E] or [R,E] -> <table>.weight [R, E] (HOFM's E is
                                      nemb * (k - 1))
  embedding (a top-level table, AFN)  -> embedding [R, E]
  linear/weight [R] or [R, 1]      -> linear.weight [R, 1] (FeaturesLinear,
                                      flat in the JAX tree past 512 rows)

Every other leaf (bilinear_w, query, values, ens_kernel, KPNN's kernel,
GAT's W and a, DCN's w_l and b_l, CIN's filter_k, ...) keeps its name and
layout. Raises on a JAX leaf it does not consume, on a port parameter or
buffer it does not fill, and on a leaf of another shape than the port's
(a table in either of its JAX layouts).

`params_from_jax` carries a tree shaped like `params` alone (gradients,
Adam moments) to a {port parameter name: tensor} dict with the same renames.
"""

import numpy as np
import torch

from armnet_tpu_torch.models import create_model

__all__ = ["from_jax_arrays", "params_from_jax", "flatten_flax"]

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var"}


def flatten_flax(tree, prefix=""):
    """Nested dict of arrays (a flax variables tree) -> {'a/b/c': array}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_flax(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _port_key(jax_key):
    """flax key -> (port state_dict key, leaf kind)."""
    collection, *mods, leaf = jax_key.split("/")
    if collection not in ("params", "batch_stats"):
        raise KeyError(f"unexpected flax collection in {jax_key!r}")
    path = []
    for i, m in enumerate(mods):
        if m.startswith("TorchLinear_"):
            path += ["linears", m.split("_")[1]]
        elif m == "BatchNorm_0" and i == len(mods) - 1:
            continue                     # the inner torch-exact BN core
        elif m.startswith("BatchNorm_"):
            path += ["norms", m.split("_")[1]]
        else:
            path.append(m)
    if leaf == "kernel" and mods:
        return ".".join(path + ["weight"]), "transpose"
    if leaf == "embedding":
        return ".".join(path + ["weight"]) if path else leaf, "table"
    if leaf == "weight" and mods == ["linear"]:
        return "linear.weight", "table"
    return ".".join(path + [_LEAF.get(leaf, leaf)]), "copy"


def _convert(flat, cfg, expected):
    out = {}
    for jax_key, arr in flat.items():
        key, kind = _port_key(jax_key)
        if key not in expected:
            raise KeyError(f"JAX leaf {jax_key!r} maps to {key!r}, which the "
                           f"port's {cfg.model} does not have")
        if key in out:
            raise KeyError(f"two JAX leaves map to {key!r}")
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if kind == "transpose":
            t = t.t().contiguous()
        elif kind == "table" and t.ndim == 1 and (
                t.numel() == expected[key].numel()):
            t = t.reshape(expected[key].shape)        # the flat JAX layout
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(f"{jax_key!r} -> {key!r}: shape {tuple(t.shape)}"
                             f" != port {tuple(expected[key].shape)}")
        out[key] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"port parameters/buffers not filled by the JAX tree: "
                       f"{missing}")
    return out


def from_jax_arrays(flat, cfg):
    """Port state_dict for the model `cfg` describes, filled from `flat`."""
    return _convert(flat, cfg, create_model(cfg).state_dict())


def params_from_jax(tree, cfg):
    """{port parameter name: tensor} from a params-shaped JAX tree (nested
    or flattened without the 'params/' collection): gradients or Adam
    moments, for comparison key by key."""
    return _convert({f"params/{k}": v for k, v in flatten_flax(tree).items()},
                    cfg,
                    dict(create_model(cfg).named_parameters()))
