"""Weight bridge from the JAX package's flax trees to the port's state_dict.

`flat` maps flax keys joined by '/' ('params/mlp/TorchLinear_0/kernel',
'batch_stats/arm_bn/BatchNorm_0/mean', ...) to numpy arrays. The renames:

  TorchLinear_i/kernel [in, out]   -> linears.i.weight [out, in] (transposed)
  BatchNorm_i/BatchNorm_0/...      -> norms.i.{weight, bias, running_*}
  <bn>/BatchNorm_0/scale|mean|var  -> <bn>.weight|running_mean|running_var
  <table>/embedding [R*E] or [R,E] -> <table>.weight [R, E]
  embedding (a top-level table, AFN)  -> embedding [R, E]

Every other leaf (bilinear_w, query, values, ens_kernel, ...) keeps its
name and layout. Raises on a JAX leaf it does not consume and on a port
parameter or buffer it does not fill.

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
    if leaf == "kernel" and mods and mods[-1].startswith("TorchLinear_"):
        return ".".join(path + ["weight"]), "transpose"
    if leaf == "embedding":
        return ".".join(path + ["weight"]) if path else leaf, "table"
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
        elif kind == "table":
            t = t.reshape(-1, cfg.nemb)
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
