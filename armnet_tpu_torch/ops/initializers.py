"""Initializers with the reference's PyTorch init semantics (port of
armnet_tpu/ops/initializers.py). Each draws from an explicit
torch.Generator and returns a new float32 tensor on the generator's device.

  * xavier_uniform: torch.nn.init.xavier_uniform_ with gain, including
    torch's fans for >2-D shapes (fan_in = shape[1]*prod(shape[2:]),
    fan_out = shape[0]*prod(shape[2:])).
  * xavier_uniform_stacked: H independent xavier_uniform_ matrices stacked
    on leading axes ([H, in, out]), fans from the trailing two dims only.
  * torch_linear_uniform: nn.Linear's default, U(±1/sqrt(fan_in)) for both
    weight and bias.
"""

import math

import torch

__all__ = ["xavier_uniform", "xavier_uniform_stacked", "torch_linear_uniform",
           "normal_unit", "zeros", "ones", "constant"]


def _torch_fans(shape):
    if len(shape) < 2:
        raise ValueError(f"xavier init needs >=2 dims, got {shape}")
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


def _uniform(shape, bound, generator):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.uniform_(-bound, bound, generator=generator)


def xavier_uniform(shape, generator, gain=1.0):
    fan_in, fan_out = _torch_fans(tuple(shape))
    return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                    generator)


def xavier_uniform_stacked(shape, generator, gain=1.0):
    """Per-matrix xavier_uniform_ of a leading-stacked [..., in, out] shape
    (GAT's per-head W): torch's fans over the whole shape would fold the
    heads into both fans and under-scale every entry by sqrt(H)."""
    if len(shape) < 2:
        raise ValueError(f"xavier init needs >=2 dims, got {shape}")
    fan_in, fan_out = shape[-2], shape[-1]
    return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                    generator)


def torch_linear_uniform(shape, fan_in, generator):
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    return _uniform(shape, bound, generator)


def normal_unit(shape, generator):
    """nn.Embedding's default init, N(0, 1)."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return t.normal_(0.0, 1.0, generator=generator)


def zeros(shape, device=None):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(shape, device=None):
    return torch.ones(shape, dtype=torch.float32, device=device)


def constant(shape, value, device=None):
    return torch.full(shape, float(value), dtype=torch.float32, device=device)
