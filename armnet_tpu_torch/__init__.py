"""armnet_tpu_torch — the PyTorch/CUDA port of armnet_tpu for NVIDIA Hopper.

Module names mirror armnet_tpu so each file's JAX counterpart is easy to
find; the JAX package stays the reference the port is tested against.

Layers (bottom-up):
  kernels/   hand-written CUDA kernels (csrc/), their builder and wrappers,
             and the plain PyTorch version of each
  ops/       embedding gather, layers, entmax dispatch, ARM and zoo
             interactions, each differentiable (autograd Functions over
             the kernels)
  models/    every model of the JAX zoo (models.MODEL_NAMES)
  data/      libsvm parse, fixed-shape batches, the shuffled train iterator
  train/     losses and metrics, the train/eval step, the epoch loop with
             early stopping, checkpoints, and the training CLI
             (python -m armnet_tpu_torch.train)
  predict    batch scoring of a libsvm file from a checkpoint

Entry points run on the card unless the caller asks for the CPU; kernel
dispatch goes by tensor device (CUDA tensor -> kernel, CPU tensor -> plain
version). They set the f32 GEMM precision from --matmul_precision
(`set_matmul_precision`).
"""

import torch

__version__ = "0.1.0"


def resolve_device(name):
    """torch.device for `name`; raises when CUDA is asked for and absent
    (never carries on on the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            f"pass --device cpu to run on the CPU")
    return device


# --matmul_precision -> whether float32 GEMMs and convolutions may use TF32
_TF32 = {"default": False, "highest": False, "high": True}


def set_matmul_precision(precision):
    """Set the float32 GEMM precision for the process, as the JAX CLI sets
    jax_default_matmul_precision: 'default' and 'highest' keep full f32
    (the port's choice, which its parity tests assume; JAX's 'default' is
    its TPU's bf16 passes, which the card has no counterpart of), 'high'
    allows TF32 in matrix products and convolutions. Any other value
    raises ValueError."""
    if precision not in _TF32:
        raise ValueError(f"--matmul_precision takes {sorted(_TF32)}, got "
                         f"{precision!r}")
    tf32 = _TF32[precision]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
