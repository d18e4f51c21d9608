"""Kernel choice (port of armnet_tpu/kernels/config.py), without its
thread-local global: the choice travels explicitly, from
ExperimentConfig.kernels through models.create_model into the ARM layer.

  auto, pallas   the per-op kernels: the entmax kernel inside the composed
                 ARM-1h chain (GEMMs, entmax, einsum, exp)
  pallas-fused   the ARM-1h interaction as one fused kernel pair
                 (kernels/arm_cuda.py, csrc/arm1h.cu, arm1h_bwd.cu), for a
                 static alpha > 1
  xla            the JAX package's pure-XLA path; the CLI refuses it (on
                 the card every path runs this repository's kernels)

Which of kernel or plain version a tensor takes still follows its device.
"""

__all__ = ["BACKENDS", "use_fused_arm"]

BACKENDS = ("auto", "xla", "pallas", "pallas-fused")


def use_fused_arm(name):
    """True for the fused ARM-1h kernels ('pallas-fused')."""
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel choice {name!r}; known: {BACKENDS}")
    return name == "pallas-fused"
