"""The port's step-level measurement harness (counterparts of the JAX
package's root bench.py and benchmarks/ scripts).

  timing          the shared helpers: the bench batch and its shifted ids,
                  wall time of warm steps between two syncs, the profiled
                  repetition (device ms and kernel launches per step), the
                  card's name, power limit and clocks
  step_breakdown  nested subsets of the train step, host wall beside
                  device time (python -m armnet_tpu_torch.benchmarks
                  .step_breakdown)
  recipes         the train step of every published recipe family
                  (python -m armnet_tpu_torch.benchmarks.recipes)

The headline is armnet_tpu_torch/bench.py (python -m armnet_tpu_torch.bench).
"""
