"""The port's measurement harness (counterparts of the JAX package's root
bench.py and benchmarks/ scripts). Each script is run as
python -m armnet_tpu_torch.benchmarks.<name>, on the card unless given
--device cpu.

  timing          the shared helpers: the bench batch and its shifted ids,
                  wall time of warm steps between two syncs, the profiled
                  repetition (device ms and kernel calls per step), the
                  card's name, power limit and clocks, the stage runner of
                  the breakdowns below
  step_breakdown  nested subsets of the train step, host wall beside
                  device time
  recipes         the train step of every published recipe family
  mh_breakdown    the multi-head ARM interaction [4096, 4, 64, 39] stage
                  by stage (the entmax kernels on its last axis: K1, K3)
  tablegrad_breakdown   the table gradient's sort, gather and whole call
  tablegrad_prep_bench  the table gradient's preparation stage by stage
                  and the kernel's own split (K7)
  fastpow_accuracy      the entmax solver's error per fastpow budget against
                  the 50-iteration bisection, the plain solver and, on the
                  card, the forward kernel against its newton build
  paired_ab       a command's A, B, A, B runs in turns, the median ratio
  scaling         train-step examples/s against the number of devices

The headline is armnet_tpu_torch/bench.py (python -m armnet_tpu_torch.bench).
"""
