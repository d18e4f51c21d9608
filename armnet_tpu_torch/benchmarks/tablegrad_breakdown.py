"""The embedding-table gradient's path split (the counterpart of the JAX
package's benchmarks/tablegrad_breakdown.py) at the Criteo recipe's shape:
N = 4096 * 39 updates of E 10 into a [2.1M, 10] table.

    python -m armnet_tpu_torch.benchmarks.tablegrad_breakdown
        [--warm 3] [--steps 10] [--reps 3] [--device cuda]

  argsort      the table gradient kernel's stable radix sort alone
               (kernels/scatter_cuda.sort_ids: sorted keys and the
               permutation), a stable torch.argsort timed beside it
  sort_gather  + g[perm] (the sorted payload) beside the sorted ids
  full         the whole table gradient, kernels/scatter_cuda.table_grad
               (sort, zero fill, segmented sums: K7)

On the CPU each stage takes the plain versions (sort_ids_plain,
table_grad_plain), as ops/embedding does. ids and g are drawn by
RandomState(0) as the JAX script draws them. Timing: benchmarks/timing.py.
stdout: one JSON line per stage (argsort's with the torch.argsort record
under `beside`); stderr: the JAX script's table.
"""

import argparse

import numpy as np
import torch

from armnet_tpu_torch import resolve_device
from armnet_tpu_torch.benchmarks.timing import add_timing_args, run_stages
from armnet_tpu_torch.kernels import scatter_cuda
from armnet_tpu_torch.ops.entmax import pick

__all__ = ["N", "E", "NROWS", "STAGES", "inputs", "grad_fn", "stages",
           "main"]

N = 4096 * 39
E = 10
NROWS = 2_100_000
STAGES = ("argsort", "sort_gather", "full")


def inputs(n=N, e=E, nrows=NROWS, device="cpu"):
    """(ids int32 [n], g float32 [n, e]) of the JAX script's draws from
    RandomState(0), on `device`."""
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, nrows, (n,)).astype(np.int32))
    g = torch.from_numpy(rng.randn(n, e).astype(np.float32))
    return ids.to(device), g.to(device)


def grad_fn(device):
    """The table gradient kernel on the card, its plain version on the
    CPU."""
    return pick(device, scatter_cuda.table_grad,
                scatter_cuda.table_grad_plain, "table_grad")


def stages(ids, g, nrows=NROWS):
    """((name, fn), ...) of STAGES: fn() returns the stage's outputs."""
    sort = pick(ids.device, scatter_cuda.sort_ids,
                scatter_cuda.sort_ids_plain, "sort_ids")
    grad = grad_fn(ids.device)

    def sort_gather():
        sid, perm = sort(ids, nrows)
        return sid, g[perm]

    table = {"argsort": lambda: sort(ids, nrows),
             "sort_gather": sort_gather,
             "full": lambda: (grad(g, ids, nrows),)}
    return tuple((name, table[name]) for name in STAGES)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="the table gradient's sort, gather and whole call (one "
                    "JSON line per stage)")
    add_timing_args(p, warm=3, steps=10, reps=3, kernels=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    ids, g = inputs(device=device)
    beside = ("torch.argsort(ids, stable=True)",
              lambda: torch.argsort(ids, stable=True))
    run_stages(stages(ids, g, NROWS), device, args.warm, args.steps,
               args.reps, beside={"argsort": beside}, n=N, e=E, nrows=NROWS)


if __name__ == "__main__":
    main()
