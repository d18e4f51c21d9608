"""Accuracy of the entmax solver per fastpow budget (N_FAST, N_POLISH), the
counterpart of the JAX package's benchmarks/fastpow_accuracy.py.

    python -m armnet_tpu_torch.benchmarks.fastpow_accuracy [--device cuda]

Each solver's max |p - p_ref| against the 50-iteration bisection (the
port's ops/entmax bisection of a tensor alpha, entmax_alpha_forward, n_iter
50: torch ops on either device; alpha in float64, so that alpha - 1, its
inverse and (1/d)^(alpha-1) round to float32 as the JAX reference's python
floats do) over random and adversarial gates at [39, 4096] (axis 0),
drawn by RandomState(0) as the JAX script draws them (`randn`; `tied`:
equal maxima put the support boundary on an input kink; `kink`: one
dominant logit over a cluster at the threshold; `large`: logits x 30), at
alpha in ALPHAS.

The pass rule is the JAX script's: large logits condition the tau solve
so that any converged solver is ~5e-6 from the reference in f32, so a
budget passes where its worst error is within REL of the worst of the
newton solver (8 bisections, 6 Newton steps) on the same cases: the bar
is REL x newton's worst over every alpha and case, and each alpha's worst
is held to it (ok_by_alpha). Against newton's worst at its own alpha the
fastpow budgets read higher at alpha 1.3 (the kink case), in the JAX
script's solver as in the port's; newton_worst_by_alpha says by how
much.

  plain    kernels/entmax_common.solve_entmax_axis0, the kernels' plain
           version, at each of BUDGETS, the newton baseline at (8, 6)
           (solver and budgets are keyword arguments there, where the JAX
           package reads them from the environment at import)
  kernel   the card only: the entmax forward kernel (entmax_cuda
           .entmax_kernel(x, alpha, axis=0)) at its compiled budget
           (12, 4), against the newton build of the same kernel
           (csrc/entmax_newton.cu, solver="newton"), whose entry takes
           alpha as an argument

stdout: one JSON line per solver and budget ({solver, budget, worst,
rows: [{alpha, case, maxerr}], bar, ok}, and for the kernel ok_by_alpha),
then a summary line; stderr: the JAX script's table.
"""

import argparse
import json
import sys

import numpy as np
import torch

from armnet_tpu_torch import resolve_device
from armnet_tpu_torch.kernels import entmax_cuda
from armnet_tpu_torch.kernels.entmax_common import (N_BISECT, N_FAST,
                                                    N_NEWTON, N_POLISH,
                                                    solve_entmax_axis0)
from armnet_tpu_torch.ops.entmax import entmax_alpha_forward

__all__ = ["BUDGETS", "REL", "ALPHAS", "SHAPE", "NEWTON", "KERNEL_BUDGET",
           "cases", "reference", "plain_solver", "kernel_solver", "sweep",
           "main"]

BUDGETS = [(8, 2), (10, 3), (12, 4), (14, 5)]
REL = 1.2      # pass bar: worst error within this factor of newton's worst
ALPHAS = (1.3, 1.7, 1.9)
SHAPE = (39, 4096)
NEWTON = (N_BISECT, N_NEWTON)            # the newton baseline's budget
KERNEL_BUDGET = (N_FAST, N_POLISH)       # csrc/entmax_solver.cuh's


def cases(shape=SHAPE, device="cpu"):
    """{name: float32 [F, N]} of the JAX script's draws from
    RandomState(0), in its order."""
    f, n = shape
    rng = np.random.RandomState(0)
    out = {
        "randn": rng.randn(f, n).astype(np.float32) * 3.0,
        "tied": np.repeat(rng.randn(f // 3 + 1, n).astype(np.float32),
                          3, axis=0)[:f] * 2.0,
        "kink": np.concatenate(
            [rng.randn(1, n).astype(np.float32) + 4.0,
             rng.randn(f - 1, n).astype(np.float32) * 1e-3], 0),
        "large": rng.randn(f, n).astype(np.float32) * 30.0,
    }
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def reference(x, alpha):
    """The 50-iteration bisection over axis 0 of a float32 x: ops/entmax's
    bisection of a tensor alpha (no budget, no kernel), alpha in float64."""
    a = torch.tensor(alpha, dtype=torch.float64, device=x.device)
    return entmax_alpha_forward(x.t(), a, 50).t()


def plain_solver(solver, n_fast=N_FAST, n_polish=N_POLISH):
    """solve(x, alpha) of the plain solver: `solver` 'fastpow' at the
    budget (n_fast, n_polish), or 'newton' at NEWTON."""
    def solve(x, alpha):
        return solve_entmax_axis0(x, alpha, solver=solver, n_fast=n_fast,
                                  n_polish=n_polish, n_bisect=NEWTON[0],
                                  n_newton=NEWTON[1])
    return solve


def kernel_solver(solver):
    """solve(x, alpha) of the forward kernel's `solver` build, over axis 0."""
    return lambda x, alpha: entmax_cuda.entmax_kernel(x, alpha, 0,
                                                      solver=solver)


def sweep(solve, xs, refs, alphas=ALPHAS):
    """{worst, rows: [{alpha, case, maxerr}]} of solve(x, alpha) against
    refs[(alpha, case)] over the cases xs."""
    rows = []
    for alpha in alphas:
        for name, x in xs.items():
            err = float((solve(x, alpha) - refs[alpha, name]).abs().max())
            rows.append({"alpha": alpha, "case": name, "maxerr": err})
    return {"worst": max(r["maxerr"] for r in rows), "rows": rows}


def _worst_by_alpha(rec):
    out = {}
    for r in rec["rows"]:
        out[r["alpha"]] = max(out.get(r["alpha"], 0.0), r["maxerr"])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(
        description="the entmax solver's error per fastpow budget against "
                    "the 50-iteration bisection (one JSON line per budget)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without CUDA) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    xs = cases(SHAPE, device)
    refs = {(a, n): reference(x, a) for a in ALPHAS for n, x in xs.items()}

    def emit(rec):
        print(json.dumps({"device": device.type, **rec}), flush=True)

    base = {"solver": "plain_newton", "budget": list(NEWTON),
            **sweep(plain_solver("newton"), xs, refs)}
    bar = base["worst"] * REL
    emit(base)
    print(f"newton {NEWTON} production baseline: worst maxerr "
          f"{base['worst']:.2e} -> pass bar {bar:.2e}", file=sys.stderr)
    results = []
    for nf, npol in BUDGETS:
        rec = {"solver": "plain_fastpow", "budget": [nf, npol],
               **sweep(plain_solver("fastpow", nf, npol), xs, refs)}
        rec.update(bar=bar, ok=rec["worst"] <= bar)
        results.append(rec)
        emit(rec)
        print(f"  fastpow({nf:2d},{npol}): worst maxerr {rec['worst']:.2e} "
              f"{'OK' if rec['ok'] else 'WORSE THAN NEWTON'}",
              file=sys.stderr)
    passing = [r for r in results if r["ok"]]
    if passing:
        print(f"smallest newton-equivalent budget: "
              f"({passing[0]['budget'][0]},{passing[0]['budget'][1]}) at "
              f"{passing[0]['worst']:.2e}", file=sys.stderr)
    summary = {"metric": "fastpow_accuracy", "device": device.type,
               "newton_worst": base["worst"], "bar": bar,
               "smallest_passing": passing[0]["budget"] if passing else None}
    if device.type == "cuda":
        kbase = {"solver": "kernel_newton", "budget": list(NEWTON),
                 "build": "csrc/entmax_newton.cu at each alpha",
                 **sweep(kernel_solver("newton"), xs, refs)}
        emit(kbase)
        kern = {"solver": "kernel_fastpow", "budget": list(KERNEL_BUDGET),
                "build": "csrc/entmax_fastpow.cu",
                **sweep(kernel_solver("fastpow"), xs, refs)}
        kbar = kbase["worst"] * REL
        kern.update(bar=kbar, ok=kern["worst"] <= kbar,
                    ok_by_alpha={a: w <= kbar for a, w in
                                 _worst_by_alpha(kern).items()},
                    newton_worst_by_alpha=_worst_by_alpha(kbase))
        emit(kern)
        print(f"kernel newton{NEWTON}: worst {kbase['worst']:.2e}; kernel "
              f"fastpow{KERNEL_BUDGET}: worst {kern['worst']:.2e} "
              f"{'OK' if kern['ok'] else 'WORSE THAN NEWTON'}",
              file=sys.stderr)
        summary.update(kernel_newton_worst=kbase["worst"],
                       kernel_worst=kern["worst"], kernel_ok=kern["ok"],
                       kernel_ok_by_alpha=kern["ok_by_alpha"])
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
