"""Where the train step's time goes (the counterpart of the JAX package's
benchmarks/step_breakdown.py): host wall and device time of nested subsets
of the bench's step at the Criteo width.

    python -m armnet_tpu_torch.benchmarks.step_breakdown
        [--model armnet_1h|armnet|gc_arm] [--kernels auto|pallas-fused]
        [--warm 20] [--steps 100] [--reps 5] [--device cuda]

  fwd            forward only: eval mode, under inference_mode
  fwd_bwd_dense  + the train-mode forward (masked BatchNorm statistics),
                 the masked BCE and the backward of every parameter but
                 the tables (the parameters whose names hold 'embedding',
                 frozen for the subset and restored after): no table
                 gradient (K7)
  fwd_bwd        + the tables' gradient (K7)
  no_metrics     + the elementwise clamp and Adam
  full           + the AUC and the meters: the trainer's make_train_step(),
                 the bench's step (armnet_tpu_torch/bench.py)

Every subset runs on a fresh model from the bench's seed and the bench's
batch, its ids shifted every step, and is built from the train step's own
pieces (train/step.py: forward_loss, task_fns, clamp_grads,
make_optimizer), so each adds to the one before it what its name says and
nothing else. Timing as the bench's (benchmarks/timing.py). stdout: one
JSON line per subset; stderr: the JAX script's table (ms per step and the
increment over the subset before) with the device ms and the host share,
1 less device over wall, beside it.
"""

import argparse
import contextlib
import itertools
import json
import sys

import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.bench import BATCH, LR, SEED, BenchStep
from armnet_tpu_torch.benchmarks.timing import (add_timing_args, bench_batch,
                                                measure, shift_ids)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.step import (clamp_grads, forward_loss,
                                         make_optimizer, task_fns)

__all__ = ["CONFIGS", "SUBSETS", "tables", "frozen", "subset_step",
           "measure_subset", "breakdown", "main"]

# Criteo-geometry recipes (reference run.sh:17-19); gc_arm shares armnet's.
CONFIGS = {
    "armnet_1h": dict(model="armnet_1h", nfeat=2_100_000, nfield=39, nemb=10,
                      h=128, mlp_nlayer=2, mlp_nhid=500, alpha=2.0),
    "armnet": dict(model="armnet", nfeat=2_100_000, nfield=39, nemb=10,
                   h=64, nattn_head=4, mlp_nlayer=2, mlp_nhid=500, alpha=2.0),
    "gc_arm": dict(model="gc_arm", nfeat=2_100_000, nfield=39, nemb=10,
                   h=64, nattn_head=4, mlp_nlayer=2, mlp_nhid=500, alpha=2.0),
}
SUBSETS = ("fwd", "fwd_bwd_dense", "fwd_bwd", "no_metrics", "full")
CLIP = 1.0                       # make_train_step's default clamp


def tables(model):
    """The model's embedding tables: its parameters whose names hold
    'embedding' (the JAX script's test)."""
    return [p for n, p in model.named_parameters() if "embedding" in n.lower()]


@contextlib.contextmanager
def frozen(params):
    """requires_grad off for `params` inside the block, each restored after
    it, also when the block raises."""
    saved = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        yield
    finally:
        for p, req in zip(params, saved):
            p.requires_grad_(req)


def subset_step(name, model, batch, nfeat, lr=LR):
    """step() of subset `name` (SUBSETS) of the train step of `model` on
    `batch`, its ids shifted by the steps taken."""
    if name == "full":
        return BenchStep(model, batch, nfeat, lr)
    loss_fn = task_fns("binary")[0]
    taken = itertools.count()

    def fresh():
        return shift_ids(batch, next(taken), nfeat)

    if name == "fwd":
        @torch.inference_mode()
        def step():
            model.eval()
            model(fresh())
    elif name in ("fwd_bwd_dense", "fwd_bwd"):
        def step():
            model.zero_grad(set_to_none=True)
            loss, _ = forward_loss(model, fresh(), loss_fn)
            loss.backward()
    elif name == "no_metrics":
        opt = make_optimizer(model.parameters(), lr)

        def step():
            opt.zero_grad(set_to_none=True)
            loss, _ = forward_loss(model, fresh(), loss_fn)
            loss.backward()
            clamp_grads(model.parameters(), CLIP)
            opt.step()
    else:
        raise ValueError(f"unknown subset {name!r}; known: {SUBSETS}")
    return step


def measure_subset(name, model, batch, nfeat, device, warm, steps, reps):
    """timing.measure of subset `name` of `model`'s step; under
    fwd_bwd_dense with the tables frozen for the whole measurement."""
    step = subset_step(name, model, batch, nfeat)
    with (frozen(tables(model)) if name == "fwd_bwd_dense"
          else contextlib.nullcontext()):
        return measure(step, device, warm, steps, reps)


def breakdown(cfg, batch_size, kernels, device, warm, steps, reps):
    """One record per subset of SUBSETS, each on a fresh model: wall ms per
    step, device ms per step, the host (idle) share, the increment of the
    median over the subset before, launches per step."""
    device = resolve_device(device)
    batch = bench_batch(cfg, batch_size, device)
    rows, prev = [], 0.0
    for name in SUBSETS:
        model = create_model(cfg, seed=SEED, device=device, kernels=kernels)
        m = measure_subset(name, model, batch, cfg.nfeat, device, warm,
                           steps, reps)
        del model
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ms = m["step_ms"]["median"]
        rows.append({"model": cfg.model, "subset": name, "kernels": kernels,
                     "batch_size": batch_size, "warm": warm, "steps": steps,
                     "reps": reps, "step_ms": m["step_ms"],
                     "increment_ms": ms - prev,
                     "device_ms_per_step": m["device_ms_per_step"],
                     "idle_share": m["idle_share"],
                     "launches": m["launches"], "card": m["card"],
                     "seconds": m["seconds"]})
        prev = ms
    return rows


def _fmt(x, spec):
    return "n/a" if x is None else format(x, spec)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="host wall and device time of nested subsets of the "
                    "train step (one JSON line per subset on stdout)")
    p.add_argument("--model", default="armnet_1h", choices=sorted(CONFIGS))
    add_timing_args(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    set_matmul_precision("default")
    cfg = ModelConfig(**CONFIGS[args.model])
    rows = breakdown(cfg, BATCH, args.kernels, args.device, args.warm,
                     args.steps, args.reps)
    print(f"{args.model} kernels={args.kernels} batch {BATCH}: ms per step "
          f"(median of {args.reps} x {args.steps})", file=sys.stderr)
    for r in rows:
        s = r["step_ms"]
        print(f"{r['subset']:14s} {s['median']:8.3f} ms  "
              f"(+{r['increment_ms']:7.3f})  min {s['min']:8.3f}  "
              f"max {s['max']:8.3f}  device "
              f"{_fmt(r['device_ms_per_step'], '8.3f')} ms  host "
              f"{_fmt(r['idle_share'], '6.1%')}", file=sys.stderr)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
