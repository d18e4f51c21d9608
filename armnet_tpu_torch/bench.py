"""Benchmark of the port: the armnet_1h train step's examples/s on the card
(the counterpart of the JAX package's root bench.py).

    python -m armnet_tpu_torch.bench [--kernels auto|pallas-fused]
        [--ensemble] [--warm 20] [--steps 100] [--reps 5] [--device cuda]
    python -m armnet_tpu_torch.bench --all [timing flags]

The step is the trainer's own make_train_step() (train/step.py): forward,
masked BCE, backward, the elementwise clamp, Adam, and the AUC of the
pre-update logits into meters on the device, as bench.py times it. The
recipe is bench.py's: armnet_1h at the Criteo width (nfeat 2.1M, 39
fields, E 10, h 128, MLP 2x500, alpha 2.0), batch 4096, lr 1e-3, the
port's own init from seed 0, and bench.py's seeded batch with the ids
shifted by the steps taken (fresh ids every step). --ensemble adds the DNN
tower of the cr_armnet1h+ preset (2 x 500). --kernels travels into
create_model. How the step is timed: benchmarks/timing.py.

stdout holds one JSON line per run and nothing else; diagnostics go to
stderr. `value` is the median examples/s over the repetitions, `min` and
`max` beside it, `step_ms` the wall ms per step, `device_ms_per_step` and
`idle_share` from the profiled repetition, `launches` the port's kernels
per step, `card` the card's name, power limit and clocks before and after
the timed repetitions, `seconds` the wall of each part, the model's
set-up included.

`vs_baseline` is null. The JAX bench's anchor, 287 examples/s, is the
reference implementation's step on the CPU of the TPU's host: a number of
neither this card nor any code in this repository, so a ratio to it says
nothing about the port.

--all runs the four variants (auto and pallas-fused, the ensemble off and
on), each in a fresh process of this module with the same timing flags,
the headline (auto, ensemble off) last, and exits non-zero if any variant
failed.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.benchmarks.timing import (add_timing_args, bench_batch,
                                                measure, shift_ids, summary)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)

__all__ = ["METRIC", "CRITEO", "ENSEMBLE", "BATCH", "VARIANTS", "BenchStep",
           "run", "main"]

METRIC = "armnet_1h_criteo_train_examples_per_sec"
CRITEO = ModelConfig(model="armnet_1h", nfeat=2_100_000, nfield=39, nemb=10,
                     h=128, mlp_nlayer=2, mlp_nhid=500, alpha=2.0)
# the DNN tower of the cr_armnet1h+ preset (utils/presets.py)
ENSEMBLE = {"ensemble": True, "dnn_nlayer": 2, "dnn_nhid": 500}
BATCH = 4096
LR = 1e-3
SEED = 0
# (kernels, ensemble) of --all, the headline last
VARIANTS = (("auto", True), ("pallas-fused", False), ("pallas-fused", True),
            ("auto", False))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BenchStep:
    """step() is one call of the trainer's make_train_step() on `batch`
    with the ids shifted by the steps taken; `meters` holds the meters
    after the last call."""

    def __init__(self, model, batch, nfeat, lr=LR):
        self.state = create_train_state(model, lr)
        self.batch, self.nfeat = batch, nfeat
        self.train_step = make_train_step()
        self.meters = init_meters(batch["y"].device)

    def __call__(self):
        self.meters = self.train_step(
            self.state, self.meters,
            shift_ids(self.batch, self.state.step, self.nfeat))


def run(cfg, batch_size, kernels, device, warm, steps, reps,
        dtype=torch.float32):
    """The bench's record of the train step of `cfg` under `kernels` on
    `device`, the model in the compute dtype `dtype`."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    model = create_model(cfg, seed=SEED, device=device, kernels=kernels,
                         dtype=dtype)
    step = BenchStep(model, bench_batch(cfg, batch_size, device), cfg.nfeat)
    setup_s = time.perf_counter() - t0
    m = measure(step, device, warm, steps, reps)
    rate = summary([batch_size / ms * 1e3 for ms in m["times_ms"]])
    return {"metric": METRIC, "value": rate["median"], "unit": "examples/s",
            "vs_baseline": None, "min": rate["min"], "max": rate["max"],
            "reps": reps, "steps": steps, "warm": warm,
            "batch_size": batch_size, "step_ms": m["step_ms"],
            "device_ms_per_step": m["device_ms_per_step"],
            "idle_share": m["idle_share"], "launches": m["launches"],
            "kernels": kernels, "ensemble": cfg.ensemble,
            "dtype": str(dtype).replace("torch.", ""),
            "loss_last": float(step.meters["loss_last"]),
            "auc_last": float(step.meters["auc_last"]),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "card": m["card"],
            "seconds": {"setup": setup_s, **m["seconds"]},
            "torch": torch.__version__, "cuda": torch.version.cuda}


def run_all(args):
    """Each of VARIANTS in a fresh process of this module; their JSON lines
    to stdout in turn. Raises SystemExit naming the variants that
    failed."""
    failed = []
    for kernels, ensemble in VARIANTS:
        cmd = [sys.executable, "-m", "armnet_tpu_torch.bench",
               "--device", args.device, "--kernels", kernels,
               "--warm", str(args.warm), "--steps", str(args.steps),
               "--reps", str(args.reps)] + (["--ensemble"] if ensemble
                                            else [])
        r = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE, text=True)
        sys.stdout.write(r.stdout)
        sys.stdout.flush()
        if r.returncode:
            failed.append(f"kernels={kernels} ensemble={ensemble} "
                          f"(exit {r.returncode})")
    if failed:
        raise SystemExit(f"bench --all: failed: {'; '.join(failed)}")


def main(argv=None):
    p = argparse.ArgumentParser(
        description="examples/s of the armnet_1h train step at the Criteo "
                    "width (one JSON line on stdout)")
    add_timing_args(p)
    p.add_argument("--ensemble", action="store_true",
                   help="add the cr_armnet1h+ DNN tower")
    p.add_argument("--all", action="store_true",
                   help="the four variants, each in a fresh process, the "
                        "headline last")
    args = p.parse_args(argv)
    if args.all:
        run_all(args)
        return
    resolve_device(args.device)
    set_matmul_precision("default")          # the trainer's default
    cfg = CRITEO.replace(**ENSEMBLE) if args.ensemble else CRITEO
    print(f"bench: armnet_1h kernels={args.kernels} ensemble={args.ensemble} "
          f"batch {BATCH}, {args.warm} warm steps, {args.reps} x "
          f"{args.steps} timed", file=sys.stderr, flush=True)
    record = run(cfg, BATCH, args.kernels, args.device, args.warm,
                 args.steps, args.reps)
    print(json.dumps(record), flush=True)


if __name__ == "__main__":
    main()
