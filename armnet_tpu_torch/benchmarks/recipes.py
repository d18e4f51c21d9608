"""Recipe-surface throughput (the counterpart of the JAX package's
benchmarks/recipes.py): the bench's train step for every published ARM
recipe family, not only the alpha 2.0 headline, at batch 4096 in one
process.

    python -m armnet_tpu_torch.benchmarks.recipes [--quick]
        [--only TAG,...] [--bf16] [--kernels auto|pallas-fused]
        [--warm 20] [--steps 100] [--reps 5] [--device cuda]

Each recipe runs armnet_tpu_torch.bench.run on a fresh model (timing:
benchmarks/timing.py). --kernels pallas-fused changes the armnet_1h rows
alone: the kernel choice is read by armnet_1h only (kernels/config.py).
--bf16 builds each model in bfloat16 activations (create_model(dtype=),
as the trainer's --bf16). stdout: one JSON line per recipe, {recipe,
ms_per_step, examples_per_sec} as the JAX script's with the spread, the
device ms per step, the idle share and the launches beside them, then the
closing summary line.
"""

import argparse
import json

import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.bench import BATCH, run
from armnet_tpu_torch.benchmarks.timing import add_timing_args
from armnet_tpu_torch.models.config import ModelConfig

__all__ = ["RECIPES", "bench_one", "main"]

# (tag, model kwargs) — geometry from the reference run.sh recipes:
#   CR_armnet1h run.sh:19, CR_armnet run.sh:17 (h=64, 4 heads),
#   AV_armnet1h run.sh:15 (alpha=1.5), alpha=1.7 is the Frappe/diabetes
#   sweet spot, 2.5 appears in the README alpha sweep; gc_arm uses the
#   armnet geometry (model zoo parity).
RECIPES = [
    ("armnet_1h_criteo_a2.0", dict(model="armnet_1h", nfeat=2_100_000,
                                   nfield=39, nemb=10, h=128, mlp_nlayer=2,
                                   mlp_nhid=500, alpha=2.0)),
    ("armnet_1h_criteo_a1.7", dict(model="armnet_1h", nfeat=2_100_000,
                                   nfield=39, nemb=10, h=128, mlp_nlayer=2,
                                   mlp_nhid=500, alpha=1.7)),
    ("armnet_1h_avazu_a1.5", dict(model="armnet_1h", nfeat=1_600_000,
                                  nfield=22, nemb=10, h=128, mlp_nlayer=3,
                                  mlp_nhid=200, alpha=1.5)),
    ("armnet_mh_criteo_a2.0", dict(model="armnet", nfeat=2_100_000,
                                   nfield=39, nemb=10, h=64, nattn_head=4,
                                   mlp_nlayer=2, mlp_nhid=500, alpha=2.0)),
    ("gc_arm_criteo_a2.0", dict(model="gc_arm", nfeat=2_100_000,
                                nfield=39, nemb=10, h=64, nattn_head=4,
                                mlp_nlayer=2, mlp_nhid=500, alpha=2.0)),
    # baseline-zoo rows: the first-order FeaturesLinear term beside the
    # table (K7 at E = 1) at Criteo geometry
    ("lr_criteo", dict(model="lr", nfeat=2_100_000, nfield=39, nemb=10)),
    ("fm_criteo", dict(model="fm", nfeat=2_100_000, nfield=39, nemb=10)),
    ("dfm_criteo", dict(model="dfm", nfeat=2_100_000, nfield=39, nemb=10,
                        mlp_nlayer=2, mlp_nhid=500)),
]


def bench_one(tag, kwargs, kernels, device, warm, steps, reps, bf16=False,
              batch_size=BATCH):
    """The row of one recipe."""
    rec = run(ModelConfig(**kwargs), batch_size, kernels, device, warm,
              steps, reps, torch.bfloat16 if bf16 else torch.float32)
    row = {"recipe": tag + ("_bf16" if bf16 else ""),
           "ms_per_step": rec["step_ms"]["median"],
           "examples_per_sec": rec["value"]}
    row.update({k: rec[k] for k in (
        "min", "max", "step_ms", "device_ms_per_step", "idle_share",
        "launches", "kernels", "dtype", "loss_last", "reps", "steps",
        "card", "seconds")})
    print(json.dumps(row), flush=True)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None):
    p = argparse.ArgumentParser(
        description="train-step throughput of every published recipe "
                    "family (one JSON line per recipe, then a summary)")
    p.add_argument("--quick", action="store_true",
                   help="first two recipes only")
    p.add_argument("--only", type=str, default=None,
                   help="comma-separated recipe tags")
    p.add_argument("--bf16", action="store_true",
                   help="bench with bfloat16 activations (--bf16 CLI parity)")
    add_timing_args(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    set_matmul_precision("default")

    todo = RECIPES[:2] if args.quick else RECIPES
    if args.only:
        keep = set(args.only.split(","))
        todo = [(t, k) for t, k in RECIPES if t in keep]
    rows = [bench_one(t, k, args.kernels, args.device, args.warm, args.steps,
                      args.reps, args.bf16) for t, k in todo]
    print(json.dumps({"metric": "recipe_throughput_table", "bf16": args.bf16,
                      "subset": bool(args.only), "kernels": args.kernels,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()
