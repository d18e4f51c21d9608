"""The port's best valid AUC from many JAX inits and from its own inits at
the same seeds: is a gap between the two packages at a few seeds the draw
of the initialisation, or systematic?

    python tests/init_draws.py --preset db_armnet1h --inits DIR
        [--epochs 15] [--device cuda] [--out draws.json]

DIR holds <preset>_<seed>.npz, the JAX package's inits, written on the CPU
by `JAX_PLATFORMS=cpu python tests/preset_curves.py --preset <preset>
--epochs 0 --seeds <seeds> --export-init DIR`. For each, the port trains
the preset on data/<its dataset> from that init (a stand-in for the JAX
package's own run: from one init the two track each other, PERF.md) and
from its own init at the same seed, with the rows in the same order.
Imports nothing of JAX, so it runs on the card. Prints one JSON object:
both valid curves per seed, and the mean and standard deviation of each
side's best valid AUC and of their paired difference.
"""

import argparse
import glob
import json
import logging
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from armnet_tpu_torch.bridge import from_jax_arrays  # noqa: E402
from armnet_tpu_torch.data.libsvm import make_dataloaders  # noqa: E402
from armnet_tpu_torch.train.loop import Trainer  # noqa: E402
from armnet_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from armnet_tpu_torch.utils.config import build_arg_parser  # noqa: E402
from armnet_tpu_torch.utils.presets import PRESETS  # noqa: E402


def curve(preset, seed, device, epochs, tmp, init=None):
    """Valid AUC per epoch of the port's run of a preset at a seed, from
    `init` (flat JAX leaves) or from its own init."""
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
        PRESETS[preset] + ["--data_dir", os.path.join(REPO, "data"),
                           "--device", device])))
    log = logging.getLogger("init_draws")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    metrics = os.path.join(tmp, "metrics.jsonl")
    loaders = make_dataloaders(cfg.dataset, cfg.data_dir, cfg.nfield,
                               cfg.batch_size, seed=seed,
                               device=torch.device(device))
    trainer = Trainer(cfg, *loaders, log, seed=seed, metrics_path=metrics)
    if init is not None:
        trainer.state.model.load_state_dict(from_jax_arrays(init, cfg))
    trainer.fit(epochs, patience=epochs, report_freq=10 ** 6)
    with open(metrics) as f:
        return [json.loads(line)["valid"] for line in f]


def _stats(xs):
    """Mean and sample standard deviation (None for a single seed)."""
    return {"mean": float(np.mean(xs)),
            "std": float(np.std(xs, ddof=1)) if len(xs) > 1 else None}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="db_armnet1h")
    p.add_argument("--inits", required=True)
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    paths = sorted(glob.glob(os.path.join(a.inits, f"{a.preset}_*.npz")))
    if not paths:
        raise FileNotFoundError(f"no {a.preset}_<seed>.npz under {a.inits}")
    result = {"preset": a.preset, "epochs": a.epochs, "device": a.device,
              "seeds": {}}
    if a.device == "cuda":
        result["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        for path in paths:
            seed = int(os.path.basename(path)[len(a.preset) + 1:-len(".npz")])
            with np.load(path) as z:
                init = {k: z[k] for k in z.files}
            result["seeds"][seed] = {
                "from_jax_init": curve(a.preset, seed, a.device, a.epochs,
                                       tmp, init),
                "own_init": curve(a.preset, seed, a.device, a.epochs, tmp)}
    best = {k: [max(r[k]) for r in result["seeds"].values()]
            for k in ("from_jax_init", "own_init")}
    result["best"] = {k: _stats(v) for k, v in best.items()}
    diff = np.subtract(best["own_init"], best["from_jax_init"])
    result["own_minus_jax_init"] = _stats(diff) | {
        "below": int((diff < 0).sum()), "n": int(diff.size)}
    text = json.dumps(result)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
