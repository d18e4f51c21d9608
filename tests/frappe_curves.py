"""Early Frappe curves of the JAX package and the port from one
initialisation, on the CPU:

    JAX_PLATFORMS=cpu python tests/frappe_curves.py [--epochs 2]
        [--seeds 2025 1 42] [--out curves.json]

For each seed, the JAX trainer of the frappe_armnet1h recipe (armnet_1h,
alpha 2, h 128, lr 0.001, batch 4096, dropout 0) draws its initial state
from the seed; the port's trainer then trains from that state, carried
over by armnet_tpu_torch.bridge, and, for comparison, from its own
initialisation at the same seed. Both packages visit the rows in the same
order. Prints one JSON object: the valid AUC per epoch of every run.
"""

import argparse
import json
import logging
import os
import sys
import tempfile

import jax
import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from armnet_tpu.data.libsvm import make_dataloaders as jax_loaders  # noqa: E402
from armnet_tpu.train.loop import Trainer as JaxTrainer  # noqa: E402
from armnet_tpu.utils.config import ExperimentConfig as JaxConfig  # noqa: E402
from armnet_tpu.utils.config import build_arg_parser as jax_parser  # noqa: E402
from armnet_tpu_torch.bridge import flatten_flax, from_jax_arrays  # noqa: E402
from armnet_tpu_torch.data.libsvm import make_dataloaders  # noqa: E402
from armnet_tpu_torch.models.config import ModelConfig  # noqa: E402
from armnet_tpu_torch.train.loop import Trainer  # noqa: E402
from armnet_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from armnet_tpu_torch.utils.config import build_arg_parser  # noqa: E402

RECIPE = ["--model", "armnet_1h", "--alpha", "2.0", "--h", "128", "--lr",
          "0.001", "--batch_size", "4096", "--dataset", "frappe",
          "--data_dir", os.path.join(REPO, "data")]


def _logger(name):
    log = logging.getLogger(name)
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def _valid_curve(trainer, epochs, metrics):
    trainer.fit(epochs=epochs, patience=epochs, report_freq=10 ** 6)
    with open(metrics) as f:
        return [json.loads(line)["valid"] for line in f]


def run(seed, epochs, tmp):
    jcfg = JaxConfig(**vars(jax_parser().parse_args(RECIPE)))
    jt = JaxTrainer(jcfg, *jax_loaders("frappe", jcfg.data_dir, jcfg.nfield,
                                       jcfg.batch_size, seed=seed),
                    _logger("jax"), seed=seed,
                    metrics_path=os.path.join(tmp, f"jax_{seed}.jsonl"))
    flat = flatten_flax(jax.tree.map(np.array, {
        "params": jt.state.params, "batch_stats": jt.state.batch_stats}))
    curves = {"jax": _valid_curve(jt, epochs,
                                  os.path.join(tmp, f"jax_{seed}.jsonl"))}
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
        RECIPE + ["--device", "cpu"])))
    model_cfg = ModelConfig(**{k: getattr(cfg, k) for k in
                               ModelConfig.__dataclass_fields__})
    for init in ("port_from_jax_init", "port_own_init"):
        metrics = os.path.join(tmp, f"{init}_{seed}.jsonl")
        pt = Trainer(cfg, *make_dataloaders("frappe", cfg.data_dir,
                                            cfg.nfield, cfg.batch_size,
                                            seed=seed),
                     _logger("port"), seed=seed, metrics_path=metrics)
        if init == "port_from_jax_init":
            pt.state.model.load_state_dict(from_jax_arrays(flat, model_cfg))
        curves[init] = _valid_curve(pt, epochs, metrics)
    return curves


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seeds", type=int, nargs="+", default=[2025, 1, 42])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = {"recipe": " ".join(RECIPE[:-2]), "epochs": args.epochs,
                  "valid_auc": {str(s): run(s, args.epochs, tmp)
                                for s in args.seeds}}
    text = json.dumps(result)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")


if __name__ == "__main__":
    main()
