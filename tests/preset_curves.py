"""Valid-AUC curves of the JAX package and the port from one initialisation,
on the CPU, for any preset whose dataset is under data/:

    JAX_PLATFORMS=cpu python tests/preset_curves.py --preset db_armnet1h
        [--epochs 15] [--seeds 2025 1 42] [--out curves.json]
        [--export-init data/parity]

For each seed, the JAX trainer of the preset (armnet_tpu_torch/utils/
presets.py, on data/<its dataset>) draws its initial state from the seed
and trains; the port's trainer (--device cpu) then trains from that state,
carried over by armnet_tpu_torch.bridge, and, for comparison, from its own
initialisation at the same seed. Every run visits the rows in the same
order. Prints one JSON object: the valid AUC per epoch of every run, the
command and the package versions.

--export-init DIR also writes, for each seed, the JAX init as
DIR/<preset>_<seed>.npz (bridge.flatten_flax's leaf names, params and
batch_stats, float32) and the three curves as DIR/<preset>_<seed>.json,
which chip_smoke.py's diabetes_parity phase reads on the card.
"""

import argparse
import json
import logging
import os
import platform
import shlex
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
from armnet_tpu_torch.train.loop import Trainer  # noqa: E402
from armnet_tpu_torch.utils.config import ExperimentConfig  # noqa: E402
from armnet_tpu_torch.utils.config import build_arg_parser  # noqa: E402
from armnet_tpu_torch.utils.presets import PRESETS  # noqa: E402

DATA = os.path.join(REPO, "data")
RUNS = ("jax", "port_from_jax_init", "port_own_init")


def recipe(preset):
    """The preset's flags plus the bundled data folder; raises where the
    preset's dataset is not under data/."""
    if preset not in PRESETS:
        raise KeyError(f"unknown preset {preset!r}; have {sorted(PRESETS)}")
    args = list(PRESETS[preset])
    cfg = jax_parser().parse_args(args)
    if not os.path.isdir(os.path.join(DATA, cfg.dataset)):
        raise FileNotFoundError(f"preset {preset!r} trains on "
                                f"{cfg.dataset!r}, which is not under data/")
    return args + ["--data_dir", DATA]


def _logger(name):
    log = logging.getLogger(name)
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def _valid_curve(trainer, epochs, metrics):
    trainer.fit(epochs=epochs, patience=epochs, report_freq=10 ** 6)
    with open(metrics) as f:
        return [json.loads(line)["valid"] for line in f]


def jax_trainer(args, seed, metrics_path=None):
    """The JAX package's Trainer of a recipe at a seed (it draws the init)."""
    jcfg = JaxConfig(**vars(jax_parser().parse_args(args)))
    loaders = jax_loaders(jcfg.dataset, jcfg.data_dir, jcfg.nfield,
                          jcfg.batch_size, seed=seed)
    return JaxTrainer(jcfg, *loaders, _logger("jax"), seed=seed,
                      metrics_path=metrics_path)


def port_trainer(args, seed, metrics_path=None):
    """The port's Trainer of a recipe at a seed, on the CPU."""
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
        args + ["--device", "cpu"])))
    loaders = make_dataloaders(cfg.dataset, cfg.data_dir, cfg.nfield,
                               cfg.batch_size, seed=seed)
    return Trainer(cfg, *loaders, _logger("port"), seed=seed,
                   metrics_path=metrics_path)


def jax_init(trainer):
    """{flat leaf name: float32 array} of a JAX trainer's current state."""
    flat = flatten_flax(jax.tree.map(np.array, {
        "params": trainer.state.params,
        "batch_stats": trainer.state.batch_stats}))
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def load_init(trainer, flat):
    """Carry a flat JAX init into a port trainer's model."""
    trainer.state.model.load_state_dict(from_jax_arrays(flat, trainer.cfg))


def run(args, seed, epochs, tmp):
    """The three valid curves of one seed, and the JAX init they share."""
    metrics = {r: os.path.join(tmp, f"{r}_{seed}.jsonl") for r in RUNS}
    jt = jax_trainer(args, seed, metrics["jax"])
    flat = jax_init(jt)
    curves = {"jax": _valid_curve(jt, epochs, metrics["jax"])}
    for r in RUNS[1:]:
        # loaders and trainer first, the init after: the rows then come in
        # the JAX run's order
        pt = port_trainer(args, seed, metrics[r])
        if r == "port_from_jax_init":
            load_init(pt, flat)
        curves[r] = _valid_curve(pt, epochs, metrics[r])
    return curves, flat


def versions():
    import flax
    import torch
    return {"python": platform.python_version(), "jax": jax.__version__,
            "flax": flax.__version__, "torch": torch.__version__,
            "numpy": np.__version__}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="frappe_armnet1h")
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--seeds", type=int, nargs="+", default=[2025, 1, 42])
    p.add_argument("--out", default=None)
    p.add_argument("--export-init", default=None, metavar="DIR")
    a = p.parse_args(argv)
    args = recipe(a.preset)
    command = ("JAX_PLATFORMS=cpu python tests/preset_curves.py "
               + shlex.join(argv))
    result = {"preset": a.preset, "recipe": " ".join(args[:-2]),
              "epochs": a.epochs, "command": command,
              "versions": versions(), "valid_auc": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for seed in a.seeds:
            curves, flat = run(args, seed, a.epochs, tmp)
            result["valid_auc"][str(seed)] = curves
            if a.export_init:
                os.makedirs(a.export_init, exist_ok=True)
                stem = os.path.join(a.export_init, f"{a.preset}_{seed}")
                np.savez(stem + ".npz", **flat)
                with open(stem + ".json", "w") as f:
                    json.dump({k: result[k] for k in
                               ("preset", "recipe", "epochs", "command",
                                "versions")}
                              | {"seed": seed, "valid_auc": curves},
                              f, indent=1)
                    f.write("\n")
    text = json.dumps(result)
    print(text)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return result


if __name__ == "__main__":
    main()
