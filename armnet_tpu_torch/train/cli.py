"""Training entry point of the port (port of the root train.py):

    python -m armnet_tpu_torch.train --model armnet_1h --dataset frappe \
        --data_dir data/ --alpha 2.0 --h 128 --lr 0.001

Loads {data_dir}/{dataset}/tr*|va*|te*libsvm once, then for each seed in
[seed, seed + repeat): re-seeds, builds a fresh logger, model and optimizer,
and runs the epoch loop with early stopping. Per seed it writes
{log_dir}/{exp_name}_{seed}/stdout.log and metrics.jsonl, and, with
--ckpt_dir, best/last checkpoints under {ckpt_dir}/{exp_name}_{seed} that
`python -m armnet_tpu_torch.predict` scores. --resume loads the 'last'
training checkpoint (model, optimizer, step) into every seed's trainer.
With --repeat > 1 the mean and std over seeds go to stdout and to
{log_dir}/{exp_name}.repeat_summary.log. `--device` defaults to cuda and
raises when CUDA is absent; pass `--device cpu` to train on the CPU.
`--kernels pallas-fused` trains through the fused ARM-1h kernels (the
trainer builds the model with the config's choice, and the checkpoints'
metadata keeps it for predict).
"""

import glob
import os

import numpy as np
import torch

from armnet_tpu_torch import resolve_device
from armnet_tpu_torch.data.libsvm import make_dataloaders
from armnet_tpu_torch.train.checkpoint import restore_checkpoint
from armnet_tpu_torch.train.loop import Trainer
from armnet_tpu_torch.utils.config import (ExperimentConfig, build_arg_parser,
                                           check_supported)
from armnet_tpu_torch.utils.logging import (get_logger, remove_logger,
                                            seed_everything)

__all__ = ["main"]


def main(argv=None):
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(argv)))
    check_supported(cfg)
    resolve_device(cfg.device)        # raises before any work without CUDA
    # full-f32 GEMMs, as the parity tests assume
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    base = os.path.join(cfg.data_dir, cfg.dataset)
    if glob.glob(os.path.join(base, "*.arff")):
        raise NotImplementedError(
            "UCI (*.arff) datasets are not ported yet; see ROADMAP.md")
    train_loader, val_loader, test_loader = make_dataloaders(
        cfg.dataset, cfg.data_dir, cfg.nfield, cfg.batch_size, seed=cfg.seed)

    results = []
    for seed in range(cfg.seed, cfg.seed + cfg.repeat):
        seed_everything(seed)
        exp_name = f"{cfg.exp_name}_{seed}"
        logger = get_logger(os.path.join(cfg.log_dir, exp_name, "stdout.log"),
                            to_stdout=True, name=f"armnet_tpu_torch.{exp_name}")
        logger.info(f"=> creating model {cfg.model}")
        logger.info(str(vars(cfg)))
        # the shuffle follows the active seed, from epoch 0, so a repeat's
        # data order does not depend on the repeats before it
        train_loader.seed = seed
        train_loader.epoch = 0
        ckpt_dir = (os.path.join(cfg.ckpt_dir, exp_name) if cfg.ckpt_dir
                    else None)
        trainer = Trainer(
            cfg, train_loader, val_loader, test_loader, logger, seed=seed,
            ckpt_dir=ckpt_dir,
            metrics_path=os.path.join(cfg.log_dir, exp_name, "metrics.jsonl"))
        if cfg.resume:
            extra = restore_checkpoint(cfg.resume, trainer.state)
            logger.info(f"resumed from {cfg.resume}: {extra}")
        best_valid, best_test = trainer.fit(
            epochs=cfg.epoch, patience=cfg.patience, eval_freq=cfg.eval_freq,
            report_freq=cfg.report_freq)
        results.append((seed, best_valid, best_test))
        remove_logger(logger)

    if len(results) > 1:
        valids = np.array([r[1] for r in results])
        tests = np.array([r[2] for r in results])
        summary = (f"repeat summary over seeds "
                   f"[{cfg.seed}, {cfg.seed + cfg.repeat}): "
                   f"valid mean {valids.mean():.4f} std {valids.std():.4f} | "
                   f"test mean {tests.mean():.4f} std {tests.std():.4f}")
        print(summary)
        with open(os.path.join(cfg.log_dir,
                               f"{cfg.exp_name}.repeat_summary.log"),
                  "a") as f:
            for seed, bv, bt in results:
                f.write(f"seed {seed}: valid {bv:.4f} test {bt:.4f}\n")
            f.write(summary + "\n")
    return results
