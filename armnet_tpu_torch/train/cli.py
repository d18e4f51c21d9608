"""Training entry point of the port (port of the root train.py):

    python -m armnet_tpu_torch.train --model armnet_1h --dataset frappe \
        --data_dir data/ --alpha 2.0 --h 128 --lr 0.001

Loads {data_dir}/{dataset}/tr*|va*|te*libsvm once (or, where the folder
holds `*.arff`, the UCI multi-class split of data/uci.py: --valid_perc
carves the valid split from train, a head of noutput <= 1 becomes nclass
outputs, and nfield is the dataset's), then for each seed in
[seed, seed + repeat): re-seeds, builds a fresh logger, model and optimizer,
and runs the epoch loop with early stopping. Per seed it writes
{log_dir}/{exp_name}_{seed}/stdout.log and metrics.jsonl, and, with
--ckpt_dir, best/last checkpoints under {ckpt_dir}/{exp_name}_{seed} that
`python -m armnet_tpu_torch.predict` scores. --resume loads the 'last'
training checkpoint (model, optimizer, step) into every seed's trainer.
With --repeat > 1 the mean and std over seeds go to stdout and to
{log_dir}/{exp_name}.repeat_summary.log. `--device` defaults to cuda and
raises when CUDA is absent; pass `--device cpu` to train on the CPU.
`--bf16` computes the activations in bfloat16 (parameters, losses,
metrics and the kernels' boundaries stay float32).
`--kernels pallas-fused` trains through the fused ARM-1h kernels (the
trainer builds the model with the config's choice, and the checkpoints'
metadata keeps it for predict). `--matmul_precision high` lets float32
GEMMs use TF32 (default and highest keep full f32), and `--debug_nans`
stops training with FloatingPointError at the first step whose loss or
gradients hold a NaN or an infinity.

Multi-process training, under torchrun (its environment starts the process
group: NCCL on cuda:LOCAL_RANK, gloo with --device cpu):

    torchrun --nproc_per_node 2 -m armnet_tpu_torch.train --device cpu \
        --mesh data:1,model:2 --shard_embedding ...

The mesh (--mesh, default every process on 'data') places each rank; each
process of the data group parses its byte-range shard of every split (the
ranks of one data row read the same rows), and the batches are its rows of
the global batch. Each rank logs to its own file (rank 0 to stdout.log,
rank r to stdout.p<r>.log); rank 0 writes metrics.jsonl and the
checkpoints.
"""

import glob
import os

import numpy as np

import torch.distributed as dist

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.data.libsvm import make_dataloaders
from armnet_tpu_torch.data.uci import uci_loader
from armnet_tpu_torch.parallel.mesh import (make_mesh,
                                            maybe_initialize_distributed)
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
    started = maybe_initialize_distributed(cfg.device)
    try:
        return _main(cfg)
    finally:
        if started:
            dist.destroy_process_group()


def _main(cfg):
    device = resolve_device(cfg.device)
    set_matmul_precision(cfg.matmul_precision)
    mesh = (make_mesh(cfg.mesh) if cfg.mesh or dist.is_initialized()
            else None)
    # the model ranks of one data row read the same rows
    shard = (None if mesh is None or not mesh.distributed
             else (mesh.data_index, mesh.data_size))
    rank = 0 if mesh is None else mesh.rank

    base = os.path.join(cfg.data_dir, cfg.dataset)
    if glob.glob(os.path.join(base, "*.arff")):
        train_loader, val_loader, test_loader = uci_loader(
            base, cfg.batch_size, valid_perc=cfg.valid_perc, seed=cfg.seed,
            device=device)
        if shard is not None:
            for loader in (train_loader, val_loader, test_loader):
                loader.data_parallel = shard
        # every UCI set, a binary one too, takes the softmax-CE + accuracy
        # head; the table keeps nfeat rows, nfield of them live
        nclass, nfield = train_loader.nclass, train_loader.ds.nfield
        cfg = cfg.replace(
            noutput=nclass if nclass >= 2 and cfg.noutput <= 1
            else cfg.noutput,
            nfield=nfield, nfeat=max(cfg.nfeat, nfield))
    else:
        train_loader, val_loader, test_loader = make_dataloaders(
            cfg.dataset, cfg.data_dir, cfg.nfield, cfg.batch_size,
            seed=cfg.seed, shard=shard, device=device,
            group=None if mesh is None else mesh.data_group)

    results = []
    for seed in range(cfg.seed, cfg.seed + cfg.repeat):
        seed_everything(seed)
        exp_name = f"{cfg.exp_name}_{seed}"
        log_name = "stdout.log" if rank == 0 else f"stdout.p{rank}.log"
        logger = get_logger(os.path.join(cfg.log_dir, exp_name, log_name),
                            to_stdout=rank == 0,
                            name=f"armnet_tpu_torch.{exp_name}"
                            + (f".p{rank}" if rank else ""))
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
            metrics_path=(os.path.join(cfg.log_dir, exp_name, "metrics.jsonl")
                          if rank == 0 else None), mesh=mesh)
        if cfg.resume:
            extra = restore_checkpoint(cfg.resume, trainer.state, mesh=mesh,
                                       sharded=trainer.sharded)
            logger.info(f"resumed from {cfg.resume}: {extra}")
        best_valid, best_test = trainer.fit(
            epochs=cfg.epoch, patience=cfg.patience, eval_freq=cfg.eval_freq,
            report_freq=cfg.report_freq)
        results.append((seed, best_valid, best_test))
        remove_logger(logger)

    if len(results) > 1 and rank == 0:
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
