"""Training loop (port of armnet_tpu/train/loop.py): epochs with
eval-capped passes, patience-based early stopping on the validation
metric, best/last checkpoints and per-epoch metrics.jsonl rows.

Semantics kept from the JAX trainer (and the reference's train.py):
  * one pass per split per epoch; each split's loop breaks after the batch
    at 0-based index `eval_freq`, i.e. eval_freq + 1 batches at most;
  * a report line every `report_freq` batches;
  * early stop: valid >= best keeps the LATEST tie as best (and its test
    metric), and the run stops after `patience` epochs without one;
  * a checkpoint ('last', copied to 'best') at every best epoch;
  * the train iterator's shuffle counter is advanced once at construction,
    as the JAX trainer's next(iter(train_loader)) advances it, so the
    first epoch is shuffled with RandomState(seed + 1) in both packages.

Meters stay on the device and are read only at report and epoch ends.
Multi-device runs (--mesh, --shard_embedding) are not ported yet.
"""

import json
import time

import torch

from armnet_tpu_torch import resolve_device
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.train.checkpoint import save_checkpoint
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_eval_step, make_train_step,
                                         task_fns)
from armnet_tpu_torch.utils.logging import AverageMeter, time_since

__all__ = ["Trainer", "run_epoch"]


def _fetch(meters):
    return {k: float(v) for k, v in meters.items()}


def run_epoch(epoch, state, loader, logger, *, device, train_step=None,
              eval_step=None, namespace="train", report_freq=30,
              eval_freq=10000, total_epochs=0, metric_name="AUC"):
    """One pass over a loader; returns the mean metric over its rows."""
    is_train = train_step is not None
    meters = init_meters(device)
    time_avg = AverageMeter()
    timestamp = time.time()
    nbatch = len(loader)

    for batch_idx, batch in enumerate(loader):
        batch = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        if is_train:
            meters = train_step(state, meters, batch)
        else:
            meters = eval_step(state, meters, batch)

        time_avg.update(time.time() - timestamp)
        timestamp = time.time()

        if batch_idx % report_freq == 0:
            m = _fetch(meters)
            w = max(m["weight"], 1.0)
            logger.info(
                f"Epoch [{epoch:3d}/{total_epochs:3d}][{batch_idx:3d}/{nbatch}]\t"
                f"{time_avg.val:.3f} ({time_avg.avg:.3f}) "
                f"{metric_name} {m['auc_last']:4f} ({m['auc_sum'] / w:4f}) "
                f"Loss {m['loss_last']:8.4f} ({m['loss_sum'] / w:8.4f})")
            timestamp = time.time()
        if batch_idx >= eval_freq:
            break

    m = _fetch(meters)
    w = max(m["weight"], 1.0)
    mean_auc = m["auc_sum"] / w
    logger.info(f"{namespace}\tTime {time_since(s=time_avg.sum):>12s} "
                f"{metric_name} {mean_auc:8.4f} "
                f"Loss {m['loss_sum'] / w:8.4f}")
    return mean_auc


class Trainer:
    """Owns the model, optimizer and step, and the epoch/early-stop loop."""

    def __init__(self, config, train_loader, val_loader, test_loader, logger,
                 seed=2025, ckpt_dir=None, metrics_path=None):
        if config.mesh or config.shard_embedding:
            raise NotImplementedError(
                "--mesh and --shard_embedding (multi-device training) are "
                "not ported yet; see ROADMAP.md")
        self.cfg = config
        self.loaders = (train_loader, val_loader, test_loader)
        self.logger = logger
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.metrics_path = metrics_path
        self.profile_dir = config.profile_dir
        self.device = resolve_device(config.device)

        model = create_model(config, seed=seed, device=self.device,
                             kernels=config.kernels)
        # the JAX trainer draws one batch here (next(iter(train_loader))),
        # which advances the shuffle counter: keep its epoch schedule
        train_loader.epoch += 1
        self.state = create_train_state(model, config.lr)
        logger.info(f"=> created model {config.model} | parameters: "
                    f"{sum(p.numel() for p in model.parameters())}")

        self.task = "multiclass" if config.noutput > 1 else "binary"
        _, _, self.metric_name = task_fns(self.task)
        # dropout masks come from a generator seeded from the run's seed
        generator = torch.Generator(self.device).manual_seed(seed + 7)
        self.train_step = make_train_step(self.task, config.clip, generator)
        self.eval_step = make_eval_step(self.task)

    def _save(self, epoch, valid_auc, test_auc):
        save_checkpoint(
            self.state.model, self.cfg, self.ckpt_dir, tag="last",
            optimizer=self.state.optimizer, step=self.state.step,
            extra={"epoch": epoch, "valid_auc": float(valid_auc),
                   "test_auc": float(test_auc), "seed": self.seed},
            is_best=True)

    def _train_epoch(self, epoch, epochs, eval_freq, report_freq):
        profiling = self.profile_dir and epoch == min(1, epochs - 1)
        if not profiling:
            return self._run(epoch, epochs, 0, eval_freq, report_freq)
        from torch.profiler import (ProfilerActivity, profile,
                                    tensorboard_trace_handler)

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(
                         self.profile_dir)):
            auc = self._run(epoch, epochs, 0, eval_freq, report_freq)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.logger.info(f"profiler trace written to {self.profile_dir}")
        return auc

    def _run(self, epoch, epochs, split, eval_freq, report_freq):
        kw = ({"train_step": self.train_step} if split == 0
              else {"eval_step": self.eval_step})
        return run_epoch(
            epoch, self.state, self.loaders[split], self.logger,
            device=self.device, namespace=("train", "val", "test")[split],
            report_freq=report_freq, eval_freq=eval_freq,
            total_epochs=epochs, metric_name=self.metric_name, **kw)

    def fit(self, epochs, patience=1, eval_freq=10000, report_freq=30):
        best_valid, best_test, patience_cnt = 0.0, 0.0, 0
        start = time.time()
        if self.metrics_path:
            open(self.metrics_path, "w").close()   # one fit = one file

        for epoch in range(epochs):
            self.logger.info(f"Epoch [{epoch:3d}/{epochs:3d}]")
            epoch_start = time.time()
            train_auc = self._train_epoch(epoch, epochs, eval_freq,
                                          report_freq)
            valid_auc = self._run(epoch, epochs, 1, eval_freq, report_freq)
            test_auc = self._run(epoch, epochs, 2, eval_freq, report_freq)

            if valid_auc >= best_valid:
                patience_cnt = 0
                best_valid, best_test = valid_auc, test_auc
                self.logger.info(f"best valid auc: valid {valid_auc:.4f}, "
                                 f"test {test_auc:.4f}")
                if self.ckpt_dir:
                    self._save(epoch, valid_auc, test_auc)
            else:
                patience_cnt += 1
                self.logger.info(f"valid {valid_auc:.4f}, test {test_auc:.4f}")
                self.logger.info(
                    f"Early stopped, {patience_cnt}-th best auc at epoch "
                    f"{epoch - patience_cnt}")
            if self.metrics_path:
                row = {"epoch": epoch, "seed": self.seed,
                       "train": round(float(train_auc), 6),
                       "valid": round(float(valid_auc), 6),
                       "test": round(float(test_auc), 6),
                       "metric": self.metric_name,
                       "best_valid": round(float(best_valid), 6),
                       "is_best": patience_cnt == 0,
                       "time_s": round(time.time() - epoch_start, 3)}
                with open(self.metrics_path, "a") as f:
                    f.write(json.dumps(row) + "\n")

            if patience_cnt >= patience:
                self.logger.info(f"Final best valid auc {best_valid:.4f}, "
                                 f"with test auc {best_test:.4f}")
                break

        self.logger.info(f"Total running time: {time_since(since=start)}")
        return best_valid, best_test
