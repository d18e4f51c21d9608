"""Per-experiment file+stdout logger (layout log/{exp_name}/stdout.log),
meters, timing, seeding (copy of armnet_tpu/utils/logging.py)."""

import logging
import os
import random
import sys
import time

import numpy as np

__all__ = ["get_logger", "remove_logger", "AverageMeter", "time_since",
           "seed_everything"]


def get_logger(log_path=None, to_stdout=True, name="armnet_tpu_torch"):
    """Experiment logger writing timestamped lines to a file and stdout."""
    log = logging.getLogger(name)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    fmt = logging.Formatter(fmt="%(asctime)s %(message)s",
                            datefmt="%m/%d/%Y-%I:%M:%S")
    if log_path:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        fh = logging.FileHandler(log_path)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        log.addHandler(fh)
    if to_stdout:
        ch = logging.StreamHandler(sys.stdout)
        ch.setLevel(logging.DEBUG)
        ch.setFormatter(fmt)
        log.addHandler(ch)
    return log


def remove_logger(log):
    """Close and detach all handlers (loggers are torn down per seed)."""
    for handler in log.handlers[:]:
        handler.close()
        log.removeHandler(handler)


class AverageMeter:
    """Tracks current value, running sum, count, and mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def time_since(since=None, s=None):
    """'XhYmZs' elapsed formatting."""
    if s is None:
        s = int(time.time() - since)
    s = int(s)
    m, s = divmod(s, 60)
    h, m = divmod(m, 60)
    return f"{h}h {m}m {s}s"


def seed_everything(seed=2022):
    """Fix python/numpy seeds and set PYTHONHASHSEED. The port's torch
    randomness is explicit (torch.Generators seeded from the run's seed in
    the model factory and the trainer), so no global torch state is
    seeded."""
    random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    np.random.seed(seed)
    return seed
