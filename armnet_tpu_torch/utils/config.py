"""Experiment config + CLI (copy of armnet_tpu/utils/config.py).

Every flag name of the JAX CLI is kept, so checkpoint metadata written by
either package restores through the same names. Differences: `--device`
(default cuda) picks where the port runs, and `--kernels` takes `auto` and
`pallas` (both the per-op kernels) and `pallas-fused` (the fused ARM-1h
kernels), while `xla` raises; whether a tensor gets the kernel or its plain
version follows its device. The multi-process flags
(--mesh, --shard_embedding, --embedding_exchange and
--embedding_capacity_factor) act on a run under torchrun
(parallel/, train/loop.py); --mesh alone, in one process, takes a mesh of
one process.
`--bf16` travels as `compute_dtype(cfg)` into models.create_model, as the
kernel choice does, with no global state.
"""

import argparse
import dataclasses
from typing import Optional

import torch

from armnet_tpu_torch.kernels.config import BACKENDS, use_fused_arm
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.parallel.mesh import parse_mesh_spec

__all__ = ["ExperimentConfig", "build_arg_parser", "check_supported",
           "compute_dtype"]


@dataclasses.dataclass
class ExperimentConfig(ModelConfig):
    # optimizer
    epoch: int = 100
    patience: int = 1
    batch_size: int = 4096
    lr: float = 0.003
    eval_freq: int = 10000          # max batches per epoch, every split
    clip: float = 1.0               # elementwise grad clamp bound
    # dataset
    dataset: str = "frappe"
    data_dir: str = "./data/"
    workers: int = 4
    valid_perc: float = 0.0
    # log & checkpoint
    log_dir: str = "./log/"
    report_freq: int = 30
    seed: int = 2025
    repeat: int = 1
    exp_name: str = "test"
    ckpt_dir: Optional[str] = None
    resume: Optional[str] = None
    # numerics and placement
    matmul_precision: str = "default"
    bf16: bool = False
    kernels: str = "auto"
    mesh: str = ""
    shard_embedding: bool = False
    embedding_exchange: str = "psum"
    embedding_capacity_factor: float = 2.0
    profile_dir: Optional[str] = None
    debug_nans: bool = False
    device: str = "cuda"


def compute_dtype(cfg):
    """The activation dtype of `cfg` (--bf16), for models.create_model."""
    return torch.bfloat16 if cfg.bf16 else torch.float32


def check_supported(cfg):
    """Raise on settings this slice of the port does not run (they may
    arrive from JAX checkpoint metadata, which bypasses the parser)."""
    if cfg.kernels == "xla":
        raise NotImplementedError(
            "--kernels 'xla' has no counterpart in the port: on the card "
            "every path runs this repository's kernels, and their plain "
            "PyTorch versions are not a backend (they run only on the CPU); "
            "take 'auto', 'pallas' or 'pallas-fused'")
    use_fused_arm(cfg.kernels)                 # raises on an unknown name
    parse_mesh_spec(cfg.mesh)                  # raises on a malformed spec
    if cfg.embedding_exchange not in ("psum", "a2a"):
        raise ValueError(f"--embedding_exchange takes 'psum' or 'a2a', got "
                         f"{cfg.embedding_exchange!r}")


def build_arg_parser():
    d = ExperimentConfig()
    p = argparse.ArgumentParser(description="armnet_tpu_torch")
    p.add_argument("--exp_name", default=d.exp_name, type=str,
                   help="exp name for log & checkpoint")
    # model config (reference-compatible names)
    p.add_argument("--model", default="armnet", type=str,
                   help="model type: lr fm hofm afm dcn cin afn armnet "
                        "armnet_1h dnn gcn gat wd ipnn kpnn nfm dfm dcn+ "
                        "xdfm gc_arm sa_glu")
    p.add_argument("--nfeat", type=int, default=d.nfeat,
                   help="the number of features")
    p.add_argument("--nfield", type=int, default=d.nfield,
                   help="the number of fields")
    p.add_argument("--nemb", type=int, default=d.nemb, help="embedding size")
    p.add_argument("--k", type=int, default=d.k,
                   help="interaction order for hofm/dcn/cin/gcn/gat/xdfm")
    p.add_argument("--h", type=int, default=d.h,
                   help="afm/cin/afn/armnet/gcn/gat hidden features/neurons")
    p.add_argument("--mlp_nlayer", type=int, default=d.mlp_nlayer,
                   help="the number of mlp layers")
    p.add_argument("--mlp_nhid", type=int, default=d.mlp_nhid,
                   help="mlp hidden units")
    p.add_argument("--dropout", default=d.dropout, type=float,
                   help="dropout rate")
    p.add_argument("--nattn_head", type=int, default=d.nattn_head,
                   help="the number of attention heads, gat/armnet")
    p.add_argument("--ensemble", action="store_true", default=False,
                   help="to ensemble with DNNs")
    p.add_argument("--dnn_nlayer", type=int, default=d.dnn_nlayer,
                   help="the number of ensemble-DNN layers")
    p.add_argument("--dnn_nhid", type=int, default=d.dnn_nhid,
                   help="ensemble-DNN hidden units")
    p.add_argument("--alpha", default=d.alpha, type=float,
                   help="entmax alpha to control sparsity")
    # optimizer
    p.add_argument("--epoch", type=int, default=d.epoch)
    p.add_argument("--patience", type=int, default=d.patience)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--lr", default=d.lr, type=float, help="learning rate")
    p.add_argument("--eval_freq", type=int, default=d.eval_freq)
    p.add_argument("--clip", type=float, default=d.clip)
    # dataset
    p.add_argument("--dataset", type=str, default=d.dataset)
    p.add_argument("--data_dir", type=str, default=d.data_dir)
    p.add_argument("--workers", default=d.workers, type=int)
    p.add_argument("--valid_perc", type=float, default=d.valid_perc)
    p.add_argument("--noutput", type=int, default=d.noutput,
                   help="output classes (1 = binary CTR)")
    # log & checkpoint
    p.add_argument("--log_dir", type=str, default=d.log_dir)
    p.add_argument("--report_freq", type=int, default=d.report_freq)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--repeat", type=int, default=d.repeat)
    p.add_argument("--ckpt_dir", type=str, default=None)
    p.add_argument("--resume", type=str, default=None)
    # numerics and placement
    p.add_argument("--matmul_precision", type=str, default=d.matmul_precision,
                   choices=["default", "high", "highest"])
    p.add_argument("--bf16", action="store_true", default=False,
                   help="compute the activations in bfloat16: the "
                        "embedding output is cast, each layer follows its "
                        "input; parameters, losses, metrics and the entmax "
                        "solve stay float32")
    p.add_argument("--kernels", type=str, default=d.kernels,
                   choices=list(BACKENDS),
                   help="auto and pallas: the per-op kernels; pallas-fused: "
                        "the fused ARM-1h kernels; xla raises")
    p.add_argument("--mesh", type=str, default=d.mesh)
    p.add_argument("--shard_embedding", action="store_true", default=False)
    p.add_argument("--embedding_exchange", type=str,
                   default=d.embedding_exchange, choices=["psum", "a2a"])
    p.add_argument("--embedding_capacity_factor", type=float,
                   default=d.embedding_capacity_factor)
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--debug_nans", action="store_true", default=False)
    p.add_argument("--device", type=str, default=d.device,
                   help="torch device to run on (default cuda; pass cpu "
                        "to run on the CPU)")
    return p
