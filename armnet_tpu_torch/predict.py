"""Batch scoring with the port (port of predict.py): load a checkpoint and
score a libsvm file, one probability per input row, in input order.

    python -m armnet_tpu_torch.predict --ckpt ./ckpt/run --input data/frappe/test.libsvm

The architecture is rebuilt from the checkpoint's metadata sidecar; a model
flag typed on the command line overrides it. `--device` defaults to cuda and
raises when CUDA is absent (pass `--device cpu` to score on the CPU).
Output: `--output` (default `<input>.scores`; '-' = stdout, and the summary
then goes to stderr) with one line per real row: the sigmoid probability,
or space-separated class probabilities for a `noutput > 1` head. The
one-line JSON summary carries `auc` (binary, both classes present) or
`accuracy` (multi-class), the scoring loop's wall time, and how the input
was read (`parse_route`: the row cache or a parser, and `parse_seconds`;
data/libsvm.py); the batches reach the device through the iterator's
lookahead. A checkpoint
trained with --bf16 scores in bfloat16 (restored from its sidecar).
"""

import dataclasses
import glob
import json
import os
import sys
import time

import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.data.libsvm import BatchIterator, LibsvmDataset
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.checkpoint import load_checkpoint, resolve_root
from armnet_tpu_torch.train.metrics import masked_accuracy, masked_roc_auc
from armnet_tpu_torch.utils.config import (ExperimentConfig, build_arg_parser,
                                           check_supported, compute_dtype)

__all__ = ["main", "load_model", "score"]

# numerics flags restored alongside the architecture
_RESTORED_EXTRAS = ("bf16", "kernels")


def _resolve_input(cfg, explicit):
    if explicit:
        return explicit
    pattern = os.path.join(cfg.data_dir, cfg.dataset, "te*libsvm")
    hits = sorted(glob.glob(pattern))
    if not hits:
        raise FileNotFoundError(
            f"--input not given and no test split matches {pattern}")
    return hits[0]


def _typed_dests(parser, argv):
    """Dests of the options typed on the command line, resolving argparse
    prefix abbreviations (--nout counts as an explicit --noutput)."""
    typed = set()
    for a in (argv if argv is not None else sys.argv[1:]):
        if not a.startswith("--"):
            continue
        opt = a.split("=")[0]
        action = parser._option_string_actions.get(opt)
        if action is not None:
            typed.add(action.dest)
            continue
        typed |= {act.dest for s, act in parser._option_string_actions.items()
                  if s.startswith(opt)}
    return typed


def _restore_model_config(cfg, meta, parser, argv):
    """Model hyperparameters (+ numerics flags) from the checkpoint metadata;
    a flag typed on this command line wins."""
    saved = meta.get("config") or {}
    typed = _typed_dests(parser, argv)
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    for name in names + list(_RESTORED_EXTRAS):
        if name in saved and name not in typed:
            cfg = cfg.replace(**{name: saved[name]})
    return cfg


def load_model(root, tag, cfg, device):
    """The checkpoint's model, in eval mode on `device`."""
    state, _ = load_checkpoint(root, tag)
    model = create_model(cfg, seed=cfg.seed, kernels=cfg.kernels,
                         dtype=compute_dtype(cfg))
    model.load_state_dict(state)
    return model.to(device).eval()


@torch.inference_mode()
def score(model, loader, device):
    """(logits, labels, masks) on `device` over every batch of `loader`
    (a loader that hands over batches elsewhere is copied from)."""
    logits, labels, masks = [], [], []
    for batch in loader:
        dev = {k: v.to(device, non_blocking=True) for k, v in batch.items()}
        logits.append(model(dev))
        labels.append(dev["y"])
        masks.append(dev["mask"])
    return torch.cat(logits), torch.cat(labels), torch.cat(masks)


def main(argv=None):
    p = build_arg_parser()
    p.add_argument("--ckpt", required=True,
                   help="checkpoint root (containing best/ and last/) or a "
                        "tag directory itself")
    p.add_argument("--tag", default="best", choices=["best", "last"],
                   help="which snapshot to score with")
    p.add_argument("--input", default=None,
                   help="libsvm file to score (default: the te* split of "
                        "--dataset under --data_dir)")
    p.add_argument("--output", default=None,
                   help="scores file (default: <input>.scores; '-' = stdout)")
    ns = vars(p.parse_args(argv))
    ckpt, tag = ns.pop("ckpt"), ns.pop("tag")
    inp, outp = ns.pop("input"), ns.pop("output")
    cfg = ExperimentConfig(**ns)

    # a tag-dir spelling names the tag, unless --tag was typed
    root, path_tag = resolve_root(ckpt, tag)
    if "tag" not in _typed_dests(p, argv):
        tag = path_tag
    meta = {}
    meta_path = os.path.join(root, f"{tag}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    cfg = _restore_model_config(cfg, meta, p, argv)
    check_supported(cfg)
    device = resolve_device(cfg.device)
    set_matmul_precision(cfg.matmul_precision)

    inp = _resolve_input(cfg, inp)
    ds = LibsvmDataset(inp, cfg.nfield)
    loader = BatchIterator(ds, cfg.batch_size, device=device)
    model = load_model(root, tag, cfg, device)

    t0 = time.perf_counter()
    logits, labels, masks = score(model, loader, device)
    multiclass = cfg.noutput > 1
    probs = (torch.softmax(logits, -1) if multiclass
             else torch.sigmoid(logits))
    real = masks > 0
    probs = probs[real].float().cpu().numpy()  # waits for the device
    seconds = time.perf_counter() - t0

    if outp is None:
        outp = inp + ".scores"
    lines = ([" ".join(f"{v:.6f}" for v in row) for row in probs]
             if multiclass else [f"{v:.6f}" for v in probs])
    if outp == "-":
        sys.stdout.write("\n".join(lines) + "\n")
    else:
        with open(outp, "w") as f:
            f.write("\n".join(lines) + "\n")

    summary = {"input": inp, "rows": int(real.sum()),
               "checkpoint": os.path.abspath(ckpt), "tag": tag,
               "model": cfg.model, "output": outp, "device": str(device),
               "batches": len(loader), "score_seconds": seconds,
               "parse_route": ds.route, "parse_seconds": ds.parse_seconds}
    if multiclass:
        summary["accuracy"] = round(float(masked_accuracy(
            logits, labels, masks)), 6)
    elif torch.unique(labels[real]).numel() > 1:
        summary["auc"] = round(float(masked_roc_auc(logits, labels, masks)),
                               6)
    print(json.dumps(summary), file=sys.stderr if outp == "-" else sys.stdout)
    return summary


if __name__ == "__main__":
    main()
