"""Checkpoint save/load for the port (the layout of
armnet_tpu/train/checkpoint.py, with torch.save in place of Orbax).

Layout: {root}/{tag}/model.pt (the model's state_dict: parameters and
BatchNorm running statistics), {root}/{tag}/optim.pt ({'optimizer': the
optimizer's state_dict, 'step': the train step count}; training
checkpoints only) and {root}/{tag}.meta.json, the sidecar: {'config':
{...}} plus the trainer's 'epoch', 'valid_auc', 'test_auc' and 'seed'.
Tags are 'best' and 'last'. predict reads model.pt and the sidecar, so a
model-only checkpoint (no optim.pt) still scores; only a resume needs
optim.pt.
"""

import dataclasses
import json
import os
import shutil

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "restore_checkpoint",
           "resolve_root"]


def save_checkpoint(model, cfg, root, tag="best", optimizer=None, step=None,
                    extra=None, is_best=False):
    """Write model.pt (+ optim.pt with an optimizer) and the sidecar under
    {root}/{tag}; with is_best, copy both to 'best' too. Returns the tag
    directory."""
    root = os.path.abspath(root)
    path = os.path.join(root, tag)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(path, "model.pt"))
    if optimizer is not None:
        torch.save({"optimizer": optimizer.state_dict(), "step": int(step)},
                   os.path.join(path, "optim.pt"))
    meta = {"config": dataclasses.asdict(cfg), **(extra or {})}
    with open(os.path.join(root, f"{tag}.meta.json"), "w") as f:
        json.dump(meta, f)
    if is_best and tag != "best":
        best = os.path.join(root, "best")
        if os.path.exists(best):
            shutil.rmtree(best)
        shutil.copytree(path, best)
        shutil.copyfile(os.path.join(root, f"{tag}.meta.json"),
                        os.path.join(root, "best.meta.json"))
    return path


def resolve_root(root, tag):
    """(root, tag) for a checkpoint root or a tag directory itself: a
    best/last basename is the tag only when the path holds no tag subdir
    (a root legitimately named 'last' stays a root)."""
    root = os.path.abspath(root)
    base = os.path.basename(root)
    if base in ("last", "best") and os.path.isdir(root) and not os.path.isdir(
            os.path.join(root, tag)):
        return os.path.dirname(root), base
    return root, tag


def load_checkpoint(root, tag="best"):
    """(state_dict on the CPU, metadata dict) of a saved checkpoint."""
    root, tag = resolve_root(root, tag)
    path = os.path.join(root, tag, "model.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no '{tag}' checkpoint under {root} (pass the checkpoint root "
            f"containing last/ and best/, or a tag directory itself)")
    state = torch.load(path, map_location="cpu", weights_only=True)
    meta = {}
    meta_path = os.path.join(root, f"{tag}.meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return state, meta


def restore_checkpoint(root, state, tag="last"):
    """Load a training checkpoint into a train.step.TrainState (model,
    optimizer, step) in place; returns the sidecar metadata."""
    model_state, meta = load_checkpoint(root, tag)
    root, tag = resolve_root(root, tag)
    path = os.path.join(root, tag, "optim.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{os.path.join(root, tag)} holds a model-only checkpoint (no "
            f"optim.pt); a resume needs the optimizer state too")
    device = next(state.model.parameters()).device
    opt = torch.load(path, map_location=device, weights_only=True)
    state.model.load_state_dict(model_state)
    state.optimizer.load_state_dict(opt["optimizer"])
    state.step = opt["step"]
    return meta
