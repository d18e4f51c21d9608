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

Multi-process runs (`mesh` with a process group): every rank gathers the
row blocks of the sharded tables (`sharded`, parallel/sharding.py) and of
their Adam moments over its model group, and rank 0 alone writes the
single-process layout, so predict scores it unchanged; a resume loads it
on every rank and slices the blocks back. Both sit between barriers.
"""

import contextlib
import dataclasses
import json
import os
import shutil

import torch
import torch.distributed as dist

from armnet_tpu_torch.parallel.sharding import gather_rows, slice_rows

__all__ = ["save_checkpoint", "load_checkpoint", "restore_checkpoint",
           "resolve_root"]


@contextlib.contextmanager
def _between_barriers(mesh):
    distributed = mesh is not None and mesh.distributed
    if distributed:
        dist.barrier()
    yield
    if distributed:
        dist.barrier()


def _sharded_slots(model, sharded):
    """{optimizer parameter index: name} of the sharded parameters (the
    optimizer holds model.parameters() in order)."""
    return {i: n for i, (n, _) in enumerate(model.named_parameters())
            if n in sharded}


def _map_tables(model, optimizer, model_state, opt_state, sharded, fn):
    """Apply fn to the sharded tables and their Adam moments, in place."""
    for name in sharded:
        model_state[name] = fn(model_state[name])
    if opt_state is not None:
        for i in _sharded_slots(model, sharded):
            if i in opt_state["state"]:
                # a copy: state_dict() shares the live per-parameter dicts
                slot = dict(opt_state["state"][i])
                for k in ("exp_avg", "exp_avg_sq"):
                    slot[k] = fn(slot[k])
                opt_state["state"][i] = slot


def save_checkpoint(model, cfg, root, tag="best", optimizer=None, step=None,
                    extra=None, is_best=False, mesh=None, sharded=()):
    """Write model.pt (+ optim.pt with an optimizer) and the sidecar under
    {root}/{tag}; with is_best, copy both to 'best' too. Returns the tag
    directory. With a distributed `mesh` every rank must call it: the
    `sharded` tables are gathered, and rank 0 writes."""
    root = os.path.abspath(root)
    path = os.path.join(root, tag)
    with _between_barriers(mesh):
        state = model.state_dict()
        opt = None if optimizer is None else optimizer.state_dict()
        if sharded and mesh is not None:
            _map_tables(model, optimizer, state, opt, sharded,
                        lambda t: gather_rows(t, mesh))
        if mesh is None or mesh.rank == 0:
            _write(cfg, root, path, tag, state, opt, step, extra, is_best)
    return path


def _write(cfg, root, path, tag, state, opt, step, extra, is_best):
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    state = {k: v.detach().cpu() for k, v in state.items()}
    torch.save(state, os.path.join(path, "model.pt"))
    if opt is not None:
        torch.save({"optimizer": opt, "step": int(step)},
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


def restore_checkpoint(root, state, tag="last", mesh=None, sharded=()):
    """Load a training checkpoint into a train.step.TrainState (model,
    optimizer, step) in place; returns the sidecar metadata. With a
    distributed `mesh` every rank must call it; the `sharded` tables and
    their moments are sliced to this rank's row block."""
    with _between_barriers(mesh):
        model_state, meta = load_checkpoint(root, tag)
        root, tag = resolve_root(root, tag)
        path = os.path.join(root, tag, "optim.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{os.path.join(root, tag)} holds a model-only checkpoint "
                f"(no optim.pt); a resume needs the optimizer state too")
        device = next(state.model.parameters()).device
        opt = torch.load(path, map_location=device, weights_only=True)
        if sharded and mesh is not None:
            _map_tables(state.model, state.optimizer, model_state,
                        opt["optimizer"], sharded,
                        lambda t: slice_rows(t, mesh).clone())
        state.model.load_state_dict(model_state)
        state.optimizer.load_state_dict(opt["optimizer"])
        state.step = opt["step"]
    return meta
