"""Train and eval steps (port of armnet_tpu/train/step.py).

The step: train-mode forward under batch_mask_scope (masked BatchNorm
statistics) and dropout_scope (the run's generator), the masked loss (BCE
with logits, or softmax CE for a multi-class head), backward, every
gradient clamped elementwise to [-clip, clip], then Adam with torch's
defaults (betas 0.9/0.999, eps 1e-8): optax.chain(clip(1.0), adam(lr)) of
the JAX package, and the reference's clamp hooks. The step is dense: every
table row gets a gradient (zero where the batch did not touch it) and
Adam decays the moments of untouched rows, as optax does; sparse gradients
and SparseAdam would not.

A model with a stored-parameter mutation (models.param_transform_for:
AFN's positive table) has it applied in place at the head of every step,
before the forward, as the JAX step applies it to state.params.

Data parallel (a mesh whose data group is a process group): the steps keep
the global-batch semantics of the JAX step, which is one program over the
global batch. The loss is the global masked sum over the global mask count
(each process back-propagates its share), BatchNorm's masked statistics are
taken over the global batch (batch_mask_scope's group), the gradients of
every parameter, replicated or a table's row block, are summed over the
data group before the clamp, and the metric is taken on the logits, labels
and masks gathered over the group. A per-rank mean averaged over ranks
would differ wherever the final batch's padding falls unevenly.

The quality metric (ROC-AUC or accuracy) is taken on the logits from before
the update, and the meters are updated before the clamp and Adam. The
step's four phases are spans (utils/tracing.py): armnet.step.forward,
.backward, .meters and .update, each carrying the step index. Meters are
tensors on the model's device, so a step never waits for the device; the
loop reads them only at report and epoch boundaries.
With debug_nans (--debug_nans) a step also waits for one flag from the
device: a NaN or an infinity in the loss or a gradient raises
FloatingPointError before the update, as jax_debug_nans stops the JAX
trainer at the first NaN. `overflow_fn(ids, mask)` (the a2a exchange's
dropped requests) adds to the `overflow_sum` meter.
"""

import torch
import torch.distributed as dist

from armnet_tpu_torch.ops.layers import batch_mask_scope, dropout_scope
from armnet_tpu_torch.parallel.mesh import all_gather_cat
from armnet_tpu_torch.train.metrics import (masked_accuracy, masked_bce,
                                            masked_roc_auc, masked_softmax_ce)
from armnet_tpu_torch.utils.tracing import span

__all__ = ["TrainState", "create_train_state", "make_optimizer",
           "make_train_step", "make_eval_step", "init_meters", "task_fns",
           "forward_loss", "clamp_grads", "check_finite", "sum_grads",
           "global_count"]


def task_fns(task):
    """(loss_fn, metric_fn, metric_name): 'binary' is the CTR path (BCE +
    ROC-AUC), 'multiclass' the UCI path (softmax CE + top-1 accuracy)."""
    if task == "binary":
        return masked_bce, masked_roc_auc, "AUC"
    if task == "multiclass":
        return masked_softmax_ce, masked_accuracy, "Acc"
    raise ValueError(f"unknown task {task!r}")


class TrainState:
    """The model, its optimizer and the number of steps taken (the torch
    counterpart of the JAX TrainState)."""

    def __init__(self, model, optimizer, step=0):
        self.model = model
        self.optimizer = optimizer
        self.step = step


def make_optimizer(params, lr):
    """Adam with torch's (and optax's) defaults; the clamp runs before it
    in the train step."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def create_train_state(model, lr):
    return TrainState(model, make_optimizer(model.parameters(), lr))


def init_meters(device):
    """Metric accumulators on the device."""
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"loss_sum": z, "auc_sum": z, "weight": z, "loss_last": z,
            "auc_last": z, "overflow_sum": z}


def _update_meters(meters, loss, auc, n, overflow=0.0):
    return {"loss_sum": meters["loss_sum"] + loss * n,
            "auc_sum": meters["auc_sum"] + auc * n,
            "weight": meters["weight"] + n,
            "loss_last": loss, "auc_last": auc,
            "overflow_sum": meters["overflow_sum"] + overflow}


def _data_group(mesh):
    return None if mesh is None else mesh.data_group


def global_count(mask, group):
    """The mask count over the data group's global batch."""
    count = mask.sum()
    if group is not None:
        dist.all_reduce(count, group=group)
    return count


def forward_loss(model, batch, loss_fn=masked_bce, generator=None,
                 group=None):
    """(loss, logits) of a train-mode forward of `batch` (tensors on the
    model's device), with masked BatchNorm statistics; updates the running
    statistics. With a data group: this process's share of the global
    batch's loss, the statistics over the global batch."""
    model.train()
    with batch_mask_scope(batch["mask"], group), dropout_scope(generator):
        logits = model(batch)
    count = None if group is None else global_count(batch["mask"], group)
    return loss_fn(logits, batch["y"], batch["mask"], count=count), logits


def sum_grads(params, group):
    """Sum every gradient over the data group, in place (one all-reduce)."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _global_metrics(loss, logits, batch, metric_fn, group):
    """(loss, metric, row count) of the global batch, from this process's
    share of the loss and its logits."""
    y, mask = batch["y"], batch["mask"]
    if group is None:
        return loss, metric_fn(logits, y, mask), mask.sum()
    loss = loss.clone()
    dist.all_reduce(loss, group=group)
    logits, y, mask = (all_gather_cat(t, group) for t in (logits, y, mask))
    return loss, metric_fn(logits, y, mask), mask.sum()


def clamp_grads(params, clip):
    """Clamp every gradient elementwise to [-clip, clip], in place."""
    for p in params:
        if p.grad is not None:
            p.grad.clamp_(-clip, clip)


def check_finite(loss, model, step):
    """Raise FloatingPointError, naming the step and what holds them, where
    the loss or a gradient of the model holds a NaN or an infinity. One
    sync with the device."""
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    flags = torch.stack([torch.isfinite(loss).all()]
                        + [torch.isfinite(g).all() for g in grads.values()])
    if bool(flags.all()):
        return
    bad = [n for n, ok in zip(["loss", *grads], flags.tolist()) if not ok]
    raise FloatingPointError(
        f"NaN or infinity at train step {step} (0-based) in: "
        f"{', '.join(bad)}")


def _overflow(overflow_fn, batch):
    return 0.0 if overflow_fn is None else overflow_fn(batch["id"],
                                                       batch["mask"])


def make_train_step(task="binary", clip=1.0, generator=None,
                    debug_nans=False, param_transform=None, mesh=None,
                    overflow_fn=None):
    """train_step(state, meters, batch) -> meters: forward, loss, backward,
    clamp, Adam; the metric on the pre-update logits. `generator` draws the
    dropout masks; with debug_nans the step raises before the update where
    the loss or a gradient is not finite (check_finite). `param_transform`
    (model -> None, in place) runs first. With a distributed `mesh` the
    batch is this process's rows of the global batch (module docstring)."""
    loss_fn, metric_fn, _ = task_fns(task)
    group = _data_group(mesh)

    def train_step(state, meters, batch):
        step = state.step
        with span("armnet.step.forward", step=step):
            if param_transform is not None:
                param_transform(state.model)
            state.optimizer.zero_grad(set_to_none=True)
            loss, logits = forward_loss(state.model, batch, loss_fn,
                                        generator, group)
        with span("armnet.step.backward", step=step):
            loss.backward()
            sum_grads(state.model.parameters(), group)
        with span("armnet.step.meters", step=step), torch.no_grad():
            loss, auc, n = _global_metrics(loss.detach(), logits.detach(),
                                           batch, metric_fn, group)
            meters = _update_meters(meters, loss, auc, n,
                                    _overflow(overflow_fn, batch))
        with span("armnet.step.update", step=step):
            if debug_nans:
                check_finite(loss, state.model, step)
            clamp_grads(state.model.parameters(), clip)
            state.optimizer.step()
        state.step += 1
        return meters

    return train_step


def make_eval_step(task="binary", mesh=None, overflow_fn=None):
    """eval_step(state, meters, batch) -> meters: running BatchNorm
    statistics, no dropout, no gradients. A stored-parameter mutation is
    the caller's: the Trainer applies it once before each eval pass."""
    loss_fn, metric_fn, _ = task_fns(task)
    group = _data_group(mesh)

    @torch.inference_mode()
    def eval_step(state, meters, batch):
        state.model.eval()
        logits = state.model(batch)
        count = (None if group is None
                 else global_count(batch["mask"], group))
        loss = loss_fn(logits, batch["y"], batch["mask"], count=count)
        loss, auc, n = _global_metrics(loss, logits, batch, metric_fn, group)
        return _update_meters(meters, loss, auc, n,
                              _overflow(overflow_fn, batch))

    return eval_step
