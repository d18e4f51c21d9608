"""One rank of a multi-process check of armnet_tpu_torch, run by
tests/test_torch_multiprocess.py (which compares the results with the JAX
package and with the single-process port; this file imports no JAX):

    python tests/torch_mp_worker.py CASE RANK WORLD INIT_FILE ARGS OUT

joins a gloo process group through the file:// rendezvous INIT_FILE, runs
CASE on the arguments torch.load(ARGS) and writes its results to
OUT.RANK.pt. The repository root must be on PYTHONPATH.
"""

import logging
import sys

import numpy as np
import torch
import torch.distributed as dist

from armnet_tpu_torch.data.libsvm import BatchIterator, make_dataloaders
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.parallel.embedding_parallel import (
    a2a_overflow_count, sharded_embedding_bag, sharded_embedding_bag_a2a)
from armnet_tpu_torch.parallel.mesh import make_mesh
from armnet_tpu_torch.parallel.sharding import (gather_rows, shard_tables,
                                                slice_rows)
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.loop import Trainer
from armnet_tpu_torch.train.metrics import masked_bce
from armnet_tpu_torch.train.step import (create_train_state, global_count,
                                         init_meters, make_train_step,
                                         sum_grads)
from armnet_tpu_torch.utils.config import ExperimentConfig


def local_rows(x, mesh):
    """This data rank's rows of a global batch."""
    b = x.shape[0] // mesh.data_size
    return x[mesh.data_index * b:(mesh.data_index + 1) * b]


def case_lookup(a, mesh):
    """psum, a2a and an overflowing a2a lookup with their gradients."""
    ids, values, w, mask = (local_rows(a[k], mesh)
                            for k in ("ids", "values", "w", "mask"))
    nfeat = a["table"].shape[0]
    out = {}
    for name, lookup in (
            ("psum", lambda s, i, v: sharded_embedding_bag(s, i, v, mesh)),
            ("a2a", lambda s, i, v: sharded_embedding_bag_a2a(
                s, i, v, mesh, capacity_factor=a["cf"])),
            ("a2a_small", lambda s, i, v: sharded_embedding_bag_a2a(
                s, i, v, mesh, capacity_factor=a["cf_small"]))):
        shard = slice_rows(a["table"], mesh).clone().requires_grad_()
        vals = values.clone().requires_grad_()
        emb = lookup(shard, ids, vals)
        (emb * w).sum().backward()
        dist.all_reduce(shard.grad, group=mesh.data_group)
        out[name] = {"emb": emb.detach(), "dtable": gather_rows(
            shard.grad, mesh), "dvalues": vals.grad}
    out["overflow"] = a2a_overflow_count(ids, nfeat, mesh, mask=mask,
                                         capacity_factor=a["cf_small"])
    return out


def _sharded_model(a, mesh, exchange):
    cfg = ModelConfig(**a["cfg"])
    model = create_model(cfg, seed=0)
    model.load_state_dict(a["weights"])
    names = shard_tables(model, mesh, cfg.nfeat, exchange, 8.0)
    return model, names


def _local_batch(batch, mesh):
    return {k: local_rows(v, mesh) for k, v in batch.items()}


def case_step(a, mesh):
    """Eval-mode loss and gradients, and the packaged train step's loss and
    metric, on the global batch and on a ragged one, per exchange."""
    out = {}
    for exchange in ("psum", "a2a"):
        model, names = _sharded_model(a, mesh, exchange)
        batch = _local_batch(a["batch"], mesh)
        model.eval()
        logits = model(batch)
        loss = masked_bce(logits, batch["y"], batch["mask"],
                          count=global_count(batch["mask"], mesh.data_group))
        loss.backward()
        sum_grads(model.parameters(), mesh.data_group)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=mesh.data_group)
        grads = {n: gather_rows(p.grad, mesh) if n in names else p.grad
                 for n, p in model.named_parameters()}
        res = {"sharded": names, "eval_loss": loss, "grads": grads}
        for key in ("batch", "ragged"):
            model, _ = _sharded_model(a, mesh, exchange)
            step = make_train_step(mesh=mesh)
            m = step(create_train_state(model, 1e-3), init_meters("cpu"),
                     _local_batch(a[key], mesh))
            res[key] = {k: m[k] for k in ("loss_last", "auc_last", "weight")}
        out[exchange] = res
    return out


class _Kept(Trainer):
    """The CLI's trainer, kept for the checks after the run."""

    last = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _Kept.last = self


def case_cli(a, mesh):
    """A CLI run; then the trained (sharded) model's logits on the test
    split, for the parent to hold predict's scores of the checkpoint to."""
    cli.Trainer = _Kept
    cli.main(a["argv"])
    trainer = _Kept.last
    trainer.state.model.eval()
    with torch.no_grad():
        logits = torch.cat([trainer.state.model(b)
                            for b in trainer.loaders[2]])
    return {"logits": logits, "sharded": trainer.sharded}


class _Rows:
    """The learnable rows of tests/test_trainer_mesh.py's SyntheticDataset."""

    def __init__(self, n, nfield=4, nfeat=64, seed=0):
        rng = np.random.RandomState(seed)
        per = nfeat // nfield
        base = (np.arange(nfield) * per)[None, :]
        self.ids = (rng.randint(0, per, (n, nfield)) + base).astype(np.int32)
        self.values = np.ones((n, nfield), np.float32)
        self.labels = (self.ids[:, 0] % 2 == 0).astype(np.float32)
        self.nfield = nfield

    def __len__(self):
        return self.labels.shape[0]


def case_learns(a, mesh):
    """fit() with row-sharded tables under each exchange: the best valid
    AUC."""
    logger = logging.getLogger(f"torch_mp_worker.{mesh.rank}")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    dp = (mesh.data_index, mesh.data_size)
    out = {}
    for exchange in ("psum", "a2a"):
        cfg = ExperimentConfig(**a["cfg"], embedding_exchange=exchange)
        tr = BatchIterator(_Rows(512, seed=0), 64, True, seed=1,
                           data_parallel=dp)
        va = BatchIterator(_Rows(256, seed=1), 64, False, data_parallel=dp)
        te = BatchIterator(_Rows(256, seed=2), 64, False, data_parallel=dp)
        trainer = Trainer(cfg, tr, va, te, logger, seed=0, mesh=mesh)
        best_valid, _ = trainer.fit(epochs=6, patience=10)
        out[exchange] = {"best_valid": best_valid,
                         "sharded": trainer.sharded}
    return out


def case_loaders(a, mesh):
    """make_dataloaders over this data rank's byte-range shards: the global
    row counts, and each split's first epoch of batches."""
    loaders = make_dataloaders(
        "tiny", a["data_dir"], a["nfield"], a["batch_size"], seed=1,
        shard=(mesh.data_index, mesh.data_size), group=mesh.data_group)
    return {"totals": [it.local_shard_total for it in loaders],
            "rows": [len(it.ds) for it in loaders],
            "routes": [it.ds.route for it in loaders],
            "epochs": [list(it) for it in loaders]}


def case_bn(a, mesh):
    """A train-mode BatchNorm on the route of the card's kernels, their
    plain versions in their place, over this data rank's rows under the
    data group's masked statistics: output, input gradient, the rank's
    weight and bias gradients and the running statistics."""
    from armnet_tpu_torch.kernels import bn_cuda
    from armnet_tpu_torch.ops import layers

    layers.bn_route = lambda training, x, ch: "fused"
    bn_cuda.bn_fwd, bn_cuda.bn_bwd = bn_cuda.bn_fwd_plain, bn_cuda.bn_bwd_plain
    x, dy, mask = (local_rows(a[k], mesh) for k in ("x", "dy", "mask"))
    bn = layers.BatchNorm(x.shape[a["axis"]], a["axis"]).train()
    bn.load_state_dict(a["state"])
    x = x.clone().requires_grad_()
    with layers.batch_mask_scope(mask, mesh.data_group):
        y = bn(x)
    (y * dy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad, "running_mean": bn.running_mean,
            "running_var": bn.running_var}


CASES = {"lookup": case_lookup, "step": case_step, "cli": case_cli,
         "learns": case_learns, "loaders": case_loaders, "bn": case_bn}


def main():
    case, rank, world, init_file, args, out = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world))
    try:
        a = torch.load(args, weights_only=False)
        mesh = make_mesh(a["spec"])
        torch.save(CASES[case](a, mesh), f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
