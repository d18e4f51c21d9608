"""Which parameters are row-sharded over the model group (port of
armnet_tpu/parallel/sharding.py), and the moves between a full table and
this rank's row block.

Rule, by parameter name and shape as in the JAX package: the table of a
module that gathers it through its `lookup` attribute (`table_name` names
the parameter: Embedding's and FeaturesLinear's `weight`, AFN's top-level
`embedding`; the deep ensemble's tables are Embeddings) whose leading
dimension is nfeat is row-sharded; everything else is replicated. Adam's
moments are made after the tables are cut, so they follow their
parameter; the clamp and AFN's positivity transform are elementwise and
act on a block unchanged. An nfeat that the model axis does not divide
leaves every table replicated, with a warning.

Every rank builds the full model from the run's seed and keeps its own
block, so the blocks are slices of the single-process initialisation.
"""

import functools
import warnings

from torch import nn

from armnet_tpu_torch.parallel.embedding_parallel import (
    sharded_embedding_bag, sharded_embedding_bag_a2a)
from armnet_tpu_torch.parallel.mesh import all_gather_cat

__all__ = ["table_modules", "shard_tables", "gather_rows", "slice_rows"]


def table_modules(model, nfeat):
    """[(parameter name, module)] of the tables that the rule shards."""
    out = []
    for name, mod in model.named_modules():
        table_name = getattr(mod, "table_name", None)
        if table_name is None:
            continue
        table = getattr(mod, table_name)
        if table.ndim == 2 and table.shape[0] == nfeat:
            out.append((f"{name}.{table_name}" if name else table_name, mod))
    return out


def slice_rows(full, mesh):
    """This rank's row block of a full [nfeat, ...] tensor."""
    rows = full.shape[0] // mesh.model_size
    return full[mesh.model_index * rows:(mesh.model_index + 1) * rows]


def gather_rows(block, mesh):
    """The full tensor from every model rank's row block (a collective over
    the model group)."""
    return all_gather_cat(block, mesh.model_group)


def shard_tables(model, mesh, nfeat, exchange="psum", capacity_factor=2.0):
    """Cut every table of the rule to this rank's row block, in place, and
    set its module's lookup to the sharded exchange ('psum' or 'a2a') over
    `mesh`. Returns the sharded parameter names ([] with a warning where
    the model axis does not divide nfeat). Call before the optimizer is
    made."""
    if exchange not in ("psum", "a2a"):
        raise ValueError(f"unknown embedding exchange {exchange!r}")
    if nfeat % mesh.model_size:
        warnings.warn(
            f"sharded lookup requested but table rows ({nfeat}) do not "
            f"divide the model axis ({mesh.model_size}); every table stays "
            f"replicated", stacklevel=2)
        return []
    lookup = (functools.partial(sharded_embedding_bag, mesh=mesh)
              if exchange == "psum" else functools.partial(
                  sharded_embedding_bag_a2a, mesh=mesh,
                  capacity_factor=capacity_factor))
    names = []
    for name, mod in table_modules(model, nfeat):
        full = getattr(mod, mod.table_name)
        block = slice_rows(full.detach(), mesh).clone()
        setattr(mod, mod.table_name, nn.Parameter(block))
        mod.lookup = lookup
        names.append(name)
    return names
