"""Value-scaled embedding gather (port of armnet_tpu/ops/embedding.py).

lookup(table, ids, values) -> [B, F, E] = table[ids] * values[..., None]

Index semantics follow jnp.take's defaults, which the JAX package keeps on
every path: ids in [-n, 0) wrap python-style, and ids outside [-n, n) give
NaN rows (a CUDA gather would otherwise fault on them). Tables are stored
[R, E]; the JAX package's flat [R*E] layout is a TPU tiling workaround and
is not carried over.

The backward is a torch.autograd.Function, as the JAX custom VJP is:
dvalues = sum_e dout * emb (from the saved gathered rows), and the table
gradient is the dense [R, E] scatter-add of dout * values at the ids,
through the table_grad CUDA kernel on a CUDA tensor or its plain version
(index_add_) on a CPU tensor (kernels/scatter_cuda.py).

Where the JAX package dispatches scaled_embedding_lookup to a sharded
lookup through a thread-local context, the port keeps no global state:
each table module gathers through its own `lookup` attribute
(ops/layers.py Embedding and FeaturesLinear, AFN's table), embedding_bag
by default, and the trainer's sharding step sets the sharded exchange
with its mesh and capacity on each sharded table
(parallel/sharding.shard_tables; parallel/embedding_parallel.py, whose
backward runs table_grad into the row block).
"""

import torch

from armnet_tpu_torch.kernels import scatter_cuda

__all__ = ["embedding_bag", "table_grad"]


def table_grad(g, ids, nrows):
    """Dense [nrows, E] scatter-add of g [N, E] at ids [N], by device."""
    if g.device.type == "cuda":
        return scatter_cuda.table_grad(g, ids, nrows)
    if g.device.type == "cpu":
        return scatter_cuda.table_grad_plain(g, ids, nrows)
    raise ValueError(f"table_grad has no path for device {g.device}")


def _gather(table, ids):
    nrows = table.shape[0]
    ids = ids.long()
    wrapped = torch.where(ids < 0, ids + nrows, ids)
    oob = (wrapped < 0) | (wrapped >= nrows)
    emb = table[wrapped.clamp(0, nrows - 1)]
    return torch.where(oob[..., None], torch.nan, emb)


class _EmbeddingBag(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, ids, values):
        emb = _gather(table, ids)
        # the gathered rows (B*F*E floats) are kept for dvalues, as the JAX
        # flat-table path keeps them
        ctx.save_for_backward(emb, ids, values)
        ctx.nrows = table.shape[0]
        return emb * values[..., None].to(table.dtype)

    @staticmethod
    def backward(ctx, dout):
        emb, ids, values = ctx.saved_tensors
        dtable = dvalues = None
        if ctx.needs_input_grad[2]:
            dvalues = (dout * emb).sum(-1).to(values.dtype)
        if ctx.needs_input_grad[0]:
            g = (dout * values[..., None].to(dout.dtype)).reshape(
                -1, emb.shape[-1])
            dtable = table_grad(g, ids.reshape(-1), ctx.nrows).to(emb.dtype)
        return dtable, None, dvalues


def embedding_bag(table, ids, values):
    """table [R, E], ids [B, F] int, values [B, F] -> [B, F, E]."""
    return _EmbeddingBag.apply(table, ids, values)
