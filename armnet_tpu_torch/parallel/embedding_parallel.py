"""Row-sharded embedding lookups over the model group (port of
armnet_tpu/parallel/embedding_parallel.py).

Each model rank holds rows [m * R, (m + 1) * R) of a table of nrows = M * R
rows; the ids of a data row's batch are the same on its M model ranks. Two
exchanges, both torch.autograd.Functions whose backward scatters into the
local shard through ops.embedding.table_grad (the K7 kernel on a CUDA shard,
its plain version on a CPU shard):

  psum: every model rank gathers the rows it owns for the whole batch
        (zeros elsewhere) and the partial rows are summed over the model
        group (all_reduce). Moves ~2 b F E a rank.
  a2a:  DLRM-style request and response. Each model rank serves a 1/M slice
        of the batch's b F requests: it buckets them by owner into
        [M, capacity], exchanges the ids (all_to_all), answers with the rows
        it owns, exchanges the rows back (all_to_all), and the M finished
        slices are gathered (all_gather). Requests past a bucket's capacity
        get zero rows (a2a_overflow_count counts them).

Every model rank receives the same output gradient, so the backward of the
psum's sum, and of the closing all_gather, is this rank's own part of it:
no reduction over the model group (a reduce-scatter of M identical copies
would make the table gradient M times too large). The backward of each
all_to_all is the reverse all_to_all.

Index semantics are those of the replicated lookup: negative ids in
[-nrows, 0) wrap python-style, and ids outside [-nrows, nrows) give NaN rows.
"""

import numpy as np
import torch
import torch.distributed as dist

from armnet_tpu_torch.ops.embedding import table_grad
from armnet_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                            all_gather_cat)

__all__ = ["sharded_embedding_bag", "sharded_embedding_bag_a2a",
           "a2a_overflow_count", "required_capacity_factor"]


def required_capacity_factor(ids_batches, nfeat, mesh, *, margin=1.25):
    """The smallest a2a capacity factor (times `margin`) at which none of
    the requests of `ids_batches` (global batches of ids, numpy) is
    dropped, by a host replay of the lookup's slicing: per data rank, per
    model rank, the owner histogram."""
    M = mesh.shape[MODEL_AXIS]
    D = mesh.shape.get(DATA_AXIS, 1)
    rows_per_shard = max(nfeat // M, 1)
    # cap = int(cf * slice_n / M) must reach each batch's worst bucket:
    # pair each worst with its own slice_n and take the largest factor
    need = 0.0
    for ids in ids_batches:
        ids = np.asarray(ids)
        bd = max(ids.shape[0] // D, 1)
        for d in range(D):
            local = ids[d * bd:(d + 1) * bd].reshape(-1)
            n = local.size
            if n == 0:
                continue
            slice_n, pad_n = _slice_layout(n, M)
            padded = np.pad(local, (0, pad_n - n))
            worst = 0
            for m in range(M):
                sl = padded[m * slice_n:(m + 1) * slice_n]
                real = _slice_real(m, slice_n, n, np.arange(slice_n))
                owner = _owner_of(sl, rows_per_shard, M)
                cnt = np.bincount(owner[real], minlength=M)
                worst = max(worst, int(cnt.max(initial=0)))
            if worst > 8:   # the capacity floor of 8 already covers it
                # +0.5 lands int() in _a2a_capacity exactly on `worst`
                need = max(need, (worst + 0.5) * M / slice_n)
    if need == 0.0:
        return 1.0
    return float(margin * need)


def _a2a_capacity(slice_n, nshards, capacity_factor):
    """Per-shard request-bucket size; the lookup and the overflow counter
    must agree on it."""
    return max(int(capacity_factor * slice_n / nshards), 8)


# The a2a lookup, the overflow counter and required_capacity_factor's numpy
# replay agree on how the n = b * F local requests split into M slices and
# which shard owns each id through these helpers (numpy or torch).

def _slice_layout(n, nshards):
    """(slice_n, pad_n): each model rank serves a ceil(n / M) slice."""
    slice_n = -(-n // nshards)
    return slice_n, slice_n * nshards


def _slice_real(m, slice_n, n, positions):
    """Mask of slice positions (`positions` = arange(slice_n)) that are real
    requests, not the ceil-pad tail past n."""
    return (m * slice_n + positions) < n


def _owner_of(ids, rows_per_shard, nshards):
    """Owning shard of each id (clipped, so padding ids stay routable)."""
    return (ids // rows_per_shard).clip(0, nshards - 1)


def _wrap(ids, nrows):
    return torch.where(ids < 0, ids + nrows, ids)


def _oob_nan(out, ids, nrows):
    """NaN rows for ids outside [-nrows, nrows), as the replicated lookup
    gives them (no shard owns such an id, which would otherwise read as a
    zero row)."""
    oob = (ids < -nrows) | (ids >= nrows)
    return torch.where(oob[..., None], torch.nan, out)


def _local_ids(ids, mesh, rows_per_shard):
    """(ids relative to this shard, whether this shard owns them)."""
    local = ids - mesh.model_index * rows_per_shard
    return local, (local >= 0) & (local < rows_per_shard)


def _shard_grad(g, local, owned, shard):
    """The dense gradient of the shard from g [N, E] at the local ids
    (the ids it does not own are dropped: they go in as R)."""
    rows = shard.shape[0]
    ids = torch.where(owned, local, rows).reshape(-1)
    return table_grad(g.reshape(-1, shard.shape[1]), ids, rows).to(
        shard.dtype)


class _PsumLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, values, mesh):
        local, owned = _local_ids(ids, mesh, shard.shape[0])
        rows = torch.where(owned[..., None],
                           shard[torch.where(owned, local, 0)], 0.0)
        if mesh.model_group is not None:
            dist.all_reduce(rows, group=mesh.model_group)
        ctx.save_for_backward(shard, rows, local, owned, values)
        return rows * values[..., None].to(rows.dtype)

    @staticmethod
    def backward(ctx, dout):
        shard, rows, local, owned, values = ctx.saved_tensors
        dshard = dvalues = None
        if ctx.needs_input_grad[2]:
            dvalues = (dout * rows).sum(-1).to(values.dtype)
        if ctx.needs_input_grad[0]:
            dshard = _shard_grad(dout * values[..., None].to(dout.dtype),
                                 local, owned, shard)
        return dshard, None, dvalues, None


def _all_to_all(x, group):
    if group is None:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _a2a_route(ids_flat, mesh, rows_per_shard, capacity_factor):
    """This rank's slice of the requests, sorted by owner into buckets:
    (slice_n, pad_n, cap, order, sorted ids, their owner, their place in
    the bucket, whether they are sent)."""
    M, m = mesh.model_size, mesh.model_index
    n = ids_flat.shape[0]
    slice_n, pad_n = _slice_layout(n, M)
    flat = torch.nn.functional.pad(ids_flat, (0, pad_n - n))
    my = flat[m * slice_n:(m + 1) * slice_n]
    cap = _a2a_capacity(slice_n, M, capacity_factor)
    positions = torch.arange(slice_n, device=ids_flat.device)
    real = _slice_real(m, slice_n, n, positions)
    owner = _owner_of(my, rows_per_shard, M)
    # padding sorts past the last owner, so it never takes capacity
    order = torch.argsort(torch.where(real, owner, M), stable=True)
    s_owner, s_real = owner[order], real[order]
    start = torch.searchsorted(torch.where(s_real, s_owner, M),
                               torch.arange(M, device=ids_flat.device))
    pos = positions - start[s_owner]
    ok = s_real & (pos < cap)
    return slice_n, pad_n, cap, order, my[order], s_owner, pos, ok


class _A2ALookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, shard, ids, values, mesh, capacity_factor):
        b, f = ids.shape
        n, (R, E) = b * f, shard.shape
        M, group = mesh.model_size, mesh.model_group
        slice_n, pad_n, cap, order, s_ids, s_owner, pos, ok = _a2a_route(
            ids.reshape(-1), mesh, R, capacity_factor)
        send = torch.zeros((M, cap), dtype=ids.dtype, device=ids.device)
        send[s_owner[ok], pos[ok]] = s_ids[ok]
        recv = _all_to_all(send, group)                   # [M, cap]
        local, owned = _local_ids(recv, mesh, R)
        rows = torch.where(owned[..., None],
                           shard[torch.where(owned, local, 0)], 0.0)
        back = _all_to_all(rows, group)                   # [M, cap, E]
        got = torch.where(ok[:, None],
                          back[s_owner, torch.where(ok, pos, 0)], 0.0)
        mine = torch.zeros((slice_n, E), dtype=shard.dtype,
                           device=shard.device)
        mine[order] = got
        emb = all_gather_cat(mine, group)[:n].reshape(b, f, E)
        ctx.save_for_backward(shard, emb, values, order, s_owner, pos, ok,
                              local, owned)
        ctx.mesh, ctx.layout = mesh, (slice_n, pad_n, cap)
        return emb * values[..., None].to(emb.dtype)

    @staticmethod
    def backward(ctx, dout):
        shard, emb, values, order, s_owner, pos, ok, local, owned = (
            ctx.saved_tensors)
        slice_n, pad_n, cap = ctx.layout
        mesh = ctx.mesh
        dshard = dvalues = None
        if ctx.needs_input_grad[2]:
            dvalues = (dout * emb).sum(-1).to(values.dtype)
        if ctx.needs_input_grad[0]:
            E = shard.shape[1]
            g = (dout * values[..., None].to(dout.dtype)).reshape(-1, E)
            g = torch.nn.functional.pad(g, (0, 0, 0, pad_n - g.shape[0]))
            # the closing all_gather's backward: this rank's slice only
            m = mesh.model_index
            d_sorted = g[m * slice_n:(m + 1) * slice_n][order]
            d_back = torch.zeros((mesh.model_size, cap, E), dtype=g.dtype,
                                 device=g.device)
            d_back[s_owner[ok], pos[ok]] = d_sorted[ok]
            d_rows = _all_to_all(d_back, mesh.model_group)
            dshard = _shard_grad(d_rows, local, owned, shard)
        return dshard, None, dvalues, None, None


def sharded_embedding_bag(shard, ids, values, mesh):
    """psum lookup: this rank's row block [R, E] of an [M * R, E] table,
    ids and values [B, F] (this data row's, the same on its model ranks)
    -> [B, F, E]."""
    nrows = shard.shape[0] * mesh.model_size
    ids = ids.long()
    out = _PsumLookup.apply(shard, _wrap(ids, nrows), values, mesh)
    return _oob_nan(out, ids, nrows)


def sharded_embedding_bag_a2a(shard, ids, values, mesh, capacity_factor=2.0):
    """all-to-all lookup (see the module docstring); same arguments and
    result as sharded_embedding_bag, but requests past a bucket's capacity
    give zero rows."""
    nrows = shard.shape[0] * mesh.model_size
    ids = ids.long()
    out = _A2ALookup.apply(shard, _wrap(ids, nrows), values, mesh,
                           capacity_factor)
    return _oob_nan(out, ids, nrows)


def a2a_overflow_count(ids, nfeat, mesh, *, mask=None, capacity_factor=2.0):
    """The number of real requests the a2a exchange drops this step, summed
    over every rank (a float32 0-d tensor): per slice, the real requests
    past each bucket's capacity. ids [B, F] and mask [B] (mask-0 pad rows
    are not real) are this data row's."""
    M = mesh.model_size
    rows_per_shard = max(nfeat // M, 1)
    b, f = ids.shape
    n = b * f
    m = mesh.model_index
    slice_n, pad_n = _slice_layout(n, M)
    flat = torch.nn.functional.pad(ids.reshape(-1).long(), (0, pad_n - n))
    if mask is None:
        mask = torch.ones((b,), device=ids.device)
    rreal = torch.nn.functional.pad(
        (mask[:, None] > 0).expand(b, f).reshape(-1), (0, pad_n - n))
    sl = slice(m * slice_n, (m + 1) * slice_n)
    positions = torch.arange(slice_n, device=ids.device)
    real = _slice_real(m, slice_n, n, positions) & rreal[sl]
    owner = _owner_of(_wrap(flat[sl], nfeat), rows_per_shard, M)
    hist = torch.bincount(owner[real], minlength=M)
    cap = _a2a_capacity(slice_n, M, capacity_factor)
    dropped = (hist - cap).clamp_min(0).sum().float()
    if mesh.distributed:
        dist.all_reduce(dropped)
    return dropped
