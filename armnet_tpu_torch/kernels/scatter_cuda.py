"""Embedding-table gradient (port of armnet_tpu/kernels/scatter_pallas.py):
the dense [nrows, E] gradient of a row gather, a duplicate-safe scatter-add
of g [N, E] at ids [N].

  table_grad         the whole gradient on the card in one call of
                     csrc/table_grad.cu (port of the Pallas `_kernel_v4`
                     and its prep): the key prep inside a stable radix sort,
                     the zero fill, the segmented sums; raises on anything
                     but CUDA tensors
  sort_ids           the card's stable radix sort alone (keys, int32
                     permutation): the hook that holds it to a stable sort
  keys_plain         the plain key prep: wrapped ids, nrows for a dropped id
  sort_ids_plain     keys_plain, then a stable torch.sort
  table_grad_plain   the plain PyTorch version: index_add_ into zeros

Ids follow the forward gather (ops/embedding.py) and JAX's .at[].add: ids
in [-nrows, 0) wrap to id + nrows, ids outside [-nrows, nrows) are dropped
(their forward rows were NaN). The kernels sum each row's updates in their
order in g, in exact f32, so two runs give the same bits; a row with more
than CHUNK updates is summed in pieces and the pieces added in order,
which is still deterministic but may round differently from a sequential
sum. index_add_ on CUDA adds with atomics in no fixed order, so it agrees
to rounding only. ops/embedding picks between the kernel and the plain
version by device.
"""

import ctypes

import torch

from armnet_tpu_torch.kernels import build

__all__ = ["table_grad", "table_grad_plain", "sort_ids", "sort_ids_plain",
           "keys_plain", "CHUNK"]

CHUNK = 256      # csrc/table_grad.cu kChunk: the longest segment summed whole
_P = ctypes.c_void_p
_I = ctypes.c_int


def keys_plain(ids, nrows):
    """int32 sort keys of ids (any device): id + nrows for an id in
    [-nrows, 0), the id in [0, nrows), nrows (dropped) for any other."""
    _check_nrows(nrows)
    ids = ids.reshape(-1).long()
    wrapped = torch.where(ids < 0, ids + nrows, ids)
    valid = (wrapped >= 0) & (wrapped < nrows)
    return torch.where(valid, wrapped, nrows).to(torch.int32)


def sort_ids_plain(ids, nrows):
    """(sorted int32 keys, int32 stable-sort permutation), the plain
    version of sort_ids (any device)."""
    sid, order = torch.sort(keys_plain(ids, nrows), stable=True)
    return sid, order.to(torch.int32)


def table_grad_plain(g, ids, nrows):
    """Plain PyTorch version (any device): zeros(nrows, E).index_add_."""
    keys = keys_plain(ids, nrows)
    valid = keys < nrows
    out = torch.zeros((nrows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, keys[valid], g.float()[valid])


def _check_nrows(nrows):
    if not 0 < nrows < 2 ** 31 - 1:
        raise ValueError(f"table_grad needs 0 < nrows < 2^31 - 1, got {nrows}")


def _check(who, *specs):
    """Each (tensor, dtypes) must be a contiguous CUDA tensor of one of the
    dtypes."""
    for t, dtypes in specs:
        if not t.is_cuda:
            raise ValueError(f"{who} needs CUDA tensors, got {t.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{who} needs {' or '.join(map(str, dtypes))}, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who} needs contiguous tensors")
    if specs[0][0].numel() >= 2 ** 31:
        raise ValueError(f"{who} takes fewer than 2^31 updates")


_SCRATCH_BYTES = {}


def _scratch(n, e, device):
    nbytes = _SCRATCH_BYTES.get((n, e))
    if nbytes is None:
        nbytes = _SCRATCH_BYTES[n, e] = build.function(
            "table_grad", "armnet_table_grad_scratch", [_I, _I],
            ctypes.c_longlong)(n, e)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


_IDS = (torch.int32, torch.int64)


def sort_ids(ids, nrows):
    """(sorted int32 keys, int32 stable-sort permutation) of the ids [N]
    (int32 or int64, contiguous, on the card): the keys of keys_plain,
    sorted by the kernel's radix sort. Raises on what it does not take."""
    _check("sort_ids", (ids, _IDS))
    _check_nrows(nrows)
    n = ids.numel()
    sid = torch.empty(n, dtype=torch.int32, device=ids.device)
    perm = torch.empty_like(sid)
    build.launch("table_grad", "armnet_table_sort", [_P, _I, _I, _I, _P, _P,
                                                     _P, _P], ids.device,
                 ids.data_ptr(), ids.dtype == torch.int64, n, nrows,
                 sid.data_ptr(), perm.data_ptr(),
                 _scratch(n, 1, ids.device).data_ptr())
    return sid, perm


def table_grad(g, ids, nrows):
    """Dense [nrows, E] float32 gradient of a gather of g's rows at ids, on
    the card: g [N, E] (made contiguous float32), ids [N] int32 or int64,
    contiguous. Raises on what the kernel does not take. Counted in the
    ledger as armnet.kernel.table_grad (build.launch)."""
    if not g.is_cuda:
        raise ValueError(f"table_grad needs CUDA tensors, got {g.device}")
    g = g.float().contiguous()
    _check("table_grad", (ids, _IDS), (g, (torch.float32,)))
    _check_nrows(nrows)
    if g.ndim != 2 or ids.shape != (g.shape[0],):
        raise ValueError(f"table_grad: g {tuple(g.shape)} and ids "
                         f"{tuple(ids.shape)} do not fit")
    n, e = g.shape
    out = torch.empty((nrows, e), dtype=torch.float32, device=g.device)
    build.launch("table_grad", "armnet_table_grad",
                 [_P, _P, _I, _I, _I, _I, _P, _P, _P], g.device,
                 g.data_ptr(), ids.data_ptr(), ids.dtype == torch.int64, n,
                 nrows, e, out.data_ptr(),
                 _scratch(n, e, g.device).data_ptr(), call="table_grad")
    return out
