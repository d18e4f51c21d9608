"""Embedding-table gradient (port of armnet_tpu/kernels/scatter_pallas.py):
the dense [nrows, E] gradient of a row gather, a duplicate-safe scatter-add
of g [N, E] at ids [N].

  table_grad         sort the ids (stable torch.sort), then launch the CUDA
                     kernel (csrc/table_grad.cu, port of the Pallas
                     `_kernel_v4`) on CUDA tensors; raises on anything else
  table_grad_sorted  the kernel launch alone, on ids already sorted
  table_grad_plain   the plain PyTorch version: index_add_ into zeros

Ids follow the forward gather (ops/embedding.py) and JAX's .at[].add: ids
in [-nrows, 0) wrap to id + nrows, ids outside [-nrows, nrows) are dropped
(their forward rows were NaN). The kernel sums each row's updates in their
order in g, in exact f32, so two runs give the same bits; index_add_ on
CUDA adds with atomics in no fixed order, so it agrees to rounding only.
ops/embedding picks between the kernel and the plain version by device.
"""

import ctypes

import torch

from armnet_tpu_torch.kernels import build

__all__ = ["table_grad", "table_grad_sorted", "table_grad_plain",
           "sort_ids", "LAUNCHES"]

# kernel launches since the count was last set to 0 (the one place that
# adds to it is table_grad_sorted, right after a successful launch)
LAUNCHES = 0


def _wrap(ids, nrows):
    """(ids wrapped into [0, nrows) where they can be, in-range mask)."""
    ids = ids.reshape(-1).long()
    wrapped = torch.where(ids < 0, ids + nrows, ids)
    return wrapped, (wrapped >= 0) & (wrapped < nrows)


def table_grad_plain(g, ids, nrows):
    """Plain PyTorch version (any device): zeros(nrows, E).index_add_."""
    wrapped, valid = _wrap(ids, nrows)
    out = torch.zeros((nrows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, wrapped[valid], g.float()[valid])


def sort_ids(ids, nrows):
    """(sorted int32 keys, int64 stable-sort permutation): wrapped ids, with
    every id outside [-nrows, nrows) keyed nrows, which the kernel drops."""
    if not 0 < nrows < 2 ** 31 - 1:
        raise ValueError(f"table_grad needs 0 < nrows < 2^31 - 1, got {nrows}")
    wrapped, valid = _wrap(ids, nrows)
    keys = torch.where(valid, wrapped, nrows).to(torch.int32)
    return torch.sort(keys, stable=True)


def table_grad_sorted(g, sid, order, nrows):
    """The CUDA kernel on ids sorted by `sort_ids`: g [N, E] contiguous
    float32, sid [N] int32, order [N] int64, all on one card. Raises on
    what the kernel does not take."""
    global LAUNCHES
    for t, dtype in ((g, torch.float32), (sid, torch.int32),
                     (order, torch.int64)):
        if not t.is_cuda:
            raise ValueError(f"table_grad needs CUDA tensors, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"table_grad needs {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("table_grad needs contiguous tensors")
    if g.ndim != 2 or not sid.shape == order.shape == (g.shape[0],):
        raise ValueError(f"table_grad: g {tuple(g.shape)}, sid "
                         f"{tuple(sid.shape)} and order {tuple(order.shape)} "
                         f"do not fit")
    n, e = g.shape
    if n >= 2 ** 31:
        raise ValueError(f"table_grad takes fewer than 2^31 updates, got {n}")
    out = torch.empty((nrows, e), dtype=torch.float32, device=g.device)
    with torch.cuda.device(g.device):
        err = build.function(
            "table_grad", "armnet_table_grad",
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p])(
                g.data_ptr(), sid.data_ptr(), order.data_ptr(), n, nrows, e,
                out.data_ptr(),
                torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"table_grad kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out


def table_grad(g, ids, nrows):
    """Dense [nrows, E] float32 gradient of a gather of g's rows at ids, on
    the card: stable sort of the ids, then the kernel."""
    if not g.is_cuda or not ids.is_cuda:
        raise ValueError(f"table_grad needs CUDA tensors, got {g.device} and "
                         f"{ids.device}")
    sid, order = sort_ids(ids, nrows)
    return table_grad_sorted(g.float().contiguous(), sid, order, nrows)
