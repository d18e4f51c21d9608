"""BatchNorm's train-mode forward and backward on the card: the kernels of
csrc/batch_norm.cu (K9, new in the port: the JAX package's BatchNorm is XLA
ops and has no Pallas kernel), and their plain PyTorch versions.

Every tensor is viewed as x3 [N, C, S]: rows, channels and the product of
the axes after the channel. `rows` [N] is the rows' mask as float32 (1
real, 0 pad) or None; `count` the number of real rows (summed over the
data-parallel group, a float32 scalar tensor) or None; `spatial` what one
count stands for, so that n = max(count, 1) * spatial, or n = spatial
without a mask.

  bn_fwd / bn_fwd_plain   x3, rows, count, spatial, weight, bias,
                          running_mean, running_var, eps, keep, group ->
                          (y3, mean, rstd); the running statistics updated
                          in place (keep of the old, the variance unbiased
                          by n / (n - 1))
  bn_bwd / bn_bwd_plain   x3, dy3, rows, count, spatial, weight, mean, rstd,
                          group -> (dx3, dweight, dbias)

With a group the channel sums go through all_reduce_sum between the
passes, so the statistics are the group's; dweight and dbias stay the
rank's own. The variance is centred (the mean first, then the squares
about it), and the sums past a thread's rows are float64; the plain
versions take every sum in float64. The kernels take contiguous float32
CUDA tensors, or raise. Nothing falls back.
"""

import ctypes

import torch

from armnet_tpu_torch.kernels import build
from armnet_tpu_torch.parallel.mesh import all_reduce_sum

__all__ = ["bn_fwd", "bn_bwd", "bn_fwd_plain", "bn_bwd_plain"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_F = ctypes.c_float


def _n(count, spatial, device):
    """n as a float64 tensor."""
    if count is None:
        return torch.tensor(float(spatial), dtype=torch.float64, device=device)
    return count.double().clamp_min(1.0) * spatial


def _rows(rows, x3):
    return 1.0 if rows is None else rows.view(-1, 1, 1).to(x3.dtype)


def bn_fwd_plain(x3, rows, count, spatial, weight, bias, running_mean,
                 running_var, eps, keep, group=None):
    """Plain forward (any device): (y3, mean, rstd), the running statistics
    updated in place."""
    w = _rows(rows, x3)
    n = _n(count, spatial, x3.device)
    sx = all_reduce_sum((x3.double() * w).sum((0, 2)), group)
    mean = (sx / n).float()
    d = x3 - mean.view(1, -1, 1)
    sq = all_reduce_sum((d.double().square() * w).sum((0, 2)), group)
    var = (sq / n).float()
    rstd = torch.rsqrt(var + eps)
    unbias = (n / (n - 1).clamp_min(1.0)).float()
    with torch.no_grad():
        running_mean.copy_(keep * running_mean + (1 - keep) * mean)
        running_var.copy_(keep * running_var + (1 - keep) * var * unbias)
    y = d * (rstd * weight).view(1, -1, 1) + bias.view(1, -1, 1)
    return y, mean, rstd


def bn_bwd_plain(x3, dy3, rows, count, spatial, weight, mean, rstd,
                 group=None):
    """Plain backward (any device): (dx3, dweight, dbias)."""
    d = x3 - mean.view(1, -1, 1)
    s1 = dy3.double().sum((0, 2))
    p = (dy3.double() * d.double()).sum((0, 2))
    dbias, dweight = s1.float(), (p * rstd.double()).float()
    s1, p = all_reduce_sum(s1, group), all_reduce_sum(p, group)
    n = _n(count, spatial, x3.device)
    r = rstd.double()
    b = (s1 / n).float().view(1, -1, 1)
    c = (r * r * p / n).float().view(1, -1, 1)
    a = (rstd * weight).view(1, -1, 1)
    dx = a * (dy3 - _rows(rows, x3) * (b + d * c))
    return dx, dweight, dbias


def _check(who, *tensors):
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"{who} needs CUDA tensors, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{who} needs float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{who} needs contiguous tensors")


def _sizes(who, x3, rows, count, *channel):
    if x3.ndim != 3 or x3.numel() == 0:
        raise ValueError(f"{who} takes a non-empty [N, C, S] tensor, got "
                         f"{tuple(x3.shape)}")
    n, c, s = x3.shape
    if c * s >= 2 ** 31:
        raise ValueError(f"{who} takes rows of fewer than 2^31 floats")
    if rows is not None and rows.shape != (n,):
        raise ValueError(f"{who}: rows {tuple(rows.shape)} is not ({n},)")
    if count is not None and count.numel() != 1:
        raise ValueError(f"{who}: count has {count.numel()} elements")
    for t in channel:
        if t.shape != (c,):
            raise ValueError(f"{who}: {tuple(t.shape)} is not ({c},)")
    return n, c, s


def _ptr(t):
    return None if t is None else t.data_ptr()


def _sums(mode, x3, dy3, rows, count, spatial, sx, mean, rstd, dgamma,
          dbeta, out):
    n, c, s = x3.shape
    nbytes = build.function("batch_norm", "armnet_bn_scratch_bytes",
                            [_L, _I, _I, _I], _L)(n, c, s, out.shape[0])
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=x3.device)
    build.launch("batch_norm", "armnet_bn_sums",
                 [_I, _P, _P, _P, _P, _D, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                  _I, _P], x3.device,
                 mode, _ptr(x3), _ptr(dy3), _ptr(rows), _ptr(count),
                 float(spatial), _ptr(sx), _ptr(mean), _ptr(rstd),
                 _ptr(dgamma), _ptr(dbeta), out.data_ptr(), scratch.data_ptr(),
                 n, c, s)


def bn_fwd(x3, rows, count, spatial, weight, bias, running_mean, running_var,
           eps, keep, group=None):
    """The forward on the card: (y3, mean, rstd) float32, the running
    statistics updated in place. It launches the mean's and the squares'
    sums and folds, the statistics and the output; one call in the ledger
    (armnet.kernel.bn_fwd)."""
    _check("bn_fwd", x3, rows, count, weight, bias, running_mean, running_var)
    n, c, s = _sizes("bn_fwd", x3, rows, count, weight, bias, running_mean,
                     running_var)
    dev = x3.device
    sx = torch.empty((1, c), dtype=torch.float64, device=dev)
    _sums(0, x3, None, rows, count, spatial, None, None, None, None, None, sx)
    sx = all_reduce_sum(sx, group)
    sq = torch.empty_like(sx)
    _sums(1, x3, None, rows, count, spatial, sx, None, None, None, None, sq)
    sq = all_reduce_sum(sq, group)
    mean = torch.empty(c, dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    build.launch("batch_norm", "armnet_bn_stats",
                 [_P, _P, _P, _D, _F, _F, _F, _P, _P, _P, _P, _I, _P], dev,
                 sx.data_ptr(), sq.data_ptr(), _ptr(count), float(spatial),
                 eps, keep, 1 - keep, mean.data_ptr(), rstd.data_ptr(),
                 running_mean.data_ptr(), running_var.data_ptr(), c)
    y = torch.empty_like(x3)
    build.launch("batch_norm", "armnet_bn_apply",
                 [_P, _P, _P, _P, _P, _P, _L, _I, _I, _P], dev,
                 x3.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                 weight.data_ptr(), bias.data_ptr(), y.data_ptr(), n, c, s,
                 call="bn_fwd")
    return y, mean, rstd


def bn_bwd(x3, dy3, rows, count, spatial, weight, mean, rstd, group=None):
    """The backward on the card: (dx3, dweight, dbias) float32. It launches
    the two sums, their fold and dx; one call in the ledger
    (armnet.kernel.bn_bwd)."""
    _check("bn_bwd", x3, dy3, rows, count, weight, mean, rstd)
    n, c, s = _sizes("bn_bwd", x3, rows, count, weight, mean, rstd)
    if dy3.shape != x3.shape:
        raise ValueError(f"bn_bwd: dy {tuple(dy3.shape)} is not "
                         f"{tuple(x3.shape)}")
    dev = x3.device
    sums = torch.empty((2, c), dtype=torch.float64, device=dev)
    dweight = torch.empty_like(weight)
    dbias = torch.empty_like(weight)
    _sums(2, x3, dy3, None, None, spatial, None, mean, rstd, dweight, dbias,
          sums)
    sums = all_reduce_sum(sums, group)
    dx = torch.empty_like(x3)
    build.launch("batch_norm", "armnet_bn_dx",
                 [_P, _P, _P, _P, _D, _P, _P, _P, _P, _P, _L, _I, _I, _P],
                 dev, x3.data_ptr(), dy3.data_ptr(), _ptr(rows), _ptr(count),
                 float(spatial), sums.data_ptr(), mean.data_ptr(),
                 rstd.data_ptr(), weight.data_ptr(), dx.data_ptr(), n, c, s,
                 call="bn_bwd")
    return dx, dweight, dbias
