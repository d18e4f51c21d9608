"""BatchNorm's kernel route (kernels/bn_cuda.py, K9) on the CPU: the plain
versions of the kernels, through the module's fused route, against the
composed BatchNorm and the JAX package's BatchNorm; their centred variance
on an input near 1 with a spread of 1e-3 (the ARM cells' exp(.)), where an
uncentred one fails; and the route each call takes, and its counters.
The kernels themselves are held to the plain versions on the card
(tests/test_torch_cuda.py)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.layers import BatchNorm as JaxBatchNorm
from armnet_tpu.ops.layers import batch_mask_scope as jax_batch_mask_scope
from armnet_tpu_torch.kernels import bn_cuda
from armnet_tpu_torch.ops import layers
from armnet_tpu_torch.ops.layers import BatchNorm, batch_mask_scope, bn_route
from armnet_tpu_torch.utils import tracing

# [N, C, S] views: arm_bn's [B, O, E] (S 10), an MLP's [B, C] (S 1), a
# channel-last 3-D input (rows B * 5, the mask repeated over them) and S 1
# on channel axis 1
SHAPES = [((12, 6, 10), 1), ((12, 6), -1), ((12, 5, 6), -1), ((12, 6, 1), 1)]


@pytest.fixture
def fused_plain(monkeypatch):
    """The module's fused route on the CPU, the kernels' plain versions in
    their place."""
    monkeypatch.setattr(layers, "bn_route", lambda training, x, ch: "fused")
    monkeypatch.setattr(bn_cuda, "bn_fwd", bn_cuda.bn_fwd_plain)
    monkeypatch.setattr(bn_cuda, "bn_bwd", bn_cuda.bn_bwd_plain)


def _inputs(shape, masked, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    mask = np.ones(shape[0], np.float32)
    if masked:
        mask[7:] = 0.0
        x[7:] = 50.0                     # pad rows: junk the stats must skip
    return x, dy, mask


def _params(n, seed=1):
    rng = np.random.RandomState(seed)
    return ({"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
             "bias": rng.normal(0, 0.1, n).astype(np.float32)},
            {"mean": rng.normal(0, 0.3, n).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n).astype(np.float32)})


def _torch_run(x, dy, mask, axis, p, s):
    """(y, dx, dweight, dbias, running mean, running var) of one train-mode
    call of the port's BatchNorm and its backward of sum(y * dy)."""
    bn = BatchNorm(x.shape[axis], axis).train()
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})
    xt = torch.from_numpy(x).requires_grad_()
    with batch_mask_scope(None if mask is None else torch.from_numpy(mask)):
        y = bn(xt)
    (y * torch.from_numpy(dy)).sum().backward()
    return [t.detach().numpy() for t in (y, xt.grad, bn.weight.grad,
                                         bn.bias.grad, bn.running_mean,
                                         bn.running_var)]


def _jax_run(x, dy, mask, axis, p, s):
    """The same from the JAX package's BatchNorm (its VJP for the
    gradients)."""
    jm = JaxBatchNorm(channel_axis=axis)

    def f(xx, params):
        v = {"params": {"BatchNorm_0": params},
             "batch_stats": {"BatchNorm_0": s}}
        if mask is None:
            return jm.apply(v, xx, train=True, mutable=["batch_stats"])
        with jax_batch_mask_scope(jnp.asarray(mask)):
            return jm.apply(v, xx, train=True, mutable=["batch_stats"])

    (y, upd), vjp = jax.vjp(f, jnp.asarray(x), p, has_aux=False)
    dx, dp = vjp((jnp.asarray(dy), jax.tree.map(jnp.zeros_like, upd)))
    st = upd["batch_stats"]["BatchNorm_0"]
    return [np.asarray(t) for t in (y, dx, dp["scale"], dp["bias"],
                                    st["mean"], st["var"])]


NAMES = ("y", "dx", "dweight", "dbias", "running_mean", "running_var")


def _close(got, want, what):
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(
            1.0, float(np.abs(b).max())), err_msg=f"{what}: {name}")


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape,axis", SHAPES)
def test_plain_kernels_match_composed_and_jax(fused_plain, shape, axis,
                                              masked):
    """The fused route with the plain versions against the composed
    BatchNorm (the CPU's own route) and the JAX package's: output, dx,
    dweight, dbias and the running statistics, the pad rows filled with
    outliers that neither statistic may see."""
    x, dy, mask = _inputs(shape, masked)
    mask = mask if masked else None
    p, s = _params(shape[axis])
    with tracing.recording() as rec:
        fused = _torch_run(x, dy, mask, axis, p, s)
    assert dict(rec.counters) == {"armnet.bn.fused": 1}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(layers, "bn_route",
                   lambda training, x, ch: "composed")
        composed = _torch_run(x, dy, mask, axis, p, s)
    _close(fused, composed, "fused (plain) vs composed")
    _close(fused, _jax_run(x, dy, mask, axis, p, s), "fused (plain) vs JAX")


def _uncentred_var(x3, w, n):
    """sum w x^2 / n - mean^2 in float32: the variance the kernels must not
    take."""
    wv = w.view(-1, 1, 1)
    mean = (x3 * wv).sum((0, 2)) / n
    return (x3.square() * wv).sum((0, 2)) / n - mean.square()


def test_variance_is_centred_on_an_input_near_one():
    """x = 1 + 1e-3 noise (arm_bn's exp(.) at the cells' weight scale),
    [4096, 4, 10], the last 96 rows pad rows: the plain version's
    variance is within 1e-4 of the float64 one and its output within 1e-3
    (unit-variance outputs); an uncentred float32 variance, sum x^2 / n -
    mean^2, misses the variance by more than 10% and fails."""
    rng = np.random.RandomState(5)
    x = (1.0 + 1e-3 * rng.randn(4096, 4, 10)).astype(np.float32)
    mask = np.ones(4096, np.float32)
    mask[-96:] = 0.0
    x3, w = torch.from_numpy(x), torch.from_numpy(mask)
    count, spatial = w.sum(), 10
    n = float(count) * spatial
    weight, bias = torch.ones(4), torch.zeros(4)
    y, mean, rstd = bn_cuda.bn_fwd_plain(x3, w, count, spatial, weight, bias,
                                         torch.zeros(4), torch.ones(4), 1e-5,
                                         0.9)
    real = x[mask > 0].astype(np.float64)
    mu64 = real.mean((0, 2))
    var64 = real.var((0, 2))
    y64 = (x.astype(np.float64) - mu64[None, :, None]) / np.sqrt(
        var64 + 1e-5)[None, :, None]
    var = (1.0 / rstd.double().square() - 1e-5).numpy()
    np.testing.assert_allclose(var, var64, rtol=1e-4)
    np.testing.assert_allclose(y.numpy()[mask > 0], y64[mask > 0], atol=1e-3)
    bad = _uncentred_var(x3, w, n).double().numpy()
    assert np.abs(bad / var64 - 1).max() > 0.1


def test_route_by_device_dtype_mode_and_shape():
    """The kernels take a train-mode float32 CUDA input with S > 1 alone:
    the CPU, a bfloat16 input, eval mode and S = 1 (an MLP's [B, C], or a
    channel-last input) take the composed ops (devices stood in for by
    what the rule reads), and each call counts its route."""
    def on(dtype, cuda, shape=(4, 3, 10)):
        return types.SimpleNamespace(dtype=dtype, is_cuda=cuda, shape=shape)

    assert bn_route(True, on(torch.float32, True), 1) == "fused"
    assert bn_route(True, on(torch.float32, True, (4, 3, 2, 5)), 1) == \
        "fused"
    assert bn_route(True, on(torch.bfloat16, True), 1) == "composed"
    assert bn_route(False, on(torch.float32, True), 1) == "composed"
    assert bn_route(True, on(torch.float32, True, (4, 3)), 1) == "composed"
    assert bn_route(True, on(torch.float32, True), 2) == "composed"
    assert bn_route(True, on(torch.float32, True, (4, 3, 1)), 1) == \
        "composed"
    assert bn_route(True, torch.zeros(2, 3, 4), 1) == "composed"
    bn = BatchNorm(3)
    before = tracing.counts("armnet.bn.")
    with tracing.recording() as rec:
        bn.train()(torch.randn(4, 3))
        bn.train()(torch.randn(4, 3).bfloat16())
        bn.eval()(torch.randn(4, 3))
    assert dict(rec.counters) == {"armnet.bn.composed": 3}
    after = tracing.counts("armnet.bn.")
    assert after["armnet.bn.composed"] - before.get(
        "armnet.bn.composed", 0) == 3
    assert after.get("armnet.bn.fused", 0) == before.get("armnet.bn.fused", 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """For a tensor that is not on the card the kernels' wrappers raise:
    nothing falls back to the plain version."""
    x = torch.ones(4, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        bn_cuda.bn_fwd(x, None, None, 8, torch.ones(3), torch.zeros(3),
                       torch.zeros(3), torch.ones(3), 1e-5, 0.9)
    with pytest.raises(ValueError, match="CUDA"):
        bn_cuda.bn_bwd(x, x, None, None, 8, torch.ones(3), torch.zeros(3),
                       torch.ones(3))
