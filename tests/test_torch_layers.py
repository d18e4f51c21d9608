"""The port's shared layers against the flax modules of the JAX package,
with the same weights (flax [in, out] kernels transposed to torch [out, in])
and the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.embedding import scaled_embedding_lookup
from armnet_tpu.ops.layers import MLP as JaxMLP
from armnet_tpu.ops.layers import BatchNorm as JaxBatchNorm
from armnet_tpu.ops.layers import TorchLinear as JaxTorchLinear
from armnet_tpu.ops.layers import batch_mask_scope as jax_batch_mask_scope
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.embedding import embedding_bag
from armnet_tpu_torch.ops.layers import (MLP, BatchNorm, Dropout, Embedding,
                                         TorchLinear, batch_mask_scope,
                                         dropout_scope)

ATOL = 1e-6


def _rng(seed):
    return np.random.RandomState(seed)


def _bn_state(rng, n):
    return ({"scale": rng.uniform(0.5, 1.5, n).astype(np.float32),
             "bias": rng.normal(0, 0.1, n).astype(np.float32)},
            {"mean": rng.normal(0, 0.3, n).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, n).astype(np.float32)})


def _load_bn(bn, p, s):
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(s["mean"]),
                        "running_var": torch.from_numpy(s["var"])})


@pytest.mark.parametrize("nrows", [20, 600])   # JAX one-hot and gather paths
def test_embedding_index_semantics_match_jax(nrows):
    rng = _rng(0)
    table = rng.randn(nrows, 4).astype(np.float32)
    ids = rng.randint(-nrows, nrows, (6, 5)).astype(np.int32)
    ids[0, 0], ids[1, 2], ids[2, 4] = nrows, -nrows - 1, -1   # OOB, OOB, wrap
    values = rng.rand(6, 5).astype(np.float32)
    jt = (jnp.asarray(table.reshape(-1)) if nrows > 512
          else jnp.asarray(table))            # the JAX flat-table layout
    yj = np.asarray(scaled_embedding_lookup(jt, jnp.asarray(ids),
                                            jnp.asarray(values), nemb=4))
    yt = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                       torch.from_numpy(values)).numpy()
    assert np.isnan(yt[0, 0]).all() and np.isnan(yt[1, 2]).all()
    assert not np.isnan(np.delete(yt.reshape(30, 4), [0, 7], 0)).any()
    np.testing.assert_allclose(yt, yj, atol=ATOL)   # NaNs compare equal


def test_embedding_module_gathers_its_table():
    emb = Embedding(50, 3, torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 49, -1]])
    out = emb(ids, torch.ones(1, 3))
    torch.testing.assert_close(out[0], emb.weight[[0, 49, 49]])


def test_torch_linear_matches_flax():
    rng = _rng(1)
    x = rng.randn(7, 12).astype(np.float32)
    jm = JaxTorchLinear(5)
    p = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    lin = TorchLinear(12, 5, torch.Generator().manual_seed(0))
    lin.load_state_dict({"weight": torch.from_numpy(np.array(p["kernel"]).T),
                         "bias": torch.from_numpy(np.array(p["bias"]))})
    yj = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    with torch.no_grad():
        np.testing.assert_allclose(lin(torch.from_numpy(x)).numpy(), yj,
                                   atol=ATOL)


@pytest.mark.parametrize("shape,axis", [((6, 8, 4), 1), ((9, 16), -1)])
def test_batchnorm_eval_matches_flax(shape, axis):
    rng = _rng(2)
    x = rng.randn(*shape).astype(np.float32)
    n = shape[axis]
    p, s = _bn_state(rng, n)
    jm = JaxBatchNorm(channel_axis=axis)
    yj = np.asarray(jm.apply(
        {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}},
        jnp.asarray(x), train=False))
    bn = BatchNorm(n, axis).eval()
    _load_bn(bn, p, s)
    with torch.no_grad():
        np.testing.assert_allclose(bn(torch.from_numpy(x)).numpy(), yj,
                                   atol=ATOL)


def _bn_train_pair(x, axis, mask=None, seed=4):
    """(port output, port running stats, JAX output, JAX running stats) of
    one train-mode BatchNorm call from the same weights and statistics,
    inside both packages' batch_mask_scope when a mask is given."""
    rng = _rng(seed)
    n = x.shape[axis]
    p, s = _bn_state(rng, n)
    jm = JaxBatchNorm(channel_axis=axis)
    v = {"params": {"BatchNorm_0": p}, "batch_stats": {"BatchNorm_0": s}}
    bn = BatchNorm(n, axis).train()
    _load_bn(bn, p, s)
    if mask is None:
        yj, upd = jm.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
        yt = bn(torch.from_numpy(x))
    else:
        with jax_batch_mask_scope(jnp.asarray(mask)):
            yj, upd = jm.apply(v, jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        with batch_mask_scope(torch.from_numpy(mask)):
            yt = bn(torch.from_numpy(x))
    st = upd["batch_stats"]["BatchNorm_0"]
    return (yt.detach().numpy(), (bn.running_mean.numpy(),
                                  bn.running_var.numpy()),
            np.asarray(yj), (np.asarray(st["mean"]), np.asarray(st["var"])))


def test_batchnorm_train_mode_matches_jax():
    """Train mode is ported: unmasked batch statistics (biased variance to
    normalize, the unbiased one into the running average, momentum 0.1)
    match the JAX BatchNorm in train mode."""
    x = _rng(5).randn(9, 16).astype(np.float32) * 2 + 0.5
    yt, (mt, vt), yj, (mj, vj) = _bn_train_pair(x, -1)
    np.testing.assert_allclose(yt, yj, atol=ATOL)
    np.testing.assert_allclose(mt, mj, atol=ATOL)
    np.testing.assert_allclose(vt, vj, atol=ATOL)


@pytest.mark.parametrize("shape,axis", [((12, 8, 4), 1), ((12, 16), -1)])
def test_batchnorm_masked_train_matches_jax(shape, axis):
    """A padded batch under batch_mask_scope: the output and the running
    statistics after one update match JAX, and the pad rows (filled with
    outliers) move neither."""
    rng = _rng(6)
    x = rng.randn(*shape).astype(np.float32)
    mask = np.ones(shape[0], np.float32)
    mask[7:] = 0.0
    x[7:] = 50.0                        # pad rows: junk the stats must skip
    yt, (mt, vt), yj, (mj, vj) = _bn_train_pair(x, axis, mask)
    np.testing.assert_allclose(yt[:7], yj[:7], atol=ATOL)
    # pad outputs are ~150 (one f32 ulp is 1.5e-5 there): relative
    np.testing.assert_allclose(yt[7:], yj[7:], rtol=1e-6)
    np.testing.assert_allclose(mt, mj, atol=ATOL)
    np.testing.assert_allclose(vt, vj, atol=ATOL)
    # the same real rows alone, unmasked, give the same statistics
    _, (mr, vr), _, _ = _bn_train_pair(x[:7], axis)
    np.testing.assert_allclose(mt, mr, atol=ATOL)
    np.testing.assert_allclose(vt, vr, atol=ATOL)


def test_batchnorm_raises_on_input_not_batch_led():
    bn = BatchNorm(6, channel_axis=0).train()
    with batch_mask_scope(torch.ones(6)):
        with pytest.raises(ValueError, match="not batch-led"):
            bn(torch.zeros(6, 3))
    with batch_mask_scope(torch.ones(5)):
        with pytest.raises(ValueError, match="not batch-led"):
            BatchNorm(3).train()(torch.zeros(4, 3))


def test_batchnorm_train_mode_has_gradients():
    x = torch.from_numpy(_rng(7).randn(8, 5).astype(np.float32))
    x.requires_grad_()
    bn = BatchNorm(5).train()
    bn(x).square().sum().backward()
    assert x.grad is not None and bn.weight.grad is not None
    # the mean is normalized out: the gradient sums to 0 per channel
    np.testing.assert_allclose(x.grad.sum(0).numpy(), 0.0, atol=1e-4)


def test_dropout_draws_from_the_scope_generator():
    drop = Dropout(0.5).train()
    x = torch.ones(64, 32)
    with dropout_scope(torch.Generator().manual_seed(3)):
        a = drop(x)
    with dropout_scope(torch.Generator().manual_seed(3)):
        b = drop(x)
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    with pytest.raises(ValueError, match="dropout_scope"):
        drop(x)
    torch.testing.assert_close(drop.eval()(x), x)
    torch.testing.assert_close(Dropout(0.0).train()(x), x)


def test_mlp_eval_matches_flax():
    rng = _rng(3)
    x = rng.randn(8, 12).astype(np.float32)
    jm = JaxMLP(2, 16, 0.0, 3)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    params = jax.tree.map(np.array, v["params"])
    stats = {f"BatchNorm_{i}": {"BatchNorm_0": _bn_state(rng, 16)[1]}
             for i in range(2)}
    yj = np.asarray(jm.apply({"params": params, "batch_stats": stats},
                             jnp.asarray(x), train=False))
    mlp = MLP(12, 2, 16, 0.0, 3, torch.Generator().manual_seed(0)).eval()
    for i, lin in enumerate(mlp.linears):
        p = params[f"TorchLinear_{i}"]
        lin.weight.data = torch.from_numpy(p["kernel"].T.copy())
        lin.bias.data = torch.from_numpy(p["bias"])
    for i, bn in enumerate(mlp.norms):
        _load_bn(bn, params[f"BatchNorm_{i}"]["BatchNorm_0"],
                 stats[f"BatchNorm_{i}"]["BatchNorm_0"])
    with torch.no_grad():
        np.testing.assert_allclose(mlp(torch.from_numpy(x)).numpy(), yj,
                                   atol=ATOL)


def test_initializers_follow_torch_bounds_and_seed():
    g = torch.Generator().manual_seed(7)
    w = init.xavier_uniform((30, 10), g, gain=1.414)
    assert w.dtype == torch.float32 and w.shape == (30, 10)
    assert float(w.abs().max()) <= 1.414 * (6.0 / 40) ** 0.5
    b = init.torch_linear_uniform((500,), 25, g)
    assert float(b.abs().max()) <= 0.2
    again = init.xavier_uniform((30, 10), torch.Generator().manual_seed(7),
                                gain=1.414)
    torch.testing.assert_close(w, again)
    with pytest.raises(ValueError):
        init.xavier_uniform((5,), g)
