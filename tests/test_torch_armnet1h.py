"""armnet_1h in the port against the JAX model: the JAX init (with running
statistics that are not trivial and embeddings widened so the exponential
neurons leave 1) is bridged into the port, and eval logits must agree.
The JAX side runs both its default CPU path and the Pallas entmax kernel in
interpret mode; h=128 takes the Pallas mid-axis entry, h=6 the general one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.config import set_kernel_backend
from armnet_tpu.models import create_model as jax_create_model
from armnet_tpu.models.config import ModelConfig as JaxModelConfig
from armnet_tpu_torch.bridge import flatten_flax, from_jax_arrays
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig

NFIELD = 5


def small_config(**kw):
    base = dict(model="armnet_1h", nfeat=600, nfield=NFIELD, nemb=4, h=128,
                mlp_nlayer=2, mlp_nhid=16, alpha=2.0, ensemble=False,
                dnn_nlayer=1, dnn_nhid=8, noutput=1)
    base.update(kw)
    return base


def random_batch(rng, nrow, nfeat):
    return {"id": rng.randint(0, nfeat, (nrow, NFIELD)).astype(np.int32),
            "value": rng.uniform(0.0, 1.2, (nrow, NFIELD)).astype(np.float32)}


def jax_armnet1h(kw, seed=0):
    """(JAX model, flax variables as numpy) with embeddings in [-0.5, 0.5]
    and random BatchNorm running statistics."""
    model = jax_create_model(JaxModelConfig(**kw))
    rng = np.random.RandomState(seed)
    batch = random_batch(rng, 4, kw["nfeat"])
    v = jax.tree.map(np.array, model.init(
        jax.random.PRNGKey(seed), {k: jnp.asarray(a) for k, a in batch.items()}))
    flat = flatten_flax(v)
    for key, arr in flat.items():
        if key.endswith("/embedding"):
            arr[...] = rng.uniform(-0.5, 0.5, arr.shape)
        elif key.endswith("/mean"):
            arr[...] = rng.normal(0.0, 0.3, arr.shape)
        elif key.endswith("/var"):
            arr[...] = rng.uniform(0.5, 1.5, arr.shape)
    return model, v, flat


def jax_logits(model, v, batch):
    return np.asarray(model.apply(
        v, {k: jnp.asarray(a) for k, a in batch.items()}, train=False))


def port_model(flat, kw):
    cfg = ModelConfig(**kw)
    model = create_model(cfg)
    model.load_state_dict(from_jax_arrays(flat, cfg))
    return model.eval()


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("h,alpha,nfeat", [(128, 2.0, 600), (6, 1.7, 300)])
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("ensemble", [False, True])
def test_eval_logits_match_jax(ensemble, noutput, h, alpha, nfeat, backend):
    kw = small_config(h=h, alpha=alpha, nfeat=nfeat, ensemble=ensemble,
                      noutput=noutput)
    jm, v, flat = jax_armnet1h(kw, seed=h + noutput)
    batch = random_batch(np.random.RandomState(1), 16, nfeat)
    set_kernel_backend(backend)
    try:
        yj = jax_logits(jm, v, batch)
    finally:
        set_kernel_backend("auto")
    with torch.no_grad():
        yt = port_model(flat, kw)(
            {k: torch.from_numpy(a) for k, a in batch.items()}).numpy()
    assert yt.shape == yj.shape == ((16,) if noutput == 1 else (16, noutput))
    assert np.ptp(yj) > 1e-3          # logits that differ between rows
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


def test_interaction_matches_jax():
    from armnet_tpu.ops.interaction import arm1h_interaction as jax_arm1h
    from armnet_tpu_torch.ops.interaction import arm1h_interaction

    rng = np.random.RandomState(2)
    emb = rng.uniform(-0.5, 0.5, (8, NFIELD, 4)).astype(np.float32)
    wk = rng.randn(4, 4).astype(np.float32)
    q = rng.randn(128, 4).astype(np.float32)
    vals = rng.randn(128, NFIELD).astype(np.float32)
    yj = np.asarray(jax_arm1h(*map(jnp.asarray, (emb, wk, q, vals)), 2.0))
    yt = arm1h_interaction(*map(torch.from_numpy, (emb, wk, q, vals)), 2.0)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)


def test_bridge_raises_on_leftover_missing_and_misshapen_leaves():
    kw = small_config(ensemble=True)
    _, _, flat = jax_armnet1h(kw)
    cfg = ModelConfig(**kw)
    with pytest.raises(KeyError, match="does not have"):
        from_jax_arrays({**flat, "params/extra/w": np.zeros(3)}, cfg)
    partial = dict(flat)
    del partial["batch_stats/arm_bn/BatchNorm_0/var"]
    with pytest.raises(KeyError, match="arm_bn.running_var"):
        from_jax_arrays(partial, cfg)
    bad = dict(flat)
    bad["params/attn_layer/query"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_arrays(bad, cfg)


def test_create_model_raises_for_models_not_ported():
    """Every zoo name is ported now (dnn builds); a name outside the zoo
    raises ValueError."""
    assert create_model(ModelConfig(model="dnn")).state_dict()
    with pytest.raises(ValueError, match="unknown"):
        create_model(ModelConfig(model="bogus"))


def test_init_is_seeded_and_train_mode_raises():
    """The init is seeded; train mode, which used to raise, now runs: a
    train-mode forward is finite, every parameter gets a gradient, and the
    running statistics of every BatchNorm (arm_bn, both MLPs) move."""
    cfg = ModelConfig(**small_config(ensemble=True))
    a, b = create_model(cfg, seed=3), create_model(cfg, seed=3)
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(ta, tb)
    batch = {k: torch.from_numpy(x) for k, x in
             random_batch(np.random.RandomState(0), 4, cfg.nfeat).items()}
    y = a.train()(batch)
    assert y.shape == (4,) and bool(torch.isfinite(y).all())
    y.sum().backward()
    assert all(p.grad is not None for p in a.parameters())
    for key, t in a.state_dict().items():
        if key.endswith("running_mean"):
            assert not torch.equal(t, b.state_dict()[key]), key
