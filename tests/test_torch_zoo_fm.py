"""The FM family of the zoo (lr, fm, hofm, afm, nfm) in the port against
the JAX models, on the CPU at small widths, with the helpers and
tolerances of tests/test_torch_armnet.py: eval logits of a bridged JAX
init (FeaturesLinear's weight flat [R] in the JAX tree past 512 rows and
[R, 1] below; HOFM's wide [R, nemb * (k - 1)] table), one train step's
gradients, a 25-step trajectory, the init scale, the bridge, and the CLI
with predict. Dropout is 0, since the two packages' dropout streams
differ. Also held to their JAX functions: FeaturesLinear, fm_pool and
the ANOVA kernel, and the scalar-head guard."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.interaction import anova_kernel as jax_anova
from armnet_tpu.ops.layers import fm_pool as jax_fm_pool
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.interaction import anova_kernel
from armnet_tpu_torch.ops.layers import fm_pool
from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)

MODELS = ("lr", "fm", "hofm", "afm", "nfm")
SCALAR = ("lr", "fm", "hofm", "afm")


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax(model, nfeat):
    check_eval_logits(zoo_kw(model, nfeat=nfeat), "auto", seed=nfeat // 100)


def test_eval_logits_match_jax_hofm_order_4_and_nfm_multiclass():
    """HOFM at order 4 (orders 3 and 4 through the ANOVA kernel, a
    [R, 3 * nemb] table) and NFM's [B, 3] head with the first-order logit
    broadcast over the classes."""
    check_eval_logits(zoo_kw("hofm", k=4), "auto", seed=4)
    check_eval_logits(zoo_kw("nfm", noutput=3), "auto", seed=5)


@pytest.mark.parametrize("model", MODELS)
def test_one_step_gradients_match_jax(model):
    check_one_step(zoo_kw(model), seed=1)


@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_jax_train_step(model):
    check_trajectory(zoo_kw(model), "auto", seed=3)


INIT = {
    "lr": {"linear.weight": ("normal", 1.0), "linear.bias": ("zeros",)},
    "fm": {"linear.weight": ("normal", 1.0),
           "embedding.weight": ("xavier", 1.0)},
    "hofm": {"linear.weight": ("normal", 1.0),
             "embedding.weight": ("xavier", 1.0)},
    "afm": {"linear.weight": ("normal", 1.0),
            "embedding.weight": ("xavier", 1.0),
            "afm.attn_w.weight": ("linear", 16),
            "afm.attn_h.weight": ("linear", 64),
            "afm.attn_p.weight": ("linear", 16)},
    "nfm": {"linear.weight": ("normal", 1.0),
            "embedding.weight": ("xavier", 1.0),
            "mlp.linears.0.weight": ("linear", 16)},
}


@pytest.mark.parametrize("model", MODELS)
def test_init_scale_matches_jax_initializers(model):
    """FeaturesLinear's weight N(0, 1) (nn.Embedding's default; flat in the
    JAX tree at 2000 rows), its bias 0; the tables xavier_uniform (HOFM's
    [R, 2 * nemb] at k = 3)."""
    kw = zoo_kw(model, nfield=39, nfeat=2000, nemb=16, h=64)
    check_init_scale(kw, INIT[model])


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_bridge_round_trip_and_raises(model, nfeat):
    """params/linear/weight ([R] past 512 rows, [R, 1] below) becomes
    linear.weight [R, 1]; HOFM's flat [R * nemb * (k - 1)] table becomes
    [R, nemb * (k - 1)]."""
    check_bridge(zoo_kw(model, nfeat=nfeat), drop="params/linear/bias",
                 misshape="params/linear/weight")


def test_bridge_reshapes_hofm_table_and_linear_weight():
    from armnet_tpu_torch.bridge import from_jax_arrays
    from test_torch_armnet1h import jax_armnet1h

    kw = zoo_kw("hofm", nfeat=600, k=4)
    _, _, flat = jax_armnet1h(kw, seed=2)
    assert flat["params/embedding/embedding"].shape == (600 * 4 * 3,)
    assert flat["params/linear/weight"].shape == (600,)
    state = from_jax_arrays(flat, ModelConfig(**kw))
    assert state["embedding.weight"].shape == (600, 12)
    np.testing.assert_array_equal(
        state["embedding.weight"].numpy()[7],
        flat["params/embedding/embedding"][7 * 12:8 * 12])
    assert state["linear.weight"].shape == (600, 1)
    np.testing.assert_array_equal(state["linear.weight"].numpy()[:, 0],
                                  flat["params/linear/weight"])


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_and_predict_scores(tmp_path, model):
    check_cli_and_predict(tmp_path, model)


@pytest.mark.parametrize("model", SCALAR)
def test_scalar_heads_raise_at_noutput_above_1(model):
    with pytest.raises(ValueError, match="scalar head"):
        create_model(ModelConfig(**zoo_kw(model, noutput=3)))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_anova_kernel_matches_jax(order):
    x = np.random.RandomState(order).randn(8, 6, 4).astype(np.float32)
    want = np.asarray(jax_anova(jnp.asarray(x), order))
    got = anova_kernel(torch.from_numpy(x), order).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if order == 2:                 # the second-order ANOVA kernel is FM's
        np.testing.assert_allclose(
            got, fm_pool(torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce_dim", [True, False])
def test_fm_pool_matches_jax(reduce_dim):
    x = np.random.RandomState(7).randn(8, 6, 4).astype(np.float32)
    want = np.asarray(jax_fm_pool(jnp.asarray(x), reduce_dim))
    got = fm_pool(torch.from_numpy(x), reduce_dim).numpy()
    assert got.shape == ((8,) if reduce_dim else (8, 4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nfeat", [600, 300])
def test_features_linear_matches_jax(nfeat):
    """The JAX FeaturesLinear (flat weight past 512 rows, 2-D below)
    against the port's on the same weights, wrapped ids included."""
    import jax

    from armnet_tpu.ops.layers import FeaturesLinear as JaxFeaturesLinear
    from armnet_tpu_torch.ops.layers import FeaturesLinear

    rng = np.random.RandomState(nfeat)
    ids = rng.randint(-nfeat, nfeat, (16, 5)).astype(np.int32)
    vals = rng.uniform(0.0, 1.2, (16, 5)).astype(np.float32)
    jm = JaxFeaturesLinear(nfeat)
    v = jm.init(jax.random.PRNGKey(0), ids, vals)
    w = np.asarray(v["params"]["weight"])
    assert w.shape == ((nfeat,) if nfeat > 512 else (nfeat, 1))
    v = {"params": {"weight": w, "bias": np.float32([0.25])}}
    want = np.asarray(jm.apply(v, ids, vals))
    lin = FeaturesLinear(nfeat, torch.Generator())
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.reshape(nfeat, 1)))
        lin.bias.fill_(0.25)
        got = lin(torch.from_numpy(ids), torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
