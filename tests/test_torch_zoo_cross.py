"""The explicit-cross zoo models (dcn, dcn+, cin, xdfm) in the port against
the JAX models, on the CPU at small widths, with the helpers and
tolerances of tests/test_torch_armnet.py: eval logits of a bridged JAX
init (dcn+ and xdfm also at three outputs), one train step's gradients,
a 25-step trajectory, the init scale (DCN's w_l [in, 1] and CIN's
filter_k [F * C_prev, nfilter] with nn.Linear's init, b_l zeros), the
bridge, and the CLI with predict. Dropout is 0, since the two packages'
dropout streams differ. Also held to their JAX functions: cross_layer and
compressed_interaction_step, and the scalar-head guard."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.interaction import \
    compressed_interaction_step as jax_cin_step
from armnet_tpu.ops.interaction import cross_layer as jax_cross_layer
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.interaction import (compressed_interaction_step,
                                              cross_layer)
from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)

MODELS = ("dcn", "dcn+", "cin", "xdfm")


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax(model, nfeat):
    check_eval_logits(zoo_kw(model, nfeat=nfeat), "auto", seed=nfeat // 100)


@pytest.mark.parametrize("model", ["dcn+", "xdfm"])
def test_eval_logits_match_jax_at_three_outputs(model):
    check_eval_logits(zoo_kw(model, noutput=3), "auto", seed=8)


@pytest.mark.parametrize("model", MODELS)
def test_one_step_gradients_match_jax(model):
    check_one_step(zoo_kw(model), seed=1)


@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_jax_train_step(model):
    check_trajectory(zoo_kw(model), "auto", seed=3)


NFIELD, NEMB, H = 39, 16, 64
INIT = {
    "dcn": {**{f"cross_net.w_{l}": ("linear", NFIELD * NEMB)
               for l in range(3)},
            **{f"cross_net.b_{l}": ("zeros",) for l in range(3)},
            "w.weight": ("linear", NFIELD * NEMB)},
    "dcn+": {"cross_net.w_0": ("linear", NFIELD * NEMB),
             "cross_net.b_2": ("zeros",),
             "mlp.linears.2.weight": ("linear", 256),
             "w.weight": ("linear", NFIELD * NEMB + 256)},
    "cin": {"linear.weight": ("normal", 1.0),
            "cin.filter_0": ("linear", NFIELD * NFIELD),
            "cin.filter_1": ("linear", NFIELD * H),
            "cin.filter_2": ("linear", NFIELD * H),
            "cin.affine.weight": ("linear", 3 * H)},
    "xdfm": {"linear.weight": ("normal", 1.0),
             "cin.filter_1": ("linear", NFIELD * H),
             "mlp.linears.0.weight": ("linear", NFIELD * NEMB)},
}


@pytest.mark.parametrize("model", MODELS)
def test_init_scale_matches_jax_initializers(model):
    kw = zoo_kw(model, nfield=NFIELD, nfeat=2000, nemb=NEMB, h=H,
                mlp_nhid=256)
    check_init_scale(kw, {"embedding.weight": ("xavier", 1.0),
                          **INIT[model]})


MISSHAPE = {"dcn": ("params/cross_net/b_1", "params/cross_net/w_2"),
            "dcn+": ("params/w/kernel", "params/cross_net/w_0"),
            "cin": ("params/cin/filter_2", "params/cin/affine/kernel"),
            "xdfm": ("params/cin/affine/kernel", "params/cin/filter_1")}


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_bridge_round_trip_and_raises(model, nfeat):
    """DCN's w_l/b_l and CIN's filter_k keep their JAX name and layout;
    the named bias-free TorchLinears (dcn's `w`, cin's `affine`) become
    [out, in] weights."""
    drop, misshape = MISSHAPE[model]
    check_bridge(zoo_kw(model, nfeat=nfeat), drop=drop, misshape=misshape)


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_and_predict_scores(tmp_path, model):
    check_cli_and_predict(tmp_path, model)


@pytest.mark.parametrize("model", ["dcn", "cin"])
def test_scalar_heads_raise_at_noutput_above_1(model):
    with pytest.raises(ValueError, match="scalar head"):
        create_model(ModelConfig(**zoo_kw(model, noutput=2)))


def test_cross_layer_matches_jax():
    rng = np.random.RandomState(3)
    x0, x = (rng.randn(8, 12).astype(np.float32) for _ in range(2))
    w = rng.randn(12, 1).astype(np.float32)
    b = rng.randn(12).astype(np.float32)
    want = np.asarray(jax_cross_layer(*map(jnp.asarray, (x0, x, w, b))))
    got = cross_layer(*map(torch.from_numpy, (x0, x, w, b))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [6, 7])
def test_compressed_interaction_step_matches_jax(c):
    """x0 [B, F, E], xk [B, C, E] (C = F at the first layer, nfilter
    after), filt [F * C, nfilter]: the ReLU leaves zeros and positives."""
    rng = np.random.RandomState(c)
    x0 = rng.randn(8, 6, 4).astype(np.float32)
    xk = rng.randn(8, c, 4).astype(np.float32)
    filt = rng.randn(6 * c, 5).astype(np.float32) * 0.2
    want = np.asarray(jax_cin_step(*map(jnp.asarray, (x0, xk, filt))))
    got = compressed_interaction_step(
        *map(torch.from_numpy, (x0, xk, filt))).numpy()
    assert got.shape == (8, 5, 4) and (got == 0).any() and (got > 0).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
