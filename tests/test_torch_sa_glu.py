"""SA-GLU (sa_glu) in the port against the JAX model, on the CPU at small
widths, with the helpers and tolerances of tests/test_torch_armnet.py:
eval logits, one train step's gradients, a 25-step trajectory, the init
scale, the bridge (q, k and v of each self-attention are bias-free
TorchLinear_0-2 in the JAX tree, linears.0-2 in the port), and the CLI
with predict. SA-GLU has no entmax, so the JAX side runs its default
path only."""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.bridge import from_jax_arrays
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops import initializers as init
from armnet_tpu_torch.ops.layers import SelfAttnLayer, TorchLinear
from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)
from test_torch_armnet1h import jax_armnet1h


@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("ensemble", [False, True])
def test_eval_logits_match_jax(ensemble, noutput):
    kw = zoo_kw("sa_glu", ensemble=ensemble, noutput=noutput)
    check_eval_logits(kw, "auto", seed=noutput + 2 * ensemble)


@pytest.mark.parametrize("ensemble", [False, True])
def test_one_step_gradients_match_jax(ensemble):
    check_one_step(zoo_kw("sa_glu", ensemble=ensemble), seed=1)


@pytest.mark.parametrize("ensemble", [False, True])
def test_trajectory_matches_jax_train_step(ensemble):
    check_trajectory(zoo_kw("sa_glu", ensemble=ensemble), "auto", seed=3)


def test_init_scale_matches_jax_initializers():
    kw = zoo_kw("sa_glu", nemb=64, nfield=39, nfeat=2000)
    check_init_scale(kw, {
        **{f"self_attn_{b}.linears.{i}.weight": ("linear", 64)
           for b in "wv" for i in range(3)},
        "w_b": ("zeros",), "v_b": ("zeros",),
        "embedding.weight": ("xavier", 1.0),
        "mlp.linears.0.weight": ("linear", 39 * 64)})


def test_bridge_round_trip_and_raises():
    check_bridge(zoo_kw("sa_glu", ensemble=True),
                 drop="params/self_attn_v/TorchLinear_2/kernel",
                 misshape="params/w_b")


def test_bridge_maps_self_attention_kernels_transposed():
    """self_attn_w/TorchLinear_i/kernel [in, out] becomes
    self_attn_w.linears.i.weight [out, in], and no bias is expected."""
    kw = zoo_kw("sa_glu", nemb=6)
    _, _, flat = jax_armnet1h(kw, seed=1)
    assert not any("self_attn" in k and k.endswith("/bias") for k in flat)
    state = from_jax_arrays(flat, ModelConfig(**kw))
    for b in "wv":
        for i in range(3):
            kernel = flat[f"params/self_attn_{b}/TorchLinear_{i}/kernel"]
            np.testing.assert_array_equal(
                state[f"self_attn_{b}.linears.{i}.weight"].numpy(), kernel.T)
            assert f"self_attn_{b}.linears.{i}.bias" not in state


def test_bias_free_linear_draws_no_bias():
    """TorchLinear(bias=False) holds no bias and draws only its weight
    from the generator, so the draws after it are those of a generator
    that drew the weight alone."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    lin = TorchLinear(4, 3, g1, bias=False)
    assert lin.bias is None and [n for n, _ in lin.named_parameters()] == [
        "weight"]
    torch.testing.assert_close(lin.weight,
                               init.torch_linear_uniform((3, 4), 4, g2))
    assert torch.equal(torch.rand(2, generator=g1),
                       torch.rand(2, generator=g2))
    attn = SelfAttnLayer(4, torch.Generator().manual_seed(0))
    out, a = attn(torch.randn(2, 5, 4))
    assert out.shape == (2, 5, 4) and a.shape == (2, 5, 5)
    torch.testing.assert_close(a.sum(-1), torch.ones(2, 5))


def test_cli_trains_and_predict_scores(tmp_path):
    check_cli_and_predict(tmp_path, "sa_glu", ["--ensemble"])
