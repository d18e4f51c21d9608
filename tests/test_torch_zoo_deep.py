"""The MLP-headed zoo models over flattened embeddings (dnn, wd, dfm, ipnn,
kpnn) in the port against the JAX models, on the CPU at small widths, with
the helpers and tolerances of tests/test_torch_armnet.py: eval logits of a
bridged JAX init at one and three outputs (the first-order logit
broadcast over the classes for wd and dfm), one train step's gradients, a
25-step trajectory, the init scale (KPNN's kernel [E, P, E] with torch's
fans), the bridge, and the CLI with predict. Dropout is 0, since the two
packages' dropout streams differ. Also held to their JAX functions: the
pair index helpers triu_indices and all_pair_indices."""

import numpy as np
import pytest

from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)

MODELS = ("dnn", "wd", "dfm", "ipnn", "kpnn")


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax(model, noutput, nfeat):
    check_eval_logits(zoo_kw(model, nfeat=nfeat, noutput=noutput), "auto",
                      seed=noutput + nfeat // 100)


@pytest.mark.parametrize("model", MODELS)
def test_one_step_gradients_match_jax(model):
    check_one_step(zoo_kw(model), seed=1)


@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_jax_train_step(model):
    check_trajectory(zoo_kw(model), "auto", seed=3)


NFIELD, NEMB, NPAIR = 39, 16, 39 * 38 // 2
INIT = {
    "dnn": {"mlp.linears.0.weight": ("linear", NFIELD * NEMB)},
    "wd": {"linear.weight": ("normal", 1.0),
           "mlp.linears.0.weight": ("linear", NFIELD * NEMB)},
    "dfm": {"linear.weight": ("normal", 1.0), "linear.bias": ("zeros",),
            "mlp.linears.0.weight": ("linear", NFIELD * NEMB)},
    "ipnn": {"mlp.linears.0.weight": ("linear", NFIELD * NEMB + NPAIR)},
    "kpnn": {"kernel": ("xavier", 1.0),
             "mlp.linears.0.weight": ("linear", NFIELD * NEMB + NPAIR)},
}


@pytest.mark.parametrize("model", MODELS)
def test_init_scale_matches_jax_initializers(model):
    """The tables xavier_uniform, FeaturesLinear N(0, 1) with a zero bias,
    the MLP nn.Linear's init over the flat embeddings (and the pair
    products); KPNN's kernel [E, P, E] xavier_uniform with fan_in P * E,
    fan_out E * E."""
    kw = zoo_kw(model, nfield=NFIELD, nfeat=2000, nemb=NEMB)
    check_init_scale(kw, {"embedding.weight": ("xavier", 1.0),
                          **INIT[model]})


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_bridge_round_trip_and_raises(model, nfeat):
    misshape = {"kpnn": "params/kernel",
                "wd": "params/linear/weight"}.get(
                    model, "params/mlp/TorchLinear_0/kernel")
    check_bridge(zoo_kw(model, nfeat=nfeat),
                 drop="batch_stats/mlp/BatchNorm_1/BatchNorm_0/mean",
                 misshape=misshape)


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_and_predict_scores(tmp_path, model):
    check_cli_and_predict(tmp_path, model)


def test_kpnn_pair_products_match_an_explicit_loop():
    """KPNN's einsum against e_i^T K[:, p, :] e_j pair by pair."""
    import torch

    from armnet_tpu_torch.models import create_model
    from armnet_tpu_torch.models.config import ModelConfig

    model = create_model(ModelConfig(**zoo_kw("kpnn")), seed=1)
    rng = np.random.RandomState(0)
    ei = torch.from_numpy(rng.randn(3, 10, 4).astype(np.float32))
    ej = torch.from_numpy(rng.randn(3, 10, 4).astype(np.float32))
    k = model.kernel.detach()
    with torch.no_grad():
        got = model.pair_products(ei, ej)
    want = torch.stack([torch.stack([ei[b, p] @ k[:, p, :] @ ej[b, p]
                                     for p in range(10)]) for b in range(3)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n", [1, 2, 10, 39])
def test_pair_indices_match_jax(n):
    """triu_indices at diagonal offsets 0 and 1 (the strict upper triangle
    that AFM and PNN pair), and all_pair_indices, equal to the JAX
    package's index arrays, in order."""
    from armnet_tpu.ops.layers import all_pair_indices as jax_all_pairs
    from armnet_tpu.ops.layers import triu_indices as jax_triu
    from armnet_tpu_torch.ops.layers import all_pair_indices, triu_indices

    cases = [(triu_indices(n, d), jax_triu(n, d)) for d in (0, 1)]
    cases.append((all_pair_indices(n), jax_all_pairs(n)))
    for got, want in cases:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
