"""GC-ARM (gc_arm) in the port against the JAX model, on the CPU at small
widths, with the helpers and tolerances of tests/test_torch_armnet.py:
eval logits (the JAX side through its default path and its Pallas entmax
kernels in interpret mode), one train step's gradients, a 25-step
trajectory, the init scale of the [K, O, E], [K, E, E] and [K, O, F]
parameters, the bridge, and the CLI with predict. GC-ARM differs from
armnet where these tests look: no d_k^-0.5 scale, a global-context bias
on the gates, emb_bn over the fields of exp(emb), and a plain cross with
no exp after it."""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from test_torch_armnet import (ARM_CASES, PARAM_RTOL, check_bridge,
                               check_cli_and_predict, check_eval_logits,
                               check_init_scale, check_one_step,
                               check_trajectory, zoo_kw)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("nhead,h,alpha", ARM_CASES)
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("ensemble", [False, True])
def test_eval_logits_match_jax(ensemble, noutput, nhead, h, alpha, backend):
    kw = zoo_kw("gc_arm", nattn_head=nhead, h=h, alpha=alpha,
                ensemble=ensemble, noutput=noutput)
    check_eval_logits(kw, backend, seed=nhead * 10 + h + noutput)


@pytest.mark.parametrize("alpha", [1.0, 2.0])
@pytest.mark.parametrize("ensemble", [False, True])
def test_one_step_gradients_match_jax(ensemble, alpha):
    check_one_step(zoo_kw("gc_arm", ensemble=ensemble, alpha=alpha), seed=1)


@pytest.mark.parametrize("backend,ensemble", [("auto", False),
                                              ("pallas", True)])
def test_trajectory_matches_jax_train_step(backend, ensemble):
    # the final parameters' rtol: under auto a ReLU below mlp.norms.0 flips
    # at step 17 (one hidden unit's gradient differs from there, as two
    # correct f32 runs may); read 2.0e-2 of the update after 25 steps
    check_trajectory(zoo_kw("gc_arm", ensemble=ensemble), backend, seed=3,
                     param_rtol=0.1 if backend == "auto" else PARAM_RTOL)


def test_init_scale_matches_jax_initializers():
    kw = zoo_kw("gc_arm", nattn_head=8, h=32, nemb=16, nfield=39,
                nfeat=2000)
    check_init_scale(kw, {
        "attn_layers.query": ("xavier", 1.414),
        "attn_layers.bilinear": ("xavier", 1.414),
        "attn_layers.values": ("xavier", 1.414),
        "embedding.weight": ("xavier", 1.0),
        "mlp.linears.0.weight": ("linear", 8 * 32 * 16)})


def test_bridge_round_trip_and_raises():
    check_bridge(zoo_kw("gc_arm", ensemble=True),
                 drop="params/attn_layers/bilinear",
                 misshape="batch_stats/emb_bn/BatchNorm_0/mean")


def test_global_context_enters_every_fields_gates():
    """Adding a row's field sum to the gates: moving one field's embedding
    moves the sparse weights of every field of that row, where armnet's
    weights of the other fields would move only through the entmax's
    threshold."""
    cfg = ModelConfig(**zoo_kw("gc_arm", alpha=1.0))
    layer = create_model(cfg, seed=2).attn_layers
    emb = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        base = layer(emb)
        moved = emb.clone()
        moved[0, 1] += 1.0
        out = layer(moved)
    assert torch.equal(out[1], base[1])
    assert bool((out[0] != base[0]).any(-1).all())


def test_cli_trains_and_predict_scores(tmp_path):
    check_cli_and_predict(tmp_path, "gc_arm", ["--kernels", "pallas-fused"])
