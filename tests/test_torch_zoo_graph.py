"""The field-graph zoo models (gcn, gat) and MultiHeadAttention in the port
against the JAX package, on the CPU at small widths, with the helpers and
tolerances of tests/test_torch_armnet.py: eval logits of a bridged JAX
init (also at three outputs, and with a given adjacency that has zero
entries and a zero row), one train step's gradients, a 25-step
trajectory, the init scale (GAT's W [H, in, out] one xavier matrix per
head, gain 1.414; GCN's weight xavier), the bridge, and the CLI with
predict. Dropout is 0, since the two packages' dropout streams differ.
Also held to their JAX functions: normalize_adj and MultiHeadAttention
with and without a mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.layers import MultiHeadAttention as JaxMultiHeadAttention
from armnet_tpu.ops.layers import normalize_adj as jax_normalize_adj
from armnet_tpu_torch.ops.layers import MultiHeadAttention, normalize_adj
from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)
from test_torch_armnet1h import jax_armnet1h, port_model, random_batch

MODELS = ("gcn", "gat")


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax(model, noutput, nfeat):
    check_eval_logits(zoo_kw(model, nfeat=nfeat, noutput=noutput), "auto",
                      seed=noutput + nfeat // 100)


def adjacency():
    """A [5, 5] adjacency with positive weights, zeros and a zero row."""
    rng = np.random.RandomState(11)
    adj = rng.uniform(0.2, 1.5, (5, 5)).astype(np.float32)
    adj[rng.rand(5, 5) < 0.3] = 0.0
    adj[3] = 0.0
    return adj


@pytest.mark.parametrize("model", MODELS)
def test_eval_logits_match_jax_with_an_adjacency(model):
    """The optional `adj` of both forwards: GCN normalizes it (a zero row
    gets degree factor 0), GAT multiplies the scores by where(adj > 0,
    adj, -9e15)."""
    kw = zoo_kw(model, k=2)
    jm, v, flat = jax_armnet1h(kw, seed=6)
    batch = random_batch(np.random.RandomState(2), 16, kw["nfeat"])
    adj = adjacency()
    yj = np.asarray(jm.apply(v, {k: jnp.asarray(a) for k, a in batch.items()},
                             train=False, adj=jnp.asarray(adj)))
    with torch.no_grad():
        yt = port_model(flat, kw)(
            {k: torch.from_numpy(a) for k, a in batch.items()},
            adj=torch.from_numpy(adj)).numpy()
    assert np.ptp(yj) > 1e-3
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("model", MODELS)
def test_one_step_gradients_match_jax(model):
    """The MLP's hidden biases, which a BatchNorm follows (noise_leaves),
    have a gradient of 0 in exact arithmetic: GCN's read 1.1e-6 apart
    (affine.linears.0.bias, values within 1.5e-6 of 0), so they are held
    at atol 4e-6."""
    check_one_step(zoo_kw(model), seed=1, noise_atol=4e-6)


@pytest.mark.parametrize("model", MODELS)
def test_trajectory_matches_jax_train_step(model):
    check_trajectory(zoo_kw(model), "auto", seed=3)


NFIELD, NEMB, H, HEADS = 39, 16, 64, 4
INIT = {
    "gcn": {"gcn_0.weight": ("xavier", 1.0), "gcn_1.weight": ("xavier", 1.0),
            "gcn_2.bias": ("zeros",),
            "affine.linears.0.weight": ("linear", NFIELD * H)},
    "gat": {"gat_0.W": ("xavier_stacked", 1.414),
            "gat_1.W": ("xavier_stacked", 1.414),
            "gat_0.a": ("linear", 2 * H), "gat_2.a": ("linear", 2 * H),
            "affine.linears.0.weight": ("linear", NFIELD * HEADS * H)},
}


@pytest.mark.parametrize("model", MODELS)
def test_init_scale_matches_jax_initializers(model):
    """GAT's W [H, in, out] takes its fans from (in, out) only: torch's
    fans of the 3-D shape would under-scale it by sqrt(H)."""
    kw = zoo_kw(model, nfield=NFIELD, nfeat=2000, nemb=NEMB, h=H,
                nattn_head=HEADS)
    check_init_scale(kw, {"embedding.weight": ("xavier", 1.0),
                          **INIT[model]})


MISSHAPE = {"gcn": ("params/gcn_1/bias", "params/gcn_0/weight"),
            "gat": ("params/gat_2/a", "params/gat_1/W")}


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("model", MODELS)
def test_bridge_round_trip_and_raises(model, nfeat):
    """GCN's gcn_l/weight|bias and GAT's W and a keep their JAX name and
    layout; the MLP is `affine`."""
    drop, misshape = MISSHAPE[model]
    check_bridge(zoo_kw(model, nfeat=nfeat), drop=drop, misshape=misshape)


@pytest.mark.parametrize("model", MODELS)
def test_cli_trains_and_predict_scores(tmp_path, model):
    check_cli_and_predict(tmp_path, model)


def test_normalize_adj_matches_jax():
    """All ones, a weighted adjacency with a zero row (whose degree factor
    is 0), and one that is not symmetric."""
    rng = np.random.RandomState(5)
    for adj in (np.ones((4, 4), np.float32), adjacency(),
                rng.uniform(0.0, 2.0, (6, 6)).astype(np.float32)):
        want = np.asarray(jax_normalize_adj(jnp.asarray(adj)))
        got = normalize_adj(torch.from_numpy(adj)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    zero_row = normalize_adj(torch.from_numpy(adjacency())).numpy()
    assert not zero_row[3].any() and not zero_row[:, 3].any()


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention_matches_jax(masked):
    """The JAX MultiHeadAttention's weights in the port's layer (the q, k,
    v and output kernels transposed into linears 0-3, the LayerNorm's
    scale and bias): the output and the attention agree, with and without
    a [B, L, L] mask that hides a key from every query."""
    rng = np.random.RandomState(9)
    x = rng.randn(4, 6, 8).astype(np.float32)
    mask = (rng.rand(4, 6, 6) > 0.3).astype(np.float32)
    mask[:, :, 2] = 0.0
    jm = JaxMultiHeadAttention(nhead=3, n_k=5, n_v=7)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    p = jax.tree.map(np.asarray, v["params"])
    p["LayerNorm_0"] = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                        "bias": rng.randn(8).astype(np.float32)}
    m = jnp.asarray(mask) if masked else None
    yj, aj = jm.apply({"params": p}, jnp.asarray(x), m)
    layer = MultiHeadAttention(8, 3, 5, 7, 0.0, torch.Generator())
    with torch.no_grad():
        for i in range(4):
            layer.linears[i].weight.copy_(torch.from_numpy(
                p[f"TorchLinear_{i}"]["kernel"].T))
        layer.layer_norm.weight.copy_(torch.from_numpy(
            p["LayerNorm_0"]["scale"]))
        layer.layer_norm.bias.copy_(torch.from_numpy(p["LayerNorm_0"]["bias"]))
        yt, at = layer(torch.from_numpy(x),
                       torch.from_numpy(mask) if masked else None)
    assert yt.shape == (4, 6, 8) and at.shape == (4, 3, 6, 6)
    if masked:
        assert float(at[..., 2].max()) == 0.0
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
