"""Multi-head ARM-Net (armnet) in the port against the JAX model, on the CPU
at small widths: a JAX init (embeddings widened to [-0.5, 0.5], random
BatchNorm running statistics) is bridged into the port, and then

  * eval logits agree (rtol 1e-5, atol 1e-5), the JAX side through its
    default CPU path and through the Pallas entmax kernels in interpret
    mode;
  * one train step's loss (rtol 1e-5) and every gradient (rtol 1e-4,
    atol 1e-6) agree with jax.grad of the JAX step's loss;
  * 25 clamp+Adam steps give losses within 5e-4 and the same final
    parameters and running statistics, but for the leaves whose gradient
    is rounding noise (NOISE_LEAVES), and the JAX side's final state
    scores the same eval logits in the port;
  * each parameter's init lies within the JAX initializer's bound, with a
    std within 10% of it (torch's fans for the [K, E, d_k] shapes);
  * the bridge carries a JAX tree over leaf for leaf and raises on a
    missing, extra or misshapen leaf.

The helpers here serve the other zoo files too (test_torch_gc_arm.py,
test_torch_sa_glu.py, test_torch_afn.py, test_torch_zoo_*.py). The port runs the kernels' plain
versions on the CPU; tests/test_torch_cuda.py holds the kernels to them on
the card.
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.config import set_kernel_backend
from armnet_tpu.models import create_model as jax_create_model
from armnet_tpu.models.config import ModelConfig as JaxModelConfig
from armnet_tpu.ops.initializers import _torch_fans
from armnet_tpu.ops.layers import batch_mask_scope as jax_batch_mask_scope
from armnet_tpu.train.metrics import masked_bce as jax_masked_bce
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu_torch.bridge import (_port_key, flatten_flax, from_jax_arrays,
                                     params_from_jax)
from armnet_tpu_torch import predict
from armnet_tpu_torch.models import (MODEL_NAMES, PORTED, create_model,
                                     param_transform_for)
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import load_checkpoint
from armnet_tpu_torch.train.step import (create_train_state, forward_loss,
                                         init_meters, make_train_step)
from test_torch_armnet1h import jax_armnet1h, jax_logits, port_model
from test_torch_armnet1h import random_batch
from test_torch_train import (BSZ, LR, NEMB, NFEAT, NFIELD, init_pair, make_batches, small_kw, to_jax,
                              to_torch, write_split)


def zoo_kw(model, **kw):
    """A small config of `model` at the 5 fields of the shared helpers."""
    base = small_kw(model=model, h=5, nattn_head=3, alpha=1.7)
    base.update(kw)
    return base


def check_eval_logits(kw, backend, seed):
    """Eval logits of a bridged JAX init, the JAX side under `backend`."""
    jm, v, flat = jax_armnet1h(kw, seed=seed)
    batch = random_batch(np.random.RandomState(1), 16, kw["nfeat"])
    set_kernel_backend(backend)
    try:
        yj = jax_logits(jm, v, batch)
    finally:
        set_kernel_backend("auto")
    with torch.no_grad():
        yt = port_model(flat, kw)(
            {k: torch.from_numpy(a) for k, a in batch.items()}).numpy()
    n = kw["noutput"]
    assert yt.shape == yj.shape == ((16,) if n == 1 else (16, n))
    assert np.ptp(yj) > 1e-3          # logits that differ between rows
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


def check_one_step(kw, seed, tweak=None, noise_atol=1e-6):
    """Every parameter's gradient of one train-mode step (masked BN on a
    padded batch, masked BCE) against jax.grad of the JAX step's loss, and
    the running statistics it leaves. A model with a stored-parameter
    mutation has it applied first on both sides, as both trainers do.
    The noise_leaves, whose gradient is 0 in exact arithmetic, are held at
    atol `noise_atol` (each caller that raises it gives its reading)."""
    jm, params, stats, model = init_pair(kw, seed=seed, tweak=tweak)
    transform = param_transform_for(kw["model"])
    if transform is not None:
        from armnet_tpu.models import param_transform_for as jax_transform
        params = jax_transform(kw["model"])(params)
        transform(model)
    b = make_batches(1, seed=seed + 1, pad_last=20)[0]
    jb = to_jax(b)

    def loss_fn(p):
        with jax_batch_mask_scope(jb["mask"]):
            logits, upd = jm.apply(
                {"params": p, "batch_stats": stats},
                {"id": jb["id"], "value": jb["value"]}, train=True,
                rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jax_masked_bce(logits, jb["y"], jb["mask"]), upd

    (lj, upd), gj = jax.value_and_grad(loss_fn, has_aux=True)(params)
    loss, _ = forward_loss(model, to_torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)

    cfg = ModelConfig(**kw)
    want = params_from_jax(jax.tree.map(np.asarray, gj), cfg)
    assert set(want) == {n for n, _ in model.named_parameters()}
    noise = noise_leaves(model, kw["model"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name].numpy(), rtol=1e-4,
            atol=noise_atol if name in noise else 1e-6, err_msg=name)
    # the running statistics at the gradients' tolerance: the MLP's sum
    # GEMM outputs of a BatchNorm'd exp(z) (arm_bn), whose f32 roundings
    # that BatchNorm magnifies (ROADMAP.md §3, u * kappa)
    after = from_jax_arrays(flatten_flax(jax.tree.map(
        np.asarray, {"params": params,
                     "batch_stats": upd.get("batch_stats", {})})),
        cfg)
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def run_jax_steps(jm, params, stats, batches, backend, param_transform):
    """(losses, final params, final batch_stats) of the JAX train step
    over `batches` under `backend`, with the model's stored-parameter
    mutation at the head of each step."""
    set_kernel_backend(backend)
    try:
        state = jax_train_state(jm, to_jax(batches[0]), lr=LR).replace(
            params=jax.tree.map(jnp.asarray, params),
            batch_stats=jax.tree.map(jnp.asarray, stats))
        step = jax_make_train_step(param_transform=param_transform)
        meters, key, losses = jax_init_meters(), jax.random.key(0), []
        for b in batches:
            state, meters = step(state, meters, to_jax(b), key)
            losses.append(float(meters["loss_last"]))
    finally:
        set_kernel_backend("auto")
    return np.asarray(losses), state.params, state.batch_stats


# Leaves whose gradient is 0 in exact arithmetic because a BatchNorm over
# the same channels follows them and takes out what they add (a shift, or
# through exp a scale): their gradient is f32 rounding noise, which Adam
# turns into steps of +-lr in either package. Besides every hidden MLP bias
# (linears.i.bias before norms.i) and those BatchNorms' running means
# (noise_leaves), per model (none for the rest of the zoo):
NOISE_LEAVES = {
    "armnet": ("arm_bn.bias",),       # through mlp.linears.0 to mlp.norms.0
    "gc_arm": ("arm_bn.bias",),
    "sa_glu": (),
    "afn": ("afn_bn.bias",            # through mlp.linears.0 to mlp.norms.0
            "afn_bias", "emb_bn.bias"),   # exp(. @ afn_kernel + b) to afn_bn
    # the softmax over AFM's pairs takes out a shift of every pair's score:
    # attn_h's bias, and attn_w's for a unit whose ReLU is on for every
    # pair of every row or for none (all 5 units at the tests' init: a
    # bias of +-0.5 against pair products under 0.25; gradients read
    # 1e-10 beside 3e-5 for attn_w.weight)
    "afm": ("afm.attn_h.bias", "afm.attn_w.bias"),
    "nfm": ("fm_bn.bias",),           # through mlp.linears.0 to mlp.norms.0
    # where each field's scores e_src[x] + e_dst[y] share a sign over y,
    # the softmax over y takes out e_src[x] and every field attends alike:
    # at the tests' init gat_1 leaves all 5 fields the same vector, so
    # gat_2 attends over equal vectors and its scorer gets a gradient of
    # rounding noise (read 1e-9 in both halves, beside 4e-2 for gat_2.W)
    "gat": ("gat_2.a",),
}

# Final leaves held to the JAX side's at ||port - jax|| <= rtol * ||jax -
# initial|| + 1e-6 * sqrt(numel), the update's norm setting the scale.
# Read (25 steps, every case of the four files): at most 1.2e-4 (AFN's
# afn_bn.running_mean), 2.0e-2 where a ReLU below mlp.norms.0 flips
# mid-run (gc_arm under auto: step 17, hidden unit 4).
PARAM_RTOL = 1e-3


def noise_leaves(model, name):
    """The leaves of `model` (a port model of zoo name `name`) that
    NOISE_LEAVES' comment describes."""
    keys = set(model.state_dict())
    out = set(NOISE_LEAVES.get(name, ()))
    for key in keys:
        m = re.fullmatch(r"(.*)linears\.(\d+)\.bias", key)
        if m and f"{m[1]}norms.{m[2]}.weight" in keys:
            out |= {key, f"{m[1]}norms.{m[2]}.running_mean"}
    return out


def check_trajectory(kw, backend, seed, tweak=None, param_rtol=PARAM_RTOL):
    """25 identical clamp+Adam steps (the last batch padded) from the same
    weights, the stored-parameter mutation at the head of each step where
    the model has one: losses within 5e-4, as tests/test_torch_train.py
    holds armnet_1h's. The port's final parameters and running statistics
    against the JAX side's (param_rtol of the update, PARAM_RTOL), all
    but the noise_leaves. Then the JAX side's final state, bridged into
    the port, scores the JAX eval logits (rtol/atol 1e-5): eval with
    running statistics that training moved. Returns the port's model."""
    from armnet_tpu.models import param_transform_for as jax_transform

    jm, params, stats, model = init_pair(kw, seed=seed, kernels=backend,
                                         tweak=tweak)
    initial = {k: v.clone() for k, v in model.state_dict().items()}
    batches = make_batches(25, seed=seed + 1, pad_last=24)
    jax_fn = jax_transform(kw["model"])
    lj, pj, sj = run_jax_steps(jm, params, stats, batches, backend, jax_fn)
    transform = param_transform_for(kw["model"])
    state = create_train_state(model, LR)
    step = make_train_step(param_transform=transform)
    meters, lt = init_meters("cpu"), []
    for b in batches:
        meters = step(state, meters, to_torch(b))
        lt.append(float(meters["loss_last"]))
    assert state.step == 25
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(np.asarray(lt), lj, atol=5e-4)

    flat = flatten_flax(jax.tree.map(np.array, {"params": pj,
                                                "batch_stats": sj}))
    want = from_jax_arrays(flat, ModelConfig(**kw))
    skip = noise_leaves(model, kw["model"])
    assert skip <= set(want)
    for name, got in model.state_dict().items():
        if name in skip:
            continue
        gap = float((got - want[name]).norm())
        moved = float((want[name] - initial[name]).norm())
        assert gap <= param_rtol * moved + 1e-6 * got.numel() ** 0.5, (
            name, gap, moved)
    b0 = {k: batches[0][k] for k in ("id", "value")}
    yj = jax_logits(jm, {"params": jax_fn(pj) if jax_fn else pj,
                         "batch_stats": sj}, b0)
    with torch.no_grad():
        yt = port_model(flat, kw)(to_torch(b0)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)
    return model


def check_init_scale(kw, expected, seed=0):
    """Each named parameter's draw, on the port and on the JAX side, lies
    within its initializer's bound and has a std within 10% of the
    expected one. `expected` maps a port parameter name to
    ("xavier", gain), ("xavier_stacked", gain), ("linear", fan_in),
    ("normal", std) or ("zeros",); the xavier bound takes the JAX
    package's torch fans, the stacked one the fans of the trailing two
    dims (one xavier matrix per leading index, GAT's W)."""
    model = create_model(ModelConfig(**kw), seed=seed)
    jm = jax_create_model(JaxModelConfig(**kw))
    b = make_batches(1, seed, nfield=kw["nfield"])[0]
    v = jm.init(jax.random.PRNGKey(seed), {"id": b["id"], "value": b["value"]})
    jax_by_port = {}
    for key, arr in flatten_flax(jax.tree.map(np.array, v)).items():
        name, kind = _port_key(key)
        jax_by_port[name] = arr.T if kind == "transpose" else arr
    params = dict(model.named_parameters())
    for name, (kind, *arg) in expected.items():
        got = params[name].detach().numpy()
        theirs = jax_by_port[name].reshape(got.shape)
        if kind == "zeros":
            assert not got.any() and not theirs.any(), name
            continue
        if kind == "normal":
            bound, std = np.inf, arg[0]
        else:
            if kind == "xavier":
                fan_in, fan_out = _torch_fans(got.shape)
                bound = arg[0] * math.sqrt(6.0 / (fan_in + fan_out))
            elif kind == "xavier_stacked":
                bound = arg[0] * math.sqrt(6.0 / sum(got.shape[-2:]))
            else:
                bound = 1.0 / math.sqrt(arg[0])
            std = bound / math.sqrt(3.0)
        for side, draw in (("port", got), ("jax", theirs)):
            assert np.abs(draw).max() <= bound, (name, side)
            assert abs(draw.std() / std - 1.0) <= 0.1, (name, side,
                                                        draw.std(), std)


def check_bridge(kw, drop, misshape, seed=0):
    """The bridge carries every leaf of a JAX tree to its port key (kernels
    transposed, flat tables reshaped, every other leaf unchanged) and fills
    every parameter and buffer; a missing leaf (`drop`), an extra one and
    one of the wrong shape (`misshape`) raise."""
    _, _, flat = jax_armnet1h(kw, seed=seed)
    cfg = ModelConfig(**kw)
    state = from_jax_arrays(flat, cfg)
    assert set(state) == set(create_model(cfg).state_dict())
    for key, arr in flat.items():
        name, kind = _port_key(key)
        want = arr.T if kind == "transpose" else arr.reshape(
            state[name].shape)
        np.testing.assert_array_equal(state[name].numpy(), want, key)
    model = create_model(cfg)
    model.load_state_dict(state)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(t, state[name], rtol=0, atol=0)
    with pytest.raises(KeyError, match="does not have"):
        from_jax_arrays({**flat, "params/extra/w": np.zeros(3)}, cfg)
    partial = dict(flat)
    del partial[drop]
    with pytest.raises(KeyError, match=_port_key(drop)[0].replace(".", r"\.")):
        from_jax_arrays(partial, cfg)
    bad = dict(flat)
    bad[misshape] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="shape"):
        from_jax_arrays(bad, cfg)


def check_cli_and_predict(tmp_path, model, flags=()):
    """train.cli.main for two epochs of `model` on a tiny split with
    checkpoints, then predict from the best one, both on the CPU: metrics
    rows, scored rows, finite scores. Returns the best checkpoint's
    state_dict."""
    data = tmp_path / "data"
    write_split(str(data / "tiny"), seed=4)
    res = cli.main(["--model", model, "--nfeat", str(NFEAT), "--nfield",
                    str(NFIELD), "--nemb", str(NEMB), "--h", "4",
                    "--nattn_head", "2", "--mlp_nhid", "16", "--lr", "0.01",
                    "--batch_size", str(BSZ), "--epoch", "2", "--patience",
                    "5", "--dataset", "tiny", "--data_dir", str(data),
                    "--log_dir", str(tmp_path / "log"), "--ckpt_dir",
                    str(tmp_path / "ckpt"), "--exp_name", "t", "--seed", "3",
                    "--device", "cpu", *flags])
    assert [r[0] for r in res] == [3] and 0.0 < res[0][1] <= 1.0
    with open(tmp_path / "log" / "t_3" / "metrics.jsonl") as f:
        assert [json.loads(line)["epoch"] for line in f] == [0, 1]
    out = tmp_path / "s.txt"
    summary = predict.main(["--ckpt", str(tmp_path / "ckpt" / "t_3"),
                            "--input", str(data / "tiny" / "test.libsvm"),
                            "--output", str(out), "--device", "cpu"])
    assert summary["model"] == model and summary["rows"] == 70
    scores = np.loadtxt(out)
    assert scores.shape == (70,) and np.isfinite(scores).all()
    return load_checkpoint(str(tmp_path / "ckpt" / "t_3"))[0]


def test_registry_builds_the_five_ported_models():
    """All 21 names of the JAX zoo are ported and build, each with the
    parameter names and shapes of the JAX model's tree (through the
    bridge)."""
    from armnet_tpu.models import MODEL_NAMES as JAX_MODEL_NAMES

    assert PORTED == MODEL_NAMES == JAX_MODEL_NAMES
    assert len(MODEL_NAMES) == 21
    for name in MODEL_NAMES:
        kw = small_kw(model=name, h=4)
        state = create_model(ModelConfig(**kw)).state_dict()
        assert state
        _, _, flat = jax_armnet1h(kw)
        assert set(from_jax_arrays(flat, ModelConfig(**kw))) == set(state)


def test_cli_trains_and_predict_scores(tmp_path):
    check_cli_and_predict(tmp_path, "armnet", ["--ensemble"])


def test_presets_copy_the_jax_package():
    """armnet_tpu_torch/utils/presets.py is the JAX package's recipes, name
    for name and flag for flag, and the port's parser takes every one."""
    from armnet_tpu.utils.presets import PRESETS as JAX_PRESETS
    from armnet_tpu_torch.utils.config import build_arg_parser
    from armnet_tpu_torch.utils.presets import PRESETS

    assert PRESETS == JAX_PRESETS
    for flags in PRESETS.values():
        build_arg_parser().parse_args(flags)


# (nhead, h, alpha): each of nhead {1, 3}, h {2, 5} and alpha {1.0
# (softmax), 1.7, 2.0} at least once
ARM_CASES = [(1, 2, 1.0), (3, 5, 1.7), (3, 2, 2.0), (1, 5, 2.0)]


@pytest.mark.parametrize("backend", ["auto", "pallas"])
@pytest.mark.parametrize("nhead,h,alpha", ARM_CASES)
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("ensemble", [False, True])
def test_eval_logits_match_jax(ensemble, noutput, nhead, h, alpha, backend):
    kw = zoo_kw("armnet", nattn_head=nhead, h=h, alpha=alpha,
                ensemble=ensemble, noutput=noutput)
    check_eval_logits(kw, backend, seed=nhead * 10 + h + noutput)


@pytest.mark.parametrize("alpha", [1.0, 1.7])
@pytest.mark.parametrize("ensemble", [False, True])
def test_one_step_gradients_match_jax(ensemble, alpha):
    check_one_step(zoo_kw("armnet", ensemble=ensemble, alpha=alpha), seed=1)


@pytest.mark.parametrize("backend,ensemble", [("auto", False),
                                              ("pallas", True)])
def test_trajectory_matches_jax_train_step(backend, ensemble):
    check_trajectory(zoo_kw("armnet", ensemble=ensemble), backend, seed=3)


def test_init_scale_matches_jax_initializers():
    """bilinear_w [K, E, d_k], query [K, O, d_k] and values [K, O, F] draw
    xavier_uniform(1.414) with torch's fans for 3-D shapes (fan_in =
    shape[1] * shape[2], fan_out = shape[0] * shape[2])."""
    kw = zoo_kw("armnet", nattn_head=8, h=32, nemb=16, nfield=39,
                nfeat=2000)
    check_init_scale(kw, {
        "attn_layer.bilinear_w": ("xavier", 1.414),
        "attn_layer.query": ("xavier", 1.414),
        "attn_layer.values": ("xavier", 1.414),
        "embedding.weight": ("xavier", 1.0),
        "mlp.linears.0.weight": ("linear", 8 * 32 * 16)})


def test_bridge_round_trip_and_raises():
    check_bridge(zoo_kw("armnet", ensemble=True),
                 drop="batch_stats/arm_bn/BatchNorm_0/var",
                 misshape="params/attn_layer/bilinear_w")


def test_multihead_interaction_matches_jax():
    """mh_gate_proj and arm_attention_multihead (k-major channels k*O + o)
    against the JAX ops, entmax over fields at alpha 1.7."""
    import jax.numpy as jnp

    from armnet_tpu.ops.entmax import sparse_normalizer as jax_normalizer
    from armnet_tpu.ops.interaction import \
        arm_attention_multihead as jax_attention
    from armnet_tpu.ops.interaction import mh_gate_proj as jax_proj
    from armnet_tpu_torch.ops.entmax import sparse_normalizer
    from armnet_tpu_torch.ops.interaction import (arm_attention_multihead,
                                                  mh_gate_proj)

    rng = np.random.RandomState(4)
    emb = rng.uniform(-0.5, 0.5, (8, 5, 4)).astype(np.float32)
    bw = rng.randn(3, 4, 6).astype(np.float32)
    q = rng.randn(3, 7, 6).astype(np.float32)
    vals = rng.randn(3, 7, 5).astype(np.float32)
    mj = np.asarray(jax_proj(jnp.asarray(bw), jnp.asarray(q)))
    mt = mh_gate_proj(torch.from_numpy(bw), torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(mt, mj, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mt[7 * 2 + 3], q[2, 3] @ bw[2].T, rtol=1e-5)
    yj = np.asarray(jax_attention(*map(jnp.asarray, (emb, bw, q, vals)),
                                  jax_normalizer(1.7, axis=1)))
    yt = arm_attention_multihead(*map(torch.from_numpy, (emb, bw, q, vals)),
                                 sparse_normalizer(1.7, axis=1))
    assert yt.shape == (8, 5, 21)
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-6)
