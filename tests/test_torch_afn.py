"""AFN (afn) in the port against the JAX model, on the CPU at small widths,
with the helpers and tolerances of tests/test_torch_armnet.py: eval logits
(a flat JAX table past 512 rows and a 2-D one below), one train step's
gradients, a 25-step trajectory, the init scale, the bridge of the
top-level table, and the CLI with predict.

AFN's table must stay positive: both trainers apply max(|W|, 1e-4) to the
STORED table at the head of every step and before each eval pass, and the
forward's clamp-abs is where(|W| >= 1e-4, |W|, 1e-4), which gives a weight
at the boundary gradient 1. The step and the trajectory run on tables
seeded with entries at the boundary, negative ones and ones near 0 that
the updates push across it (the port's twin of
tests/test_trajectory_parity.py's AFN case).
"""

import jax
import numpy as np
import pytest
import torch

from armnet_tpu.models.afn import embedding_positivity as jax_positivity
from armnet_tpu_torch.models import create_model, param_transform_for
from armnet_tpu_torch.models.afn import POSITIVE_MIN, embedding_positivity
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.checkpoint import (restore_checkpoint,
                                               save_checkpoint)
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from armnet_tpu_torch.bridge import flatten_flax, from_jax_arrays
from test_torch_armnet import (check_bridge, check_cli_and_predict,
                               check_eval_logits, check_init_scale,
                               check_one_step, check_trajectory, zoo_kw)
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from test_torch_train import LR, init_pair, make_batches, to_jax, to_torch


def near_zero_table(share):
    """A tweak for init_pair: a `share` of the main table uniform within
    2e-3 of 0 (half of it negative, so the updates carry entries across
    the 1e-4 clamp), and a few entries exactly at +-1e-4."""
    def tweak(flat, rng):
        t = flat["params/embedding"]
        pick = rng.rand(*t.shape) < share
        t[pick] = rng.uniform(-2e-3, 2e-3, int(pick.sum()))
        t.reshape(-1)[:12:2] = np.float32(POSITIVE_MIN)
        t.reshape(-1)[1:12:2] = -np.float32(POSITIVE_MIN)
    return tweak


@pytest.mark.parametrize("nfeat", [600, 300])
@pytest.mark.parametrize("noutput", [1, 3])
@pytest.mark.parametrize("ensemble", [False, True])
def test_eval_logits_match_jax(ensemble, noutput, nfeat):
    kw = zoo_kw("afn", nfeat=nfeat, ensemble=ensemble, noutput=noutput)
    check_eval_logits(kw, "auto", seed=noutput + 2 * ensemble)


@pytest.mark.parametrize("ensemble", [False, True])
def test_one_step_gradients_match_jax(ensemble):
    """After the positivity transform, on a table with entries at the
    boundary: the where-based clamp-abs gives them gradient 1 on both
    sides."""
    check_one_step(zoo_kw("afn", ensemble=ensemble), seed=1,
                   tweak=near_zero_table(0.25))


@pytest.mark.parametrize("ensemble", [False, True])
def test_trajectory_matches_jax_train_step(ensemble):
    """25 steps, each after the positivity transform, from a table with 5%
    of its entries seeded near 0: entries cross the clamp during the run,
    and the losses and the final parameters agree with the JAX trainer's
    step (check_trajectory).

    AFN's float32 trajectory is chaotic in both packages (the JAX
    package's own AFN trajectory test says so and runs 10 steps at 2e-3):
    a gradient that is rounding noise (a bias in front of a BatchNorm, an
    entry at the clamp) becomes an Adam step of +-lr either way, and the
    log of an entry near the clamp magnifies any move. From a quarter of
    the table near 0, one of the two runs separates by 1e-3 after 15
    steps; test_every_step_of_a_trajectory_matches_jax_from_its_state
    holds that table step by step instead."""
    model = check_trajectory(zoo_kw("afn", ensemble=ensemble), "auto",
                             seed=3, tweak=near_zero_table(0.05))
    # the last update left entries under the clamp (the next step's
    # transform lifts them)
    assert int((model.embedding.detach() < POSITIVE_MIN).sum()) > 0


def test_every_step_of_a_trajectory_matches_jax_from_its_state():
    """25 JAX train steps from a table with a quarter of its entries near
    0; before each, the JAX state is bridged into the port, which takes
    the same step from it: the step's loss (rtol 1e-5) and the table after
    the positivity transform (exactly) agree, at every state of the run,
    crossed entries included."""
    from armnet_tpu.models import param_transform_for as jax_transform

    kw = zoo_kw("afn", ensemble=True)
    jm, params, stats, _ = init_pair(kw, seed=3, tweak=near_zero_table(0.25))
    batches = make_batches(25, seed=4, pad_last=24)
    cfg = ModelConfig(**kw)
    jstate = jax_train_state(jm, to_jax(batches[0]), lr=LR).replace(
        params=params, batch_stats=stats)
    jstep = jax_make_train_step(param_transform=jax_transform("afn"))
    step = make_train_step(param_transform=embedding_positivity)
    crossed = 0
    for i, b in enumerate(batches):
        flat = flatten_flax(jax.tree.map(np.array, {
            "params": jstate.params, "batch_stats": jstate.batch_stats}))
        model = create_model(cfg)
        model.load_state_dict(from_jax_arrays(flat, cfg))
        crossed += int((model.embedding.detach() < POSITIVE_MIN).sum())
        embedding_positivity(model)
        want = jax_transform("afn")({"embedding": flat["params/embedding"]})
        np.testing.assert_array_equal(
            model.embedding.detach().numpy().reshape(-1),
            np.asarray(want["embedding"]).reshape(-1))
        meters = step(create_train_state(model, LR), init_meters("cpu"),
                      to_torch(b))
        jstate, jmeters = jstep(jstate, jax_init_meters(), to_jax(b),
                                jax.random.key(0))
        np.testing.assert_allclose(float(meters["loss_last"]),
                                   float(jmeters["loss_last"]), rtol=1e-5,
                                   err_msg=f"step {i}")
    assert crossed > 0


def test_positivity_transform_matches_jax():
    """max(|W|, 1e-4) in place on the main table only, as the JAX
    package's embedding_positivity does on its params tree; idempotent."""
    cfg = ModelConfig(**zoo_kw("afn", nfeat=300, ensemble=True))
    model = create_model(cfg, seed=4)
    with torch.no_grad():
        model.embedding[:3] = torch.tensor([0.0, -5e-5, -0.3]).view(3, 1)
    deep = model.ensemble.deep_embedding.weight.detach().clone()
    want = np.asarray(jax_positivity(
        {"embedding": model.embedding.detach().numpy()})["embedding"])
    assert param_transform_for("afn") is embedding_positivity
    assert all(param_transform_for(n) is None
               for n in ("armnet", "armnet_1h", "gc_arm", "sa_glu"))
    embedding_positivity(model)
    np.testing.assert_array_equal(model.embedding.detach().numpy(), want)
    assert float(model.embedding.detach().min()) == np.float32(POSITIVE_MIN)
    once = model.embedding.detach().clone()
    embedding_positivity(model)
    assert torch.equal(model.embedding.detach(), once)
    assert torch.equal(model.ensemble.deep_embedding.weight.detach(), deep)


def test_eval_transform_in_place_keeps_the_trajectory(tmp_path):
    """The trainer applies the transform in place before an eval pass
    (the JAX trainer evaluates a transformed copy): 20 steps straight give
    the same losses as 10 steps, the in-place transform, a checkpoint, a
    fresh state restored from it and 10 more steps."""
    cfg = ModelConfig(**zoo_kw("afn"))
    batches = [to_torch(b) for b in make_batches(20, seed=7, pad_last=9)]
    step = make_train_step(param_transform=embedding_positivity)

    def run(state, bs):
        meters, out = init_meters("cpu"), []
        for b in bs:
            meters = step(state, meters, b)
            out.append(float(meters["loss_last"]))
        return out

    straight = run(create_train_state(create_model(cfg, seed=2), LR),
                   batches)
    state = create_train_state(create_model(cfg, seed=2), LR)
    assert run(state, batches[:10]) == straight[:10]
    embedding_positivity(state.model)
    save_checkpoint(state.model, cfg, tmp_path, tag="last",
                    optimizer=state.optimizer, step=state.step)
    fresh = create_train_state(create_model(cfg, seed=9), LR)
    restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 10
    assert run(fresh, batches[10:]) == straight[10:]


def test_init_scale_matches_jax_initializers():
    """The table xavier_uniform (gain 1, flat in the JAX tree past 512
    rows), afn_kernel N(0, 1) * 0.1, afn_bias 0."""
    kw = zoo_kw("afn", nfield=39, h=64, nfeat=2000, nemb=16)
    check_init_scale(kw, {
        "embedding": ("xavier", 1.0),
        "afn_kernel": ("normal", 0.1),
        "afn_bias": ("zeros",),
        "mlp.linears.0.weight": ("linear", 64 * 16)})


@pytest.mark.parametrize("nfeat", [600, 300])
def test_bridge_round_trip_and_raises(nfeat):
    """The top-level table params/embedding ([R*E] flat past 512 rows,
    [R, E] below) becomes the port's `embedding`."""
    check_bridge(zoo_kw("afn", nfeat=nfeat, ensemble=True),
                 drop="params/embedding", misshape="params/afn_kernel")


def test_cli_trains_and_predict_scores(tmp_path):
    """The CLI and predict on the CPU; the checkpoint, written after an
    eval pass, holds the transformed (positive) table."""
    state = check_cli_and_predict(tmp_path, "afn")
    assert float(state["embedding"].min()) >= np.float32(POSITIVE_MIN)
