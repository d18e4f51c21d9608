"""Training with the port (armnet_tpu_torch) against the JAX package, on the
CPU at small sizes: nfeat 600 (above the 512-row one-hot cut, so JAX takes
its flat-table gather and table_grad_flat), 5 fields, E=4, h=128, batch 64,
inputs from seeded numpy and weights bridged from the JAX init.

  * masked BCE / softmax CE, values and gradients;
  * the shuffled train iterator, epoch by epoch, and the trainer's advance
    of its shuffle counter at construction;
  * one step's gradients of every parameter against jax.grad of the JAX
    train step's loss, and the running statistics it leaves;
  * a 25-step trajectory against armnet_tpu.train.step.make_train_step,
    the JAX side through its default path, through the Pallas entmax
    kernels and through the fused ARM-1h kernels in interpret mode;
  * checkpoint round trip, --resume, and the CLI end to end.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.data.libsvm import BatchIterator as JaxBatchIterator
from armnet_tpu.data.libsvm import LibsvmDataset as JaxLibsvmDataset
from armnet_tpu.kernels.config import set_kernel_backend
from armnet_tpu.models import create_model as jax_create_model
from armnet_tpu.models.config import ModelConfig as JaxModelConfig
from armnet_tpu.ops.layers import batch_mask_scope as jax_batch_mask_scope
from armnet_tpu.train.loop import Trainer as JaxTrainer
from armnet_tpu.train.metrics import masked_bce as jax_masked_bce
from armnet_tpu.train.metrics import masked_softmax_ce as jax_masked_ce
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu.utils.config import ExperimentConfig as JaxExperimentConfig
from armnet_tpu_torch import predict, set_matmul_precision
from armnet_tpu_torch.bridge import (flatten_flax, from_jax_arrays,
                                     params_from_jax)
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          make_dataloaders)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import (load_checkpoint,
                                               restore_checkpoint,
                                               save_checkpoint)
from armnet_tpu_torch.train.loop import Trainer
from armnet_tpu_torch.train.metrics import masked_bce, masked_softmax_ce
from armnet_tpu_torch.train.step import (create_train_state, forward_loss,
                                         init_meters, make_train_step)
from armnet_tpu_torch.utils import tracing
from armnet_tpu_torch.utils.config import ExperimentConfig, build_arg_parser

NFIELD, NFEAT, NEMB, BSZ = 5, 600, 4, 64
LR = 0.003


def small_kw(**kw):
    base = dict(model="armnet_1h", nfeat=NFEAT, nfield=NFIELD, nemb=NEMB,
                h=128, mlp_nlayer=2, mlp_nhid=16, alpha=2.0, ensemble=False,
                dnn_nlayer=1, dnn_nhid=8, noutput=1)
    base.update(kw)
    return base


def make_batches(n, seed, pad_last=0, nfield=NFIELD):
    """n batches of BSZ rows of nfield fields; the last one padded as the
    loader pads (id 0, value 1.0, label 0, mask 0) when pad_last > 0."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        b = {"id": rng.randint(0, NFEAT, (BSZ, nfield)).astype(np.int32),
             "value": rng.uniform(0.0, 1.2, (BSZ, nfield)).astype(np.float32),
             "y": (rng.rand(BSZ) < 0.4).astype(np.float32),
             "mask": np.ones(BSZ, np.float32)}
        if pad_last and i == n - 1:
            b["id"][-pad_last:] = 0
            b["value"][-pad_last:] = 1.0
            b["y"][-pad_last:] = 0.0
            b["mask"][-pad_last:] = 0.0
        out.append(b)
    return out


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def init_pair(kw, seed, kernels="auto", tweak=None):
    """(JAX model, JAX params, JAX batch_stats, port model under
    `kernels`) from one JAX init with embeddings widened to [-0.5, 0.5]
    (so the exponential neurons leave 1) and random running statistics;
    `tweak(flat, rng)` may then change the flat numpy leaves in place."""
    jm = jax_create_model(JaxModelConfig(**kw))
    b0 = make_batches(1, seed, nfield=kw["nfield"])[0]
    v = jm.init(jax.random.PRNGKey(seed),
                {"id": jnp.asarray(b0["id"]), "value": jnp.asarray(b0["value"])})
    flat = flatten_flax(jax.tree.map(np.array, v))
    rng = np.random.RandomState(seed)
    for key, arr in flat.items():
        if key.endswith("/embedding"):
            arr[...] = rng.uniform(-0.5, 0.5, arr.shape)
        elif key.endswith("/mean"):
            arr[...] = rng.normal(0.0, 0.3, arr.shape)
        elif key.endswith("/var"):
            arr[...] = rng.uniform(0.5, 1.5, arr.shape)
    if tweak is not None:
        tweak(flat, rng)
    nested = _nest(flat)
    cfg = ModelConfig(**kw)
    model = create_model(cfg, kernels=kernels)
    model.load_state_dict(from_jax_arrays(flat, cfg))
    return jm, nested["params"], nested.get("batch_stats", {}), model


def write_split(root, seed, rows=(150, 70, 70)):
    """tr/va/te libsvm files of small armnet_1h rows under root."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name, n in zip(("train", "valid", "test"), rows):
        with open(os.path.join(root, f"{name}.libsvm"), "w") as f:
            for _ in range(n):
                ids = rng.randint(0, NFEAT, NFIELD)
                y = int(ids[0] % 3 == 0)          # learnable from field 0
                f.write(f"{y} " + " ".join(
                    f"{i}:{rng.uniform(0.1, 1.0):.4f}" for i in ids) + "\n")
    return root


@pytest.fixture
def quiet_logger():
    log = logging.getLogger("test_torch_train")
    log.addHandler(logging.NullHandler())
    log.propagate = False
    return log


def test_masked_losses_match_jax():
    """Values and logit gradients, with a non-finite logit on a pad row."""
    rng = np.random.RandomState(0)
    mask = (rng.rand(32) < 0.8).astype(np.float32)
    logits = rng.randn(32).astype(np.float32) * 3
    logits[mask == 0] = np.inf
    labels = (rng.rand(32) < 0.4).astype(np.float32)
    lj, gj = jax.value_and_grad(jax_masked_bce)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    lt = torch.from_numpy(logits).requires_grad_()
    loss = masked_bce(lt, torch.from_numpy(labels), torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(gj), atol=1e-7)
    assert bool(torch.isfinite(lt.grad).all())

    logits3 = rng.randn(32, 3).astype(np.float32)
    logits3[mask == 0, 0] = np.inf
    labels3 = rng.randint(0, 3, 32).astype(np.float32)
    lj, gj = jax.value_and_grad(jax_masked_ce)(
        jnp.asarray(logits3), jnp.asarray(labels3), jnp.asarray(mask))
    lt = torch.from_numpy(logits3).requires_grad_()
    loss = masked_softmax_ce(lt, torch.from_numpy(labels3),
                             torch.from_numpy(mask))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-6)
    np.testing.assert_allclose(lt.grad[mask > 0].numpy(),
                               np.asarray(gj)[mask > 0], atol=1e-7)


def test_shuffled_iterator_and_trainer_epoch_match_jax(tmp_path,
                                                       quiet_logger):
    """Both trainers advance the train iterator's shuffle counter once at
    construction (the JAX one by drawing a first batch), so the first
    epoch is shuffled with RandomState(seed + 1); then 3 epochs of batches,
    the padded last batch included, are the same."""
    root = write_split(str(tmp_path / "d"), seed=1)
    path = os.path.join(root, "train.libsvm")
    jl = JaxBatchIterator(JaxLibsvmDataset(path, NFIELD, use_cache=False),
                          BSZ, True, seed=5, device_put=False)
    pl = BatchIterator(LibsvmDataset(path, NFIELD), BSZ, True, seed=5)
    kw = small_kw(h=6)
    JaxTrainer(JaxExperimentConfig(**kw), jl, jl, jl, quiet_logger, seed=5)
    Trainer(ExperimentConfig(**kw, device="cpu"), pl, pl, pl, quiet_logger,
            seed=5)
    assert jl.epoch == pl.epoch == 1
    for _ in range(3):
        got = list(pl)
        want = list(jl)
        assert len(got) == len(want) == 3
        for bp, bj in zip(got, want):
            for k in ("id", "value", "y", "mask"):
                np.testing.assert_array_equal(bp[k].numpy(), bj[k], k)
    assert float(got[-1]["mask"].sum()) == 150 - 2 * BSZ
    assert jl.epoch == pl.epoch == 4


@pytest.mark.parametrize("ensemble", [False, True])
def test_one_step_gradients_match_jax(ensemble):
    """Every parameter's gradient of one train-mode step (masked BN on a
    padded batch, masked BCE) against jax.grad of the JAX step's loss, and
    the running statistics the step leaves."""
    kw = small_kw(ensemble=ensemble)
    jm, params, stats, model = init_pair(kw, seed=1)
    b = make_batches(1, seed=2, pad_last=20)[0]
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
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        torch.testing.assert_close(p.grad.clamp(-1, 1),
                                   want[name].clamp(-1, 1), rtol=1e-4,
                                   atol=1e-6)
    after = from_jax_arrays(flatten_flax(jax.tree.map(
        np.asarray, {"params": params, "batch_stats": upd["batch_stats"]})),
        cfg)
    # the MLP's statistics sum GEMM outputs, which the two packages sum in
    # different orders: a few f32 ulps of the batch mean
    for name, buf in model.named_buffers():
        np.testing.assert_allclose(buf.numpy(), after[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _run_jax(jm, params, stats, batches, backend):
    set_kernel_backend(backend)
    try:
        state = jax_train_state(jm, to_jax(batches[0]), lr=LR).replace(
            params=jax.tree.map(jnp.asarray, params),
            batch_stats=jax.tree.map(jnp.asarray, stats))
        step = jax_make_train_step()
        meters, key, losses = jax_init_meters(), jax.random.key(0), []
        for b in batches:
            state, meters = step(state, meters, to_jax(b), key)
            losses.append(float(meters["loss_last"]))
        b0 = to_jax(batches[0])
        logits = jm.apply({"params": state.params,
                           "batch_stats": state.batch_stats},
                          {"id": b0["id"], "value": b0["value"]}, train=False)
    finally:
        set_kernel_backend("auto")
    return np.asarray(losses), np.asarray(logits)


@pytest.mark.parametrize("backend,ensemble", [("auto", False),
                                              ("pallas", False),
                                              ("auto", True),
                                              ("pallas-fused", False)])
def test_trajectory_matches_jax_train_step(backend, ensemble):
    """25 identical clamp+Adam steps (the last batch padded) from the same
    weights: the loss curves agree within 5e-4 and the final eval logits
    within 1e-2, the pattern of tests/test_trajectory_parity.py. The port
    runs under the same kernel choice as the JAX side."""
    kw = small_kw(ensemble=ensemble)
    jm, params, stats, model = init_pair(kw, seed=3, kernels=backend)
    batches = make_batches(25, seed=4, pad_last=24)
    lj, yj = _run_jax(jm, params, stats, batches, backend)

    state = create_train_state(model, LR)
    step = make_train_step()
    meters, lt = init_meters("cpu"), []
    for b in batches:
        meters = step(state, meters, to_torch(b))
        lt.append(float(meters["loss_last"]))
    assert state.step == 25
    with torch.no_grad():
        yt = model.eval()(to_torch(batches[0])).numpy()
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(np.asarray(lt), lj, atol=5e-4)
    np.testing.assert_allclose(yt, yj, atol=1e-2)


def test_debug_nans_stops_at_the_first_non_finite_step():
    """With debug_nans a train step whose loss or gradients hold a NaN
    raises FloatingPointError naming the step, before the update (the
    weights are those of the step before); without it, and on clean
    batches, nothing is raised."""
    cfg = ModelConfig(**small_kw())
    state = create_train_state(create_model(cfg, seed=0), LR)
    step = make_train_step(debug_nans=True)
    meters = init_meters("cpu")
    clean, bad = make_batches(2, seed=8)
    meters = step(state, meters, to_torch(clean))
    assert state.step == 1
    bad["value"][3, 2] = np.nan
    before = [p.detach().clone() for p in state.model.parameters()]
    with pytest.raises(FloatingPointError, match="train step 1 .*loss"):
        step(state, meters, to_torch(bad))
    assert state.step == 1
    for a, p in zip(before, state.model.parameters()):
        assert torch.equal(a, p.detach())
    quiet = make_train_step()
    quiet(state, init_meters("cpu"), to_torch(bad))
    assert state.step == 2


def test_debug_nans_flag_reaches_the_trainer(tmp_path, quiet_logger):
    """--debug_nans parses into the config, and the trainer's step raises
    on a NaN batch; without the flag it does not."""
    write_split(str(tmp_path / "d"), seed=2)
    for flag, raises in ((["--debug_nans"], True), ([], False)):
        cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
            ["--model", "armnet_1h", "--nfeat", str(NFEAT), "--nfield",
             str(NFIELD), "--nemb", str(NEMB), "--device", "cpu"] + flag)))
        assert cfg.debug_nans is raises
        loaders = make_dataloaders("d", str(tmp_path), NFIELD, BSZ, seed=3)
        t = Trainer(cfg, *loaders, quiet_logger, seed=3)
        bad = make_batches(1, seed=9)[0]
        bad["value"][0, 0] = np.inf * 0.0
        if raises:
            with pytest.raises(FloatingPointError):
                t.train_step(t.state, init_meters("cpu"), to_torch(bad))
        else:
            t.train_step(t.state, init_meters("cpu"), to_torch(bad))


@pytest.fixture
def restore_matmul_precision():
    yield
    set_matmul_precision("highest")


@pytest.mark.parametrize("precision,tf32", [("default", False),
                                            ("highest", False),
                                            ("high", True)])
def test_matmul_precision_flag(tmp_path, restore_matmul_precision,
                               precision, tf32):
    """--matmul_precision reaches the GEMM settings through the CLI:
    default and highest keep full f32, high allows TF32."""
    set_matmul_precision("high" if not tf32 else "highest")
    write_split(str(tmp_path / "data" / "tiny"), seed=4)
    cli.main(["--model", "armnet_1h", "--nfeat", str(NFEAT), "--nfield",
              str(NFIELD), "--nemb", str(NEMB), "--h", "8", "--mlp_nhid",
              "8", "--batch_size", str(BSZ), "--epoch", "1", "--dataset",
              "tiny", "--data_dir", str(tmp_path / "data"), "--log_dir",
              str(tmp_path / "log"), "--device", "cpu",
              "--matmul_precision", precision])
    assert torch.backends.cuda.matmul.allow_tf32 is tf32
    assert torch.backends.cudnn.allow_tf32 is tf32
    assert torch.get_float32_matmul_precision() == (
        "high" if tf32 else "highest")


def test_matmul_precision_rejects_other_values(restore_matmul_precision):
    """Any other value raises: from the parser, and from a config that
    bypasses it (checkpoint metadata)."""
    with pytest.raises(ValueError, match="matmul_precision"):
        set_matmul_precision("bf16")
    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(["--matmul_precision", "fastest"])


def _trained_state(cfg, nsteps):
    state = create_train_state(create_model(cfg, seed=0), cfg.lr)
    step, meters = make_train_step(), init_meters("cpu")
    for b in make_batches(nsteps, seed=6):
        meters = step(state, meters, to_torch(b))
    return state


def test_checkpoint_round_trip(tmp_path):
    """Model, optimizer and step come back; 'best' is a copy of 'last' with
    its sidecar; a model-only checkpoint still loads for scoring but cannot
    resume."""
    cfg = ExperimentConfig(**small_kw(), lr=0.01, device="cpu")
    state = _trained_state(cfg, 3)
    extra = {"epoch": 4, "valid_auc": 0.5, "test_auc": 0.25, "seed": 7}
    save_checkpoint(state.model, cfg, tmp_path, tag="last",
                    optimizer=state.optimizer, step=state.step, extra=extra,
                    is_best=True)
    fresh = create_train_state(create_model(cfg, seed=9), cfg.lr)
    meta = restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 3
    assert {k: meta[k] for k in extra} == extra
    assert meta["config"]["nfeat"] == NFEAT
    for (ka, a), (kb, b) in zip(state.model.state_dict().items(),
                                fresh.model.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(st[k], sb["state"][i][k], rtol=0,
                                       atol=0)
    best, best_meta = load_checkpoint(str(tmp_path / "best"))
    assert best_meta == meta
    torch.testing.assert_close(best["embedding.weight"],
                               state.model.embedding.weight.detach())

    save_checkpoint(state.model, cfg, tmp_path / "model_only")
    load_checkpoint(str(tmp_path / "model_only"))
    with pytest.raises(FileNotFoundError, match="optim.pt"):
        restore_checkpoint(str(tmp_path / "model_only"), fresh, tag="best")


def _record_losses(trainer, out):
    step = trainer.train_step

    def wrapped(state, meters, batch):
        meters = step(state, meters, batch)
        out.append(float(meters["loss_last"]))
        return meters

    trainer.train_step = wrapped


def test_fit_logs_one_line_of_the_counters_that_moved(tmp_path):
    """A fit ends with one line of every armnet.* counter that moved during
    it, each as its difference over the fit: on the CPU the BatchNorms'
    composed route, and here a kernel call that a wrapped train step counts
    once a step. A counter that did not move during the fit is left out,
    and no op has a line of its own."""
    write_split(str(tmp_path / "d"), seed=2)
    cfg = ExperimentConfig(**small_kw(), lr=0.01, batch_size=BSZ,
                           device="cpu")
    messages = []
    logger = logging.getLogger("test_torch_train.counters")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logger.addHandler(handler)
    t = Trainer(cfg, *make_dataloaders("d", str(tmp_path), NFIELD, BSZ,
                                       seed=3), logger, seed=3)
    steps = []
    _record_losses(t, steps)
    step = t.train_step

    def counted(*args):
        tracing.count("armnet.kernel.table_grad")
        return step(*args)

    t.train_step = counted
    tracing.count("armnet.kernel.cin_fwd")      # before the fit: not logged
    before = tracing.counts("armnet.")
    try:
        t.fit(2, patience=5, report_freq=100)
    finally:
        logger.removeHandler(handler)
    moved = {k: v - before.get(k, 0)
             for k, v in tracing.counts("armnet.").items()
             if v != before.get(k, 0)}
    assert moved["armnet.kernel.table_grad"] == len(steps) == 6
    assert moved["armnet.bn.composed"] > 0
    assert "armnet.kernel.cin_fwd" not in moved
    lines = [m for m in messages if m.startswith("counters:")]
    assert lines == [f"counters: what ran during the fit (kernel calls, "
                     f"routes) {dict(sorted(moved.items()))}"]
    assert not [m for m in messages if m.startswith(("cin:", "bn:"))]


def test_resume_continues_the_loss_curve(tmp_path, quiet_logger):
    """Two epochs straight, against one epoch, a checkpoint, and a new
    trainer restored from it for the second: the second epoch's step
    losses are the same. (A resume restarts the shuffle schedule, as the
    JAX CLI's does, so the iterator is set to the epoch the first run
    stood at.)"""
    root = write_split(str(tmp_path / "d"), seed=2)
    cfg = ExperimentConfig(**small_kw(), lr=0.01, batch_size=BSZ,
                           device="cpu")

    def loaders():
        return make_dataloaders("d", str(tmp_path), NFIELD, BSZ, seed=3)

    straight = []
    t = Trainer(cfg, *loaders(), quiet_logger, seed=3)
    _record_losses(t, straight)
    t.fit(2, patience=5, report_freq=100)

    first, second = [], []
    t = Trainer(cfg, *loaders(), quiet_logger, seed=3,
                ckpt_dir=str(tmp_path / "ck"))
    _record_losses(t, first)
    t.fit(1, patience=5, report_freq=100)
    resumed_loaders = loaders()
    t = Trainer(cfg, *resumed_loaders, quiet_logger, seed=3)
    restore_checkpoint(str(tmp_path / "ck"), t.state)
    assert t.state.step == 3
    resumed_loaders[0].epoch = 2
    _record_losses(t, second)
    t.fit(1, patience=5, report_freq=100)
    assert len(straight) == 6
    np.testing.assert_allclose(first, straight[:3], rtol=1e-6)
    np.testing.assert_allclose(second, straight[3:], rtol=1e-6)


def test_cli_trains_on_the_cpu_and_predict_scores_it(tmp_path, capsys):
    """train.cli.main for two epochs on a tiny split: metrics.jsonl rows,
    the feed's line in the log (CPU rows stream; the second epoch took the
    order drawn ahead during the first), best/last training checkpoints
    that predict scores, and a --resume with a --profile_dir trace that
    names the step's and the feed's spans."""
    write_split(str(tmp_path / "data" / "tiny"), seed=4)
    common = ["--model", "armnet_1h", "--nfeat", str(NFEAT), "--nfield",
              str(NFIELD), "--nemb", str(NEMB), "--h", "16", "--mlp_nhid",
              "16", "--alpha", "2.0", "--lr", "0.01", "--batch_size",
              str(BSZ), "--patience", "5", "--dataset", "tiny", "--data_dir",
              str(tmp_path / "data"), "--log_dir", str(tmp_path / "log"),
              "--ckpt_dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    res = cli.main(common + ["--epoch", "2", "--seed", "3", "--exp_name",
                             "t"])
    assert [r[0] for r in res] == [3] and 0.0 < res[0][1] <= 1.0
    with open(tmp_path / "log" / "t_3" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["epoch"] for r in rows] == [0, 1]
    assert set(rows[0]) == {"epoch", "seed", "train", "valid", "test",
                            "metric", "best_valid", "is_best", "time_s"}
    log = (tmp_path / "log" / "t_3" / "stdout.log").read_text()
    assert ("feed: rows resident on the device (train, val, test) [False, "
            "False, False]; train epoch orders drawn ahead 1, at the "
            "epoch's start 1") in log
    ck = tmp_path / "ckpt" / "t_3"
    assert (ck / "last" / "optim.pt").exists()
    assert (ck / "best" / "model.pt").exists()
    with open(ck / "best.meta.json") as f:
        assert set(json.load(f)) == {"config", "epoch", "valid_auc",
                                     "test_auc", "seed"}
    summary = predict.main(["--ckpt", str(ck), "--input",
                            str(tmp_path / "data" / "tiny" / "test.libsvm"),
                            "--output", str(tmp_path / "s.txt"), "--device",
                            "cpu"])
    assert summary["rows"] == 70 and 0.0 <= summary["auc"] <= 1.0

    res = cli.main(common + ["--epoch", "1", "--seed", "3", "--exp_name",
                             "r", "--resume", str(ck), "--repeat", "2",
                             "--profile_dir", str(tmp_path / "prof")])
    assert [r[0] for r in res] == [3, 4]
    traces = [n for n in os.listdir(tmp_path / "prof") if n.endswith(".json")]
    assert traces
    # the profiled epoch shows the program's spans under their names
    for n in traces:
        written = (tmp_path / "prof" / n).read_text()
        assert '"armnet.step.forward"' in written
        assert '"armnet.feed.gather"' in written
    assert "repeat summary" in capsys.readouterr().out
    assert (tmp_path / "log" / "r.repeat_summary.log").exists()


def test_cli_raises_on_what_is_not_ported(tmp_path):
    """An *.arff folder now trains (the UCI multi-class path, 3 classes:
    a 3-way head over its 2 fields); --mesh trains (a mesh of one process
    here), a mesh of more processes than the run has and a missing CUDA
    raise."""
    data = tmp_path / "data"
    write_split(str(data / "tiny"), seed=5)
    (data / "uci").mkdir()
    rows = "\n".join(f"{i % 7}.5,{i % 5}.0,{i % 3}" for i in range(30))
    (data / "uci" / "uci.arff").write_text(
        "@relation uci\n@attribute a numeric\n@attribute b numeric\n"
        "@attribute clase {0,1,2}\n@data\n" + rows + "\n")
    (data / "uci" / "conxuntos.dat").write_text(
        " ".join(map(str, range(20))) + "\n"
        + " ".join(map(str, range(20, 30))) + "\n")
    base = ["--model", "armnet_1h", "--nfeat", str(NFEAT), "--nfield",
            str(NFIELD), "--data_dir", str(data), "--log_dir",
            str(tmp_path / "log"), "--device", "cpu", "--epoch", "1"]
    res = cli.main(base + ["--dataset", "uci", "--batch_size", "8", "--h",
                           "4", "--valid_perc", "0.25", "--ckpt_dir",
                           str(tmp_path / "ckpt")])
    assert [r[0] for r in res] == [2025] and 0.0 <= res[0][1] <= 1.0
    meta = load_checkpoint(str(tmp_path / "ckpt" / "test_2025"))[1]
    assert (meta["config"]["noutput"], meta["config"]["nfield"]) == (3, 2)
    res = cli.main(base + ["--dataset", "tiny", "--mesh", "data:1,model:1",
                           "--shard_embedding"])
    assert 0.0 <= res[0][1] <= 1.0
    with pytest.raises(ValueError, match="needs 2 processes, have 1"):
        cli.main(base + ["--dataset", "tiny", "--mesh", "data:2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(base[:-4] + ["--dataset", "tiny"])
