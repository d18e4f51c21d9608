"""Multi-process armnet_tpu_torch against the JAX package and the
single-process port, on the CPU: 2 and 4 processes in a gloo group, each a
fresh interpreter running tests/torch_mp_worker.py (which imports no JAX)
with a file:// rendezvous under the test's tmp directory, a timeout and a
kill on expiry.

  * the psum and a2a lookups and their table gradients at model:2,
    data:2,model:2 and model:4 against the dense JAX embedding_bag and its
    gradient: duplicate and power-law ids, wrapped negative ids,
    out-of-range ids as NaN rows; the a2a overflow count against the real
    drops and the JAX a2a_overflow_count;
  * the armnet_1h step at data:2,model:2 (tests/test_parallel.py's
    shapes): eval-mode loss (rtol 1e-6) and gradients (atol 1e-5) against
    the JAX single-device step and the single-process port; the train
    step's loss and AUC against the JAX step (rtol 1e-3) and the port's; a
    ragged final batch padded on one rank only;
  * a 2-process CLI run whose checkpoint predict scores to the sharded
    model's logits; the sharded trainer learns.
"""

import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.models import create_model as jax_create_model
from armnet_tpu.models.config import ModelConfig as JaxModelConfig
from armnet_tpu.ops.embedding import embedding_bag as jax_embedding_bag
from armnet_tpu.parallel.embedding_parallel import (
    a2a_overflow_count as jax_overflow_count)
from armnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from armnet_tpu.train.metrics import masked_bce as jax_masked_bce
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu_torch import predict
from armnet_tpu_torch.bridge import (flatten_flax, from_jax_arrays,
                                     params_from_jax)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.checkpoint import load_checkpoint
from armnet_tpu_torch.train.metrics import masked_bce
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_mp_worker.py")
SPAWN_TIMEOUT = 150           # seconds for one group of processes
LOOKUP_SPECS = {"model:2": 2, "data:2,model:2": 4, "model:4": 4}


def spawn(tmp, case, world, args):
    """Run `case` in `world` worker processes; their results by rank."""
    argf, init, out = tmp / "args.pt", tmp / "init", tmp / "out"
    torch.save(args, argf)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [tmp / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, case, str(r), str(world), str(init),
                 str(argf), str(out)], cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        expired = [p for p in procs if p.poll() is None]
        for p in expired:
            p.kill()
            p.wait()
    if expired or any(p.returncode for p in procs):
        text = "\n".join(f"--- rank {r} (rc {p.returncode}) ---\n"
                         + logs[r].read_text()[-3000:]
                         for r, p in enumerate(procs))
        pytest.fail(f"{case} in {world} processes "
                    f"{'timed out' if expired else 'failed'}:\n{text}")
    return [torch.load(f"{out}.{r}.pt", weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each case's processes run once per module; tests read the results."""
    cache = {}

    def get(case, spec, world, make_args):
        if (case, spec) not in cache:
            args = dict(make_args(), spec=spec)
            cache[case, spec] = (args, spawn(
                tmp_path_factory.mktemp(case), case, world, args))
        return cache[case, spec]

    return get


# --- the lookups ------------------------------------------------------------

NFEAT, NEMB, B, F = 64, 8, 16, 5


def lookup_args():
    rng = np.random.RandomState(3)
    # power-law ids (many repeats of the low ids) and uniform ones
    ids = np.where(rng.rand(B, F) < 0.5,
                   np.minimum(rng.zipf(1.5, (B, F)) - 1, NFEAT - 1),
                   rng.randint(0, NFEAT, (B, F))).astype(np.int64)
    ids[0, :4] = (-1, -NFEAT, NFEAT, -NFEAT - 1)   # wrapped; out of range
    ids[1, 0] = 100
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0                                  # loader padding
    ids[-3:] = 0
    return {"table": torch.from_numpy(rng.randn(NFEAT, NEMB).astype(
                np.float32)),
            "ids": torch.from_numpy(ids),
            "values": torch.from_numpy(rng.uniform(0.1, 1.0, (B, F)).astype(
                np.float32)),
            "w": torch.from_numpy(rng.randn(B, F, NEMB).astype(np.float32)),
            "mask": torch.from_numpy(mask), "cf": 64.0, "cf_small": 0.5}


def _lookup(runs, spec):
    args, res = runs("lookup", spec, LOOKUP_SPECS[spec], lookup_args)
    return args, res


def _by_data_row(res, spec, key):
    """The global batch's result, gathered by data index (model 0's)."""
    shape = dict(p.split(":") for p in spec.split(","))
    M, D = int(shape.get("model", 1)), int(shape.get("data", 1))
    return torch.cat([res[d * M][key] for d in range(D)])


def _jax_dense(args):
    table, ids, values, w = (jnp.asarray(args[k].numpy()) for k in
                             ("table", "ids", "values", "w"))
    ids = ids.astype(jnp.int32)

    def f(t, v):
        return jnp.sum(jax_embedding_bag(t, ids, v) * w)

    emb = jax_embedding_bag(table, ids, values)
    dt, dv = jax.grad(f, argnums=(0, 1))(table, values)
    return np.asarray(emb), np.asarray(dt), np.asarray(dv)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
@pytest.mark.parametrize("spec", list(LOOKUP_SPECS))
def test_sharded_lookup_matches_dense_jax(runs, spec, exchange):
    args, res = _lookup(runs, spec)
    emb, dtable, dvalues = _jax_dense(args)
    per = [r[exchange] for r in res]
    got = _by_data_row(per, spec, "emb").numpy()
    oob = np.isnan(emb).any(-1)
    assert oob.sum() == 3                       # 64, -65 and 100
    np.testing.assert_array_equal(np.isnan(got).any(-1), oob)
    np.testing.assert_allclose(got[~oob], emb[~oob], rtol=0, atol=1e-6)
    for r in per:                               # the full gradient, any rank
        np.testing.assert_allclose(r["dtable"].numpy(), dtable, rtol=0,
                                   atol=1e-5)
    got_dv = _by_data_row(per, spec, "dvalues").numpy()
    np.testing.assert_allclose(got_dv[~oob], dvalues[~oob], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("spec", list(LOOKUP_SPECS))
def test_a2a_overflow_count_is_the_real_drops(runs, spec):
    args, res = _lookup(runs, spec)
    emb, _, _ = _jax_dense(args)
    got = _by_data_row([r["a2a_small"] for r in res], spec, "emb").numpy()
    real = (args["mask"].numpy() > 0)[:, None] & ~np.isnan(emb).any(-1)
    dropped = int((real & (np.abs(got).sum(-1) == 0)).sum())
    counts = {float(r["overflow"]) for r in res}
    assert len(counts) == 1, counts               # summed over every rank
    shape = dict(p.split(":") for p in spec.split(","))
    # the JAX counter shards its batch over 'data': a 1-wide axis there
    mesh = jax_make_mesh(f"data:{shape.get('data', 1)},model:"
                         f"{shape['model']}",
                         devices=jax.devices()[:LOOKUP_SPECS[spec]])
    ids = args["ids"].numpy().astype(np.int32)
    ref = float(jax_overflow_count(
        jnp.asarray(np.where(ids < 0, ids + NFEAT, ids)), NFEAT, mesh,
        mask=jnp.asarray(args["mask"].numpy()),
        capacity_factor=args["cf_small"]))
    assert dropped > 0
    assert counts == {dropped} == {ref}


# --- the train step ---------------------------------------------------------

STEP_KW = dict(model="armnet_1h", nfeat=1024, nfield=6, nemb=8, h=8,
               mlp_nlayer=1, mlp_nhid=16, alpha=1.7, dropout=0.0)
STEP_B = 32


def _step_batches():
    rng = np.random.RandomState(11)
    batch = {
        "id": rng.randint(0, 1024, (STEP_B, 6)).astype(np.int32),
        "value": rng.rand(STEP_B, 6).astype(np.float32),
        "y": rng.randint(0, 2, (STEP_B,)).astype(np.float32),
        "mask": np.ones((STEP_B,), np.float32)}
    # the loader's padding of a final partial batch: rows 22-31, all on
    # the second data rank (rows 16-31)
    ragged = {k: v.copy() for k, v in batch.items()}
    ragged["id"][22:], ragged["value"][22:] = 0, 1.0
    ragged["y"][22:], ragged["mask"][22:] = 0.0, 0.0
    return batch, ragged


@pytest.fixture(scope="module")
def step_ref():
    """The JAX single-device model, its state, and the port's weights."""
    jm = jax_create_model(JaxModelConfig(**STEP_KW))
    batch, ragged = _step_batches()
    state0 = jax_train_state(jm, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, lr=1e-3, seed=0)
    flat = flatten_flax(jax.tree.map(np.array, {
        "params": state0.params, "batch_stats": state0.batch_stats}))
    weights = from_jax_arrays(flat, ModelConfig(**STEP_KW))
    return jm, state0, weights, batch, ragged


def _step_args(step_ref):
    _, _, weights, batch, ragged = step_ref
    return {"cfg": STEP_KW, "weights": weights,
            "batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "ragged": {k: torch.from_numpy(v) for k, v in ragged.items()}}


def _port_model(weights):
    model = create_model(ModelConfig(**STEP_KW), seed=0)
    model.load_state_dict(weights)
    return model


def _port_step(weights, batch):
    """The single-process port's train step's meters."""
    return make_train_step()(create_train_state(_port_model(weights), 1e-3),
                             init_meters("cpu"),
                             {k: torch.from_numpy(v) for k, v in
                              batch.items()})


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_step_matches_single_process(runs, step_ref, exchange):
    """Eval-mode BatchNorm (running statistics): the global loss and the
    gathered gradients against the JAX single-device step and the
    single-process port."""
    jm, state0, weights, batch, _ = step_ref
    _, res = runs("step", "data:2,model:2", 4, lambda: _step_args(step_ref))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits = jm.apply({"params": p, "batch_stats": state0.batch_stats},
                          {"id": jb["id"], "value": jb["value"]},
                          train=False)
        return jax_masked_bce(logits, jb["y"], jb["mask"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(state0.params)
    jgrads = params_from_jax(jgrads, ModelConfig(**STEP_KW))
    model = _port_model(weights).eval()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss = masked_bce(model(tb), tb["y"], tb["mask"])
    loss.backward()
    loss = loss.detach()
    for r in res:
        got = r[exchange]
        assert got["sharded"] == ["embedding.weight"]
        np.testing.assert_allclose(float(got["eval_loss"]), float(jloss),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got["eval_loss"]), float(loss),
                                   rtol=1e-6)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(got["grads"][name].numpy(),
                                       jgrads[name].numpy(), atol=1e-5,
                                       err_msg=name)
            np.testing.assert_allclose(got["grads"][name].numpy(),
                                       p.grad.numpy(), atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_sharded_train_step_loss_and_auc(runs, step_ref, exchange):
    """Train-mode BatchNorm over the global batch: the step's loss and AUC
    against the JAX step at its test's tolerance (1e-3) and against the
    single-process port's. (Not the updated parameters: Adam's first step
    moves each by lr * sign(g), and the gradients of the near-constant
    exp-neuron channels are rounding noise, tests/test_parallel.py.)"""
    jm, state0, weights, batch, _ = step_ref
    _, res = runs("step", "data:2,model:2", 4, lambda: _step_args(step_ref))
    _, jm_ref = jax_make_train_step()(
        state0, jax_init_meters(), {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.key(7))
    port = _port_step(weights, batch)
    for r in res:
        got = r[exchange]["batch"]
        for key in ("loss_last", "auc_last"):
            np.testing.assert_allclose(float(got[key]), float(jm_ref[key]),
                                       rtol=1e-3)
            np.testing.assert_allclose(float(got[key]), float(port[key]),
                                       rtol=1e-5)
        assert float(got["weight"]) == STEP_B


@pytest.mark.parametrize("exchange", ["psum", "a2a"])
def test_ragged_final_batch_padded_on_one_rank(runs, step_ref, exchange):
    """The padding of a final partial batch falls on the second data rank
    only; the loss is the global masked mean all the same (a mean of
    per-rank means would weigh the first rank's 16 rows as the second
    rank's 6)."""
    _, _, weights, _, ragged = step_ref
    _, res = runs("step", "data:2,model:2", 4, lambda: _step_args(step_ref))
    port = _port_step(weights, ragged)
    for r in res:
        got = r[exchange]["ragged"]
        assert float(got["weight"]) == 22.0
        np.testing.assert_allclose(float(got["loss_last"]),
                                   float(port["loss_last"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["auc_last"]),
                                   float(port["auc_last"]), rtol=1e-5)


# --- the CLI and the trainer ------------------------------------------------

CLI_NFIELD, CLI_NFEAT = 5, 600


def _write_split(root, seed, rows=(150, 70, 70)):
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name, n in zip(("train", "valid", "test"), rows):
        with open(os.path.join(root, f"{name}.libsvm"), "w") as f:
            for _ in range(n):
                ids = rng.randint(0, CLI_NFEAT, CLI_NFIELD)
                f.write(f"{int(ids[0] % 3 == 0)} " + " ".join(
                    f"{i}:{rng.uniform(0.1, 1.0):.4f}" for i in ids) + "\n")


def test_two_process_cli_checkpoint_scores_as_the_sharded_model(
        runs, tmp_path_factory):
    """torchrun-style CLI run at data:1,model:2 with the a2a exchange and
    the auto capacity: rank 0 writes the single-process layout, and predict
    scores it to the trained sharded model's logits."""
    tmp = tmp_path_factory.mktemp("cli_data")
    _write_split(str(tmp / "d" / "tiny"), seed=4)
    argv = ["--model", "armnet_1h", "--nfeat", str(CLI_NFEAT), "--nfield",
            str(CLI_NFIELD), "--nemb", "4", "--h", "16", "--mlp_nhid", "16",
            "--batch_size", "32", "--epoch", "1", "--device", "cpu",
            "--dataset", "tiny", "--data_dir", str(tmp / "d"),
            "--log_dir", str(tmp / "log"), "--ckpt_dir", str(tmp / "ckpt"),
            "--mesh", "data:1,model:2", "--shard_embedding",
            "--embedding_exchange", "a2a", "--embedding_capacity_factor", "0"]
    _, res = runs("cli", "data:1,model:2", 2, lambda: {"argv": argv})
    assert res[0]["sharded"] == ["embedding.weight"]
    np.testing.assert_allclose(res[0]["logits"].numpy(),
                               res[1]["logits"].numpy(), rtol=0, atol=1e-6)
    ckpt = tmp / "ckpt" / "test_2025"
    state, _ = load_checkpoint(str(ckpt), "last")
    assert tuple(state["embedding.weight"].shape) == (CLI_NFEAT, 4)
    log = tmp / "log" / "test_2025"
    assert (log / "stdout.log").exists() and (log / "stdout.p1.log").exists()
    assert "read by" in (log / "stdout.log").read_text()
    out = tmp / "scores.txt"
    summary = predict.main(["--ckpt", str(ckpt), "--tag", "last", "--input",
                            str(tmp / "d" / "tiny" / "test.libsvm"),
                            "--output", str(out), "--device", "cpu"])
    assert summary["rows"] == 70
    want = torch.sigmoid(res[0]["logits"][:70]).numpy()
    np.testing.assert_allclose(np.loadtxt(out), want, rtol=0, atol=1e-6)


def test_sharded_loaders_count_the_global_rows(runs, tmp_path_factory):
    """data:2: each rank parses its byte-range shard of every split, the
    row counts are summed over the data group, and each global batch is
    the two ranks' halves: the real rows of an unshuffled epoch are each
    shard's first rows, the surplus past the epoch's batches skipped."""
    tmp = tmp_path_factory.mktemp("loader_data")
    _write_split(str(tmp / "tiny"), seed=6, rows=(101, 37, 45))
    args, res = runs("loaders", "data:2", 2, lambda: {
        "data_dir": str(tmp), "nfield": CLI_NFIELD, "batch_size": 16})
    files = [tmp / "tiny" / f"{n}.libsvm" for n in ("train", "valid", "test")]
    for split, path in enumerate(files):
        full = np.loadtxt(path, usecols=0)
        nb = -(-len(full) // 16)
        assert [r["totals"][split] for r in res] == [len(full)] * 2
        assert sum(r["rows"][split] for r in res) == len(full)
        assert all(len(r["epochs"][split]) == nb for r in res)
        if split == 0:
            continue                                 # shuffled
        labels = [np.concatenate([b["y"][b["mask"] > 0].numpy()
                                  for b in r["epochs"][split]]) for r in res]
        start = 0
        for r, got in zip(res, labels):
            n = r["rows"][split]
            assert len(got) == min(n, nb * 8)
            np.testing.assert_array_equal(got, full[start:start + len(got)])
            start += n
    assert all(route == "native" for r in res for route in r["routes"])


def test_sharded_trainer_learns(runs):
    """fit() at data:2,model:2 with row-sharded tables, each exchange, on
    tests/test_trainer_mesh.py's learnable rows (cf. its
    test_sharded_trainer_learns)."""
    cfg = dict(model="armnet_1h", nfeat=64, nfield=4, nemb=8, h=8,
               mlp_nlayer=1, mlp_nhid=16, alpha=1.7, lr=0.01,
               mesh="data:2,model:2", shard_embedding=True, device="cpu")
    _, res = runs("learns", "data:2,model:2", 4, lambda: {"cfg": cfg})
    for r in res:
        for exchange in ("psum", "a2a"):
            assert r[exchange]["sharded"] == ["embedding.weight"]
            assert r[exchange]["best_valid"] > 0.95, r[exchange]
    assert len({r["psum"]["best_valid"] for r in res}) == 1


# --- BatchNorm on the kernels' route ----------------------------------------

def bn_args():
    rng = np.random.RandomState(8)
    x = (rng.randn(16, 6, 10) * 2 + 0.5).astype(np.float32)
    mask = np.ones(16, np.float32)
    mask[[5, 13, 14, 15]] = 0.0                  # pad rows on both ranks
    x[mask == 0] = 50.0
    state = {"weight": torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(
                 np.float32)),
             "bias": torch.from_numpy(rng.normal(0, 0.1, 6).astype(
                 np.float32)),
             "running_mean": torch.zeros(6), "running_var": torch.ones(6)}
    return {"x": torch.from_numpy(x), "mask": torch.from_numpy(mask),
            "dy": torch.from_numpy(rng.randn(16, 6, 10).astype(np.float32)),
            "axis": 1, "state": state}


def test_bn_kernel_route_takes_the_groups_statistics(runs):
    """The kernels' route (their plain versions on the CPU) in two data
    ranks: the channel sums all-reduced over the data group give the
    composed BatchNorm's output, input gradient and running statistics
    over the whole batch in one process, and the ranks' weight and bias
    gradients sum to its."""
    from armnet_tpu_torch.ops.layers import BatchNorm, batch_mask_scope

    args, res = runs("bn", "data:2", 2, bn_args)
    bn = BatchNorm(6, 1).train()
    bn.load_state_dict(args["state"])
    x = args["x"].clone().requires_grad_()
    with batch_mask_scope(args["mask"]):
        y = bn(x)
    (y * args["dy"]).sum().backward()
    got = {k: torch.cat([r[k] for r in res]) for k in ("y", "dx")}
    got.update({k: res[0][k] + res[1][k] for k in ("dweight", "dbias")})
    want = {"y": y.detach(), "dx": x.grad, "dweight": bn.weight.grad,
            "dbias": bn.bias.grad}
    for k, ref in want.items():
        torch.testing.assert_close(got[k], ref, rtol=1e-5, atol=1e-5)
    for r in res:
        torch.testing.assert_close(r["running_mean"], bn.running_mean,
                                   rtol=1e-6, atol=1e-7)
        torch.testing.assert_close(r["running_var"], bn.running_var,
                                   rtol=1e-6, atol=1e-7)
