"""armnet_tpu_torch.benchmarks.scaling against the JAX package's
benchmarks/scaling.py on the CPU:

  * the world sizes, flag defaults and recipe equal the JAX script's (its
    main() and measure() run with their measurement and model stubbed);
  * the one-device row's step is the trainer's make_train_step() on the
    bench's batch: 3 steps from one JAX init against the JAX step on the
    same batch (loss within 5e-4, AUC within 1e-3);
  * the JAX mesh rule;
  * one 2-process gloo run (--shard_embedding, psum) with --device cpu at
    nfeat 1000, 6 fields, 32 rows a device: two rows, the second on
    data:1,model:2 with the table sharded;
  * main() raises without CUDA before it builds a model.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import armnet_tpu.models as jax_models
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu_torch.bench import LR, SEED
from armnet_tpu_torch.benchmarks import scaling
from armnet_tpu_torch.benchmarks.timing import bench_batch
from armnet_tpu_torch.models.config import ModelConfig
from jax_scripts import REPO, load
from test_torch_train import init_pair, small_kw


def test_sizes_and_defaults_equal_the_jax_script(monkeypatch):
    mod = load("scaling")
    calls = []
    monkeypatch.setattr(mod, "measure", lambda *a, **k: calls.append(
        (a, k)) or 1.0)
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(64)))
    monkeypatch.setattr(jax.config, "update", lambda *a: None)
    monkeypatch.setenv("XLA_FLAGS", "")
    monkeypatch.setattr(sys, "argv", ["scaling.py"])
    mod.main()
    assert tuple(a[0] for a, _ in calls) == scaling.SIZES
    _, bpd, nfeat, nfield, shard = calls[0][0]
    assert (bpd, nfeat, nfield, shard) == (4096, 2_100_000, 39, False)
    assert calls[0][1] == {"exchange": "psum"}
    parser_defaults = _port_defaults(monkeypatch)
    assert parser_defaults == {"batch_per_device": 4096, "nfeat": 2_100_000,
                               "nfield": 39, "shard_embedding": False,
                               "embedding_exchange": "psum",
                               "max_devices": None}


def _port_defaults(monkeypatch):
    seen = {}

    def stop(args, *a, **k):
        seen.update({k: getattr(args, k) for k in (
            "batch_per_device", "nfeat", "nfield", "shard_embedding",
            "embedding_exchange", "max_devices")})
        raise StopIteration

    monkeypatch.setattr(scaling, "measure_row", stop)
    with pytest.raises(StopIteration):
        scaling.main(["--device", "cpu"])
    return seen


def test_recipe_equals_the_jax_script(monkeypatch):
    mod = load("scaling")

    class Built(Exception):
        pass

    def capture(cfg):
        raise Built(cfg)

    monkeypatch.setattr(jax_models, "create_model", capture)
    with pytest.raises(Built) as got:
        mod.measure(1, 8, 100, 5, False)
    cfg = got.value.args[0]
    assert {k: getattr(cfg, k) for k in scaling.RECIPE} == scaling.RECIPE
    assert (cfg.nfeat, cfg.nfield) == (100, 5)
    port = scaling.config(100, 5)
    assert {k: getattr(port, k) for k in scaling.RECIPE} == scaling.RECIPE
    assert (LR, SEED) == (1e-3, 0)


@pytest.mark.parametrize("d,shard,want", [
    (1, False, "data:1,model:1"), (2, True, "data:1,model:2"),
    (8, True, "data:4,model:2"), (8, False, "data:8,model:1")])
def test_mesh_rule(d, shard, want):
    assert scaling.mesh_spec(d, shard) == want


def test_one_device_step_is_the_trainers_step(monkeypatch):
    kw = small_kw(nfeat=1000, nfield=6, nemb=4, h=8, mlp_nlayer=1,
                  mlp_nhid=16, alpha=2.0)
    jm, params, stats, model = init_pair(kw, seed=7)
    monkeypatch.setattr(scaling, "create_model", lambda *a, **k: model)
    cfg = ModelConfig(**kw)
    step, names, meters = scaling.make_step(cfg, 64, 1, "cpu")
    assert names == []
    got = []
    for _ in range(3):
        step()
        got.append((float(meters[0]["loss_last"]),
                    float(meters[0]["auc_last"])))
    batch = {k: jnp.asarray(v.numpy())
             for k, v in bench_batch(cfg, 64, "cpu").items()}
    state = jax_train_state(jm, batch, lr=LR, seed=SEED).replace(
        params=jax.tree.map(jnp.asarray, params),
        batch_stats=jax.tree.map(jnp.asarray, stats))
    jstep, jmeters, key, want = jax_make_train_step(), jax_init_meters(), \
        jax.random.key(0), []
    for _ in range(3):
        state, jmeters = jstep(state, jmeters, batch, key)
        want.append((float(jmeters["loss_last"]),
                     float(jmeters["auc_last"])))
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=5e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-3)
    assert got[2, 0] < got[0, 0]


def test_two_gloo_processes_sharded():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run(
        [sys.executable, "-m", "armnet_tpu_torch.benchmarks.scaling",
         "--device", "cpu", "--max_devices", "2", "--nfeat", "1000",
         "--nfield", "6", "--batch_per_device", "32", "--shard_embedding",
         "--embedding_exchange", "psum", "--warm", "1", "--steps", "2",
         "--reps", "2"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    *rows, table = [json.loads(line) for line in out.stdout.splitlines()]
    assert table["metric"] == "scaling_table" and table["rows"] == rows
    assert [r["devices"] for r in rows] == [1, 2]
    one, two = rows
    assert one["mesh"] is None and one["sharded"] == []
    assert one["scaling_efficiency"] == 1.0
    assert two["mesh"] == {"data": 1, "model": 2}
    assert two["sharded"] == ["embedding.weight"]
    assert two["exchange"] == "psum" and two["batch_size"] == 64
    for r in rows:
        assert r["examples_per_sec"] > 0 and np.isfinite(r["loss_last"])
        assert r["scaling_efficiency"] == pytest.approx(
            r["examples_per_sec"] / (one["examples_per_sec"]
                                     * r["devices"]))
        assert not any(r["launches"].values())


def test_main_raises_without_cuda(monkeypatch):
    def no_model(*a, **k):
        raise AssertionError("built a model")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(scaling, "create_model", no_model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling.main([])
