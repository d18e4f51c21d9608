"""The port's measurement harness (armnet_tpu_torch.bench and
armnet_tpu_torch.benchmarks) against the JAX package's bench.py,
benchmarks/step_breakdown.py and benchmarks/recipes.py, on the CPU at a
small width: nfeat 1000, 6 fields, E 4, h 8, MLP 1x16, batch 64.

  * bench_batch draws bench.py's arrays and shift_ids shifts the ids;
  * 5 bench steps from one JAX init against the JAX bench's body (its
    make_train_step on the ids shifted by state.step), under auto and
    pallas-fused, the ensemble off and on;
  * the recipe and breakdown tables equal the JAX scripts';
  * time_steps, summary and --all's control flow;
  * the breakdown's subsets nest, fwd_bwd_dense restores the tables'
    requires_grad (also when the step raises), full is the trainer's step;
  * the entry points raise without CUDA before building a model, and a
    CPU run's record has every key of the JSON line.
"""

import importlib.util
import json
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.config import set_kernel_backend
from armnet_tpu.train.step import create_train_state as jax_train_state
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu.train.step import make_train_step as jax_make_train_step
from armnet_tpu_torch import bench
from armnet_tpu_torch.benchmarks import recipes, step_breakdown, timing
from armnet_tpu_torch.kernels import build
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from armnet_tpu_torch.utils import tracing
from test_torch_train import init_pair, small_kw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NFEAT, NFIELD, BSZ = 1000, 6, 64
KW = small_kw(nfeat=NFEAT, nfield=NFIELD, nemb=4, h=8, mlp_nlayer=1,
              mlp_nhid=16, alpha=2.0)


def small_cfg(**kw):
    return ModelConfig(**{**KW, **kw})


def test_bench_batch_draws_the_jax_bench_arrays_and_shifts_ids():
    """bench.py's draws from RandomState(0); (id + step) % nfeat."""
    cfg = small_cfg()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, NFEAT, (BSZ, NFIELD)).astype(np.int32)
    y = rng.randint(0, 2, (BSZ,)).astype(np.float32)
    b = timing.bench_batch(cfg, BSZ, "cpu")
    assert b["id"].dtype == torch.int32
    np.testing.assert_array_equal(b["id"].numpy(), ids)
    np.testing.assert_array_equal(b["y"].numpy(), y)
    np.testing.assert_array_equal(b["value"].numpy(),
                                  np.ones((BSZ, NFIELD), np.float32))
    np.testing.assert_array_equal(b["mask"].numpy(), np.ones(BSZ, np.float32))
    for step in (0, 7, NFEAT + 3):
        s = timing.shift_ids(b, step, NFEAT)
        np.testing.assert_array_equal(s["id"].numpy(), (ids + step) % NFEAT)
        assert s["id"].dtype == torch.int32 and s["y"] is b["y"]


def _jax_bench(jm, params, stats, batch_np, backend, nsteps):
    """(loss_last, auc_last) after each of nsteps of the JAX bench's body
    (bench.py: make_train_step on ids + state.step), params replaced."""
    set_kernel_backend(backend)
    try:
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state = jax_train_state(jm, batch, lr=bench.LR, seed=0).replace(
            params=jax.tree.map(jnp.asarray, params),
            batch_stats=jax.tree.map(jnp.asarray, stats))
        step = jax_make_train_step()
        key, meters, out = jax.random.key(0), jax_init_meters(), []
        for _ in range(nsteps):
            b = dict(batch)
            b["id"] = (batch["id"]
                       + jnp.asarray(state.step, jnp.int32)) % NFEAT
            state, meters = step(state, meters, b, key)
            out.append((float(meters["loss_last"]),
                        float(meters["auc_last"])))
    finally:
        set_kernel_backend("auto")
    return np.asarray(out)


@pytest.mark.parametrize("kernels,ensemble", [("auto", False),
                                              ("auto", True),
                                              ("pallas-fused", False),
                                              ("pallas-fused", True)])
def test_bench_steps_match_the_jax_bench(kernels, ensemble):
    """5 bench steps from one JAX init: loss_last within 5e-4 and auc_last
    within 1e-3 of the JAX bench's at every step, the JAX side under the
    same kernel choice (its Pallas kernels in interpret mode)."""
    kw = {**KW, "ensemble": ensemble, "dnn_nlayer": 1, "dnn_nhid": 8}
    jm, params, stats, model = init_pair(kw, seed=5, kernels=kernels)
    batch = timing.bench_batch(ModelConfig(**kw), BSZ, "cpu")
    want = _jax_bench(jm, params, stats,
                      {k: v.numpy() for k, v in batch.items()}, kernels, 5)
    step, got = bench.BenchStep(model, batch, NFEAT), []
    for _ in range(5):
        step()
        got.append((float(step.meters["loss_last"]),
                    float(step.meters["auc_last"])))
    got = np.asarray(got)
    assert step.state.step == 5
    np.testing.assert_allclose(got[:, 0], want[:, 0], atol=5e-4)
    np.testing.assert_allclose(got[:, 1], want[:, 1], atol=1e-3)


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("script", ["recipes", "step_breakdown"])
def test_tables_equal_the_jax_scripts(script):
    """RECIPES and CONFIGS letter for letter; the bench's recipe is the
    breakdown's armnet_1h row (bench.py's ModelConfig)."""
    jax_mod = _load_jax_script(script)
    if script == "recipes":
        assert recipes.RECIPES == jax_mod.RECIPES
        assert jax_mod.BATCH == bench.BATCH
    else:
        assert step_breakdown.CONFIGS == jax_mod.CONFIGS
        assert jax_mod.BATCH == bench.BATCH
        assert bench.CRITEO == ModelConfig(**jax_mod.CONFIGS["armnet_1h"])


def test_time_steps_and_summary():
    calls = []
    times = timing.time_steps(lambda: calls.append(1), warm=3, steps=4,
                              reps=2, device="cpu")
    assert len(calls) == 3 + 2 * 4 and len(times) == 2
    assert all(t >= 0 for t in times)
    assert timing.summary([3.0, 1.0, 2.0]) == {"median": 2.0, "min": 1.0,
                                               "max": 3.0}


def _subset_after_one_step(name, kernels):
    """(model, what step() returned) after one step of subset `name` on a
    fresh model from the bench's seed."""
    cfg = small_cfg()
    model = create_model(cfg, seed=bench.SEED, kernels=kernels)
    step = step_breakdown.subset_step(
        name, model, timing.bench_batch(cfg, BSZ, "cpu"), NFEAT)
    if name == "fwd_bwd_dense":
        with step_breakdown.frozen(step_breakdown.tables(model)):
            step()
    else:
        step()
    return model, step


def test_kernel_calls_read_the_ledger():
    """kernel_calls reads each kernel wrapper's calls from the ledger
    (armnet.kernel.*, no route counter), less an earlier read; the
    profiled repetition's calls per step are the ledger's over its calls,
    by the number of calls (on the CPU without a device time)."""
    before = timing.kernel_calls()
    assert set(before) == set(build.KERNEL_CALLS)
    tracing.count("armnet.kernel.table_grad", 3)
    tracing.count("armnet.kernel.bn_fwd")
    tracing.count("armnet.bn.fused")
    none = dict.fromkeys(build.KERNEL_CALLS, 0)
    assert timing.kernel_calls(before) == {**none, "table_grad": 3,
                                           "bn_fwd": 1}
    device_ms, per_step = timing.profile_steps(
        lambda: tracing.count("armnet.kernel.entmax_fwd", 2), 4, "cpu")
    assert device_ms is None
    assert per_step == {**none, "entmax_fwd": 2.0}


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
def test_breakdown_subsets_nest(kernels):
    """fwd leaves no gradient; fwd_bwd_dense gives every parameter but the
    tables the gradient fwd_bwd gives it, and the tables none; no_metrics
    leaves the parameters full leaves; full's meters are finite."""
    init = create_model(small_cfg(), seed=bench.SEED).state_dict()
    runs = {n: _subset_after_one_step(n, kernels)
            for n in step_breakdown.SUBSETS}
    fwd = dict(runs["fwd"][0].named_parameters())
    assert all(p.grad is None for p in fwd.values())
    assert all(torch.equal(p, init[n]) for n, p in fwd.items())
    dense = dict(runs["fwd_bwd_dense"][0].named_parameters())
    full_grad = dict(runs["fwd_bwd"][0].named_parameters())
    tables = {n for n in dense if "embedding" in n}
    assert tables == {"embedding.weight"}
    for n, p in dense.items():
        assert p.requires_grad
        if n in tables:
            assert p.grad is None
        else:
            assert torch.isfinite(p.grad).all(), n
            torch.testing.assert_close(p.grad, full_grad[n].grad,
                                       rtol=0, atol=0)
    assert all(torch.isfinite(full_grad[n].grad).all() for n in tables)
    adam = dict(runs["no_metrics"][0].named_parameters())
    full_model, full_step = runs["full"]
    for n, p in full_model.named_parameters():
        torch.testing.assert_close(p, adam[n], rtol=0, atol=0)
        assert not torch.equal(p, init[n]), n
    assert all(torch.isfinite(v) for v in full_step.meters.values())


@pytest.mark.parametrize("fails", [False, True])
def test_fwd_bwd_dense_restores_the_tables(fails):
    """The tables get no gradient under fwd_bwd_dense and requires_grad
    comes back after it, also where a step raises in the middle."""
    cfg = small_cfg(ensemble=True, dnn_nlayer=1, dnn_nhid=8)
    model = create_model(cfg, seed=bench.SEED)
    tables = step_breakdown.tables(model)
    assert len(tables) == 2
    forward, calls = model.forward, []

    def flaky(batch):
        calls.append(1)
        if fails and len(calls) == 3:
            raise RuntimeError("injected")
        assert not any(t.requires_grad for t in tables)
        return forward(batch)

    model.forward = flaky
    batch = timing.bench_batch(cfg, BSZ, "cpu")
    if fails:
        with pytest.raises(RuntimeError, match="injected"):
            step_breakdown.measure_subset("fwd_bwd_dense", model, batch,
                                          NFEAT, "cpu", 1, 2, 2)
    else:
        m = step_breakdown.measure_subset("fwd_bwd_dense", model, batch,
                                          NFEAT, "cpu", 1, 2, 2)
        assert len(m["times_ms"]) == 2
        assert all(t.grad is None for t in tables)
    assert all(p.requires_grad for p in model.parameters())


def test_full_is_the_trainers_step():
    """full's meters after 3 steps equal make_train_step's on the same
    shifted ids from the same init."""
    cfg = small_cfg()
    batch = timing.bench_batch(cfg, BSZ, "cpu")
    full = step_breakdown.subset_step(
        "full", create_model(cfg, seed=bench.SEED), batch, NFEAT)
    state = create_train_state(create_model(cfg, seed=bench.SEED), bench.LR)
    train_step, meters = make_train_step(), init_meters("cpu")
    for i in range(3):
        full()
        meters = train_step(state, meters, timing.shift_ids(batch, i, NFEAT))
    assert full.state.step == 3
    for k, v in meters.items():
        torch.testing.assert_close(full.meters[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("entry", ["bench", "step_breakdown", "recipes"])
def test_entry_points_raise_without_cuda(entry, monkeypatch):
    """With no card and no --device cpu each entry point raises before it
    builds a model (the table)."""
    def no_model(*a, **k):
        raise AssertionError("built a model")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "create_model", no_model)
    monkeypatch.setattr(step_breakdown, "create_model", no_model)
    main = {"bench": bench.main, "step_breakdown": step_breakdown.main,
            "recipes": recipes.main}[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])


RECORD_KEYS = {"metric", "value", "unit", "vs_baseline", "min", "max",
               "reps", "steps", "warm", "batch_size", "step_ms",
               "device_ms_per_step", "idle_share", "launches", "kernels",
               "ensemble", "dtype", "loss_last", "auc_last", "device", "card",
               "seconds", "torch", "cuda"}


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
def test_run_on_the_cpu_returns_the_whole_record(kernels):
    rec = bench.run(small_cfg(), BSZ, kernels, "cpu", 1, 2, 3)
    assert set(rec) == RECORD_KEYS
    json.dumps(rec)
    assert rec["metric"] == "armnet_1h_criteo_train_examples_per_sec"
    assert rec["unit"] == "examples/s" and rec["vs_baseline"] is None
    assert rec["min"] <= rec["value"] <= rec["max"]
    assert rec["value"] == pytest.approx(BSZ / rec["step_ms"]["median"]
                                         * 1e3)
    assert rec["kernels"] == kernels and rec["device"] == "cpu"
    # the CPU: no card, no device time, no kernel called
    assert rec["card"] == {"before": None, "after": None}
    assert rec["device_ms_per_step"] is None and rec["idle_share"] is None
    assert set(rec["launches"]) == set(build.KERNEL_CALLS)
    assert not any(rec["launches"].values())
    assert np.isfinite(rec["loss_last"])
    assert set(rec["seconds"]) == {"setup", "warm", "card", "timed",
                                   "profiled"}


def test_breakdown_and_recipe_rows_on_the_cpu(capsys):
    rows = step_breakdown.breakdown(small_cfg(), BSZ, "auto", "cpu", 1, 2, 2)
    assert [r["subset"] for r in rows] == list(step_breakdown.SUBSETS)
    assert sum(r["increment_ms"] for r in rows) == pytest.approx(
        rows[-1]["step_ms"]["median"])
    row = recipes.bench_one("tiny_fm", dict(model="fm", nfeat=NFEAT,
                                            nfield=NFIELD, nemb=4),
                            "auto", "cpu", 1, 2, 2, bf16=True,
                            batch_size=BSZ)
    assert row["recipe"] == "tiny_fm_bf16" and row["dtype"] == "bfloat16"
    assert json.loads(capsys.readouterr().out) == row


def test_all_runs_every_variant_headline_last(monkeypatch, capsys):
    """--all: one fresh process per variant with the same timing flags,
    their lines on stdout in turn, the headline last; SystemExit naming a
    variant that failed."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        fail = "pallas-fused" in cmd and "--ensemble" in cmd
        return subprocess.CompletedProcess(cmd, 3 if fail else 0,
                                           stdout=json.dumps(len(cmds)) + "\n")

    monkeypatch.setattr(bench.subprocess, "run", fake_run)
    with pytest.raises(SystemExit, match="kernels=pallas-fused "
                                         "ensemble=True \\(exit 3\\)"):
        bench.main(["--all", "--steps", "7", "--device", "cpu"])
    assert capsys.readouterr().out.split() == ["1", "2", "3", "4"]
    assert len(cmds) == 4
    assert all(c[c.index("--steps") + 1] == "7" for c in cmds)
    assert all(c[c.index("--device") + 1] == "cpu" for c in cmds)
    last = cmds[-1]
    assert last[last.index("--kernels") + 1] == "auto"
    assert "--ensemble" not in last
    assert sorted((c[c.index("--kernels") + 1], "--ensemble" in c)
                  for c in cmds) == sorted(bench.VARIANTS)
