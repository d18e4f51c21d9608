"""armnet_tpu_torch.benchmarks.tablegrad_breakdown and tablegrad_prep_bench
against the JAX package's benchmarks/tablegrad_breakdown.py and
tablegrad_prep_bench.py on the CPU, at N 512 updates of E 10 into 3000
rows (the JAX side eager; its table_grad is the reference scatter-add off
the TPU, as its own tests run it):

  * the shapes, BUCKET, IDX_BITS and stage names equal the JAX scripts';
    the stages the port leaves out are those that NOT_PORTED names;
  * the breakdown's stages against the JAX stage bodies' read-outs and
    against the JAX ops that they time: sorts and gathers exact, the table
    gradient within atol 1e-5;
  * every prep stage against what the JAX stage body hands its probe:
    integer outputs exact, float outputs within atol 1e-5;
  * main() on the CPU prints a line per stage and launches no kernel; the
    entry points raise without CUDA before they draw an input.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.scatter_pallas import table_grad as jax_table_grad
from armnet_tpu_torch.benchmarks import tablegrad_breakdown as tb
from armnet_tpu_torch.benchmarks import tablegrad_prep_bench as tp
from jax_scripts import bodies, load, probe_reads

SMALL = dict(N=512, NROWS=3000)
DRAW = tb.inputs


@pytest.fixture(scope="module")
def jax_tb():
    return load("tablegrad_breakdown")


@pytest.fixture(scope="module")
def jax_tp():
    return load("tablegrad_prep_bench")


def test_tables_equal_the_jax_scripts(jax_tb, jax_tp, monkeypatch):
    for mod in (jax_tb, jax_tp):
        assert (tb.N, tb.E, tb.NROWS) == (mod.N, mod.E, mod.NROWS)
    assert (tp.BUCKET, tp.IDX_BITS) == (jax_tp.BUCKET, jax_tp.IDX_BITS)
    assert [n for n, _ in bodies(jax_tb, monkeypatch, **SMALL)] == list(
        tb.STAGES)
    names = [n for n, _ in bodies(jax_tp, monkeypatch, **SMALL)]
    assert [n for n in names if n not in tp.NOT_PORTED] == list(tp.STAGES)
    assert set(names) == set(tp.STAGES) | set(tp.NOT_PORTED)


def small_inputs():
    return DRAW(SMALL["N"], tb.E, SMALL["NROWS"])


def test_inputs_are_the_jax_scripts_draws():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, SMALL["NROWS"], (SMALL["N"],)).astype(np.int32)
    g = rng.randn(SMALL["N"], tb.E).astype(np.float32)
    got_ids, got_g = small_inputs()
    assert got_ids.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), ids)
    np.testing.assert_array_equal(got_g.numpy(), g)


@pytest.mark.parametrize("stage", tb.STAGES)
def test_breakdown_stage_matches_the_jax_stage(stage, jax_tb, monkeypatch):
    ids, g = small_inputs()
    got = dict(tb.stages(ids, g, SMALL["NROWS"]))[stage]()
    jids, jg = jnp.asarray(ids.numpy()), jnp.asarray(g.numpy())
    order = np.asarray(jnp.argsort(jids))
    # the JAX body reads one entry at a fixed index (clipped to N - 1 as a
    # JAX gather clips it) and returns it on the zero scalar it carries
    k = min(12345, SMALL["N"] - 1)
    if stage == "argsort":
        sid, perm = (t.numpy() for t in got)
        np.testing.assert_array_equal(perm, order)
        np.testing.assert_array_equal(sid, ids.numpy()[order])
        readout = perm[k]
    elif stage == "sort_gather":
        sid, sg = (t.numpy() for t in got)
        np.testing.assert_array_equal(sid, ids.numpy()[order])
        np.testing.assert_array_equal(sg, g.numpy()[order])
        readout = sg[k, 0] + np.float32(sid[k])
    else:
        (out,) = got
        want = np.asarray(jax_table_grad(jg, jids, SMALL["NROWS"]))
        np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-5)
        readout = out[0, 0] + out[-1, -1]
    body = dict(bodies(jax_tb, monkeypatch, **SMALL))[stage]
    np.testing.assert_allclose(float(readout), float(body(jnp.zeros(()))),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("stage", tp.STAGES)
def test_prep_stage_matches_the_jax_stage(stage, jax_tp, monkeypatch):
    ids, g = small_inputs()
    got = [t.numpy()
           for t in dict(tp.stages(ids, g, SMALL["NROWS"]))[stage]()]
    body = dict(bodies(jax_tp, monkeypatch, **SMALL))[stage]
    want = [np.asarray(w) for w in probe_reads(body, monkeypatch)][-len(got):]
    assert [w.shape for w in want] == [t.shape for t in got]
    for t, w in zip(got, want):
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(t, w)
        else:
            np.testing.assert_allclose(t, w, rtol=0, atol=1e-5)


def _lines(out):
    return [json.loads(line) for line in out.split("\n") if line]


def test_mains_on_the_cpu(monkeypatch, capsys):
    for mod in (tb, tp):
        monkeypatch.setattr(mod, "inputs", _small_on)
        monkeypatch.setattr(mod, "NROWS", SMALL["NROWS"])
    flags = ["--device", "cpu", "--warm", "1", "--steps", "1", "--reps",
             "1"]
    tb.main(flags)
    rows = _lines(capsys.readouterr().out)
    assert [r["stage"] for r in rows] == list(tb.STAGES)
    assert rows[0]["beside"]["what"] == "torch.argsort(ids, stable=True)"
    assert rows[0]["beside"]["step_ms"]["median"] > 0
    tp.main(flags)
    rows = _lines(capsys.readouterr().out)
    assert [r["stage"] for r in rows] == list(tp.STAGES)
    for r in rows:
        assert not any(r["launches"].values())
        assert (r["bucket"], r["idx_bits"]) == (2048, 18)
    # a left-out stage runs nothing, and says why
    tp.main(["pair_build,argsort"] + flags)
    out = capsys.readouterr()
    assert [r["stage"] for r in _lines(out.out)] == ["argsort"]
    assert "pair_build: not ported" in out.err


def _small_on(device):
    return tuple(t.to(device) for t in small_inputs())


@pytest.mark.parametrize("mod", [tb, tp])
def test_mains_raise_without_cuda(mod, monkeypatch):
    def no_inputs(*a, **k):
        raise AssertionError("drew the inputs")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "inputs", no_inputs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
