"""armnet_tpu_torch.benchmarks.mh_breakdown against the JAX package's
benchmarks/mh_breakdown.py on the CPU, at B 8, K 2, O 4, F 5, E 3:

  * the stage names, shapes and alpha equal the JAX script's;
  * every stage on the same RandomState(0) inputs gives what the JAX
    stage body hands its probe (the JAX side eager, entmax_pallas in
    interpret mode as on any backend but the TPU): forward values within
    atol 1e-5, the *_bwd stages' gradients within 1e-4 of their norms;
  * main() on the CPU prints one JSON line per stage, no kernel launched,
    and raises without CUDA before it draws an input.
"""

import json

import numpy as np
import pytest
import torch

from armnet_tpu_torch.benchmarks import mh_breakdown
from jax_scripts import bodies, load, probe_reads

SMALL = dict(B=8, K=2, O=4, F=5, E=3)


@pytest.fixture(scope="module")
def jax_mod():
    return load("mh_breakdown")


def test_tables_equal_the_jax_script(jax_mod, monkeypatch):
    assert mh_breakdown.SHAPE == (jax_mod.B, jax_mod.K, jax_mod.O, jax_mod.F,
                                  jax_mod.E)
    names = [n for n, _ in bodies(jax_mod, monkeypatch, **SMALL)]
    assert tuple(names) == mh_breakdown.STAGES
    assert [n for n, _ in mh_breakdown.stages(mh_breakdown.inputs(
        tuple(SMALL.values())))] == names


@pytest.fixture(scope="module")
def port_outputs():
    inp = mh_breakdown.inputs(tuple(SMALL.values()))
    return {name: [t.detach().numpy() for t in fn()]
            for name, fn in mh_breakdown.stages(inp)}


@pytest.mark.parametrize("stage", mh_breakdown.STAGES)
def test_stage_matches_the_jax_stage(stage, jax_mod, port_outputs,
                                     monkeypatch):
    body = dict(bodies(jax_mod, monkeypatch, **SMALL))[stage]
    got = port_outputs[stage]
    # a stage whose body passes its output through a barrier of its own
    # before the probe's (transpose) hands the same array twice
    want = [np.asarray(w) for w in probe_reads(body, monkeypatch)][-len(got):]
    assert [w.shape for w in want] == [g.shape for g in got]
    for g, w in zip(got, want):
        if stage.endswith("_bwd"):
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), stage
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_main_on_the_cpu_prints_every_stage(monkeypatch, capsys):
    monkeypatch.setattr(mh_breakdown, "SHAPE", tuple(SMALL.values()))
    mh_breakdown.main(["--device", "cpu", "--warm", "1", "--steps", "1",
                       "--reps", "1"])
    rows = [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line]
    assert tuple(r["stage"] for r in rows) == mh_breakdown.STAGES
    for r in rows:
        assert r["shape"] == SMALL and r["alpha"] == 2.0
        assert r["step_ms"]["median"] > 0 and r["device_ms_per_step"] is None
        assert not any(r["launches"].values())
    mh_breakdown.main(["entmax_fwd,transpose", "--device", "cpu", "--warm",
                       "0", "--steps", "1", "--reps", "1"])
    assert [json.loads(line)["stage"] for line in
            capsys.readouterr().out.split("\n") if line] == ["entmax_fwd",
                                                             "transpose"]


def test_main_raises_without_cuda(monkeypatch):
    def no_inputs(*a, **k):
        raise AssertionError("drew the inputs")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mh_breakdown, "inputs", no_inputs)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mh_breakdown.main([])
