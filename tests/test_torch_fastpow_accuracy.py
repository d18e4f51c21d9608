"""armnet_tpu_torch.benchmarks.fastpow_accuracy against the JAX package's
benchmarks/fastpow_accuracy.py on the CPU, at its own size ([39, 4096],
alpha 1.3, 1.7, 1.9):

  * BUDGETS and REL equal the JAX script's, and so do the cases, alphas
    and draws its measure() takes;
  * the port's plain solver at (12, 4) against the JAX solver at its
    default budget, and the port's reference (the 50-iteration bisection)
    against the JAX one, case by case within atol 1e-5;
  * the `large` case's error within REL of the JAX newton solver's worst
    (the JAX pass rule), at every alpha;
  * one swept budget, (8, 2), against the JAX script run in a subprocess
    with that budget's environment: the same rows within atol 1e-5;
  * the solver's keyword arguments select the branches and budgets that
    the JAX environment knobs select;
  * main() on the CPU and without CUDA.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import armnet_tpu.kernels.entmax_common as jax_common
import armnet_tpu.ops.entmax as jax_entmax
from armnet_tpu_torch.benchmarks import fastpow_accuracy as fa
from armnet_tpu_torch.kernels.entmax_common import solve_entmax_axis0
from jax_scripts import REPO, load

SCRIPT = os.path.join(REPO, "benchmarks", "fastpow_accuracy.py")


@pytest.fixture(scope="module")
def jax_mod():
    return load("fastpow_accuracy")


def test_tables_equal_the_jax_script(jax_mod):
    assert fa.BUDGETS == jax_mod.BUDGETS and fa.REL == jax_mod.REL
    assert fa.NEWTON == (8, 6) and fa.KERNEL_BUDGET == (12, 4)


def _jax_measure(solver, monkeypatch, capsys):
    """(JSON line, [(alpha, x, got, ref)]) of the JAX script's measure() in
    this process under `solver` at its default budgets: its solver and
    reference wrapped to record their inputs and outputs."""
    calls, refs = [], []
    solve, bisect = jax_common.solve_entmax_axis0, jax_entmax.entmax_bisect

    def record_solve(x, alpha):
        got = solve(x, alpha)
        calls.append((alpha, np.asarray(x), np.asarray(got)))
        return got

    def record_ref(x, alpha, n_iter):
        ref = bisect(x, alpha=alpha, n_iter=n_iter)
        refs.append(np.asarray(ref).T)
        return ref

    with monkeypatch.context() as m:
        m.setattr(jax_common, "solve_entmax_axis0", record_solve)
        m.setattr(jax_entmax, "entmax_bisect", record_ref)
        m.setattr(jax_common, "SOLVER", solver)
        m.setattr(jax.config, "update", lambda *a: None)
        m.setenv("ARMNET_ENTMAX_FAST", str(jax_common.N_FAST))
        m.setenv("ARMNET_ENTMAX_POLISH", str(jax_common.N_POLISH))
        capsys.readouterr()
        load("fastpow_accuracy").measure()
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, [(a, x, got, ref) for (a, x, got), ref in zip(calls, refs)]


@pytest.fixture(scope="module")
def port_cases():
    xs = fa.cases()
    return xs, {(a, n): fa.reference(x, a) for a in fa.ALPHAS
                for n, x in xs.items()}


def test_cases_and_solver_match_the_jax_measure(port_cases, monkeypatch,
                                                capsys):
    line, calls = _jax_measure("fastpow", monkeypatch, capsys)
    xs, refs = port_cases
    assert [(r["alpha"], r["case"]) for r in line["rows"]] == [
        (a, n) for a in fa.ALPHAS for n in xs]
    solve = fa.plain_solver("fastpow", 12, 4)
    for (alpha, name), (a, x, got, ref) in zip(
            [(a, n) for a in fa.ALPHAS for n in xs], calls):
        assert a == alpha
        np.testing.assert_array_equal(xs[name].numpy(), x)
        np.testing.assert_allclose(solve(xs[name], alpha).numpy(), got,
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(refs[alpha, name].numpy(), ref, rtol=0,
                                   atol=1e-5)
    port = fa.sweep(solve, xs, refs)
    np.testing.assert_allclose([r["maxerr"] for r in port["rows"]],
                               [r["maxerr"] for r in line["rows"]], rtol=0,
                               atol=1e-5)


def test_large_case_within_the_jax_newton_bar(port_cases, monkeypatch,
                                              capsys):
    newton, _ = _jax_measure("newton", monkeypatch, capsys)
    bar = fa.REL * newton["worst"]
    xs, refs = port_cases
    large = fa.sweep(fa.plain_solver("fastpow"), {"large": xs["large"]},
                     refs)
    assert len(large["rows"]) == len(fa.ALPHAS)
    for r in large["rows"]:
        assert r["maxerr"] <= bar, (r, bar)
    port_newton = fa.sweep(fa.plain_solver("newton"), xs, refs)
    np.testing.assert_allclose(port_newton["worst"], newton["worst"],
                               rtol=0, atol=1e-5)


def test_a_swept_budget_matches_the_jax_subprocess(port_cases):
    env = dict(os.environ, _FPACC_WORKER="1", JAX_PLATFORMS="cpu",
               ARMNET_ENTMAX_SOLVER="fastpow", ARMNET_ENTMAX_BISECT="8",
               ARMNET_ENTMAX_NEWTON="6", ARMNET_ENTMAX_FAST="8",
               ARMNET_ENTMAX_POLISH="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    out = subprocess.run([sys.executable, SCRIPT], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    assert want["budget"] == [8, 2]
    xs, refs = port_cases
    got = fa.sweep(fa.plain_solver("fastpow", 8, 2), xs, refs)
    assert [(r["alpha"], r["case"]) for r in got["rows"]] == [
        (r["alpha"], r["case"]) for r in want["rows"]]
    np.testing.assert_allclose([r["maxerr"] for r in got["rows"]],
                               [r["maxerr"] for r in want["rows"]], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_solver_keywords_select_the_jax_branches(alpha, monkeypatch):
    """newton at alpha <= 2 and a fastpow budget other than the default
    give the JAX solver's outputs under the same settings (alpha 1.5 and 2
    bisect whatever the solver; 2.5 takes newton either way)."""
    x = np.random.RandomState(3).randn(39, 64).astype(np.float32) * 3.0
    for solver, kw, knobs in (
            ("newton", {"n_bisect": 5, "n_newton": 4},
             {"SOLVER": "newton", "N_BISECT": 5, "N_NEWTON": 4}),
            ("fastpow", {"n_fast": 9, "n_polish": 3},
             {"SOLVER": "fastpow", "N_FAST": 9, "N_POLISH": 3})):
        with monkeypatch.context() as m:
            for k, v in knobs.items():
                m.setattr(jax_common, k, v)
            want = np.asarray(jax_common.solve_entmax_axis0(x, alpha))
        got = solve_entmax_axis0(torch.from_numpy(x), alpha, solver=solver,
                                 **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="unknown entmax solver"):
        solve_entmax_axis0(torch.from_numpy(x), 1.7, solver="bisect")


def test_main_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(fa, "SHAPE", (39, 64))
    fa.main(["--device", "cpu"])
    *rows, summary = [json.loads(line) for line in
                      capsys.readouterr().out.strip().splitlines()]
    assert [r["solver"] for r in rows] == ["plain_newton"] + [
        "plain_fastpow"] * len(fa.BUDGETS)
    assert [r["budget"] for r in rows[1:]] == [list(b) for b in fa.BUDGETS]
    assert all(len(r["rows"]) == 12 for r in rows)
    assert summary["bar"] == pytest.approx(fa.REL * rows[0]["worst"])
    assert "kernel_worst" not in summary      # the kernels: the card only


def test_main_raises_without_cuda(monkeypatch):
    def no_cases(*a, **k):
        raise AssertionError("drew the cases")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fa, "cases", no_cases)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fa.main([])
