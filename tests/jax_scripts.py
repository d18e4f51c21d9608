"""Helpers of the tests that hold the port's benchmark modules
(armnet_tpu_torch/benchmarks/) to the JAX package's scripts in
benchmarks/: load a script as a module, and run its stage bodies eagerly
at a small size, recording the arrays that each body's probe reads.

The stage bodies of benchmarks/mh_breakdown.py and tablegrad_prep_bench.py
are closures of their main(); each hands its body to chain_time() and
prints the stage's name. With chain_time replaced by a recorder, main()
gives every (name, body); a body called on a zero scalar runs its stage
once, eagerly, and every array that it passes to
jax.lax.optimization_barrier (its probe's first step) is recorded.
"""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    """benchmarks/<name>.py as a fresh module; the persistent compilation
    cache that some scripts switch on at import is left off."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    update = jax.config.update
    jax.config.update = lambda key, value: None
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update = update
    return mod


def bodies(mod, monkeypatch, argv=(), **small):
    """[(stage name, body)] of the script's main() in its order, its module
    constants set to `small` first."""
    for k, v in small.items():
        monkeypatch.setattr(mod, k, v)
    found, names = [], []
    monkeypatch.setattr(mod, "chain_time",
                        lambda body: found.append(body) or 0.0)
    monkeypatch.setattr(mod, "print", lambda line, **kw: names.append(
        line.split()[0]), raising=False)
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    mod.main()
    assert len(names) == len(found)
    return list(zip(names, found))


def probe_reads(body, monkeypatch):
    """The arrays that one eager run of `body` hands its probe: every array
    passed to jax.lax.optimization_barrier, with jax.lax.slice clipping its
    limits to the array (the probes read the first 256 entries of arrays
    that may be smaller at a test's size)."""
    seen = []
    slice_ = jax.lax.slice
    with monkeypatch.context() as m:
        m.setattr(jax.lax, "optimization_barrier",
                  lambda x: seen.append(x) or x)
        m.setattr(jax.lax, "slice", lambda x, start, limit, *a: slice_(
            x, start, tuple(min(l, s) for l, s in zip(limit, x.shape)), *a))
        body(jnp.zeros(()))
    return seen
