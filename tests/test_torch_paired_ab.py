"""armnet_tpu_torch.benchmarks.paired_ab against the JAX package's
benchmarks/r5_paired_ab.py on a stub command (a Python one-liner whose
number depends on its arm's environment and on a count of the runs before
it): the same JSON line, keys, pairs, ratios and median ratio, for an odd
and an even number of pairs; two trees selected by PYTHONPATH with
PYTHONSAFEPATH; a run past its timeout killed with the processes it
started; no run without CUDA unless --device cpu.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from armnet_tpu_torch.benchmarks import paired_ab
from jax_scripts import REPO

# prints a line that is no JSON, one that does not parse, one without a
# value and, last, the value: V of its arm times 1 + the runs before it / 7
STUB = ("import json, os; p = os.environ['COUNT']; "
        "n = int(open(p).read()) if os.path.exists(p) else 0; "
        "open(p, 'w').write(str(n + 1)); print('warming up'); print('{bad'); "
        "print(json.dumps({'other': 1})); "
        "print(json.dumps({'value': float(os.environ.get('V', '100'))"
        " * (1 + n / 7)}))")


def _run(cmd, env):
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("pairs", [2, 3])
def test_same_line_as_the_jax_script(pairs, tmp_path):
    stub = f"{sys.executable} -c \"{STUB}\""
    argv = ["--a", "V=100", "--b", "V=120 UNUSED=1", "--cmd", stub,
            "--pairs", str(pairs)]
    lines = {}
    for name, cmd in (
            ("jax", [sys.executable, "benchmarks/r5_paired_ab.py"]),
            ("port", [sys.executable, "-m",
                      "armnet_tpu_torch.benchmarks.paired_ab", "--device",
                      "cpu"])):
        env = dict(os.environ, COUNT=str(tmp_path / f"{name}.count"))
        lines[name] = _run(cmd + argv, env)
    assert lines["port"] == lines["jax"]
    assert list(lines["port"]) == ["a_env", "b_env", "cmd", "pairs",
                                   "ratios", "median_ratio"]
    assert len(lines["port"]["pairs"]) == pairs
    assert lines["port"]["median_ratio"] is not None


def test_median_ratio():
    assert paired_ab.median_ratio([]) is None
    assert paired_ab.median_ratio([1.3, 0.9, 1.1]) == 1.1
    assert paired_ab.median_ratio([1.0, 1.25, 0.5, 2.0]) == 1.125
    assert paired_ab.parse_env("A=1 B=x=y") == {"A": "1", "B": "x=y"}


def test_pythonpath_selects_a_tree(tmp_path):
    """Each arm's PYTHONPATH names a tree of its own; PYTHONSAFEPATH keeps
    the repository (the working directory of every run) off the path."""
    for tree, value in (("a", 2.0), ("b", 3.0)):
        pkg = tmp_path / tree / "armnet_tpu_torch"
        pkg.mkdir(parents=True)
        (pkg / "__init__.py").write_text("")
        (pkg / "bench.py").write_text(
            f"import json\nprint(json.dumps({{'value': {value}}}))\n")
    line = _run([sys.executable, "-m",
                 "armnet_tpu_torch.benchmarks.paired_ab", "--device", "cpu",
                 "--a", f"PYTHONSAFEPATH=1 PYTHONPATH={tmp_path / 'a'}",
                 "--b", f"PYTHONSAFEPATH=1 PYTHONPATH={tmp_path / 'b'}",
                 "--cmd", f"{sys.executable} -m armnet_tpu_torch.bench",
                 "--pairs", "1"], dict(os.environ))
    assert line["pairs"] == [[2.0, 3.0]] and line["median_ratio"] == 1.5
    assert paired_ab.DEFAULT_CMD == "python -m armnet_tpu_torch.bench"


def test_a_run_past_its_timeout_is_killed_with_its_children(tmp_path):
    """The shell and the process it starts both end when a run outlasts
    the timeout."""
    pid_file = tmp_path / "child.pid"
    cmd = (f"{sys.executable} -c \"import os, time; open('{pid_file}', "
           f"'w').write(str(os.getpid())); time.sleep(60)\"; echo done")
    with pytest.raises(subprocess.TimeoutExpired):
        paired_ab.run_once({}, cmd, timeout=3)
    pid = int(pid_file.read_text())
    with pytest.raises(ProcessLookupError):
        for _ in range(50):
            os.kill(pid, 0)
            time.sleep(0.1)


def test_main_raises_without_cuda(monkeypatch):
    def no_run(*a, **k):
        raise AssertionError("ran the command")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(paired_ab, "run_once", no_run)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paired_ab.main(["--b", "X=1"])
