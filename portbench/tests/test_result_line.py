"""The result line: exactly correct, attempted, failed, metrics, device
(with breakdown when traced), and last `checks`, the numbers compared
beside their limits, which the benchmark's contract asks for in the line
under a key of its own that comes last, and which also close stderr; and
the command's exits without a card or without the program."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import result, spec
from portbench.trace import Trace

ROOT = spec.ROOT
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
LAST = "checks"


@pytest.mark.parametrize("name", ["cr_armnet1h.train", "cr_armnet.train"])
def test_untraced_line(small_cell, name):
    line = result.measure(small_cell(name), 2 ** 31 + 11, 0.3, False, "cpu")
    assert list(line) == KEYS + [LAST]
    assert set(line[LAST]) == set(small_cell(name).limits)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in small_cell(name).end_to_end}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    out, err = io.StringIO(), io.StringIO()
    result.emit(line, out, err)
    assert json.loads(out.getvalue().splitlines()[-1]) == line
    tail = err.getvalue().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def test_traced_line_carries_breakdown_and_device_times(small_cell,
                                                        monkeypatch):
    """On the CPU no device operation is traced; a canned trace stands in
    for the profiler's to show the traced line's shape."""
    from portbench import harness

    def canned(prof, spans, device_type=None):
        w = spans.by_name()["portbench.window"][-1]
        return Trace([("k", "kernel", w[0], w[0] + (w[1] - w[0]) // 2)],
                     spans.by_name(), w)

    monkeypatch.setattr(harness.tracing, "from_profiler", canned)
    monkeypatch.setattr(harness, "profile",
                        lambda **kw: contextlib.nullcontext())
    cell = small_cell("cr_armnet1h.train")
    line = result.measure(cell, 5, 0.3, True, "cpu")
    assert list(line) == KEYS + ["breakdown", LAST]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert "idle_share.train" in line["metrics"]


def test_command_needs_a_card():
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "cr_armnet1h.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert p.returncode != 0 and p.stdout == ""


def test_command_fails_without_the_program(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="", PYTHONSAFEPATH="")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "cr_armnet1h.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode != 0 and p.stdout == ""
