"""A run's result line: the metrics read by each metric's reader, the
device, the breakdown of a traced run, and the check (`correct`, with
each number compared beside its limit)."""

import json
import sys

import torch

from portbench import harness, spec

__all__ = ["measure", "check", "emit"]


def check(numbers, limits):
    """(correct, {name: {value, limit}}): every number the run compared is
    finite and at most its limit; a number without a limit is an error."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    # a number that is not finite goes into the JSON line as a string
    checks = {k: {"value": v if harness.finite(v) else str(v),
                  "limit": limits[k]}
              for k, v in sorted(numbers.items())}
    ok = all(harness.finite(v) and v <= limits[k]
             for k, v in numbers.items())
    return ok, checks


def read_metrics(cell, window, traced):
    """{name: {value, unit}} of the cell's end-to-end metrics (per-layer
    with a trace); a reader that finds nothing leaves its metric out."""
    out = {}
    for entry in (cell.per_layer if traced else cell.end_to_end):
        value = spec.load_reader(entry["name"], cell.root).read(window)
        if value is not None:
            out[entry["name"]] = {"value": float(value),
                                  "unit": entry["unit"]}
    return out


def device_info(device, chips, peak, window):
    if torch.device(device).type == "cuda":
        info = {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": chips, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    if window.trace is not None:
        info["busy_s"] = window.busy_s
        info["window_s"] = window.trace.window_s
    return info


def measure(cell, seed, seconds, traced, device, hooks=None, control=None):
    """The result line (a dict, `checks` last) of one run of `cell`."""
    window, numbers, peak = harness.run(cell, seed, seconds, traced,
                                           device, hooks, control)
    correct, checks = check(numbers, cell.limits)
    line = {"correct": correct, "attempted": window.steps, "failed": 0,
            "metrics": read_metrics(cell, window, traced),
            "device": device_info(device, cell.chips, peak, window)}
    if window.trace is not None:
        line["breakdown"] = {"device_ops": window.trace.top_ops(),
                             "idle_gaps": window.trace.idle_gaps()}
    line["checks"] = checks
    return line


def emit(line, out=None, err=None):
    """The checks as the last lines of stderr, the line as the last line
    of stdout."""
    out, err = out or sys.stdout, err or sys.stderr
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
