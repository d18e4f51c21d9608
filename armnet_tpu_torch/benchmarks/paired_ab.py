"""Paired A/B of a benchmark command (the counterpart of the JAX package's
benchmarks/r5_paired_ab.py): A, B, A, B, ... in turns, each run a fresh
process, and the median of the per-pair ratios B / A.

    python -m armnet_tpu_torch.benchmarks.paired_ab --b "VAR=1 ..."
        [--a "..."] [--cmd "python -m armnet_tpu_torch.bench"]
        [--pairs 3] [--timeout 1200] [--device cuda]

The same step's wall moves 1.4-2.2x between processes and calls on the
card's machine (PERF.md §2), so two versions compare only inside one call
and in turns: drift moves both sides of a pair together, and the per-pair
ratio is what is left. --a and --b are environment assignments added to
each arm's process; the command runs from the repository root, and the
last JSON line of its stdout with a "value" key gives its number (the
bench's contract).

To compare two trees, give each arm its tree first on the import path and
keep the working directory off it (PYTHONSAFEPATH=1: `python -m` puts the
working directory first otherwise):

    --a "PYTHONSAFEPATH=1 PYTHONPATH=/path/to/parent"
    --b "PYTHONSAFEPATH=1 PYTHONPATH=/path/to/change"

stdout: one JSON line {a_env, b_env, cmd, pairs: [[a, b], ...], ratios,
median_ratio} (a ratio above 1 means B is faster). --device cuda (the
default) raises without CUDA before the first run; --device cpu runs where
there is no card, the command then choosing its own device.
"""

import argparse
import json
import os
import signal
import subprocess
import sys

from armnet_tpu_torch import resolve_device

__all__ = ["ROOT", "DEFAULT_CMD", "parse_env", "run_once", "median_ratio",
           "main"]

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
DEFAULT_CMD = "python -m armnet_tpu_torch.bench"


def parse_env(s):
    """'A=1 B=x' -> {'A': '1', 'B': 'x'}."""
    env = {}
    for kv in s.split():
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def run_once(extra_env, cmd, timeout):
    """The number of one run of `cmd` (a shell command, from ROOT) with
    `extra_env` added to the environment: the "value" of the last JSON
    line of its stdout that has one, None where none does. The command
    runs in a process group of its own, killed whole if it outlasts
    `timeout` seconds (subprocess.TimeoutExpired is raised then)."""
    env = dict(os.environ, **extra_env)
    proc = subprocess.Popen(cmd, shell=True, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    val = None
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if "value" in obj:
                val = float(obj["value"])
    if val is None:
        print(f"paired_ab: no value parsed (rc={proc.returncode}); stderr "
              f"tail: {(stderr.strip().splitlines() or ['<none>'])[-1]}",
              file=sys.stderr, flush=True)
    return val


def median_ratio(ratios):
    """The median of the ratios (the mean of the middle two, to 4 places,
    for an even count), None for none."""
    if not ratios:
        return None
    s, n = sorted(ratios), len(ratios)
    return s[n // 2] if n % 2 else round((s[n // 2 - 1] + s[n // 2]) / 2, 4)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="A, B, A, B runs of a command in turns; the median "
                    "per-pair ratio B / A (one JSON line)")
    ap.add_argument("--a", type=str, default="", help="env for arm A, e.g. ''")
    ap.add_argument("--b", type=str, required=True,
                    help="env for arm B, e.g. 'ARMNET_PREFETCH_THREAD=1'")
    ap.add_argument("--cmd", type=str, default=DEFAULT_CMD)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--timeout", type=int, default=1200)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    a_env, b_env = parse_env(args.a), parse_env(args.b)
    pairs, ratios = [], []
    for i in range(args.pairs):
        a = run_once(a_env, args.cmd, args.timeout)
        b = run_once(b_env, args.cmd, args.timeout)
        pairs.append([a, b])
        if a and b:
            ratios.append(round(b / a, 4))
        print(f"pair {i + 1}/{args.pairs}: A={a} B={b}", file=sys.stderr,
              flush=True)
    print(json.dumps({"a_env": args.a, "b_env": args.b, "cmd": args.cmd,
                      "pairs": pairs, "ratios": ratios,
                      "median_ratio": median_ratio(ratios)}), flush=True)


if __name__ == "__main__":
    main()
