"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The run needs as many CUDA devices as the
cell's `chips`, and exits 2 without a result where it has fewer. It makes
the cell's weights and rows from the seed, warms up, measures for
`--seconds`, checks what the measured path produced against the plain
reference, and prints as the last line of stdout one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones, each {value, unit}), device, with
--trace 1 breakdown, and last `checks` (each number compared with its
limit, as the benchmark's contract asks), which also close stderr. The
environment's BENCH_RUN is not read.

The program's kernels are built into build/armnet_tpu_torch/ inside the
checkout (the program fixes that directory), so only a checkout's first
run builds them.
"""

import argparse
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "armnet_tpu")

# a library of the program that could load JAX by itself is kept from it
os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules(modules=None):
    """Top-level names of loaded modules that a run may not hold, compared
    whole (armnet_tpu_torch is not armnet_tpu)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from portbench import result, spec

    cell = spec.load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found {have}", file=sys.stderr)
        return 2
    line = result.measure(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; it may load none of "
              f"{list(FORBIDDEN)}", file=sys.stderr)
        return 3
    result.emit(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
