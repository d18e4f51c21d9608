"""The readings a cell's limits are set from (not run by the benchmark's
runs): on each seed, the numbers the check compares for the program as
the configuration states it, for the control (the program's own
lower-precision paths: TF32 products, `--matmul_precision high`, and
bfloat16 activations, `--bf16`) and for a planted fault (half of every
batch left out, the loss a mean over the rest). One JSON line per seed
and variant on stdout.

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3
        [--variants program tf32 bf16 fault]

The check's first steps are read at the cell's own batch; no window runs.
"""

import argparse
import json
import sys
import time

import torch

from portbench import gen, harness, spec

__all__ = ["VARIANTS", "FAULTS", "train_readings", "main"]

VARIANTS = ("program", "tf32", "bf16", "fault")


def _half_batch(step, session):
    """The train step on the first half of each batch (a fault)."""
    def faulty(state, meters, batch):
        half = batch["y"].shape[0] // 2
        return step(state, meters, {k: v[:half] for k, v in batch.items()})
    return faulty


FAULTS = {"step": _half_batch}


def _control(variant):
    return variant if variant in ("tf32", "bf16") else None


def train_readings(cell, seed, device, variants):
    """{variant: numbers} of the check's first steps on one seed; the rows
    and the reference's readings are shared by the variants."""
    rows = harness.make_rows(cell.config, cell.traffic, seed, device)
    order = gen.epoch_order(len(rows), int(seed) % (2 ** 31), 0)
    refr = harness.train_reference(cell, seed, rows, device, order)
    harness._free(device)
    out = {}
    for v in variants:
        hooks = FAULTS if v == "fault" else None
        session = harness.TrainSession(cell, seed, device, rows,
                                       _control(v), hooks)
        prog = session.first_steps()
        session.close()
        del session
        harness._free(device)
        numbers, _, worst = harness.train_numbers(prog, refr)
        out[v] = {**numbers, "worst": worst}
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=list(VARIANTS),
                   choices=VARIANTS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        found = train_readings(cell, seed, device, args.variants)
        for variant, numbers in found.items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "variant": variant, "numbers": numbers,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
