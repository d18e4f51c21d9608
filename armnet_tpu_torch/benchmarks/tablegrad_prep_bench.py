"""The table gradient's preparation, stage by stage (the counterpart of the
JAX package's benchmarks/tablegrad_prep_bench.py) at the Criteo recipe's
shape: N = 4096 * 39 updates of E 10 into a [2.1M, 10] table.

    python -m armnet_tpu_torch.benchmarks.tablegrad_prep_bench [STAGE,...]
        [--warm 3] [--steps 10] [--reps 3] [--device cuda]

  dyn_overhead    a copy of ids and g (the JAX stage's input refresh at its
                  carried scalar's value 0: roll by 0, add 0)
  sort_only       torch.sort of the ids (keys only)
  argsort         stable torch.argsort of the ids
  sort_comb       torch.sort of one combined key (bucket << IDX_BITS | pos)
  sort_comb_full  + the order, the sorted ids and the bucket starts
                  (searchsorted of the bucket edges)
  searchsorted    sorted ids + the bucket starts (BUCKET rows a bucket)
  kernel_v4       the whole table gradient (kernels/scatter_cuda
                  .table_grad, K7: the JAX package's v4 kernel and its prep)
  kernel_flat     + .view(-1) of its [nrows, E] output (flat-stored tables)
  reshape_tax     the same: a view costs nothing in the port, where the
                  JAX stage paid a relayout
  k7_split        the port's own split of the whole call on the card
                  (kernels/bench.table_grad_split): the radix passes, the
                  zero fill and the segmented sums by torch.profiler,
                  beside the PyTorch route it replaced and zeros +
                  index_add_; the card only

Not ported: pair_build, pair_gather, pair_gatherT (the bf16 hi|residual
payload of the TPU kernel's two MXU passes), idrow, idcol (its lane-layout
id rows and columns) and transposeT (the post-processing of a transposed
output the JAX package tried and dropped). The port's kernel sums g in
exact f32 in its own layout, so none of them has a counterpart; a STAGE
argument naming one runs nothing for it (NOT_PORTED says why, on stderr).

The torch-op stages run alike on the card and the CPU; kernel_* take the
plain version (table_grad_plain) on the CPU. ids and g are drawn by
RandomState(0) as the JAX script draws them. Timing:
benchmarks/timing.py. stdout: one JSON line per stage; stderr: the JAX
script's table.
"""

import argparse
import json
import sys

import torch

from armnet_tpu_torch import resolve_device
from armnet_tpu_torch.benchmarks.tablegrad_breakdown import (E, N, NROWS,
                                                             grad_fn, inputs)
from armnet_tpu_torch.benchmarks.timing import (add_timing_args, parse_only,
                                                run_stages)
from armnet_tpu_torch.kernels.bench import table_grad_split

__all__ = ["N", "E", "NROWS", "BUCKET", "IDX_BITS", "STAGES", "NOT_PORTED",
           "stages", "main"]

BUCKET = 2048
BUCKET_BITS = 11               # the JAX script's `ids >> 11`: log2(BUCKET)
IDX_BITS = 18
assert 1 << BUCKET_BITS == BUCKET and N < (1 << IDX_BITS)
STAGES = ("dyn_overhead", "sort_only", "argsort", "sort_comb",
          "sort_comb_full", "searchsorted", "kernel_v4", "kernel_flat",
          "reshape_tax")
_PAYLOAD = ("the TPU kernel's bf16 hi|residual payload for its two MXU "
            "passes; the port's kernel sums g in exact f32")
NOT_PORTED = {
    "pair_build": _PAYLOAD, "pair_gather": _PAYLOAD,
    "pair_gatherT": _PAYLOAD,
    "idrow": "the TPU kernel's [8, N] id row for its lane-tiled DMA",
    "idcol": "a [N, 128] id column for a transposed one-hot TPU kernel",
    "transposeT": "the post-processing of a transposed-output TPU kernel "
                  "the JAX package dropped"}


def stages(ids, g, nrows=NROWS):
    """((name, fn), ...) of STAGES: fn() returns the stage's outputs, the
    arrays that the JAX stage's probe reads, in its order."""
    n = ids.shape[0]
    nb = -(-nrows // BUCKET)
    grad = grad_fn(ids.device)
    pos = torch.arange(n, dtype=torch.int32, device=ids.device)

    def comb_sorted():
        return torch.sort(((ids >> BUCKET_BITS) << IDX_BITS) | pos).values

    def sort_comb_full():
        cs = comb_sorted()
        sid = ids[cs & ((1 << IDX_BITS) - 1)]
        edges = torch.arange(nb + 1, dtype=torch.int32,
                             device=ids.device) << IDX_BITS
        return sid, torch.searchsorted(cs, edges).int()

    def searchsorted():
        sid = torch.sort(ids).values
        edges = torch.arange(nb + 1, dtype=torch.int32,
                             device=ids.device) * BUCKET
        return sid, torch.searchsorted(sid, edges).int()

    table = {
        "dyn_overhead": lambda: (torch.roll(ids, 0), g + 0.0),
        "sort_only": lambda: (torch.sort(ids).values,),
        "argsort": lambda: (torch.argsort(ids, stable=True),),
        "sort_comb": lambda: (comb_sorted(),),
        "sort_comb_full": sort_comb_full,
        "searchsorted": searchsorted,
        "kernel_v4": lambda: (grad(g, ids, nrows),),
        "kernel_flat": lambda: (grad(g, ids, nrows).view(-1),),
        "reshape_tax": lambda: (grad(g, ids, nrows).view(-1),),
    }
    return tuple((name, table[name]) for name in STAGES)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="the table gradient's preparation stage by stage (one "
                    "JSON line per stage)")
    p.add_argument("only", nargs="?", default=None,
                   help="comma-separated stages (default: all)")
    add_timing_args(p, warm=3, steps=10, reps=3, kernels=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    only = parse_only(args.only)
    for name in sorted((only or set()) & set(NOT_PORTED)):
        print(f"{name}: not ported: {NOT_PORTED[name]}", file=sys.stderr)
    ids, g = inputs(device=device)
    run_stages(stages(ids, g, NROWS), device, args.warm, args.steps,
               args.reps, only, n=N, e=E, nrows=NROWS, bucket=BUCKET,
               idx_bits=IDX_BITS)
    if only is not None and "k7_split" not in only:
        return
    if device.type != "cuda":
        print("k7_split: the card's kernels only; skipped on the CPU",
              file=sys.stderr)
        return
    split = table_grad_split(g, ids, NROWS)
    print(f"{'k7_split':16s} whole {split['whole_ms']:.4f} ms = sort "
          f"{split['sort_ms']:.4f} + fill and sums {split['kernel_ms']:.4f}"
          f"; zeros + index_add_ {split['library_ms']:.4f}",
          file=sys.stderr)
    print(json.dumps({"stage": "k7_split", "n": N, "e": E, "nrows": NROWS,
                      **split}), flush=True)


if __name__ == "__main__":
    main()
