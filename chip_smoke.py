#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (armnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure with a non-zero exit:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc of every armnet_tpu_torch/kernels/csrc/*.cu, in parallel;
              ptxas registers and spills of every kernel, and of the
              instantiations the main paths launch apart
  3. kernel   each CUDA kernel against its plain PyTorch version on the
              card: the entmax forward and backward at both Criteo and
              Frappe shapes, a 2-D last-axis and a ragged shape, the
              Diabetes130 step (43 fields), columns of 65, 100 and 300
              (the forward's shared-memory route), the shapes where inner
              is small (the last axis of mh_breakdown's gates, (1048576,
              39, 1), and the multi-head presets' gates [B, F, C] at C
              8-64: the packed routes) and a NaN column, at four alphas
              (timed at the Criteo, Frappe and Diabetes130 steps and at d
              100, with each route; the backward's registers, spills and
              blocks per SM);
              the table gradient on a Criteo batch's int32 and int64 ids,
              Zipf-skewed ids, all ids equal, wrapped and dropped ids and
              a ragged table, and on the Criteo batch at the zoo's widths
              E = 1 (FeaturesLinear) and 20 (HOFM) and on the UCI step's
              16 live rows of 5,500 (512 updates each), twice (bitwise
              equal), its radix sort
              against a stable torch.sort, and its time split into the
              sort and the fill and segmented sums (by torch.profiler; by
              CUDA events where no profiler session records a device
              event: split_by in the line). Kernel, plain and
              library times (device ms of one call, and host-inclusive
              ms beside them: armnet_tpu_torch/kernels/bench.py) beside
              the bound
     kernel_arm  the fused ARM-1h forward (K5) and recompute backward (K6)
              against their plain versions at the Criteo and Frappe steps,
              a ragged batch, one row, O 200 and 96, F 16 and 17, fewer
              rows than K6's grid, wide embeddings (Frappe at nemb 100
              with h 10, Criteo's fields at nemb 40) and past the 40-field
              bucket (F 41, 43, 64, 128, the wide build at 43), at four
              alphas, K6 twice (bitwise equal); kernel, plain and
              composed-path times at the Criteo and Diabetes130 steps and
              at the UCI armnet_1h step (B 512, F 16, alpha 1.7) beside
              the bound, blocks per SM, K6's grid and its split
              into its main kernel and the ordered sum of the blocks'
              partials
     kernel_multihead  K2 and K4 at the multi-head presets' channel
              counts C = nattn_head x h in {6, 8, 16, 32, 64, 256, 512} at
              39 and 43 fields and four alphas against their plain
              versions; timed at the gates of cr_armnet [4096, 39, 256],
              alpha 2, db_armnet [1024, 43, 32], alpha 1.7, the UCI armnet
              step [512, 16, 512], alpha 1.7, av_armnet [4096, 22, 32],
              alpha 1.5, av_armnet+ [4096, 22, 64], alpha 2,
              frappe_armnet+ [4096, 10, 16], alpha 1.5, and ml_armnet+
              [4096, 3, 8], alpha 2.5, beside the bound and the plain
              versions, with each route and its blocks per SM
     kernel_cin  the CIN layer's fused kernels (K8) at the xdfm_criteo
              step's layers (65,536 rows, E 10, 39 fields, C 39 and 200,
              200 maps), TF32 off: forward, dx0, dxk and dW against the
              plain version (on 4,096 rows; dW summed over blocks of them)
              within 2e-5 of the largest entry, the backward twice bitwise
              equal, launches a call; device and host-inclusive ms beside
              the bound, the plain version and the blocked route
              (kernels/bench.py's cin section), registers and spills
     kernel_bn  BatchNorm's train-mode kernels (K9) at the cells'
              BatchNorms that take them (kernels/bench.py's BN_SHAPES:
              arm_bn of cr_armnet1h and cr_armnet), masked
              with an eighth of the rows pad rows of outliers: y, mean,
              rstd, the running statistics, dx, dweight and dbias within
              KERNELS_VS_PLAIN_RTOL of the plain version, norm-wise; both
              passes twice, bitwise equal; launches a call; device and
              host-inclusive ms beside the bound, the plain version,
              the composed path and F.batch_norm (cuDNN), registers and
              spills
     data_path  the libsvm parse routes on a seeded 100,000-row Criteo-
              geometry file: seconds of the native parser (built with g++
              from armnet_tpu_torch/data/csrc/), the vectorized numpy
              parse, a row-cache miss and hit, and 4 byte-range shards;
              equal arrays on every route, `native` as the route, and
              malformed lines skipped as the line-by-line parser skips
              them
  4. serve    armnet_tpu_torch.predict at the Criteo width of the
              cr_armnet1h preset (nfeat 2.1M, 39 fields, E=10, h=128, MLP
              2x500, alpha 2.0), ensemble off and on, on a seeded synthetic
              10,000-row libsvm file, one cold and three warm calls each:
              rows, finite scores, one kernel launch per batch, and GPU
              logits against the CPU's for the first batch
     serve_fused  the same, ensemble off, under --kernels pallas-fused
              (restored from the checkpoint's sidecar): one K5 launch per
              batch and no entmax launch; logits against the auto path's
              on the card and the CPU's
  5. frappe   predict at frappe_armnet1h widths on data/frappe/test.libsvm:
              rows, one launch per batch, GPU vs CPU logits of the first batch
     serve_armnet  predict of the multi-head armnet at the cr_armnet and
              cr_armnet+ widths (the ensemble off and on) on the serving
              file: one K2 launch per batch and no K5, GPU vs CPU logits
  6. profile  torch.profiler over one warm Criteo-width scoring pass:
              device time by kernel and the device's busy share
  7. train    (every train phase's batches reach the card through the
              iterator's lookahead: pinned memory, a copy stream)
              armnet_tpu_torch.train.cli.main at cr_armnet1h widths,
              ensemble off and on (the cr_armnet1h+ tower), and with the
              ensemble off under --kernels pallas-fused (K5 and K6 per
              step, no entmax launch), 2 epochs of 10 batches on seeded
              synthetic files: finite losses that fall, the kernel
              launches per train step and per eval batch, one step on the
              card against the same step on the CPU from the run's
              checkpoint, and warm train rows/s over whole epochs
     bench    the measurement harness, each script in fresh processes:
              python -m armnet_tpu_torch.bench under auto and
              pallas-fused, the ensemble off and on (the headline, auto
              without the ensemble, at its defaults: 5 x 100 warm steps;
              the others at 3 x 50), the step breakdown of armnet_1h
              (3 x 30) under both kernel choices, and the recipes'
              --quick rows: every line parses, every time and rate finite
              and > 0, the launches per step of each kernel (K7 none in
              fwd and fwd_bwd_dense)
     benchmarks  the rest of the harness: K1 and K3 on the last axis of
              mh_breakdown's gates [4096, 4, 64, 39] (the (1048576, 39, 1)
              view) through its entmax stages in this process, held to
              their plain versions and timed beside them and the bound;
              tablegrad_breakdown's table gradient against index_add_ on
              the card; then in fresh processes mh_breakdown,
              tablegrad_breakdown and tablegrad_prep_bench (every stage,
              times finite and > 0, launches per call), fastpow_accuracy
              (the kernel's worst error within 1.2x the newton build's at
              each alpha), scaling --max_devices 1 (one row) and one A/A
              pair of the bench through paired_ab
     feeds    warm train rows/s of cr_armnet1h with the batches gathered
              from rows resident on the card, fed through the streaming
              lookahead (RESIDENT_SHARE 0), through it with the prefetch
              thread (ARMNET_PREFETCH_THREAD=1) and copied at the head of
              each step (the loop before the lookahead), in turns
     distributed  torchrun (one process, NCCL) of the training CLI at
              cr_armnet1h width with --mesh data:1,model:1
              --shard_embedding against the same run in this process:
              per-step losses, the checkpoint's parameters (1e-6) and
              predict's logits (1e-5); then in a one-process NCCL group
              one train step per exchange with the table cut by
              shard_tables (K7 into the shard) against the replicated step
     train_armnet  the same at the cr_armnet and cr_armnet+ widths under
              auto, and gc_arm with cr_armnet's flags under pallas-fused
              (K2, K4 and K7 a step, no K5/K6): launches, falling losses,
              one step on the card against the CPU on 1024 rows (the
              CPU step takes the card's outputs of the BatchNorms over
              channel axis 1), and for cr_armnet warm rows/s and the
              train-step profile
  8. frappe_train  3 epochs of the frappe_armnet1h recipe on data/frappe/:
              valid and test AUC per epoch beside the JAX package's curve
     diabetes_train  3 epochs of the db_armnet1h recipe (43 fields, alpha
              1.7) on data/uci_diabetes/ under --kernels auto and
              pallas-fused: launches per step, falling finite losses, one
              step on the card against the CPU, valid and test AUC
     diabetes_parity  15 epochs of the db_armnet1h recipe in process from
              the JAX package's seed-2025 init (data/parity/), under
              --kernels auto and pallas-fused: the best valid AUC within
              0.003 of the JAX package's from that init on the CPU; the
              per-epoch valid AUC beside the JAX and port CPU curves, the
              first epoch past 0.9, train losses, launches and seconds
     diabetes_armnet  3 epochs of the db_armnet recipe (K2/K4 at C = 32,
              alpha 1.7) on data/uci_diabetes/: the same checks
     frappe_zoo  afn, sa_glu and the other 16 zoo models (lr, fm, hofm,
              afm, nfm, dnn, wd, dfm, ipnn, kpnn, dcn, dcn+, cin, xdfm,
              gcn, gat) with the CLI defaults on data/frappe/, 2 epochs
              each (6-20 for the models with a first-order term): K7
              launches (twice a step where a FeaturesLinear sits beside
              the table) and, for cin and xdfm, K8's (a forward a layer a
              batch, its backward's launches a layer a step), no other;
              valid and test AUC against the JAX
              package's over as many epochs, one step against the CPU
              (unpinned but for the channel-axis-1 BatchNorms and gcn's
              MLP BatchNorms), predict
              of the best checkpoint with GPU vs CPU logits, and AFN's
              main table at least 1e-4 at every forward
     criteo_zoo  xdfm and dfm at Criteo geometry (nfeat 2.1M, 39 fields,
              batch 4096) on the synthetic split: launches (K7 twice a
              step; xdfm's K8 a layer, CIN 3 x 128), falling losses, one
              step against the CPU, predict of the serving file with GPU
              vs CPU logits, peak device memory and warm train rows/s
     uci_train  the UCI multi-class path on a seeded ARFF at the UCI-121
              letter geometry (20,000 rows, 16 columns, 26 classes,
              conxuntos.dat 10,000 / 10,000): armnet at the CLI defaults
              and armnet_1h under pallas-fused, --batch_size 512
              --valid_perc 0.1, 10 epochs: launches, falling losses, one
              step against the CPU (pinned; armnet_1h unpinned too), best
              valid, test and train accuracy against the JAX package's
     bf16     --bf16 on Frappe: frappe_armnet1h under auto and
              pallas-fused and frappe_armnet, 2 epochs each: launches,
              the Embedding outputs bfloat16 and the MLP head's input in
              the JAX model's dtype, falling losses, the step against the
              CPU (loss within 2e-2, the kernels held to their plain
              versions at their boundary), best valid AUC against the JAX
              package's --bf16 run, predict of the best checkpoint (bf16
              restored from the sidecar), peak memory and warm rows/s
              against the same run in float32
  9. profile_train  torch.profiler over one warm Criteo-width train step,
              under auto and under pallas-fused
 10. entmax_alpha  the learned-alpha entmax (a tensor alpha, torch ops on
              every device) at [4096, 39, 128] over fields, a scalar and a
              per-column alpha: y against the CPU within 1e-5, dx and
              dalpha within 1e-5 of their norms, no kernel launch
The armnet_1h phases hold their GPU-vs-CPU steps unpinned and pinned.
Then one JSON line {"kernels": [...]} and, last, the device JSON line.
Weights are random, drawn from a seed. Exits non-zero without a result when
CUDA is absent. Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from armnet_tpu_torch import predict
from armnet_tpu_torch.benchmarks.timing import (
    launch_counts as read_counts, zero_launch_counts as zero_counts)
from armnet_tpu_torch.bridge import from_jax_arrays
from armnet_tpu_torch.data import libsvm
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          make_dataloaders)
from armnet_tpu_torch.data.uci import uci_loader
from armnet_tpu_torch.kernels import (arm_cuda, bench, bn_cuda, build,
                                      cin_cuda, entmax_cuda, scatter_cuda)
from armnet_tpu_torch.kernels.bench import (CRITEO_ARM, DIABETES_ARM,
                                            FRAPPE_ARM, FRAPPE_NEMB100_ARM,
                                            arm_bwd_split, arm_inputs,
                                            ZOO_WIDTHS, criteo_ids,
                                            device_events, host_incl_ms,
                                            ptxas_report, table_grad_cases,
                                            table_grad_split, time_ms)
from armnet_tpu_torch.kernels.bounds import (bound, entmax_bound_ms,
                                             entmax_bwd_ops_per_element,
                                             fused_arm_bounds)
from armnet_tpu_torch.models import create_model, param_transform_for
from armnet_tpu_torch.ops.interaction import arm1h_interaction
from armnet_tpu_torch.ops.layers import BatchNorm
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from armnet_tpu_torch.train.loop import Trainer, run_epoch
from armnet_tpu_torch.train.step import clamp_grads, forward_loss, task_fns
from armnet_tpu_torch.utils import tracing
from armnet_tpu_torch.utils.config import (ExperimentConfig, build_arg_parser,
                                           compute_dtype)
from armnet_tpu_torch.utils.presets import PRESETS
from armnet_tpu_torch.utils.logging import get_logger, remove_logger

REPO = os.path.dirname(os.path.abspath(__file__))
CRITEO_SHAPE = (4096, 39, 128)
FRAPPE_SHAPE = (4096, 10, 128)
# the db_armnet1h step (batch 1024, 43 fields), and columns past the entmax
# forward's register buckets (its shared-memory route), cut in batch so
# that the plain versions stay quick
DIABETES_SHAPE = (1024, 43, 128)
LONG_SHAPES = ((256, 65, 128), (128, 100, 128), (32, 300, 128))
# the shapes where inner is small (the packed routes'): the last axis of
# mh_breakdown's gates [4096, 4, 64, 39] as its (outer, d, inner) view, and
# the multi-head presets' gates [B, F, C] (utils/presets.py: C = nattn_head
# x h, batch 4096 but db_armnet's 1024)
LAST_AXIS_VIEW = (4096 * 4 * 64, 39, 1)
CR_ARMNET_SHAPE, DB_ARMNET_SHAPE = (4096, 39, 256), (1024, 43, 32)
AV_ARMNET_SHAPE, AV_ARMNET_PLUS_SHAPE = (4096, 22, 32), (4096, 22, 64)
FRAPPE_ARMNET_PLUS_SHAPE, ML_ARMNET_PLUS_SHAPE = (4096, 10, 16), (4096, 3, 8)
PACKED_SHAPES = (LAST_AXIS_VIEW, DB_ARMNET_SHAPE, AV_ARMNET_SHAPE,
                 AV_ARMNET_PLUS_SHAPE, FRAPPE_ARMNET_PLUS_SHAPE,
                 ML_ARMNET_PLUS_SHAPE)
CRITEO_NFEAT = 2_100_000
ALPHAS = (1.5, 1.7, 2.0, 2.5)
SEED = 2025
TRAIN_BATCHES, EVAL_ROWS = 10, 6000      # synthetic Criteo train split
CPU_ROWS = 1024     # rows of a scoring batch that the CPU scores to compare
PLAIN_REPS = 5      # timings of a plain version (10-40 ms a call on the card)
# the JAX package's valid AUC after each epoch of phase_frappe_train's run,
# on the CPU: `JAX_PLATFORMS=cpu python train.py --model armnet_1h --alpha
# 2.0 --h 128 --lr 0.001 --batch_size 4096 --epoch 3 --patience 3 --seed
# 2025 --dataset frappe --data_dir data/` (jax 0.9.0; a rerun reads the
# same digits)
FRAPPE_JAX_VALID = (0.82166, 0.847645, 0.895021)
# the db_armnet1h preset, run on the bundled data/uci_diabetes/ split (43
# fields a row)
DIABETES_FLAGS = PRESETS["db_armnet1h"]
# the JAX package's seed-2025 init of the db_armnet1h model (.npz, leaf
# names of bridge.flatten_flax) and the valid AUC curves trained from it on
# the CPU (.json: the JAX package, the port from that init and from its
# own), written by `JAX_PLATFORMS=cpu python tests/preset_curves.py
# --preset db_armnet1h --epochs 15 --seeds 2025 --export-init data/parity`
PARITY = os.path.join(REPO, "data", "parity", f"db_armnet1h_{SEED}")
# the card's best valid AUC from that init against the JAX package's: the
# Frappe anchor's limit (PERF.md §2)
PARITY_BEST_ATOL = 0.003


# wall seconds by phase and by part of a phase, added up over the run
SECONDS = {}


def log(phase, **kw):
    print(f"{phase}: " + json.dumps(kw), flush=True)


@contextlib.contextmanager
def timed(name):
    """Adds the wall seconds of the block to SECONDS[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        SECONDS[name] = SECONDS.get(name, 0.0) + time.perf_counter() - t0


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("device", nvidia_smi=smi, torch=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch_version=torch.__version__,
        cuda=torch.version.cuda)
    print(smi, flush=True)
    return smi


def main_path_instantiations():
    """The kernel instantiations that the smoke's main paths launch (alpha
    2 at Criteo and Frappe, 1.7 at 43 fields for Diabetes130 and at 16
    for the UCI letter geometry; int32 ids), as ptxas_report names
    them."""
    names = {"sum_rows_kernel"}
    # (alpha, the entmax's d, K5's and K6's field bucket: 0 is the column
    # in shared memory)
    for alpha, fields, bucket in ((2.0, (39, 10), 40), (1.7, (43,), 0),
                                  (1.7, (UCI_FIELDS,), 40)):
        fwd, bwd = entmax_cuda.mode_id(alpha), entmax_cuda.g_mode_id(alpha)
        names |= {f"entmax_fwd_kernel<"
                  f"{entmax_cuda.route_for(d, 128, 4096, alpha)[1]},{fwd}>"
                  for d in fields}
        names.add(f"entmax_bwd_staged_kernel<{bwd}>")
        names.add(f"arm1h_fwd_kernel<40,{fwd}>" if bucket
                  else f"arm1h_fwd_col_kernel<{fwd}>")
        names.add(f"arm1h_bwd_kernel<{bucket},{fwd},{bwd},0>")
    # the packed routes: K1/K3 on the last axis of mh_breakdown's gates
    # (benchmarks), K2/K4 at the db_armnet step (diabetes_armnet)
    for alpha, (outer, d, inner) in ((2.0, LAST_AXIS_VIEW),
                                     (1.7, DB_ARMNET_SHAPE)):
        _, bucket, lanes = entmax_cuda.route_for(d, inner, outer, alpha)
        names.add(f"entmax_fwd_packed_kernel<{bucket},"
                  f"{entmax_cuda.mode_id(alpha)},{lanes}>")
        names.add(f"entmax_bwd_packed_kernel<{entmax_cuda.g_mode_id(alpha)}>")
    names |= {f"radix_{k}_kernel<int>" for k in ("count", "scatter")}
    return names | {"radix_scan_kernel", "zero_kernel", "segment_kernel",
                    "long_segment_kernel"}


def phase_build():
    t0 = time.perf_counter()
    secs = build.build_all()
    report = {n: ptxas_report(build.build_log(n)) for n in secs}
    main = main_path_instantiations()
    main_path = {k: v for r in report.values() for k, v in r.items()
                 if k in main}
    check(set(main_path) == main, f"ptxas reports no "
                                  f"{sorted(main - set(main_path))}")
    log("build", seconds=round(time.perf_counter() - t0, 3), per_source=secs,
        ptxas_main_path=main_path, ptxas=report)


def phase_kernel():
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # the serving shapes of the Criteo and Frappe phases (register buckets
    # 40 and 16), a 2-D last-axis case and a ragged one (packed), the
    # Diabetes130 step (bucket 48), columns past the buckets (shared) and
    # the packed routes' shapes
    cases = [(CRITEO_SHAPE, 1), (FRAPPE_SHAPE, 1), ((8192, 39), -1),
             ((7, 5, 13), 1), (DIABETES_SHAPE, 1),
             *((shape, 1) for shape in LONG_SHAPES + PACKED_SHAPES)]
    stats = {}
    for alpha in ALPHAS:
        tol = 5e-6 if alpha <= 2.0 else 1e-5
        errs = []
        for shape, axis in cases:
            x = torch.randn(shape, generator=g, device="cuda") * 3.0
            yk = entmax_cuda.entmax_kernel(x, alpha, axis)
            yp = entmax_cuda.entmax_plain(x, alpha, axis)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(yk).all()),
                  f"entmax kernel non-finite at alpha={alpha} {shape}")
            err = float((yk - yp).abs().max())
            rowsum = float((yk.sum(axis) - 1.0).abs().max())
            check(err <= tol, f"entmax kernel vs plain at alpha={alpha} "
                              f"{shape}: {err} > {tol}")
            check(rowsum <= 1e-5, f"entmax rows at alpha={alpha} {shape} "
                                  f"sum to 1 +- {rowsum}")
            errs.append(err)
        # a NaN makes its whole column NaN, as in the plain version
        x = torch.randn((7, 5, 13), generator=g, device="cuda")
        x[3, 2, 4] = float("nan")
        yk = entmax_cuda.entmax_kernel(x, alpha, 1)
        yp = entmax_cuda.entmax_plain(x, alpha, 1)
        check(bool(yk[3, :, 4].isnan().all()) and int(yk.isnan().sum()) == 5
              and torch.allclose(yk, yp, rtol=0, atol=tol, equal_nan=True),
              f"entmax kernel vs plain on a NaN column at alpha={alpha}")
        x = torch.randn(CRITEO_SHAPE, generator=g, device="cuda") * 3.0
        ms = time_ms(lambda: entmax_cuda.entmax_kernel(x, alpha, 1))
        incl_ms = host_incl_ms(lambda: entmax_cuda.entmax_kernel(x, alpha, 1))
        plain_ms = time_ms(lambda: entmax_cuda.entmax_plain(x, alpha, 1),
                           PLAIN_REPS, 1)
        xf = torch.randn(FRAPPE_SHAPE, generator=g, device="cuda") * 3.0
        frappe_ms = time_ms(lambda: entmax_cuda.entmax_kernel(xf, alpha, 1))
        bound, by = entmax_bound_ms(CRITEO_SHAPE, alpha)
        more = {}
        for name, shape in (("diabetes", DIABETES_SHAPE),
                            ("d100", LONG_SHAPES[1])):
            xs = torch.randn(shape, generator=g, device="cuda") * 3.0
            more[name] = {
                "shape": list(shape),
                "route": entmax_cuda.route_for(shape[1], shape[2], shape[0],
                                               alpha),
                "ms": time_ms(lambda: entmax_cuda.entmax_kernel(xs, alpha,
                                                                1)),
                "plain_ms": time_ms(lambda: entmax_cuda.entmax_plain(
                    xs, alpha, 1), PLAIN_REPS, 1),
                "bound_ms": entmax_bound_ms(shape, alpha)[0]}
        stats[alpha] = {"ms": ms, "host_incl_ms": incl_ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "max_abs_err": max(errs),
                        "frappe_ms": frappe_ms, **more}
        log("kernel", name="entmax_fwd", alpha=alpha,
            shape=list(CRITEO_SHAPE), axis=1,
            route=entmax_cuda.route_for(39, 128, 4096, alpha), ms=ms,
            host_incl_ms=incl_ms, plain_ms=plain_ms, bound_us=bound * 1e3,
            bound_by=by, frappe_shape=list(FRAPPE_SHAPE),
            frappe_route=entmax_cuda.route_for(10, 128, 4096, alpha),
            frappe_ms=frappe_ms,
            frappe_bound_us=entmax_bound_ms(FRAPPE_SHAPE, alpha)[0] * 1e3,
            **more, checked_shapes=[list(c[0]) for c in cases],
            max_abs_err=max(errs), tol=tol,
            library="none: no single PyTorch call computes entmax")
    return stats


def phase_kernel_bwd():
    """The entmax backward kernel against its plain version, y from the
    forward kernel, at the forward phase's shapes and alphas (d 3-300, the
    small-inner shapes among them), its device time at the Criteo, Frappe
    and Diabetes130 steps and at d 100 beside the bound and the plain
    version, with its route, registers, spills and blocks per SM."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [(CRITEO_SHAPE, 1), (FRAPPE_SHAPE, 1), ((8192, 39), -1),
             ((7, 5, 13), 1), (DIABETES_SHAPE, 1),
             *((shape, 1) for shape in LONG_SHAPES + PACKED_SHAPES)]
    ptxas = {k: v for k, v in ptxas_report(build.build_log(
        "entmax_bwd")).items() if k.startswith("entmax_bwd")}
    tol = 2e-5
    stats = {}
    for alpha in ALPHAS:
        errs = []
        for shape, axis in cases:
            y = entmax_cuda.entmax_kernel(
                torch.randn(shape, generator=g, device="cuda") * 3.0, alpha,
                axis)
            dy = torch.randn(shape, generator=g, device="cuda")
            dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, axis)
            dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, axis)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(dk).all()),
                  f"entmax_bwd kernel non-finite at alpha={alpha} {shape}")
            err = float((dk - dp).abs().max())
            if alpha > 2.0 and shape in PACKED_SHAPES:
                # g = y^(2 - alpha) is unbounded as y -> 0 and dx = dy*g -
                # q*g cancels: past alpha 2 two float32 dx differ by more
                # than tol on large draws, so a small-inner shape's dx is
                # held to the float64 VJP within KERNELS_VS_PLAIN_RTOL of
                # its norm
                d64 = entmax_cuda.entmax_bwd_plain(y.double(), dy.double(),
                                                   alpha, axis)
                check(within(dk.double() - d64, d64, KERNELS_VS_PLAIN_RTOL,
                             0.0),
                      f"entmax_bwd kernel vs the float64 VJP at alpha="
                      f"{alpha} {shape}: not within {KERNELS_VS_PLAIN_RTOL} "
                      f"of its norm")
            else:
                check(err <= tol, f"entmax_bwd kernel vs plain at alpha="
                                  f"{alpha} {shape}: {err} > {tol}")
            errs.append(err)
        # a NaN column of y gives a NaN column of dx, as in the plain version
        x = torch.randn((7, 5, 13), generator=g, device="cuda")
        x[3, 2, 4] = float("nan")
        y = entmax_cuda.entmax_kernel(x, alpha, 1)
        dy = torch.randn((7, 5, 13), generator=g, device="cuda")
        dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)
        dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1)
        check(bool(dk[3, :, 4].isnan().all()) and int(dk.isnan().sum()) == 5
              and torch.allclose(dk, dp, rtol=0, atol=tol, equal_nan=True),
              f"entmax_bwd kernel vs plain on a NaN column at alpha={alpha}")
        timed_at = {}
        for name, shape in (("criteo", CRITEO_SHAPE), ("frappe", FRAPPE_SHAPE),
                            ("diabetes", DIABETES_SHAPE),
                            ("d100", LONG_SHAPES[1])):
            y = entmax_cuda.entmax_kernel(
                torch.randn(shape, generator=g, device="cuda") * 3.0,
                alpha, 1)
            dy = torch.randn(shape, generator=g, device="cuda")
            numel = math.prod(shape)
            bound_ms, by = bound(3 * 4 * numel,
                                 entmax_bwd_ops_per_element(alpha) * numel)
            timed_at[name] = {
                "shape": list(shape),
                "ms": time_ms(lambda: entmax_cuda.entmax_bwd_kernel(
                    y, dy, alpha, 1)),
                "host_incl_ms": host_incl_ms(
                    lambda: entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)),
                "plain_ms": time_ms(lambda: entmax_cuda.entmax_bwd_plain(
                    y, dy, alpha, 1), PLAIN_REPS, 1),
                "bound_ms": bound_ms, "bound_by": by,
                "route": entmax_cuda.bwd_route_for(shape[1], shape[2]),
                "blocks_per_sm": entmax_cuda.bwd_blocks_per_sm(
                    shape[1], alpha, shape[2])}
        crit = timed_at.pop("criteo")
        stats[alpha] = {**crit, "max_abs_err": max(errs), **timed_at}
        log("kernel", name="entmax_bwd", alpha=alpha, axis=1, **crit,
            **timed_at, ptxas=ptxas,
            checked_shapes=[list(c[0]) for c in cases],
            max_abs_err=max(errs), tol=tol,
            library="none: no single PyTorch call computes the entmax VJP")
    return stats


def criteo_rows(rows, nfeat, nfield, seed):
    """Seeded synthetic rows at Criteo geometry: 13 numeric fields with 100
    id buckets each and real values in (0, 1], 26 categorical fields that
    share the rest of the nfeat ids with value 1; ~25% positive labels.
    Returns (ids [rows, nfield] int64, values, labels)."""
    rng = np.random.RandomState(seed)
    n_num = 13
    ids = criteo_ids(rows, nfeat, nfield, rng)
    values = np.ones((rows, nfield))
    values[:, :n_num] = np.round(rng.uniform(1e-3, 1.0, (rows, n_num)), 6)
    labels = (rng.rand(rows) < 0.25).astype(int)
    return ids, values, labels


def write_criteo_libsvm(path, rows, nfeat, nfield, seed):
    """criteo_rows written as a libsvm file."""
    ids, values, labels = criteo_rows(rows, nfeat, nfield, seed)
    line = "%d " + " ".join(["%d:%g"] * nfield) + "\n"
    pairs = np.empty((rows, 2 * nfield), dtype=object)
    pairs[:, 0::2], pairs[:, 1::2] = ids, values
    with open(path, "w") as f:
        f.writelines(line % (labels[r], *pairs[r]) for r in range(rows))


# the UCI-121 `letter` dataset's geometry: 20,000 rows of 16 numeric
# columns and a 26-value nominal class, split 10,000 / 10,000 by its
# conxuntos.dat (the collection is fetched over the network, so the smoke
# writes a seeded stand-in: write_uci_letter)
UCI_ROWS, UCI_FIELDS, UCI_CLASSES = 20_000, 16, 26
UCI_BATCH, UCI_NFEAT = 512, 5500     # --batch_size 512; the CLI's nfeat
UCI_ARM = (UCI_BATCH, UCI_FIELDS, 10, 10, 128)     # armnet_1h's K5/K6 step


def write_uci_letter(root, seed=SEED):
    """{root}/letter/letter.arff and conxuntos.dat at the letter geometry,
    from numpy seeded `seed`: a class signal planted in the column means
    (a unit-normal centre per class and column, unit noise), then each
    column scaled and shifted (the Standardizer takes those out). Returns
    the dataset folder."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, UCI_CLASSES, UCI_ROWS)
    centers = rng.randn(UCI_CLASSES, UCI_FIELDS)
    x = centers[y] + rng.randn(UCI_ROWS, UCI_FIELDS)
    x = x * rng.uniform(0.5, 8.0, UCI_FIELDS) + rng.uniform(-5, 10,
                                                             UCI_FIELDS)
    folder = os.path.join(root, "letter")
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "letter.arff"), "w") as f:
        f.write("@relation letter\n")
        f.writelines(f"@attribute f{j} numeric\n" for j in range(UCI_FIELDS))
        f.write("@attribute clase {" + ",".join(map(str, range(UCI_CLASSES)))
                + "}\n@data\n")
        f.writelines(",".join(f"{v:.4f}" for v in row) + f",{label}\n"
                     for row, label in zip(x, y))
    order = rng.permutation(UCI_ROWS)
    with open(os.path.join(folder, "conxuntos.dat"), "w") as f:
        for part in (order[:UCI_ROWS // 2], order[UCI_ROWS // 2:]):
            f.write(" ".join(map(str, part)) + "\n")
    return folder


def phase_kernel_table_grad():
    """The table-gradient kernels against their plain version (index_add_)
    and against themselves (bitwise), on the train step's shapes: g
    [4096*39, 10] and nrows 2.1M, and on the Criteo batch's ids at the
    zoo's widths (bench.ZOO_WIDTHS: FeaturesLinear's E = 1, HOFM's E =
    20), and on the UCI step's ids (16 live rows of 5,500, 512 updates
    each). The plain version runs on a CPU copy of
    the inputs, where index_add_ adds in the kernel's order: where no row
    has more than scatter_cuda.CHUNK updates (which the kernel sums whole,
    in that order) the result is held at rtol 1e-5, atol 1e-6; where one
    has more (the Zipf cases, all ids equal; the kernel adds its pieces'
    sums in order) at 1e-6 + 1e-5 * sum|g| over the row's updates, a bound
    on any reordering of the sum. On the card index_add_'s atomics add in
    no fixed order, so there every case is held to that bound. The radix
    sort is held to a stable torch.sort (the same keys and permutation).
    Timed on bench.table_grad_cases (a Criteo batch with ids uniform
    within each field, the same Zipf-skewed, all ids equal) and on the
    Criteo batch at E = 1 and 20 and the UCI step: the whole
    call, its kernels' device time split into the sort (the key prep
    folded into its first pass) and the zero fill with the segmented sums,
    the PyTorch route it replaced (elementwise prep, stable torch.sort)
    and zeros + index_add_, one PyTorch call for the same sums."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    nrows = CRITEO_NFEAT
    timed_cases = table_grad_cases()
    crit = timed_cases["criteo_batch"]
    n = crit.numel()
    cases = {name: (ids, nrows, 10) for name, ids in timed_cases.items()}
    for e in ZOO_WIDTHS:
        cases[f"criteo_batch_e{e}"] = (crit, nrows, e)
    # the UCI step: every row's ids are its 16 column indices, so 512 rows
    # put 16 segments of 512 into the 5,500-row default table
    cases["uci_16_live"] = (torch.arange(
        UCI_FIELDS, dtype=torch.int32, device="cuda").repeat(UCI_BATCH),
        UCI_NFEAT, 10)
    timed_names = set(cases)
    cases["criteo_batch_int64"] = (crit.long(), nrows, 10)
    cases["wrapped_and_dropped"] = (torch.randint(
        -2 * nrows, 2 * nrows, (n,), generator=g, device="cuda",
        dtype=torch.int32), nrows, 10)
    cases["ragged_small"] = (torch.randint(
        0, 3001, (37,), generator=g, device="cuda", dtype=torch.int32), 3001,
        10)
    errs, card_errs, out = [], [], {}
    for name, (ids, rows, e) in cases.items():
        gr = torch.randn((ids.shape[0], e), generator=g, device="cuda")
        got = scatter_cuda.table_grad(gr, ids, rows)
        again = scatter_cuda.table_grad(gr, ids, rows)
        sid, perm = scatter_cuda.sort_ids(ids, rows)
        want_sid, want_perm = scatter_cuda.sort_ids_plain(ids, rows)
        want = scatter_cuda.table_grad_plain(gr.cpu(), ids.cpu(), rows)
        card = scatter_cuda.table_grad_plain(gr, ids, rows)
        spread = scatter_cuda.table_grad_plain(gr.abs(), ids, rows)
        torch.cuda.synchronize()
        keys = scatter_cuda.keys_plain(ids, rows)
        longest = int(torch.bincount(keys[keys < rows]).max())
        got_cpu = got.cpu()
        err = float((got_cpu - want).abs().max())
        card_err = float((got - card).abs().max())
        if longest <= scatter_cuda.CHUNK:
            check(torch.allclose(got_cpu, want, rtol=1e-5, atol=1e-6),
                  f"table_grad kernel vs plain on {name}: max abs err {err}")
        else:
            check(bool(((got_cpu - want).abs()
                        <= 1e-6 + 1e-5 * spread.cpu()).all()),
                  f"table_grad kernel vs plain on {name} (a row of "
                  f"{longest} updates): max abs err {err}")
        check(bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all()),
              f"table_grad kernel vs index_add_ on the card on {name}: "
              f"max abs err {card_err}")
        check(torch.equal(got, again),
              f"table_grad kernel not bitwise deterministic on {name}")
        check(torch.equal(sid, want_sid) and torch.equal(perm, want_perm),
              f"radix sort vs stable torch.sort on {name}")
        errs.append(err)
        card_errs.append(card_err)
        record = dict(case=name, n=int(ids.shape[0]), ids=str(ids.dtype),
                      e=e, nrows=rows, longest_row=longest,
                      max_abs_err_cpu_plain=err,
                      max_abs_err_card_plain=card_err)
        if name in timed_names:
            with timed("table_grad.timing"):
                times = table_grad_split(gr, ids, rows)
            plain_ms = time_ms(lambda: scatter_cuda.table_grad_plain(
                gr, ids, rows))
            # each input read once (g f32, ids), the dense output written
            # once; one add per update element
            bound_ms, by = bound(4 * rows * e + 4 * gr.numel()
                                 + ids.element_size() * ids.numel(),
                                 gr.numel())
            out[name] = {**times, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": by}
            record.update(times, plain_ms=plain_ms,
                          prep="folded into the radix sort's first pass",
                          library="torch.zeros(nrows, E).index_add_(0, ids, "
                                  "g)",
                          bound_us=bound_ms * 1e3, bound_by=by)
        log("kernel", name="table_grad", **record,
            tol="rtol 1e-5, atol 1e-6 vs the CPU plain version (1e-6 + "
                "1e-5 * sum|g| where a row has more than CHUNK updates); "
                "1e-6 + 1e-5 * sum|g| vs index_add_ on the card; bitwise "
                "equal to itself")
    out["max_abs_err"] = max(errs)
    out["max_abs_err_vs_index_add_on_card"] = max(card_errs)
    return out


def phase_kernel_arm():
    """K5 and K6 against their plain versions on the card at the Criteo and
    Frappe steps, a ragged batch, one row, more neurons than a block's 128
    threads (O 200), a part of a block (O 96), F at the register bucket's
    edge (16, 17), fewer rows than K6's grid, and embeddings wider than
    K6's 16-wide register sums (Frappe at nemb 100 with h 10, Criteo's
    fields at nemb 40), and past the 40-field register bucket (the columns
    in shared memory): F 41, 64 and 128 at the cr_armnet1h widths, the
    Diabetes130 step (B 1024, F 43) and the wide build at 43 fields, at
    four alphas: the forward within rtol/atol 2e-5, the four gradients
    within rtol 5e-4, atol 5e-5 (the JAX package's tolerances for its fused
    kernel, tests/test_arm_pallas.py), and K6 equal to itself bit for bit.
    Times at the Criteo and Diabetes130 steps and, at alpha 1.7, the UCI
    armnet_1h step (B 512, F 16): kernel, plain version and
    the composed path of --kernels auto (GEMMs, the entmax kernel, einsum
    and exp, and its autograd backward), which is the yardstick: no single
    PyTorch call computes this function."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [CRITEO_ARM, FRAPPE_ARM, (4095, 39, 10, 10, 128),
             (1, 39, 10, 10, 128), (512, 39, 10, 10, 200),
             (512, 39, 10, 10, 96), (512, 16, 10, 10, 128),
             (512, 17, 10, 10, 128), (100, 39, 10, 10, 128),
             FRAPPE_NEMB100_ARM, (512, 39, 40, 40, 128),
             (256, 41, 10, 10, 128), DIABETES_ARM, (256, 64, 10, 10, 128),
             (128, 128, 10, 10, 128), (64, 43, 33, 20, 130)]
    stats = {}
    for alpha in ALPHAS:
        ferrs, berrs = [], []
        for shape in cases:
            emb, wk, q, vt, dout = arm_inputs(g, shape)
            out = arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha)
            want = arm_cuda.arm1h_fwd_plain(emb, wk, q, vt, alpha)
            grads = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
            again = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
            gwant = arm_cuda.arm1h_bwd_plain(emb, wk, q, vt, dout, alpha)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"arm1h_fwd kernel non-finite at alpha={alpha} {shape}")
            ferrs.append(float((out - want).abs().max()))
            check(torch.allclose(out, want, rtol=2e-5, atol=2e-5),
                  f"arm1h_fwd kernel vs plain at alpha={alpha} {shape}: "
                  f"max abs err {ferrs[-1]}")
            for name, a, b, c in zip(("de", "dwk", "dq", "dvt"), grads,
                                     again, gwant):
                berrs.append(float((a - c).abs().max()))
                check(torch.allclose(a, c, rtol=5e-4, atol=5e-5),
                      f"arm1h_bwd kernel {name} vs plain at alpha={alpha} "
                      f"{shape}: max abs err {berrs[-1]}")
                check(torch.equal(a, b), f"arm1h_bwd kernel {name} not "
                                         f"bitwise deterministic at "
                                         f"alpha={alpha} {shape}")
        steps = [("criteo", CRITEO_ARM), ("diabetes", DIABETES_ARM)]
        if alpha == 1.7:
            steps.append(("uci", UCI_ARM))
        for step, shape in steps:
            stats.update(arm_step_times(g, step, shape, alpha, ferrs, berrs))
    return stats


def arm_step_times(g, step, shape, alpha, ferrs, berrs):
    """{(kind, alpha) or (kind, alpha, step): record} of K5 and K6 at one
    step's shape: kernel, host-inclusive, plain and composed times, the
    bound, blocks per SM and K6's grid, and at the Criteo step K6's split
    by torch.profiler; logged as kernel_arm lines. The Criteo step's
    records take the plain keys."""
    rows, f, e, dk, o = shape
    stats = {}
    emb, wk, q, vt, dout = arm_inputs(g, shape)
    leaves = [t.clone().requires_grad_() for t in (emb, wk, q, vt)]
    composed = arm1h_interaction(leaves[0], leaves[1], leaves[2],
                                 leaves[3].t(), alpha)
    times = {
        "fwd": (lambda: arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha),
                lambda: arm_cuda.arm1h_fwd_plain(emb, wk, q, vt, alpha),
                lambda: arm1h_interaction(emb, wk, q, vt.t(), alpha)),
        "bwd": (lambda: arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout,
                                                  alpha),
                lambda: arm_cuda.arm1h_bwd_plain(emb, wk, q, vt, dout,
                                                 alpha),
                lambda: torch.autograd.grad(composed, leaves, dout,
                                            retain_graph=True))}
    bounds = fused_arm_bounds(shape, alpha)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = arm_cuda.bwd_grid(rows, f, e, dk, o, alpha, emb.device)
    launch = {"fwd": {"blocks_per_sm": arm_cuda.fwd_blocks_per_sm(
                  f, e, dk, o, alpha)},
              "bwd": {"blocks_per_sm": arm_cuda.bwd_blocks_per_sm(
                  f, e, dk, o, alpha), "grid": grid,
                  "grid_blocks_per_sm": grid / sms}}
    if step == "criteo":
        launch["bwd"].update(arm_bwd_split(emb, wk, q, vt, dout, alpha))
    for kind, errs in (("fwd", ferrs), ("bwd", berrs)):
        kernel, plain, comp = times[kind]
        ms, plain_ms, composed_ms = (time_ms(kernel),
                                     time_ms(plain, PLAIN_REPS, 1),
                                     time_ms(comp))
        incl_ms = host_incl_ms(kernel)
        bound_ms, by, nbytes, nops = bounds[kind]
        key = (kind, alpha) if step == "criteo" else (kind, alpha, step)
        stats[key] = {
            "ms": ms, "host_incl_ms": incl_ms, "plain_ms": plain_ms,
            "composed_ms": composed_ms, "bound_ms": bound_ms,
            "bound_by": by, "max_abs_err": max(errs), **launch[kind]}
        log("kernel_arm", name=f"arm1h_{kind}", alpha=alpha, step=step,
            shape=dict(zip("BFEDO", shape)), ms=ms,
            host_incl_ms=incl_ms, plain_ms=plain_ms, composed_ms=composed_ms,
            bound_us=bound_ms * 1e3, bound_by=by, bytes=nbytes,
            f32_instruction_slots=nops, max_abs_err=max(errs),
            **launch[kind],
            tol="rtol/atol 2e-5" if kind == "fwd" else
                "rtol 5e-4, atol 5e-5; bitwise equal to itself",
            library="none: no single PyTorch call computes the fused "
                    "ARM-1h interaction; composed_ms is the port's "
                    "--kernels auto path on the card")
    del composed, leaves
    return stats


def run_predict(ckpt, inp, out, expect_rows, kernel="entmax_fwd",
                cin_layers=0):
    """predict.main on the card with the kernel counts set to 0 just before
    and read just after; checks rows, finite scores and launches: `kernel`
    once per batch (entmax_fwd under auto, arm1h_fwd under pallas-fused,
    which predict restores from the checkpoint's sidecar), and K8's
    forward `cin_layers` times per batch (cin and xdfm), no other; none but
    K8's where `kernel` is None (a model without entmax)."""
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()), timed("predict"):
        summary = predict.main(["--ckpt", ckpt, "--input", inp, "--output",
                                out, "--device", "cuda"])
    counts = read_counts()
    scores = np.loadtxt(out, ndmin=1)
    check(summary["rows"] == expect_rows == scores.shape[0],
          f"predict scored {summary['rows']} rows ({scores.shape[0]} "
          f"written), expected {expect_rows}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    want = dict.fromkeys(counts, 0)
    if kernel is not None:
        want[kernel] = summary["batches"]
    want["cin_fwd"] = summary["batches"] * cin_layers
    check(counts == want, f"predict launched {counts} over "
                          f"{summary['batches']} batches, expected {want}")
    return summary, counts[kernel] if kernel is not None else 0


def preset_flags(name, kernels="auto", *more):
    """A preset's flags (armnet_tpu_torch/utils/presets.py) under
    `kernels`, at its batch size (4096 where it names none), then `more`
    (a later flag wins)."""
    return ["--batch_size", "4096", *PRESETS[name], "--kernels", kernels,
            *more]


def flags_config(flags):
    """The ExperimentConfig that `flags` give on the card, seeded SEED."""
    return ExperimentConfig(**vars(build_arg_parser().parse_args(
        [*flags, "--seed", str(SEED), "--device", "cuda"])))


def criteo_flags(ensemble, kernels="auto"):
    """The cr_armnet1h preset's flags, cr_armnet1h+ when the ensemble is
    on (the same widths and a 2x500 tower); lr 0.001 for both."""
    return preset_flags("cr_armnet1h+" if ensemble else "cr_armnet1h",
                        kernels, "--lr", "0.001")


def criteo_config(ensemble, kernels="auto"):
    """The config of criteo_flags on the card."""
    return flags_config(criteo_flags(ensemble, kernels))


def first_batch_logits(ckpt, cfg, inp, device, rows=None):
    """The checkpoint's logits of the file's first batch (its first `rows`
    rows if given) on `device`, on the CPU."""
    first = next(iter(BatchIterator(LibsvmDataset(inp, cfg.nfield),
                                    cfg.batch_size)))
    with torch.inference_mode(), timed(f"logits_{device}"):
        return predict.load_model(ckpt, "best", cfg, device)(
            {k: v[:rows].to(device) for k, v in first.items()}).cpu()


def first_batch_logit_err(ckpt, cfg, inp):
    """Scores the file's first batch from the checkpoint on the card, and
    its first CPU_ROWS rows on the CPU (the plain versions); fails unless
    those rows' logits agree within rtol 1e-4, atol 1e-5. Scoring is row by
    row (BatchNorm takes its running statistics), so a row's logit does not
    depend on the rest of its batch. Returns the max abs difference."""
    lg = first_batch_logits(ckpt, cfg, inp, "cuda")
    check(bool(torch.isfinite(lg).all()), "non-finite GPU logits")
    lg = lg[:CPU_ROWS]
    lc = first_batch_logits(ckpt, cfg, inp, "cpu", CPU_ROWS)
    err = float((lg - lc).abs().max())
    check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
          f"GPU vs CPU logits of the first batch differ by {err}")
    return err


def phase_serve_criteo(tmp):
    rows = 10_000
    inp = os.path.join(tmp, "criteo_synth.libsvm")
    with timed("write_libsvm"):
        write_criteo_libsvm(inp, rows, CRITEO_NFEAT, 39, SEED)
    launches_total = 0
    for ensemble in (False, True):
        cfg = criteo_config(ensemble)
        ckpt = os.path.join(tmp, f"ckpt_criteo_ens{int(ensemble)}")
        save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
        out = os.path.join(tmp, f"criteo_ens{int(ensemble)}.scores")
        runs = []
        for _ in range(4):              # the first call includes warm-up
            runs.append(run_predict(ckpt, inp, out, rows))
            launches_total += runs[-1][1]
        err = first_batch_logit_err(ckpt, cfg, inp)
        for i, (s, launches) in enumerate(runs):
            log("serve", width="cr_armnet1h", ensemble=ensemble,
                call="cold" if i == 0 else "warm", rows=s["rows"],
                batches=s["batches"], launches=launches,
                rows_per_s=s["rows"] / s["score_seconds"],
                ms_per_batch=s["score_seconds"] / s["batches"] * 1e3,
                auc=s.get("auc"), gpu_vs_cpu_logit_err=err)
    return inp, launches_total


def phase_serve_fused(tmp, inp):
    """predict at Criteo width, ensemble off, from a checkpoint whose
    sidecar says --kernels pallas-fused: one K5 launch per batch and no
    entmax launch; the first batch's logits against the CPU's (plain fused
    versions) and against the auto path's on the card, both within rtol
    1e-4, atol 1e-5."""
    cfg = criteo_config(False, "pallas-fused")
    ckpt = os.path.join(tmp, "ckpt_criteo_fused")
    save_checkpoint(create_model(cfg, seed=SEED, kernels=cfg.kernels), cfg,
                    ckpt, "best")
    out = os.path.join(tmp, "criteo_fused.scores")
    runs = [run_predict(ckpt, inp, out, 10_000, "arm1h_fwd")
            for _ in range(4)]              # the first call includes warm-up
    err = first_batch_logit_err(ckpt, cfg, inp)
    lf = first_batch_logits(ckpt, cfg, inp, "cuda")
    la = first_batch_logits(ckpt, cfg.replace(kernels="auto"), inp, "cuda")
    auto_err = float((lf - la).abs().max())
    check(torch.allclose(lf, la, rtol=1e-4, atol=1e-5),
          f"pallas-fused vs auto logits on the card differ by {auto_err}")
    for i, (s, launches) in enumerate(runs):
        log("serve_fused", width="cr_armnet1h", ensemble=False,
            kernels="pallas-fused", call="cold" if i == 0 else "warm",
            rows=s["rows"], batches=s["batches"], arm1h_fwd_launches=launches,
            rows_per_s=s["rows"] / s["score_seconds"],
            ms_per_batch=s["score_seconds"] / s["batches"] * 1e3,
            auc=s.get("auc"), gpu_vs_cpu_logit_err=err,
            fused_vs_auto_logit_err=auto_err)
    return sum(launches for _, launches in runs)


def phase_serve_frappe(tmp):
    cfg = ExperimentConfig(model="armnet_1h", nfeat=5500, nfield=10, nemb=10,
                           h=128, alpha=2.0, batch_size=4096, seed=SEED)
    ckpt = os.path.join(tmp, "ckpt_frappe")
    save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
    inp = os.path.join(REPO, "data", "frappe", "test.libsvm")
    summary, launches = run_predict(ckpt, inp,
                                    os.path.join(tmp, "frappe.scores"), 14430)
    err = first_batch_logit_err(ckpt, cfg, inp)
    log("frappe", rows=summary["rows"], batches=summary["batches"],
        launches=launches, auc=summary.get("auc"),
        rows_per_s=summary["rows"] / summary["score_seconds"],
        gpu_vs_cpu_logit_err=err)
    return launches


def phase_profile(inp):
    """torch.profiler over one warm scoring pass of the Criteo-width model
    (ensemble off): device time by kernel and the device's busy share of
    the pass's wall time."""
    from torch.profiler import ProfilerActivity

    cfg = criteo_config(False)
    model = create_model(cfg, seed=SEED).to("cuda").eval()
    loader = BatchIterator(LibsvmDataset(inp, 39), 4096)

    def scoring_pass():
        t0 = time.perf_counter()
        predict.score(model, loader, "cuda")
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    scoring_pass()
    # device-side events only (kernels, copies): an aten op's own event
    # carries its kernels' time too and would count it twice
    events, wall_ms = device_events(
        scoring_pass, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    busy_ms = (sum(e.self_device_time_total for e in events) / 1e3
               if events else None)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    log("profile", batches=len(loader), wall_ms=wall_ms, device_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms if events else None,
        top=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
             for e in top])


def run_cli(argv):
    """train.cli.main with the counts set to 0 just before and read just
    after; its log lines go to the run's stdout.log only."""
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        results = cli.main(argv)
    torch.cuda.synchronize()
    return results, read_counts(), time.perf_counter() - t0


def train_losses(log_path):
    """(train-step losses per epoch, mean train loss per epoch) from a run's
    stdout.log written with --report_freq 1."""
    steps, means, in_train = [], [], False
    with open(log_path) as f:
        for line in f:
            msg = line.rstrip("\n").split(" ", 1)[1]
            if msg.startswith("Epoch [") and "][" not in msg:
                steps.append([])
                in_train = True
            elif in_train and msg.startswith("Epoch ["):
                steps[-1].append(float(msg.split("Loss")[1].split("(")[0]))
            elif msg.startswith("train\t"):
                means.append(float(msg.split("Loss")[1]))
                in_train = False
    return steps, means


@torch.no_grad()
def entmax_support(model, batch, rows=None):
    """The entmax support y > 0 of the batch's ARM gates (of its first
    `rows` rows if given: a row's gates depend on that row alone), on the
    CPU: [B, F, O] for armnet_1h, by the same ops as
    ops/interaction.arm1h_interaction; [B, F, K*O] for armnet and gc_arm,
    where their attention layer's output (the entmax weights times
    values) is not 0. None for a model without entmax."""
    from armnet_tpu_torch.models.armnet import ARMNet
    from armnet_tpu_torch.models.armnet_1h import ARMNet1H
    from armnet_tpu_torch.models.common import VALUE_CLAMP
    from armnet_tpu_torch.models.gc_arm import GCARM
    from armnet_tpu_torch.ops.entmax import entmax_bisect
    from armnet_tpu_torch.ops.layers import promoted

    if not isinstance(model, (ARMNet1H, ARMNet, GCARM)):
        return None
    emb = model.embedding(batch["id"][:rows],
                          batch["value"][:rows].clamp(*VALUE_CLAMP))
    if isinstance(model, ARMNet):
        return (model.attn_layer(emb) != 0).cpu()
    if isinstance(model, GCARM):
        return (model.attn_layers(emb) != 0).cpu()
    a = model.attn_layer
    keys = torch.matmul(emb, a.bilinear_w.to(emb.dtype))
    gates = torch.matmul(*promoted(keys, a.query.t())) * (
        a.query.shape[-1] ** -0.5)
    return (entmax_bisect(gates, a.alpha, axis=1) > 0).cpu()


def u_kappa(inputs, model):
    """u * kappa over the inputs ({name: tensor}, bn_tap) of the model's
    BatchNorms over channel axis 1: kappa is the largest |mean| / std over
    an input's channels (axis 1). One f32 rounding (u = 2^-24) of that
    input is u * kappa of the spread the BatchNorm divides by, and every
    gradient above and below inherits that relative error; for arm_bn the
    input is the exponential neurons exp(z). 0 without such a
    BatchNorm."""
    from armnet_tpu_torch.ops.layers import BatchNorm

    def kappa(x):
        x = x.float().movedim(1, 0).reshape(x.shape[1], -1)
        return float((x.mean(1).abs() / x.std(1)).max())
    axis1 = {n for n, m in model.named_modules()
             if isinstance(m, BatchNorm) and m.channel_axis == 1}
    return max((kappa(x) for n, x in inputs.items() if n in axis1),
               default=0.0) * 2.0 ** -24


def pinned_norms(model):
    """Names of the model's BatchNorms whose outputs a pinned CPU step takes
    from the card (gpu_vs_cpu_step): those over channel axis 1 (arm_bn,
    emb_bn, afn_bn), where one magnified rounding of the input moves the
    ReLUs below across 0 (ROADMAP.md §3), and GCN's MLP BatchNorms, which
    do the same: its graph convolutions over the all-ones adjacency give
    the MLP fields of one value, and unpinned, gcn_0.bias
    read 2.4e-4 from the CPU at rtol 1e-4 on an H100 after 2 Frappe
    epochs, the plain versions on the card the same gap."""
    from armnet_tpu_torch.models.gcn import GCN
    from armnet_tpu_torch.ops.layers import BatchNorm

    return {n for n, m in model.named_modules()
            if isinstance(m, BatchNorm)
            and (m.channel_axis == 1 or isinstance(model, GCN))}


@contextlib.contextmanager
def bn_tap(model, inputs, outputs=None, pin=None):
    """While active, the input of each of the model's BatchNorms goes to
    inputs[name] (on the CPU) in a forward, and its output to
    outputs[name] where `outputs` is given; with `pin` ({name: tensor})
    the output of each BatchNorm named there takes pin[name]'s values
    while its gradient still flows through the BatchNorm, so that what
    lies below the BatchNorm sees the values of another run."""
    from armnet_tpu_torch.ops.layers import BatchNorm

    def tap(name):
        def pre(module, args):
            inputs[name] = args[0].detach().cpu()

        def post(module, args, out):
            if outputs is not None:
                outputs[name] = out.detach().cpu()
            if pin is not None and name in pin:
                return out + (pin[name].to(out.device) - out).detach()
        return pre, post

    hooks = []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            pre, post = tap(name)
            hooks += [m.register_forward_pre_hook(pre),
                      m.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


# each kernel wrapper: (module, wrapper's name, plain version's name, the
# name of its launches: read_counts', or bn_cuda's wrapper for K9)
KERNEL_WRAPPERS = (
    (entmax_cuda, "entmax_kernel", "entmax_plain", "entmax_fwd"),
    (entmax_cuda, "entmax_bwd_kernel", "entmax_bwd_plain", "entmax_bwd"),
    (scatter_cuda, "table_grad", "table_grad_plain", "table_grad"),
    (arm_cuda, "arm1h_fwd_kernel", "arm1h_fwd_plain", "arm1h_fwd"),
    (arm_cuda, "arm1h_bwd_kernel", "arm1h_bwd_plain", "arm1h_bwd"),
    (cin_cuda, "cin_fwd", "cin_fwd_plain", "cin_fwd"),
    (cin_cuda, "cin_bwd", "cin_bwd_plain", "cin_bwd"),
    (bn_cuda, "bn_fwd", "bn_fwd_plain", "bn_fwd"),
    (bn_cuda, "bn_bwd", "bn_bwd_plain", "bn_bwd"))


@contextlib.contextmanager
def swapped_kernels(make):
    """While active, each kernel wrapper is make(name, kernel, plain): the
    ops look the wrappers up at every call."""
    saved = [getattr(mod, attr) for mod, attr, _, _ in KERNEL_WRAPPERS]
    for (mod, attr, plain, name), kernel in zip(KERNEL_WRAPPERS, saved):
        setattr(mod, attr, make(name, kernel, getattr(mod, plain)))
    try:
        yield
    finally:
        for (mod, attr, _, _), kernel in zip(KERNEL_WRAPPERS, saved):
            setattr(mod, attr, kernel)


def plain_versions_on_card():
    """While active, CUDA tensors take the plain PyTorch versions instead of
    the kernels (no kernel launches)."""
    return swapped_kernels(lambda name, kernel, plain: plain)


def one_step_grads(state, cfg, batch, device, probes=(), tap=None):
    """(loss, logits, {name: clamped grad}, [probe(model, batch) for each
    of probes] taken before the step, u * kappa of the step's forward
    (u_kappa)), on the CPU, of one train step (the task's loss, the
    config's compute dtype) from the model state `state` on `device`,
    after the model's stored-parameter mutation (AFN's
    positivity) as the train step does. `tap` is bn_tap's (inputs,
    outputs, pin) for the step's forward (default: a new inputs dict)."""
    tap = tap or ({},)
    with timed(f"step_{device}.setup"):
        model = create_model(cfg, seed=SEED, kernels=cfg.kernels,
                             dtype=compute_dtype(cfg))
        model.load_state_dict(state)
        model.to(device)
        batch = {k: v.to(device) for k, v in batch.items()}
        transform = param_transform_for(cfg.model)
        if transform is not None:
            transform(model)
    with timed(f"step_{device}.probe"):
        seen = [probe(model, batch) for probe in probes]
    loss_fn = task_fns("multiclass" if cfg.noutput > 1 else "binary")[0]
    with timed(f"step_{device}.step"), bn_tap(model, *tap):
        loss, logits = forward_loss(model, batch, loss_fn)
        loss.backward()
        clamp_grads(model.parameters(), 1.0)
        return (loss.item(), logits.detach().float().cpu(),
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                seen, u_kappa(tap[0], model))


def within(delta, ref, rtol, atol=1e-6):
    """||delta|| <= atol * sqrt(numel) + rtol * ||ref|| (2-norms)."""
    return float(delta.norm()) <= (atol * delta.numel() ** 0.5
                                   + rtol * float(ref.norm()))


# the kernels against their plain versions inside one train step on the
# card: the loss and each clamped gradient, norm-wise (largest gradient gap
# read 8.4e-7 over every phase, the loss 0)
KERNELS_VS_PLAIN_RTOL = 1e-5


# the GPU-vs-CPU train loss under --bf16: XLA-free, but the card's and the
# CPU's bfloat16 GEMMs round differently (read in the CPU tests: logits
# within 2.6e-2 relative, losses within 1e-2), so the f32 1e-5 does not hold
BF16_LOSS_RTOL = 2e-2


def kernels_held_to_plain(gaps):
    """While active, every kernel wrapper also runs its plain version on the
    same (float32) inputs on the card and appends to gaps[name] the
    norm-wise relative gap of its output: the kernels held at their
    boundary, where a later layer's bfloat16 rounding cannot magnify a
    1e-7 difference into one bfloat16 ulp."""
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def held(name, kernel, plain):
        def run(*args):
            out = kernel(*args)
            # on copies: K9's forward updates the running statistics in place
            want = plain(*(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
            pairs = zip(out, want) if isinstance(out, tuple) else [(out, want)]
            gaps.setdefault(name, []).append(max(rel(a, b) for a, b in pairs))
            return out
        return run

    return swapped_kernels(held)


def gpu_vs_cpu_step(ckpt, cfg, batch, enforce=True, pinned=False):
    """One train step (masked BN forward, the task's loss, backward, clamp)
    from the checkpoint on the card, on the card with the plain versions
    swapped in (which isolates the kernels' share of any gap), and on the
    CPU. With enforce=False the same numbers are logged and nothing is
    held; with a set of pin modes (pinned="both") only those steps are
    held and the others logged.

    Each clamped gradient is held norm-wise to atol 1e-6 plus rtol =
    max(1e-4, 16 u kappa) (u_kappa) against the CPU: rtol 1e-4 where the
    forward allows it; where arm_bn magnifies one f32 rounding of exp(z)
    to u kappa of its spread, two correct f32 steps differ by that much
    times the depth below, and the bound follows the conditioning this
    run measures. The loss, the forward's own output with no depth below
    it, is held to max(1e-5, u kappa) relative unpinned and to 1e-5
    pinned (armnet_1h's unpinned Criteo step read 1.52e-5 at a u kappa of
    7.2e-4 on an H100, the same step with the card's BatchNorms on the
    composed ops 1.51e-5, and pinned 0). The kernels are held to the
    plain versions on the card (same inputs, same GEMMs) at the fixed
    norm-wise KERNELS_VS_PLAIN_RTOL, loss and gradients.

    With `pinned` (the phases of the models after armnet_1h) the CPU step
    takes the card's outputs of the BatchNorms of pinned_norms (bn_tap):
    the magnified rounding moves ReLUs below such a BatchNorm across 0,
    and two correct f32 steps then differ by more than any bound of the
    conditioning (ROADMAP.md §3). Pinned, the forward above each pinned
    BatchNorm is held too: its input on the card and on the CPU within
    1e-5 of its norm. pinned="both" (armnet_1h's phases) holds the
    unpinned CPU step by the unpinned rule and a pinned one by the pinned
    rule, and returns the unpinned result with the pinned one under
    "pinned". Also logged: the elements outside the elementwise rtol 1e-4,
    atol 1e-6 and, among the batch's first CPU_ROWS rows, the entmax
    columns whose support differs between card and CPU.

    Under --bf16 (cfg.bf16) the loss is held to BF16_LOSS_RTOL and the
    kernels at their boundary instead (kernels_held_to_plain, each call's
    output within KERNELS_VS_PLAIN_RTOL of its plain version); the
    gradients and the BatchNorm inputs, whose bfloat16 GEMMs round apart
    on the card and the CPU, are logged."""
    with timed("step.load"):
        state, _ = load_checkpoint(ckpt, "last")
    card_in, card_out, boundary = {}, {}, {}
    with (kernels_held_to_plain(boundary) if cfg.bf16
          else contextlib.nullcontext()):
        lg, yg, gg, (sg,), cond = one_step_grads(
            state, cfg, batch, "cuda", (entmax_support,),
            (card_in, card_out))
    with plain_versions_on_card():
        lq, yq, gq, _, _ = one_step_grads(state, cfg, batch, "cuda")

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    def hold(pin_on):
        pin = ({n: card_out[n] for n in pinned_norms(create_model(cfg))}
               if pin_on else {})
        cpu_in = {}
        lc, yc, gc, (sc,), _ = one_step_grads(
            state, cfg, batch, "cpu",
            (lambda model, b: entmax_support(model, b, CPU_ROWS),),
            (cpu_in, None, pin))
        bn_gaps = {n: rel(card_in[n].float(), cpu_in[n].float())
                   for n in pin}
        rtol = max(1e-4, 16 * cond)
        flips = (torch.zeros(0) if sg is None
                 else (sg[:CPU_ROWS] != sc).any(1))   # [rows, O] columns
        per_param, bad, unlike_plain, strict_outside = {}, [], [], {}
        for name, ref in gc.items():
            dg = (gg[name] - ref).abs()
            tol = 1e-6 + 1e-4 * ref.abs()
            out = int((dg > tol).sum())
            per_param[name] = {
                "norm": float(ref.norm()), "numel": ref.numel(),
                "gpu_rel_gap": rel(gg[name], ref),
                "gpu_plain_rel_gap": rel(gq[name], ref),
                "kernels_vs_plain_rel_gap": rel(gg[name], gq[name]),
                "gpu_max_abs_gap": float(dg.max())}
            if out:
                i = int((dg - tol).argmax())
                strict_outside[name] = {
                    "elements": out, "of": ref.numel(),
                    "worst_index": list(map(int, np.unravel_index(
                        i, tuple(ref.shape)))),
                    "gpu": float(gg[name].reshape(-1)[i]),
                    "cpu": float(ref.reshape(-1)[i])}
            if not within(gg[name] - ref, ref, rtol):
                bad.append(name)
            if not within(gg[name] - gq[name], gq[name],
                          KERNELS_VS_PLAIN_RTOL):
                unlike_plain.append(name)
        # over the gradients above the atol floor (the biases that a
        # BatchNorm follows have a true gradient of 0)
        real = [v for v in per_param.values()
                if v["norm"] > 1e-6 * v["numel"] ** 0.5]
        res = {"loss_gpu": lg, "loss_cpu": lc,
               "loss_rel_gap": abs(lg - lc) / abs(lc),
               "loss_kernels_vs_plain_rel_gap": abs(lg - lq) / abs(lq),
               "logits_max_abs_gap": float((yg - yc).abs().max()),
               "logits_max_abs_gap_plain_on_card": float(
                   (yq - yc).abs().max()),
               "u_kappa": cond, "grad_rtol": rtol,
               "loss_rtol": 1e-5 if pin_on else max(1e-5, cond),
               "max_grad_rel_gap": max(v["gpu_rel_gap"] for v in real),
               "max_grad_kernels_vs_plain_rel_gap": max(
                   v["kernels_vs_plain_rel_gap"] for v in real),
               "support_flip_columns": int(flips.sum()),
               "support_rows": min(CPU_ROWS, len(yc)),
               "strict_elementwise_outside": {
                   n: v["elements"] for n, v in strict_outside.items()}}
        if pin_on:
            res.update(pinned_bn=sorted(pin), bn_input_rel_gap=bn_gaps)
        if cfg.bf16:
            res["kernels_at_boundary_max_rel_gap"] = {
                k: max(v) for k, v in boundary.items()}
        enforced = (enforce if isinstance(enforce, bool)
                    else pin_on in enforce)
        log("train_gpu_vs_cpu", model=cfg.model, ensemble=cfg.ensemble,
            kernels=cfg.kernels, bf16=cfg.bf16, rows=len(yc),
            nfield=cfg.nfield, alpha=cfg.alpha, ckpt=ckpt,
            enforced=enforced, pinned=pin_on, **res, outside_bound=bad,
            unlike_plain=unlike_plain, per_param=per_param,
            strict_worst=strict_outside)
        if not enforced:
            return res
        if cfg.bf16:
            check(res["loss_rel_gap"] <= BF16_LOSS_RTOL,
                  f"GPU vs CPU bf16 train loss: relative gap "
                  f"{res['loss_rel_gap']} > {BF16_LOSS_RTOL}")
            worst = res["kernels_at_boundary_max_rel_gap"]
            check(worst and all(v <= KERNELS_VS_PLAIN_RTOL
                                for v in worst.values()),
                  f"kernels vs plain versions at their boundary in a bf16 "
                  f"step: {worst}")
            return res
        check(res["loss_rel_gap"] <= res["loss_rtol"],
              f"GPU vs CPU train loss: relative gap {res['loss_rel_gap']} > "
              f"{res['loss_rtol']:.3g}")
        check(res["loss_kernels_vs_plain_rel_gap"] <= KERNELS_VS_PLAIN_RTOL,
              f"train loss with the kernels vs the plain versions on the "
              f"card: relative gap {res['loss_kernels_vs_plain_rel_gap']}")
        check(all(v <= 1e-5 for v in bn_gaps.values()),
              f"GPU vs CPU BatchNorm inputs: relative gaps {bn_gaps}")
        check(not bad, f"GPU vs CPU clamped gradients outside norm-wise "
                       f"rtol {rtol:.3g}, atol 1e-6: {bad}")
        check(not unlike_plain,
              f"clamped gradients with the kernels vs the plain versions on "
              f"the card outside norm-wise rtol {KERNELS_VS_PLAIN_RTOL}, "
              f"atol 1e-6: {unlike_plain}")
        return res

    if pinned != "both":
        return hold(bool(pinned))
    res = hold(False)
    res["pinned"] = {k: v for k, v in hold(True).items() if k in GAP_KEYS}
    return res


class HeadCopy:
    """A CPU iterator's batches, each copied to the card at the head of its
    step, as the train loop did before the lookahead."""

    def __init__(self, loader):
        self.loader = loader

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for batch in self.loader:
            yield {k: v.to("cuda", non_blocking=True)
                   for k, v in batch.items()}


FEEDS = ("resident", "lookahead", "thread", "head_copy")


def warm_train_rate(cfg, data, epochs=4, dataset="criteo", nfield=39,
                    feed="lookahead"):
    """Host-clock rows/s of whole train epochs (run_epoch over the train
    split of {data}/{dataset}, TRAIN_BATCHES batches for the synthetic
    Criteo one: batch assembly, copies, steps) on a fresh trainer of
    `cfg`, the first epoch being the warm-up. The batches are gathered on
    the card from its resident rows (`feed` 'resident'), reach it through
    the iterator's streaming lookahead (RESIDENT_SHARE 0: 'lookahead'),
    through it with the prefetch thread on ('thread':
    ARMNET_PREFETCH_THREAD=1), or are copied at the head of each step
    ('head_copy'). Returns (warm rates, warm ms per step, the trainer)."""
    loaders = make_dataloaders(dataset, data, nfield, cfg.batch_size,
                               seed=SEED,
                               device=None if feed == "head_copy" else "cuda")
    logger = get_logger(None, to_stdout=False, name="chip_smoke.train_rate")
    trainer = Trainer(cfg, *loaders, logger, seed=SEED)
    rows = len(loaders[0].ds)
    train = HeadCopy(loaders[0]) if feed == "head_copy" else loaders[0]
    secs = []
    prev = os.environ.get("ARMNET_PREFETCH_THREAD")
    os.environ["ARMNET_PREFETCH_THREAD"] = "1" if feed == "thread" else "0"
    # the rows stream where the card holds no share of them (the choice
    # is made at the first iteration)
    share = libsvm.RESIDENT_SHARE
    if feed != "resident":
        libsvm.RESIDENT_SHARE = 0.0
    try:
        for ep in range(epochs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_epoch(ep, trainer.state, train, logger,
                      device=trainer.device, train_step=trainer.train_step,
                      report_freq=10 ** 9)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
    finally:
        libsvm.RESIDENT_SHARE = share
        if prev is None:
            del os.environ["ARMNET_PREFETCH_THREAD"]
        else:
            os.environ["ARMNET_PREFETCH_THREAD"] = prev
    remove_logger(logger)
    warm = secs[1:]
    return ([rows / t for t in warm],
            [t / len(loaders[0]) * 1e3 for t in warm], trainer)


def criteo_split(tmp):
    """Seeded synthetic Criteo-geometry train (TRAIN_BATCHES x 4096 rows),
    valid and test (EVAL_ROWS each) files under {tmp}/train_data/criteo;
    returns (data_dir, the train file's first batch)."""
    data = os.path.join(tmp, "train_data")
    os.makedirs(os.path.join(data, "criteo"))
    for i, (name, rows) in enumerate((("train", TRAIN_BATCHES * 4096),
                                      ("valid", EVAL_ROWS),
                                      ("test", EVAL_ROWS))):
        with timed("write_libsvm"):
            write_criteo_libsvm(os.path.join(data, "criteo",
                                             f"{name}.libsvm"),
                                rows, CRITEO_NFEAT, 39, SEED + 10 + i)
    return data, next(iter(BatchIterator(LibsvmDataset(
        os.path.join(data, "criteo", "train.libsvm"), 39), 4096)))


def phase_train(tmp, data, first):
    """cli.main at Criteo width, ensemble off and on under auto, and
    ensemble off under pallas-fused: launches, losses, the GPU-vs-CPU
    step, then the warm rate and, ensemble off, the train-step profile."""
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    totals = dict.fromkeys(read_counts(), 0)
    for ensemble, kernels in ((False, "auto"), (True, "auto"),
                              (False, "pallas-fused")):
        fused = kernels == "pallas-fused"
        exp = f"criteo_ens{int(ensemble)}" + ("_fused" if fused else "")
        with timed("train.cli"):
            _, counts, seconds = run_cli(criteo_flags(ensemble, kernels) + [
                "--dataset", "criteo", "--data_dir", data, "--epoch", "2",
                "--patience", "5", "--report_freq", "1", "--seed", str(SEED),
                "--exp_name", exp, "--log_dir", os.path.join(tmp, "log"),
                "--ckpt_dir", os.path.join(tmp, "ckpt"), "--device", "cuda"])
        want = {"entmax_fwd": steps + evals, "entmax_bwd": steps,
                "table_grad": steps * (2 if ensemble else 1),
                "arm1h_fwd": 0, "arm1h_bwd": 0, "cin_fwd": 0, "cin_bwd": 0,
                **bn_want(steps, 1)}
        if fused:
            want.update(entmax_fwd=0, entmax_bwd=0, arm1h_fwd=steps + evals,
                        arm1h_bwd=steps)
        check(counts == want, f"train launches {counts}, expected {want} "
                              f"({steps} steps, {evals} eval batches)")
        losses, means = train_losses(os.path.join(
            tmp, "log", f"{exp}_{SEED}", "stdout.log"))
        flat = [x for ep in losses for x in ep]
        check(len(flat) == steps and all(math.isfinite(x) for x in flat),
              f"train losses {losses}")
        check(means[1] < flat[0], f"second epoch's mean loss {means[1]} is "
                                  f"not below the first step's {flat[0]}")
        with open(os.path.join(tmp, "log", f"{exp}_{SEED}",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        check([r["epoch"] for r in rows] == [0, 1],
              f"metrics.jsonl rows {rows}")
        ckpt = os.path.join(tmp, "ckpt", f"{exp}_{SEED}")
        # the run's best checkpoint scores through predict on the card,
        # which restores the run's --kernels from the sidecar
        score_kernel = "arm1h_fwd" if fused else "entmax_fwd"
        with timed("train.predict"):
            scored, score_launches = run_predict(
                ckpt, os.path.join(data, "criteo", "valid.libsvm"),
                os.path.join(tmp, f"{exp}.scores"), EVAL_ROWS, score_kernel)
        with timed("train.gpu_vs_cpu"):
            cfg = criteo_config(ensemble, kernels)
            if not fused:
                gap = gpu_vs_cpu_step(ckpt, cfg, first, pinned="both")
            else:
                # held from the state the auto run's step was held at, so
                # the two kernel choices are compared at one conditioning;
                # the fused run's own state is logged beside it
                gap = gpu_vs_cpu_step(state_ckpt, cfg, first, pinned="both")
                gpu_vs_cpu_step(ckpt, cfg, first, enforce=False)
        if not ensemble and not fused:
            state_ckpt = ckpt
        with timed("train.warm_rate"):
            rates, ms_step, trainer = warm_train_rate(cfg, data)
        log("train", width="cr_armnet1h", ensemble=ensemble, kernels=kernels,
            steps=steps, eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, first_step_loss=flat[0],
            valid_auc=[r["valid"] for r in rows],
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "launches": score_launches},
            epoch_mean_loss=means, warm_rows_per_s=rates,
            warm_ms_per_step=ms_step,
            gpu_vs_cpu={k: gap[k] for k in (
                "loss_rel_gap", "logits_max_abs_gap", "u_kappa", "grad_rtol",
                "max_grad_rel_gap", "support_flip_columns", "pinned")})
        for k in totals:
            totals[k] += counts[k]
        totals[score_kernel] += score_launches
        if not ensemble:
            phase_profile_train(trainer, first, cfg)
        del trainer
        torch.cuda.empty_cache()
    return totals


def phase_profile_train(trainer, batch, cfg):
    """torch.profiler over one warm Criteo-width train step of the
    trainer's model (ensemble off), the batch's copy to the card included:
    device time by kernel and the device's busy share of the step's wall
    time."""
    from torch.profiler import ProfilerActivity

    from armnet_tpu_torch.train.step import init_meters

    def timed_step():
        t0 = time.perf_counter()
        dev = {k: v.to("cuda", non_blocking=True) for k, v in batch.items()}
        trainer.train_step(trainer.state, init_meters("cuda"), dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    timed_step()
    events, wall_ms = device_events(
        timed_step, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    busy_ms = (sum(e.self_device_time_total for e in events) / 1e3
               if events else None)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
    port = ("entmax_", "radix_", "zero_kernel", "segment_kernel", "arm1h_",
            "sum_rows_kernel")
    log("profile_train", model=cfg.model, kernels=cfg.kernels,
        wall_ms=wall_ms, device_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms if events else None,
        top=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
             for e in top],
        port_kernels=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
                      for e in events if any(k in e.key for k in port)])


def phase_frappe_train(tmp):
    """3 epochs of the frappe_armnet1h recipe through cli.main on the
    bundled Frappe split; fails unless the last valid AUC is >= 0.85."""
    _, counts, seconds = run_cli([
        "--model", "armnet_1h", "--alpha", "2.0", "--h", "128", "--lr",
        "0.001", "--batch_size", "4096", "--epoch", "3", "--patience", "3",
        "--seed", str(SEED), "--dataset", "frappe", "--data_dir",
        os.path.join(REPO, "data"), "--log_dir", os.path.join(tmp, "log"),
        "--exp_name", "frappe", "--report_freq", "1000", "--device", "cuda"])
    with open(os.path.join(tmp, "log", f"frappe_{SEED}",
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    valid = [r["valid"] for r in rows]
    log("frappe_train", epochs=len(rows), valid_auc=valid,
        test_auc=[r["test"] for r in rows], train_auc=[r["train"] for r in rows],
        jax_valid_auc=list(FRAPPE_JAX_VALID), seconds=seconds,
        launches=counts)
    check(len(rows) == 3 and valid[-1] >= 0.85,
          f"Frappe valid AUC after 3 epochs {valid} (needs >= 0.85)")
    return counts


def phase_diabetes_train(tmp):
    """3 epochs of the db_armnet1h recipe (armnet_tpu/utils/presets.py: 43
    fields, alpha 1.7, batch 1024) through cli.main on the bundled
    data/uci_diabetes/ split, under --kernels auto and pallas-fused: the
    kernel launches per step (K2/K4 under auto, K5/K6 under pallas-fused,
    their 43 fields past the fused kernels' 40-field register bucket),
    finite step losses whose last epoch's mean is below the first's, one
    step from the run's checkpoint on the card against the CPU (loss 1e-5
    relative, gradients norm-wise at rtol max(1e-4, 16 u kappa): ROADMAP
    §3), and the valid and test AUC per epoch."""
    data = os.path.join(REPO, "data")
    split = os.path.join(data, "uci_diabetes")
    loaders = {name: BatchIterator(LibsvmDataset(
        os.path.join(split, f"{name}.libsvm"), 43), 1024)
        for name in ("train", "valid", "test")}
    first = next(iter(loaders["train"]))
    steps = 3 * len(loaders["train"])
    evals = 3 * (len(loaders["valid"]) + len(loaders["test"]))
    totals = dict.fromkeys(read_counts(), 0)
    for kernels in ("auto", "pallas-fused"):
        exp = f"diabetes_{kernels}"
        flags = DIABETES_FLAGS + ["--kernels", kernels]
        with timed("diabetes_train.cli"):
            _, counts, seconds = run_cli(flags + [
                "--data_dir", data, "--epoch", "3", "--patience", "3",
                "--report_freq", "1", "--seed", str(SEED), "--exp_name",
                exp, "--log_dir", os.path.join(tmp, "log"), "--ckpt_dir",
                os.path.join(tmp, "ckpt"), "--device", "cuda"])
        want = {"entmax_fwd": steps + evals, "entmax_bwd": steps,
                "table_grad": steps, "arm1h_fwd": 0, "arm1h_bwd": 0,
                "cin_fwd": 0, "cin_bwd": 0, **bn_want(steps, 1)}
        if kernels == "pallas-fused":
            want.update(entmax_fwd=0, entmax_bwd=0, arm1h_fwd=steps + evals,
                        arm1h_bwd=steps)
        check(counts == want, f"diabetes launches {counts}, expected {want} "
                              f"({steps} steps, {evals} eval batches)")
        losses, means = train_losses(os.path.join(
            tmp, "log", f"{exp}_{SEED}", "stdout.log"))
        flat = [x for ep in losses for x in ep]
        check(len(flat) == steps and all(math.isfinite(x) for x in flat),
              f"diabetes train losses {losses}")
        check(means[-1] < means[0], f"diabetes epoch mean losses {means} "
                                    f"do not fall")
        with open(os.path.join(tmp, "log", f"{exp}_{SEED}",
                               "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(flags)))
        with timed("diabetes_train.gpu_vs_cpu"):
            gap = gpu_vs_cpu_step(os.path.join(tmp, "ckpt", f"{exp}_{SEED}"),
                                  cfg, first, pinned="both")
        log("diabetes_train", recipe="db_armnet1h", kernels=kernels,
            steps=steps, eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, first_step_loss=flat[0],
            epoch_mean_loss=means, valid_auc=[r["valid"] for r in rows],
            test_auc=[r["test"] for r in rows],
            gpu_vs_cpu={k: gap[k] for k in (
                "loss_rel_gap", "logits_max_abs_gap", "u_kappa", "grad_rtol",
                "max_grad_rel_gap", "support_flip_columns", "pinned")})
        for k in totals:
            totals[k] += counts[k]
    return totals


def first_epoch_past(curve, level=0.9):
    """The 1-based epoch at which a valid AUC curve first passes `level`,
    or None."""
    return next((i + 1 for i, v in enumerate(curve) if v > level), None)


def phase_diabetes_parity(tmp):
    """15 epochs of the db_armnet1h recipe on data/uci_diabetes/ from the
    JAX package's seed-2025 init (PARITY, carried in by bridge), under
    --kernels auto (K2, K4, K7) and pallas-fused (K5 and K6 on their
    past-40-field builds, K7), in process. The trainer and its loaders are
    built at seed 2025 before the init is loaded, so the rows come in the
    order of the CPU runs in PARITY's JSON. Fails unless the best valid
    AUC is within PARITY_BEST_ATOL of the JAX package's from the same init,
    every kernel of the choice launched once per step (and per eval batch
    for the forward), and every step loss is finite. Logs the per-epoch
    valid AUC beside the JAX and port CPU curves and their gaps (not
    gated: before take-off the AUC sits at 0.55-0.75, where rounding moves
    it by a few thousandths), the first epoch past 0.9 on each, the mean
    train loss per epoch and the seconds."""
    with open(PARITY + ".json") as f:
        ref = json.load(f)
    with np.load(PARITY + ".npz") as z:
        init = {k: z[k] for k in z.files}
    epochs, curves = ref["epochs"], ref["valid_auc"]
    jax_curve, cpu_curve = curves["jax"], curves["port_from_jax_init"]
    data = os.path.join(REPO, "data")
    totals = dict.fromkeys(read_counts(), 0)
    for kernels in ("auto", "pallas-fused"):
        cfg = flags_config(DIABETES_FLAGS + ["--kernels", kernels,
                                             "--data_dir", data])
        exp = os.path.join(tmp, "log", f"parity_{kernels}")
        logger = get_logger(os.path.join(exp, "stdout.log"), to_stdout=False,
                            name=f"chip_smoke.parity_{kernels}")
        loaders = make_dataloaders(cfg.dataset, data, cfg.nfield,
                                   cfg.batch_size, seed=SEED,
                                   device=torch.device("cuda"))
        trainer = Trainer(cfg, *loaders, logger, seed=SEED,
                          metrics_path=os.path.join(exp, "metrics.jsonl"))
        trainer.state.model.load_state_dict(from_jax_arrays(init, cfg))
        zero_counts()
        t0 = time.perf_counter()
        trainer.fit(epochs, patience=epochs, report_freq=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        remove_logger(logger)
        steps = epochs * len(loaders[0])
        evals = epochs * (len(loaders[1]) + len(loaders[2]))
        fused = kernels == "pallas-fused"
        want = zoo_want(steps, evals, entmax=not fused, tables=1, bns=1)
        if fused:
            want.update(arm1h_fwd=steps + evals, arm1h_bwd=steps)
        check(counts == want, f"diabetes_parity launches {counts}, expected "
                              f"{want} ({steps} steps, {evals} eval batches)")
        losses, means = train_losses(os.path.join(exp, "stdout.log"))
        flat = [x for ep in losses for x in ep]
        check(len(flat) == steps and all(math.isfinite(x) for x in flat),
              f"diabetes_parity train losses {losses}")
        with open(os.path.join(exp, "metrics.jsonl")) as f:
            valid = [json.loads(line)["valid"] for line in f]
        best_gap = max(valid) - max(jax_curve)
        log("diabetes_parity", recipe="db_armnet1h", kernels=kernels,
            init=os.path.relpath(PARITY, REPO) + ".npz", epochs=epochs,
            valid_auc=valid, jax_cpu_valid_auc=jax_curve,
            port_cpu_valid_auc=cpu_curve,
            port_own_init_cpu_valid_auc=curves["port_own_init"],
            gap_vs_jax=[round(v - j, 6) for v, j in zip(valid, jax_curve)],
            gap_vs_port_cpu=[round(v - c, 6)
                             for v, c in zip(valid, cpu_curve)],
            best=max(valid), jax_best=max(jax_curve),
            port_cpu_best=max(cpu_curve), best_gap_vs_jax=best_gap,
            first_epoch_past_0_9={
                "card": first_epoch_past(valid),
                "jax_cpu": first_epoch_past(jax_curve),
                "port_cpu": first_epoch_past(cpu_curve)},
            epoch_mean_loss=means, steps=steps, eval_batches=evals,
            launches=counts, seconds=seconds, jax=ref["versions"]["jax"])
        check(len(valid) == epochs and abs(best_gap) <= PARITY_BEST_ATOL,
              f"diabetes_parity ({kernels}): best valid AUC {max(valid)} "
              f"against the JAX package's {max(jax_curve)} from the same "
              f"init (limit {PARITY_BEST_ATOL})")
        for k in totals:
            totals[k] += counts[k]
    return totals


# the multi-head presets' channel counts C = nattn_head * h on the entmax
# kernels' inner axis, and a ragged 6 (the packed routes' thread loads)
MULTIHEAD_C = (6, 8, 16, 32, 64, 256, 512)
# the UCI armnet step: 4 heads x 128 neurons over 16 fields, batch 512
UCI_ARMNET_SHAPE = (UCI_BATCH, UCI_FIELDS, 4 * 128)
# the timed steps: (name, the gates [B, F, C], alpha) of the presets
MULTIHEAD_STEPS = (("cr_armnet", CR_ARMNET_SHAPE, 2.0),
                   ("db_armnet", DB_ARMNET_SHAPE, 1.7),
                   ("uci_armnet", UCI_ARMNET_SHAPE, 1.7),
                   ("av_armnet", AV_ARMNET_SHAPE, 1.5),
                   ("av_armnet+", AV_ARMNET_PLUS_SHAPE, 2.0),
                   ("frappe_armnet+", FRAPPE_ARMNET_PLUS_SHAPE, 1.5),
                   ("ml_armnet+", ML_ARMNET_PLUS_SHAPE, 2.5))


# rows of the xdfm_criteo step that K8 is held to its plain version on (the
# plain version's outer product of 4,096 rows is 0.25-1.3 GB a layer), and
# the tolerance: float32 sums of the F * C products (of the rows too, in
# dW) in another order, 2e-5 of the largest entry (tests/test_torch_cuda.py
# holds the same against float64)
CIN_CHECK_ROWS = 4096
CIN_ATOL = 2e-5


def phase_kernel_cin():
    """K8 at the xdfm_criteo step's layers (bench.CIN_LAYERS: 65,536 rows,
    E 10, 39 fields, C 39 and 200, 200 maps) in full float32 (TF32 off):
    the forward on every row, its first CIN_CHECK_ROWS rows against the
    plain version on those rows; the backward's dx0 and dxk there against
    the plain version's, and dW against the plain version summed over
    blocks of CIN_CHECK_ROWS rows (the ReLU mask from the kernel's output
    on both sides); each within CIN_ATOL of its largest entry; the
    backward twice, bitwise equal; one forward and cin_cuda.bwd_launches
    launches a call. Then bench.bench_cin's device times beside the bound,
    the plain version and the blocked route. The matmul settings are
    restored after. Returns {(kind, C): record}."""
    tf32, precision = (torch.backends.cuda.matmul.allow_tf32,
                       torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rows, recs = CIN_CHECK_ROWS, {}
    try:
        g = torch.Generator(device="cuda").manual_seed(SEED + 8)
        for shape in bench.CIN_LAYERS:
            b, e, f, c, n = shape
            x0, xk, w, dout = bench.cin_inputs(g, shape)
            zero_counts()
            out = cin_cuda.cin_fwd(x0, xk, w)
            grads = cin_cuda.cin_bwd(x0, xk, w, out, dout)
            again = cin_cuda.cin_bwd(x0, xk, w, out, dout)
            torch.cuda.synchronize()
            counts = read_counts()
            want_bwd = 2 * cin_cuda.bwd_launches(b * e, f, c, n)
            check(counts == {**dict.fromkeys(counts, 0), "cin_fwd": 1,
                             "cin_bwd": want_bwd},
                  f"K8 at {shape} launched {counts}")
            check(all(torch.equal(u, v) for u, v in zip(grads, again)),
                  f"K8's backward at {shape}: two calls differ")
            ref = cin_cuda.cin_fwd_plain(x0[:rows], xk[:rows], w)
            dx0, dxk, dw = cin_cuda.cin_bwd_plain(
                x0[:rows], xk[:rows], w, out[:rows], dout[:rows])
            for s0 in range(rows, b, rows):
                dw += cin_cuda.cin_bwd_plain(
                    x0[s0:s0 + rows], xk[s0:s0 + rows], w,
                    out[s0:s0 + rows], dout[s0:s0 + rows])[2]
            errs = {}
            for name, got, want in (("out", out[:rows], ref),
                                    ("dx0", grads[0][:rows], dx0),
                                    ("dxk", grads[1][:rows], dxk),
                                    ("dw", grads[2], dw)):
                errs[name] = float((got - want).abs().max()
                                   / want.abs().max())
            check(all(v <= CIN_ATOL for v in errs.values()),
                  f"K8 at {shape} against its plain version: gaps over the "
                  f"largest entry {errs} (limit {CIN_ATOL})")
            check(bool((out == 0).any() and (out > 0).any()),
                  f"K8 at {shape}: the ReLU cut no output or every one")
            recs[("check", c)] = {"errs": errs, "launches": counts}
            del x0, xk, w, dout, out, grads, again, ref, dx0, dxk, dw
            torch.cuda.empty_cache()
        for rec in bench.bench_cin():
            kind = next((k for k in ("fwd", "bwd") if f"cin_{k}" in rec),
                        None)
            if kind is not None:
                recs[(kind, rec[f"cin_{kind}"]["C"])] = rec
            else:
                recs["ptxas"] = rec["cin_ptxas"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(precision)
    for kind in ("fwd", "bwd"):
        for c in (39, 200):
            r = recs[(kind, c)]
            check(all(math.isfinite(r[k]) and r[k] > 0 for k in (
                "time_ms", "plain_ms", "blocked_ms", "bound_ms")),
                  f"K8 {kind} at C {c}: times {r}")
            log("kernel_cin", kind=kind, C=c, **r,
                max_rel_err=max(recs[("check", c)]["errs"].values()))
    log("kernel_cin", ptxas=recs["ptxas"],
        checks={c: recs[("check", c)] for c in (39, 200)})
    return recs


def phase_kernel_bn():
    """K9 at bench.BN_SHAPES, masked as the trainer calls it, an eighth of
    the rows pad rows of outliers (50): the forward and backward against
    the plain version on the same inputs (y, mean, rstd, the running
    statistics, dx, dweight, dbias), each norm-wise within
    KERNELS_VS_PLAIN_RTOL; both twice, bitwise equal; bn_cuda's launches a
    call. Then bench.bench_bn's times beside the bound, the plain version,
    the composed path and F.batch_norm. Returns {name: record}."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    recs = {}
    for name, shape in bench.BN_SHAPES:
        n, c, s = shape
        x, dy, rows, _, weight, bias = bench.bn_inputs(g, shape)
        rows[-(n // 8):] = 0.0
        x[rows == 0] = 50.0
        args = (rows, rows.sum(), s)
        runs = []
        for fwd, bwd in ((bn_cuda.bn_fwd, bn_cuda.bn_bwd),
                         (bn_cuda.bn_fwd, bn_cuda.bn_bwd),
                         (bn_cuda.bn_fwd_plain, bn_cuda.bn_bwd_plain)):
            rm = torch.zeros(c, device="cuda")
            rv = torch.ones(c, device="cuda")
            before = (bn_cuda.LAUNCHES, bn_cuda.BWD_LAUNCHES)
            y, mean, rstd = fwd(x, *args, weight, bias, rm, rv, 1e-5, 0.9)
            grads = bwd(x, dy, *args, weight, mean, rstd)
            launched = (bn_cuda.LAUNCHES - before[0],
                        bn_cuda.BWD_LAUNCHES - before[1])
            runs.append(([y, mean, rstd, rm, rv, *grads], launched))
        torch.cuda.synchronize()
        (got, launched), (again, _), (want, _) = runs
        names = ("y", "mean", "rstd", "running_mean", "running_var", "dx",
                 "dweight", "dbias")
        gaps = {k: float((a - b).norm() / b.norm().clamp_min(1e-30))
                for k, a, b in zip(names, got, want)}
        check(all(within(a - b, b, KERNELS_VS_PLAIN_RTOL, 0.0)
                  for a, b in zip(got, want)),
              f"K9 at {shape} against its plain version: {gaps}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K9 at {shape}: two calls differ")
        check(launched == (bn_cuda.FWD_CALL_LAUNCHES,
                           bn_cuda.BWD_CALL_LAUNCHES),
              f"K9 at {shape} launched {launched}")
        recs[("check", name)] = {"rel_gaps": gaps, "launches": launched}
        del x, dy, rows, runs, got, again, want
        torch.cuda.empty_cache()
    for rec in bench.bench_bn():
        kind = next((k for k in ("fwd", "bwd") if f"bn_{k}" in rec), None)
        if kind is None:
            recs["ptxas"] = rec["bn_ptxas"]
            continue
        recs[(kind, rec[f"bn_{kind}"])] = rec
        check(all(math.isfinite(rec[k]) and rec[k] > 0 for k in (
            "time_ms", "plain_ms", "composed_ms", "library_ms",
            "bound_ms")),
              f"K9 {kind} at {rec[f'bn_{kind}']}: times {rec}")
        log("kernel_bn", kind=kind, **rec,
            max_rel_gap=max(recs[("check", rec[f"bn_{kind}"])][
                "rel_gaps"].values()))
    log("kernel_bn", ptxas=recs["ptxas"],
        checks={name: recs[("check", name)] for name, _ in bench.BN_SHAPES})
    return recs


def phase_kernel_multihead():
    """K2 and K4 against their plain versions on [256, F, C] at F 39 and 43,
    C in MULTIHEAD_C and the four alphas, at the tolerances of the kernel
    phases; then both held to their plain versions at those tolerances and
    timed at each of MULTIHEAD_STEPS beside the plain versions and the
    bounds, with each kernel's route and blocks per SM. Returns
    {"fwd"|"bwd": {step: record}}, each record's max_abs_err that of its
    own step."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {"fwd": [], "bwd": []}
    for alpha in ALPHAS:
        ftol = 5e-6 if alpha <= 2.0 else 1e-5
        for f in (39, 43):
            for c in MULTIHEAD_C:
                x = torch.randn((256, f, c), generator=g, device="cuda") * 3.0
                yk = entmax_cuda.entmax_kernel(x, alpha, 1)
                yp = entmax_cuda.entmax_plain(x, alpha, 1)
                dy = torch.randn((256, f, c), generator=g, device="cuda")
                dk = entmax_cuda.entmax_bwd_kernel(yk, dy, alpha, 1)
                dp = entmax_cuda.entmax_bwd_plain(yk, dy, alpha, 1)
                torch.cuda.synchronize()
                for kind, got, want, tol in (("fwd", yk, yp, ftol),
                                             ("bwd", dk, dp, 2e-5)):
                    err = float((got - want).abs().max())
                    check(bool(torch.isfinite(got).all()) and err <= tol,
                          f"entmax_{kind} kernel vs plain at alpha={alpha} "
                          f"[256, {f}, {c}]: {err} > {tol}")
                    errs[kind].append(err)
    out = {"fwd": {}, "bwd": {}}
    for step, shape, alpha in MULTIHEAD_STEPS:
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        y = entmax_cuda.entmax_kernel(x, alpha, 1)
        dy = torch.randn(shape, generator=g, device="cuda")
        dx = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)
        err = {}
        for kind, got, want, tol in (
                ("fwd", y, entmax_cuda.entmax_plain(x, alpha, 1),
                 1e-5 if alpha > 2.0 else 5e-6),
                ("bwd", dx, entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1),
                 2e-5)):
            err[kind] = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()) and err[kind] <= tol,
                  f"entmax_{kind} kernel vs plain at alpha={alpha} "
                  f"{list(shape)}: {err[kind]} > {tol}")
        numel = math.prod(shape)
        fbound, fby = entmax_bound_ms(shape, alpha)
        bbound, bby = bound(3 * 4 * numel,
                            entmax_bwd_ops_per_element(alpha) * numel)
        b, f, c = shape
        out["fwd"][step] = {
            "shape": list(shape), "alpha": alpha,
            "route": entmax_cuda.route_for(f, c, b, alpha),
            "blocks_per_sm": entmax_cuda.fwd_blocks_per_sm(f, c, b, alpha),
            "ms": time_ms(lambda: entmax_cuda.entmax_kernel(x, alpha, 1)),
            "plain_ms": time_ms(lambda: entmax_cuda.entmax_plain(
                x, alpha, 1), PLAIN_REPS, 1),
            "bound_ms": fbound, "bound_by": fby,
            "max_abs_err": err["fwd"]}
        out["bwd"][step] = {
            "shape": list(shape), "alpha": alpha,
            "ms": time_ms(lambda: entmax_cuda.entmax_bwd_kernel(
                y, dy, alpha, 1)),
            "plain_ms": time_ms(lambda: entmax_cuda.entmax_bwd_plain(
                y, dy, alpha, 1), PLAIN_REPS, 1),
            "bound_ms": bbound, "bound_by": bby,
            "route": entmax_cuda.bwd_route_for(f, c),
            "blocks_per_sm": entmax_cuda.bwd_blocks_per_sm(f, alpha, c),
            "max_abs_err": err["bwd"]}
        for kind in ("fwd", "bwd"):
            log("kernel_multihead", name=f"entmax_{kind}", step=step,
                **out[kind][step], checked_c=list(MULTIHEAD_C),
                checked_f=[39, 43], alphas=list(ALPHAS),
                max_abs_err_over_c=max(errs[kind]))
    return out


def phase_serve_armnet(tmp, inp):
    """predict at the cr_armnet and cr_armnet+ widths (the ensemble off
    and on) on the serving phase's synthetic file, a cold and a warm
    call: rows, finite scores, one K2 launch per batch and no other (no
    K5), and the first batch's GPU logits against the CPU's."""
    launches = 0
    for name in ("cr_armnet", "cr_armnet+"):
        cfg = flags_config(preset_flags(name))
        ckpt = os.path.join(tmp, f"ckpt_{name}")
        save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
        out = os.path.join(tmp, f"{name}.scores")
        runs = [run_predict(ckpt, inp, out, 10_000) for _ in range(2)]
        launches += sum(n for _, n in runs)
        err = first_batch_logit_err(ckpt, cfg, inp)
        for i, (s, n) in enumerate(runs):
            log("serve_armnet", preset=name, ensemble=cfg.ensemble,
                channels=cfg.nattn_head * cfg.h,
                call="cold" if i == 0 else "warm", rows=s["rows"],
                batches=s["batches"], entmax_fwd_launches=n,
                rows_per_s=s["rows"] / s["score_seconds"],
                gpu_vs_cpu_logit_err=err)
    return launches


def train_run(tmp, exp, flags, data, split, batch, epochs, want,
              check_auc=None, pinned=True, enforce=True):
    """cli.main of `flags` for `epochs` on {data}/{split} with checkpoints,
    the counts set to 0 just before: launches equal to `want`, finite step
    losses whose last epoch's mean is below the first step's, a
    metrics.jsonl row per epoch (and check_auc(rows) where given), then
    one step from the run's checkpoint on the card against the CPU on
    `batch` (gpu_vs_cpu_step, `pinned`, `enforce`), under the config the
    run saved in its checkpoint's sidecar. Returns (counts, metrics rows,
    the step's gap, cli seconds, the config)."""
    bn_before = tracing.counts("armnet.bn.")
    with timed(f"{exp}.cli"):
        _, counts, seconds = run_cli(flags + [
            "--dataset", split, "--data_dir", data, "--epoch", str(epochs),
            "--patience", str(epochs), "--report_freq", "1", "--seed",
            str(SEED), "--exp_name", exp, "--log_dir",
            os.path.join(tmp, "log"), "--ckpt_dir",
            os.path.join(tmp, "ckpt"), "--device", "cuda"])
    check(counts == want, f"{exp} launches {counts}, expected {want}")
    ckpt = os.path.join(tmp, "ckpt", f"{exp}_{SEED}")
    cfg = ExperimentConfig(**load_checkpoint(ckpt, "last")[1]["config"])
    bn_routes(exp, cfg, bn_before)
    losses, means = train_losses(os.path.join(tmp, "log", f"{exp}_{SEED}",
                                              "stdout.log"))
    flat = [x for ep in losses for x in ep]
    check(len(losses) == epochs and all(math.isfinite(x) for x in flat),
          f"{exp} train losses {losses}")
    check(means[-1] < flat[0], f"{exp}: last epoch's mean loss {means[-1]} "
                               f"is not below the first step's {flat[0]}")
    with open(os.path.join(tmp, "log", f"{exp}_{SEED}",
                           "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    check([r["epoch"] for r in rows] == list(range(epochs)),
          f"{exp} metrics.jsonl rows {rows}")
    if check_auc is not None:
        check_auc(rows)
    with timed(f"{exp}.gpu_vs_cpu"):
        gap = gpu_vs_cpu_step(ckpt, cfg, batch, enforce, pinned)
    return counts, rows, gap, seconds, cfg


def bn_routes(exp, cfg, before):
    """Log the BatchNorm calls of a run by route since `before`
    (tracing.counts). In float32 every train-mode call of a BatchNorm over
    channel axis 1 (arm_bn, emb_bn, afn_bn: [B, C, E] inputs, S = E > 1)
    takes the kernels (armnet.bn.fused, a multiple of those BatchNorms);
    an MLP's (S = 1) and eval's take the composed ops. Under --bf16 a
    BatchNorm whose input is bfloat16 takes the composed ops (logged, not
    held)."""
    got = {k: v - before.get(k, 0)
           for k, v in tracing.counts("armnet.bn.").items()}
    norms = [m.channel_axis for m in create_model(cfg).modules()
             if isinstance(m, BatchNorm)]
    wide = norms.count(1)
    fused = got.get("armnet.bn.fused", 0)
    log("bn_routes", run=exp, model=cfg.model, bf16=cfg.bf16,
        batchnorms=len(norms), over_channel_axis_1=wide, **got)
    if not cfg.bf16:
        check(fused % max(wide, 1) == 0 and (fused > 0) == (wide > 0),
              f"{exp}: {wide} of {len(norms)} BatchNorms over channel axis "
              f"1, calls by route {got}")


def split_batches(split, nfield, batch):
    """Batches of each of split's train, valid and test files (a directory
    under data/), and the train file's first batch."""
    its = [BatchIterator(LibsvmDataset(os.path.join(
        REPO, "data", split, f"{name}.libsvm"), nfield), batch)
        for name in ("train", "valid", "test")]
    return [len(it) for it in its], next(iter(its[0]))


# the zoo models with a FeaturesLinear beside their embedding table: K7
# runs twice a train step, once for each (lr's FeaturesLinear is its only
# table; every other model has one table, and the DNN ensemble adds one)
TWO_TABLES = frozenset({"fm", "hofm", "afm", "nfm", "wd", "dfm", "cin",
                        "xdfm"})


def tables(model, ensemble=False):
    """K7 launches a train step of `model`: one per table."""
    return (2 if model in TWO_TABLES else 1) + int(ensemble)


def zoo_want(steps, evals, entmax, tables, cin=(0, 0), bns=0):
    """Launch counts of a run: K2 once per train step and eval batch and K4
    once per step where the model has entmax, K7 `tables` times per step,
    K8's forward cin[0] times per step and eval batch and its backward
    cin[1] times per step (cin_want), K9 for `bns` BatchNorms a train step
    (bn_want), never K5 or K6."""
    return {"entmax_fwd": (steps + evals) * entmax,
            "entmax_bwd": steps * entmax,
            "table_grad": steps * tables,
            "arm1h_fwd": 0, "arm1h_bwd": 0,
            "cin_fwd": (steps + evals) * cin[0], "cin_bwd": steps * cin[1],
            **bn_want(steps, bns)}


def bn_want(steps, bns):
    """K9's launches in `steps` train steps that each call `bns` BatchNorms
    on the fused route: a forward and a backward call of each (eval
    batches take the running statistics on the composed ops)."""
    return {"bn_fwd": steps * bns * bn_cuda.FWD_CALL_LAUNCHES,
            "bn_bwd": steps * bns * bn_cuda.BWD_CALL_LAUNCHES}


def bn_wide(cfg):
    """The BatchNorms of cfg's model that take K9 in a float32 train step
    on the card: those over channel axis 1 (arm_bn, emb_bn, afn_bn over [B,
    C, E]: S = E > 1, ops/layers.bn_route); the others normalize [B, C]
    over its last axis (S = 1: the composed ops)."""
    from armnet_tpu_torch.ops.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) and m.channel_axis == 1
               for m in create_model(cfg).modules())


def cin_want(cfg, rows):
    """(K8 forward launches a batch, its backward launches a train step) of
    cfg's model on batches of `rows` rows: for cin and xdfm one forward a
    CIN layer and cin_cuda.bwd_launches of each layer's backward (the same
    for a ragged last batch of 26 rows or more, whose dW rows are cut as
    the whole batch's are); (0, 0) for every other model."""
    if cfg.model not in ("cin", "xdfm"):
        return 0, 0
    c, bwd = cfg.nfield, 0
    for _ in range(cfg.k):
        bwd += cin_cuda.bwd_launches(rows * cfg.nemb, cfg.nfield, c, cfg.h)
        c = cfg.h
    return cfg.k, bwd


GAP_KEYS = ("loss_rel_gap", "logits_max_abs_gap", "u_kappa", "grad_rtol",
            "max_grad_rel_gap", "max_grad_kernels_vs_plain_rel_gap",
            "bn_input_rel_gap", "support_flip_columns")


def phase_train_armnet(tmp, data, first):
    """cli.main at the cr_armnet and cr_armnet+ widths under auto, and
    gc_arm with cr_armnet's flags under pallas-fused (which these models
    read nowhere: K2/K4/K7, no K5/K6), 2 epochs of TRAIN_BATCHES batches
    each (train_run; the step against the CPU on the first CPU_ROWS rows
    of the first batch), then for cr_armnet warm rows/s (printed, not
    claimed) and the train-step profile."""
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    cut = {k: v[:CPU_ROWS] for k, v in first.items()}
    totals = dict.fromkeys(read_counts(), 0)
    for exp, flags in (
            ("cr_armnet", preset_flags("cr_armnet")),
            ("cr_armnet+", preset_flags("cr_armnet+")),
            ("cr_gc_arm_fused", preset_flags("cr_armnet", "pallas-fused",
                                             "--model", "gc_arm"))):
        ensemble = "--ensemble" in flags
        counts, rows, gap, seconds, cfg = train_run(
            tmp, exp, flags, data, "criteo", cut, 2,
            zoo_want(steps, evals, 1,
                     tables(flags_config(flags).model, ensemble),
                     bns=bn_wide(flags_config(flags))))
        rate = {}
        if exp == "cr_armnet":
            with timed(f"{exp}.warm_rate"):
                rates, ms_step, trainer = warm_train_rate(cfg, data, epochs=3)
            rate = {"warm_rows_per_s": rates, "warm_ms_per_step": ms_step}
        log("train_armnet", run=exp, model=cfg.model, ensemble=ensemble,
            kernels=cfg.kernels, channels=cfg.nattn_head * cfg.h,
            steps=steps, eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, valid_auc=[r["valid"] for r in rows],
            **rate, gpu_vs_cpu={k: gap[k] for k in GAP_KEYS})
        if exp == "cr_armnet":
            phase_profile_train(trainer, first, cfg)
            del trainer
            torch.cuda.empty_cache()
        for k in totals:
            totals[k] += counts[k]
    return totals


def phase_diabetes_armnet(tmp):
    """3 epochs of the db_armnet recipe (32 heads x 1 neuron, 43 fields,
    alpha 1.7: K2/K4 at C = 32 in the powf mode) on data/uci_diabetes/
    under auto (train_run), with the valid and test AUC per epoch."""
    (train, valid, test), first = split_batches("uci_diabetes", 43, 1024)
    steps, evals = 3 * train, 3 * (valid + test)
    counts, rows, gap, seconds, cfg = train_run(
        tmp, "db_armnet", preset_flags("db_armnet"), os.path.join(
            REPO, "data"), "uci_diabetes", first, 3,
        zoo_want(steps, evals, 1, tables("armnet"), bns=1))
    log("diabetes_armnet", recipe="db_armnet", channels=cfg.nattn_head
        * cfg.h, steps=steps, eval_batches=evals, launches=counts,
        per_step={k: counts[k] / steps for k in counts}, cli_seconds=seconds,
        valid_auc=[r["valid"] for r in rows],
        test_auc=[r["test"] for r in rows],
        gpu_vs_cpu={k: gap[k] for k in GAP_KEYS})
    return counts


# The zoo on Frappe with the CLI defaults (the ensemble-capable models of
# the earlier phases, then the rest): {model: (epochs, the JAX package's
# best valid AUC over those epochs)}, from `python train.py --model <m>
# --dataset frappe --data_dir data/ --epoch 20 --patience 20 --seed 2025`
# on the CPU (a constant learning rate, so its first n epochs are an
# n-epoch run); the port's run at the same seed is held to it less 0.02.
# 2 epochs where the JAX run is past 0.9 after 2; for the models with a
# first-order term, whose N(0, 1) linear weights keep the AUC near 0.5
# for the first epochs, the fewest epochs after which its best is within
# 0.01 of its 20-epoch best (lr, still rising at 20, and afm all 20), so
# that every floor is far above the 0.5 of a constant or random score.
FRAPPE_ZOO = {
    "afn": (2, 0.9286), "sa_glu": (2, 0.9171), "lr": (20, 0.6298),
    "fm": (13, 0.9250), "hofm": (8, 0.9297), "afm": (20, 0.8864),
    "nfm": (6, 0.9329), "dnn": (2, 0.9293), "wd": (6, 0.9428),
    "dfm": (6, 0.9429), "ipnn": (2, 0.9291), "kpnn": (2, 0.9293),
    "dcn": (2, 0.9158), "dcn+": (2, 0.9278), "cin": (9, 0.9381),
    "xdfm": (6, 0.9425), "gcn": (2, 0.9065), "gat": (2, 0.9169)}


def phase_frappe_zoo(tmp):
    """Each FRAPPE_ZOO model with the CLI defaults on data/frappe/ for its
    epochs (train_run; the step against the CPU on the first CPU_ROWS
    rows): launches (K7 once per table a step, tables; K8's for cin and
    xdfm, cin_want; no entmax, K5 or K6), valid and test AUC per epoch,
    the best valid AUC at least the JAX package's over the same epochs
    (FRAPPE_ZOO) less 0.02; then predict of the run's best checkpoint on
    the test file (no kernel launch but K8's forward) with GPU vs CPU
    logits of its first batch. For AFN the main
    table's minimum at every forward of the run, train and eval, at least
    1e-4 (the positivity transform at the head of each step and before
    each eval pass)."""
    from armnet_tpu_torch.models.afn import AFN, POSITIVE_MIN

    data = os.path.join(REPO, "data")
    inp = os.path.join(data, "frappe", "test.libsvm")
    (train, valid, test), first = split_batches("frappe", 10, 4096)
    cut = {k: v[:CPU_ROWS] for k, v in first.items()}
    totals = dict.fromkeys(read_counts(), 0)

    for model, (epochs, jax_valid) in FRAPPE_ZOO.items():
        steps, evals = epochs * train, epochs * (valid + test)
        mins = []

        def record(module, args):
            if isinstance(module, AFN):
                mins.append(module.embedding.detach().amin())

        def auc_floor(rows):
            best = max(r["valid"] for r in rows)
            check(best >= jax_valid - 0.02,
                  f"{model} Frappe valid AUC {[r['valid'] for r in rows]}: "
                  f"best {best} < the JAX package's {jax_valid} - 0.02")

        hook = torch.nn.modules.module.register_module_forward_pre_hook(
            record)
        flags = ["--model", model, "--batch_size", "4096"]
        cin = cin_want(flags_config(flags), 4096)
        try:
            counts, rows, gap, seconds, cfg = train_run(
                tmp, f"frappe_{model}", flags, data, "frappe", cut, epochs,
                zoo_want(steps, evals, 0, tables(model), cin,
                         bn_wide(flags_config(flags))), auc_floor)
        finally:
            hook.remove()
        least = (float(torch.stack([m.cpu() for m in mins]).min()) if mins
                 else None)
        if model == "afn":
            # train steps, eval batches, and gpu_vs_cpu_step's forwards
            check(len(mins) >= steps + evals and least >= np.float32(
                POSITIVE_MIN), f"AFN table minimum {least} over "
                               f"{len(mins)} forwards")
        ckpt = os.path.join(tmp, "ckpt", f"frappe_{model}_{SEED}")
        with timed("frappe_zoo.predict"):
            scored, _ = run_predict(ckpt, inp, os.path.join(
                tmp, f"frappe_{model}.scores"), 14430, None, cin[0])
            err = first_batch_logit_err(ckpt, cfg, inp)
        log("frappe_zoo", model=model, steps=steps, eval_batches=evals,
            launches=counts, per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds,
            valid_auc=[r["valid"] for r in rows],
            test_auc=[r["test"] for r in rows],
            train_auc=[r["train"] for r in rows],
            epochs=epochs, jax_valid_floor=jax_valid - 0.02,
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "rows_per_s": scored["rows"]
                          / scored["score_seconds"]},
            gpu_vs_cpu_logit_err=err,
            table_min_over_forwards=least, forwards=len(mins),
            gpu_vs_cpu={k: gap[k] for k in GAP_KEYS})
        for k in totals:
            totals[k] += counts[k]
    return totals


def phase_criteo_zoo(tmp, data, first, inp):
    """xdfm and dfm at Criteo geometry (nfeat 2.1M, 39 fields, batch 4096,
    the other widths at the CLI defaults: nemb 10, CIN 3 x 128, MLP
    2 x 256) on the synthetic Criteo split: cli.main for 2 epochs of
    TRAIN_BATCHES batches (train_run: K7 twice a step, the table's and
    FeaturesLinear's E = 1 into 2.1M rows, and xdfm's K8; falling finite
    losses; the step against the CPU on the first CPU_ROWS rows), predict
    of the best checkpoint on the 10,000-row serving file (no kernel
    launch but xdfm's K8 forward) with GPU
    vs CPU logits, the peak device memory of the run and warm train
    rows/s (printed, not claimed)."""
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    cut = {k: v[:CPU_ROWS] for k, v in first.items()}
    totals = dict.fromkeys(read_counts(), 0)
    for model in ("xdfm", "dfm"):
        exp = f"cr_{model}"
        flags = ["--model", model, "--nfeat", str(CRITEO_NFEAT), "--nfield",
                 "39", "--batch_size", "4096"]
        cin = cin_want(flags_config(flags), 4096)
        torch.cuda.reset_peak_memory_stats()
        counts, rows, gap, seconds, cfg = train_run(
            tmp, exp, flags, data, "criteo", cut, 2,
            zoo_want(steps, evals, 0, tables(model), cin,
                     bn_wide(flags_config(flags))))
        peak = torch.cuda.max_memory_allocated()
        ckpt = os.path.join(tmp, "ckpt", f"{exp}_{SEED}")
        with timed(f"{exp}.predict"):
            runs = [run_predict(ckpt, inp, os.path.join(
                tmp, f"{exp}.scores"), 10_000, None, cin[0])[0]
                for _ in range(2)]
            err = first_batch_logit_err(ckpt, cfg, inp)
        with timed(f"{exp}.warm_rate"):
            rates, ms_step, trainer = warm_train_rate(cfg, data, epochs=3)
        del trainer
        torch.cuda.empty_cache()
        log("criteo_zoo", model=model, nfeat=cfg.nfeat, nfield=cfg.nfield,
            nemb=cfg.nemb, h=cfg.h, k=cfg.k, steps=steps,
            eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, valid_auc=[r["valid"] for r in rows],
            peak_device_bytes=peak,
            serve_warm_rows_per_s=runs[-1]["rows"]
            / runs[-1]["score_seconds"],
            gpu_vs_cpu_logit_err=err, warm_rows_per_s=rates,
            warm_ms_per_step=ms_step,
            gpu_vs_cpu={k: gap[k] for k in GAP_KEYS})
        for k in totals:
            totals[k] += counts[k]
    return totals


# The JAX package on the CPU on write_uci_letter's file at the smoke's flags
# and seed: `python train.py --model <m> --kernels <k> --dataset letter
# --data_dir <dir> --batch_size 512 --valid_perc 0.1 --epoch 10 --patience
# 10 --seed 2025` (armnet under auto, armnet_1h under pallas-fused, its
# fused kernels in Pallas interpret mode there): {model: (best valid
# accuracy, test accuracy at that epoch, best train accuracy)}. Valid and
# test sit at chance (0.04) for 3 epochs while train accuracy climbs:
# arm_bn's running variance decays from 1 toward the ~1e-8 batch variance
# of exp(z) by 0.9 a step, so eval scores are flat until ~70 steps; from
# epoch 6 valid holds 0.76-0.79.
UCI_JAX = {"armnet": (0.781, 0.7943, 0.845889),
           "armnet_1h": (0.785, 0.7894, 0.850556)}
UCI_FLAGS = ["--batch_size", str(UCI_BATCH), "--valid_perc", "0.1"]
# 10 epochs (180 steps), not 5: over the first ~90 steps valid and test
# accuracy sit on arm_bn's running-variance transient (UCI_JAX's note),
# where one step's rounding moves them by several points (the port on
# the CPU read 0.353 / 0.3215 after 5 epochs against JAX's 0.373 /
# 0.3669, its train accuracy within 0.003 of JAX's at every epoch)
UCI_EPOCHS = 10


def phase_uci_train(tmp):
    """The UCI multi-class path at the letter geometry (write_uci_letter):
    cli.main for UCI_EPOCHS epochs of armnet at the CLI defaults (alpha
    1.7, 4 heads of 128, nemb 10, MLP 2 x 256, a 26-way head; K2/K4 at
    [512, 16, 512], K7 into 16 live rows of 5,500) and of armnet_1h under
    pallas-fused (K5 and K6 at 16 fields, alpha 1.7), --batch_size 512
    --valid_perc 0.1
    (train_run: launches, falling finite losses, one step against the CPU
    held with the channel-axis-1 BatchNorms pinned, as armnet's steps are;
    armnet_1h's unpinned step logged beside it: on an H100 a ReLU below
    mlp.norms.0 flipped there, mlp.norms.0.bias 3.6e-3 apart at a 16 u
    kappa of 2.0e-3, ROADMAP §3 fault 4); the best valid and test
    accuracy and the best train accuracy at least the JAX package's
    (UCI_JAX) less 0.02."""
    folder = write_uci_letter(os.path.join(tmp, "uci_data"))
    train, valid, test = uci_loader(folder, UCI_BATCH, valid_perc=0.1,
                                    seed=SEED)
    first = next(iter(BatchIterator(train.ds, UCI_BATCH)))
    steps = UCI_EPOCHS * len(train)
    evals = UCI_EPOCHS * (len(valid) + len(test))
    totals = dict.fromkeys(read_counts(), 0)
    for model, kernels in (("armnet", "auto"), ("armnet_1h", "pallas-fused")):
        jax_valid, jax_test, jax_train = UCI_JAX[model]

        def acc_floor(rows):
            best = max(rows, key=lambda r: r["valid"])
            got = (best["valid"], best["test"], max(r["train"] for r in rows))
            check(all(g >= w - 0.02 for g, w in zip(
                got, (jax_valid, jax_test, jax_train))),
                  f"UCI {model}: best valid, its test and the best train "
                  f"accuracy {got} below the JAX package's "
                  f"{UCI_JAX[model]} less 0.02")

        want = zoo_want(steps, evals, 1, 1, bns=1)
        if kernels == "pallas-fused":
            want.update(entmax_fwd=0, entmax_bwd=0, arm1h_fwd=steps + evals,
                        arm1h_bwd=steps)
        counts, rows, gap, seconds, cfg = train_run(
            tmp, f"uci_{model}", ["--model", model, "--kernels", kernels,
                                  *UCI_FLAGS],
            os.path.dirname(folder), "letter", first, UCI_EPOCHS, want,
            acc_floor, pinned=True if model == "armnet" else "both",
            enforce={True})
        check((cfg.noutput, cfg.nfield, cfg.nfeat)
              == (UCI_CLASSES, UCI_FIELDS, UCI_NFEAT),
              f"UCI run's config {cfg.noutput, cfg.nfield, cfg.nfeat}")
        log("uci_train", model=model, kernels=kernels, rows=UCI_ROWS,
            nfield=cfg.nfield, nclass=cfg.noutput, nfeat=cfg.nfeat,
            steps=steps, eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, train_acc=[r["train"] for r in rows],
            valid_acc=[r["valid"] for r in rows],
            test_acc=[r["test"] for r in rows],
            jax_valid_test_train=list(UCI_JAX[model]),
            gpu_vs_cpu={k: gap[k] for k in GAP_KEYS + ("pinned",)
                        if k in gap})
        for k in totals:
            totals[k] += counts[k]
    return totals


# The JAX package's best valid AUC over 2 epochs on the CPU, `python
# train.py <preset's flags> [--kernels pallas-fused] --batch_size 4096
# --dataset frappe --data_dir data/ --epoch 2 --patience 2 --seed 2025
# --bf16` (the fused kernels in Pallas interpret mode there): {(preset,
# kernels): AUC}. In float32 the same armnet_1h run reads 0.847645 after 2
# epochs (FRAPPE_JAX_VALID, the second epoch of a run with --epoch 3).
BF16_JAX = {("frappe_armnet1h", "auto"): 0.839723,
            ("frappe_armnet1h", "pallas-fused"): 0.905903,
            ("frappe_armnet", "auto"): 0.912682}


def phase_bf16(tmp, smi):
    """--bf16 on Frappe: frappe_armnet1h under auto and pallas-fused and
    frappe_armnet, 2 epochs each (train_run: launches, falling finite
    losses; the step against the CPU with the loss within BF16_LOSS_RTOL
    and the kernels held to their plain versions at their boundary,
    unpinned and pinned), every Embedding's output bfloat16 and the MLP
    head's input in the JAX model's dtype (float32 behind the promoting
    gate products of the composed paths, bfloat16 behind the fused
    kernel's cast back), the best valid AUC at least the JAX package's
    (BF16_JAX) less 0.02, and the same run's in float32 beside it; the
    share of arm_bn's channels whose batch variance is 0 in the first
    three train steps (logged); predict of the best checkpoint, which
    restores bf16 from the sidecar (its Embedding outputs bfloat16, its
    scores within 5e-3 of the bfloat16 model's on the card); then peak
    device memory and warm rows/s of each against the same run in
    float32, on one card (printed, not claimed)."""
    from armnet_tpu_torch.ops.layers import MLP, BatchNorm, Embedding

    data = os.path.join(REPO, "data")
    inp = os.path.join(data, "frappe", "test.libsvm")
    (train, valid, test), first = split_batches("frappe", 10, 4096)
    cut = {k: v[:CPU_ROWS] for k, v in first.items()}
    steps, evals = 2 * train, 2 * (valid + test)
    totals = dict.fromkeys(read_counts(), 0)
    for preset, kernels, head in (
            ("frappe_armnet1h", "auto", torch.float32),
            ("frappe_armnet1h", "pallas-fused", torch.bfloat16),
            ("frappe_armnet", "auto", torch.float32)):
        exp = f"bf16_{preset}_{kernels}"
        emb_dtypes, head_dtypes, flat_share = set(), set(), []

        def record(module, args, out):
            if isinstance(module, Embedding):
                emb_dtypes.add(out.dtype)
            elif isinstance(module, MLP):
                head_dtypes.add(args[0].dtype)
            elif (isinstance(module, BatchNorm) and module.training
                  and module.channel_axis == 1 and len(flat_share) < 3):
                # arm_bn in the run's first train steps: the share of its
                # channels whose batch variance is 0 (exp(z) near 1.0
                # rounds to one bfloat16 value)
                x = args[0].float().movedim(1, 0).flatten(1)
                flat_share.append(float((x.var(1) == 0).float().mean()))

        def auc_floor(rows):
            best = max(r["valid"] for r in rows)
            check(best >= BF16_JAX[preset, kernels] - 0.02,
                  f"{exp} valid AUC {[r['valid'] for r in rows]}: best "
                  f"{best} < the JAX package's {BF16_JAX[preset, kernels]}"
                  f" - 0.02")

        # arm_bn's input is the MLP head's dtype: float32 behind the
        # composed gate products (K9), bfloat16 behind K5 (composed ops)
        want = zoo_want(steps, evals, 1, 1, bns=int(head == torch.float32))
        score_kernel = "entmax_fwd"
        if kernels == "pallas-fused":
            want.update(entmax_fwd=0, entmax_bwd=0, arm1h_fwd=steps + evals,
                        arm1h_bwd=steps)
            score_kernel = "arm1h_fwd"
        flags = preset_flags(preset, kernels, "--bf16")
        hook = torch.nn.modules.module.register_module_forward_hook(record)
        try:
            counts, rows, gap, seconds, cfg = train_run(
                tmp, exp, flags, data, "frappe", cut, 2, want, auc_floor,
                pinned="both" if "1h" in preset else True)
        finally:
            hook.remove()
        check(cfg.bf16 and emb_dtypes == {torch.bfloat16}
              and head_dtypes == {head},
              f"{exp}: Embedding outputs {emb_dtypes}, MLP inputs "
              f"{head_dtypes} (expected bfloat16, {head})")
        ckpt = os.path.join(tmp, "ckpt", f"{exp}_{SEED}")
        out = os.path.join(tmp, f"{exp}.scores")
        emb_dtypes.clear()
        hook = torch.nn.modules.module.register_module_forward_hook(record)
        try:
            with timed("bf16.predict"):
                scored, score_launches = run_predict(ckpt, inp, out, 14430,
                                                     score_kernel)
        finally:
            hook.remove()
        lg = first_batch_logits(ckpt, cfg, inp, "cuda")
        want_p = torch.sigmoid(lg.float()).numpy()
        got_p = np.loadtxt(out, max_rows=len(want_p))
        err = float(np.abs(got_p - want_p).max())
        # predict restored bf16 from the sidecar: its Embedding outputs are
        # bfloat16, and its scores are the bf16 model's (a bfloat16 GEMM
        # of another batch size may round an ulp apart: 5e-3 a probability)
        check(emb_dtypes == {torch.bfloat16} and err <= 5e-3,
              f"{exp}: predict's Embedding outputs {emb_dtypes}, scores "
              f"{err} from the bf16 model's on the card")
        with timed("bf16.f32_run"):
            _, f32_counts, _ = run_cli(preset_flags(preset, kernels) + [
                "--dataset", "frappe", "--data_dir", data, "--epoch", "2",
                "--patience", "2", "--seed", str(SEED), "--exp_name",
                f"f32_{preset}_{kernels}", "--log_dir",
                os.path.join(tmp, "log"), "--device", "cuda"])
        with open(os.path.join(tmp, "log", f"f32_{preset}_{kernels}_{SEED}",
                               "metrics.jsonl")) as f:
            f32_valid = [json.loads(line)["valid"] for line in f]
        rate = {}
        for dtype_flags in ([], ["--bf16"]):
            run_cfg = flags_config(preset_flags(preset, kernels,
                                                *dtype_flags))
            torch.cuda.reset_peak_memory_stats()
            with timed("bf16.warm_rate"):
                rates, ms_step, trainer = warm_train_rate(
                    run_cfg, data, epochs=3, dataset="frappe", nfield=10)
            rate["bf16" if dtype_flags else "f32"] = {
                "peak_device_bytes": torch.cuda.max_memory_allocated(),
                "warm_rows_per_s": rates, "warm_ms_per_step": ms_step}
            del trainer
            torch.cuda.empty_cache()
        log("bf16", preset=preset, kernels=kernels, steps=steps,
            eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, embedding_dtype=str(emb_dtypes),
            mlp_input_dtype=str(head_dtypes),
            arm_bn_zero_variance_share_first_steps=flat_share,
            valid_auc=[r["valid"] for r in rows],
            test_auc=[r["test"] for r in rows], f32_valid_auc=f32_valid,
            jax_valid_floor=BF16_JAX[preset, kernels] - 0.02,
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "launches": score_launches,
                          "vs_bf16_model_max_abs": err},
            against_f32=rate, device=smi,
            gpu_vs_cpu={k: gap[k] for k in GAP_KEYS + (
                "kernels_at_boundary_max_rel_gap", "pinned") if k in gap})
        for k in totals:
            totals[k] += counts[k] + f32_counts[k]
        totals[score_kernel] += score_launches
    return totals


def phase_entmax_alpha():
    """The learned-alpha entmax (a tensor alpha: the generic bisection and
    its VJP, torch ops on every device, as the JAX package runs it in XLA
    ops) on CUDA tensors at [4096, 39, 128] over axis 1, with a scalar
    alpha and a per-column alpha [1, 1, 128] in (1.2, 2.2): y within 1e-5
    elementwise of the same function on the CPU, dx and dalpha within 1e-5
    of their norms (the card's and the CPU's powf round apart: at alpha
    near 1.2, p = z^5, elementwise dx read 3.1e-5 apart on an H100;
    dalpha sums up to 524,288 columns); no kernel launches; the card's
    wall ms of forward and backward."""
    from armnet_tpu_torch.ops.entmax import entmax_bisect

    g = torch.Generator().manual_seed(SEED + 9)
    x = torch.randn(CRITEO_SHAPE, generator=g) * 3.0
    dy = torch.randn(CRITEO_SHAPE, generator=g)
    for kind, alpha in (("scalar", torch.tensor(1.5)),
                        ("per_column", 1.2 + torch.rand(
                            (1, 1, CRITEO_SHAPE[2]), generator=g))):
        res = {}
        for device in ("cuda", "cpu"):
            xd = x.to(device, copy=True).requires_grad_()
            ad = alpha.to(device, copy=True).requires_grad_()
            zero_counts()
            t0 = time.perf_counter()
            y = entmax_bisect(xd, ad, axis=1)
            y.backward(dy.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (y.detach().cpu(), xd.grad.cpu(), ad.grad.cpu(),
                           (time.perf_counter() - t0) * 1e3, read_counts())
        (yg, dxg, dag, ms, counts), (yc, dxc, dac, cpu_ms, _) = (
            res["cuda"], res["cpu"])
        errs = {"y": float((yg - yc).abs().max()),
                "dx": float((dxg - dxc).abs().max()),
                "dx_rel": float((dxg - dxc).norm() / dxc.norm()),
                "dalpha_rel": float((dag - dac).norm() / dac.norm())}
        log("entmax_alpha", alpha=kind, shape=list(CRITEO_SHAPE), axis=1,
            alpha_shape=list(alpha.shape), **errs, launches=counts,
            card_ms=ms, cpu_ms=cpu_ms, dalpha_norm=float(dac.norm()),
            tol="y 1e-5 elementwise; dx and dalpha 1e-5 of their norms")
        check(all(v == 0 for v in counts.values()),
              f"learned-alpha entmax launched kernels: {counts}")
        check(errs["y"] <= 1e-5 and errs["dx_rel"] <= 1e-5
              and errs["dalpha_rel"] <= 1e-5,
              f"learned-alpha entmax, {kind} alpha, card vs CPU: {errs}")


DATA_ROWS = 100_000       # the data_path phase's Criteo-geometry file
MALFORMED_ROWS = 2_000    # its first rows, with malformed lines among them


def phase_data_path(tmp):
    """The parse routes on a DATA_ROWS-row Criteo-geometry file: seconds of
    the native parser's build, the native parser, the vectorized numpy
    parse, a cache miss (the
    native parse and the cache's publish) and a cache hit; equal arrays on
    every route and over 4 byte-range shards, and `native` as the route.
    Then its first MALFORMED_ROWS rows with malformed lines among them: the
    native parser skips them as the line-by-line parser does."""
    from armnet_tpu_torch.data import libsvm as dl
    from armnet_tpu_torch.data import native

    path = os.path.join(tmp, "data_path.libsvm")
    with timed("write_libsvm"):
        write_criteo_libsvm(path, DATA_ROWS, CRITEO_NFEAT, 39, SEED + 20)
    secs = {}

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    run("native_build", native.load)        # g++ at first use
    want, route = run("native", lambda: dl.parse_routed(
        path, 39, use_cache=False))
    check(route == "native", f"the parse took the {route} route")
    check(want[0].shape == (DATA_ROWS, 39), f"parsed {want[0].shape}")
    fast = run("numpy_fast", lambda: dl._parse_numpy_fast(path, 39))
    miss = run("cache_miss", lambda: dl.parse_routed(path, 39))
    hit = run("cache_hit", lambda: dl.parse_routed(path, 39))
    shards = run("native_4_shards", lambda: [
        dl._parse_native(path, 39, dl.shard_byte_range(path, i, 4))
        for i in range(4)])
    check((miss[1], hit[1]) == ("native", "cache"),
          f"cache routes {miss[1]}, {hit[1]}")
    joined = tuple(np.concatenate([p[k] for p in shards]) for k in range(3))
    for name, got in (("numpy_fast", fast), ("cache_miss", miss[0]),
                      ("cache_hit", hit[0]), ("native_4_shards", joined)):
        check(all(np.array_equal(g, w) for g, w in zip(got, want)),
              f"{name} arrays differ from the native parse")

    bad = os.path.join(tmp, "malformed.libsvm")
    with open(path) as f:
        lines = [next(f) for _ in range(MALFORMED_ROWS)]
    broken = ["1 3:0.5\n", "0 x:1 " + lines[0].split(" ", 1)[1],
              "1 " + " ".join(["4:1"] * 40) + "\n"]
    for i, line in enumerate(broken):
        lines.insert(500 * (i + 1), line)
    with open(bad, "w") as f:
        f.writelines(lines)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        nat, route = dl.parse_routed(bad, 39, use_cache=False)
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            robust = run("numpy_robust_malformed",
                         lambda: dl._parse_numpy_robust(bad, 39))
    check(route == "native" and nat[0].shape == (MALFORMED_ROWS, 39),
          f"malformed file: {route}, {nat[0].shape}")
    check(all(np.array_equal(g, w) for g, w in zip(nat, robust)),
          "native and line-by-line parses of the malformed file differ")
    check(all(np.array_equal(g, w[:MALFORMED_ROWS])
              for g, w in zip(nat, want)), "malformed file: rows differ")
    skips = [str(w.message) for w in caught if "malformed" in str(w.message)]
    check(len(skips) == 2 and all(f"skipped {len(broken)} malformed" in m
                                  for m in skips), f"warnings {skips}")
    check(printed.getvalue().count("incorrect data format") == len(broken),
          "the line-by-line parse printed another count")
    size = os.path.getsize(path)
    log("data_path", rows=DATA_ROWS, nfield=39, mbytes=size / 1e6,
        seconds=secs, native_mb_per_s=size / 1e6 / secs["native"],
        cache_hit_speedup=secs["native"] / secs["cache_hit"],
        malformed_skipped=len(broken), library=os.path.relpath(
            native.library_path(), REPO), cache_dir=dl.cache_dir())


# the bench's variants (kernels, ensemble): the headline at the bench's
# defaults, the others at BENCH_SHORT; the breakdown's and the recipes'
# flags
BENCH_SHORT = ["--reps", "3", "--steps", "50"]
BREAKDOWN_FLAGS = ["--model", "armnet_1h", "--reps", "3", "--steps", "30"]
HARNESS_TIMEOUT = 600


def harness_lines(module, argv):
    """The JSON lines that `python -m module argv` prints on stdout (a fresh
    process in the repo; its stderr passes through); raises where it exits
    non-zero or a line does not parse."""
    r = subprocess.run([sys.executable, "-m", module, *argv], cwd=REPO,
                       stdout=subprocess.PIPE, text=True,
                       timeout=HARNESS_TIMEOUT)
    check(r.returncode == 0, f"{module} {argv} exited {r.returncode}")
    return [json.loads(line) for line in r.stdout.splitlines()]


def check_timed(name, rec, keys):
    """Each of `keys` of rec and of its step_ms finite and > 0, the idle
    share in [0, 1)."""
    vals = {k: rec[k] for k in keys}
    vals.update({f"step_ms.{k}": v for k, v in rec["step_ms"].items()})
    bad = {k: v for k, v in vals.items()
           if not (isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
    check(not bad, f"{name}: not finite and > 0: {bad}")
    check(0.0 <= rec["idle_share"] < 1.0,
          f"{name}: idle share {rec['idle_share']}")


def want_per_step(kernels, tables, backward=True):
    """The port's launches per train step of armnet_1h under `kernels`:
    K2 and K4 (auto) or K5 and K6 (pallas-fused), K7 `tables` times and K9
    for arm_bn; without the backward (the breakdown's fwd subset, in eval
    mode) the interaction's forward kernel only, arm_bn on the composed
    ops."""
    fused = kernels == "pallas-fused"
    return {"entmax_fwd": 0 if fused else 1,
            "entmax_bwd": 0 if fused or not backward else 1,
            "table_grad": tables,
            "arm1h_fwd": 1 if fused else 0,
            "arm1h_bwd": 1 if fused and backward else 0,
            "cin_fwd": 0, "cin_bwd": 0, **bn_want(1, int(backward))}


def phase_bench():
    """The harness on the card, each script in fresh processes: the bench's
    four variants (--all's, headline last, at the defaults, the others at
    BENCH_SHORT), the step breakdown of armnet_1h under both kernel choices
    and the recipes' --quick rows; every line parses, every time and rate
    is finite and > 0, and the launches per step are the step's: one K2
    and one K4 (auto) or one K5 and one K6 (pallas-fused), K7 once a table,
    none in fwd and fwd_bwd_dense, and arm_bn's K9 forward and backward,
    none in fwd (eval mode)."""
    from armnet_tpu_torch.bench import VARIANTS
    from armnet_tpu_torch.benchmarks.step_breakdown import SUBSETS

    rate_keys = ("value", "min", "max", "device_ms_per_step")
    for kernels, ensemble in VARIANTS:
        headline = (kernels, ensemble) == VARIANTS[-1]
        argv = (["--kernels", kernels] + (["--ensemble"] if ensemble else [])
                + ([] if headline else BENCH_SHORT))
        with timed(f"bench.{kernels}{'+' if ensemble else ''}"):
            lines = harness_lines("armnet_tpu_torch.bench", argv)
        check(len(lines) == 1, f"bench {argv}: {len(lines)} lines")
        rec = lines[0]
        log("bench", **rec)
        check_timed(f"bench {argv}", rec, rate_keys)
        check(math.isfinite(rec["loss_last"]), f"bench loss {rec}")
        check(not headline or (rec["reps"], rec["steps"]) == (5, 100),
              f"headline at {rec['reps']} x {rec['steps']}")
        want = want_per_step(kernels, 2 if ensemble else 1)
        check(rec["launches"] == want,
              f"bench {argv}: launches per step {rec['launches']}, "
              f"expected {want}")
    for kernels in ("auto", "pallas-fused"):
        with timed(f"bench.breakdown.{kernels}"):
            rows = harness_lines("armnet_tpu_torch.benchmarks.step_breakdown",
                                 BREAKDOWN_FLAGS + ["--kernels", kernels])
        check([r["subset"] for r in rows] == list(SUBSETS),
              f"breakdown subsets {[r['subset'] for r in rows]}")
        for r in rows:
            log("bench_breakdown", **r)
            check_timed(f"breakdown {kernels} {r['subset']}", r,
                        ("device_ms_per_step",))
            dense = r["subset"] in ("fwd", "fwd_bwd_dense")
            want = want_per_step(kernels, 0 if dense else 1,
                                 backward=r["subset"] != "fwd")
            check(r["launches"] == want,
                  f"breakdown {kernels} {r['subset']}: launches per step "
                  f"{r['launches']}, expected {want}")
    with timed("bench.recipes"):
        lines = harness_lines("armnet_tpu_torch.benchmarks.recipes",
                              ["--quick"])
    *rows, table = lines
    check(len(rows) == 2 and table["rows"] == rows,
          f"recipes --quick: {len(rows)} rows and {table.get('metric')}")
    for r in rows:
        log("bench_recipes", **r)
        check_timed(f"recipe {r['recipe']}", r,
                    ("ms_per_step", "examples_per_sec", "min", "max",
                     "device_ms_per_step"))
        check(r["launches"] == want_per_step("auto", 1),
              f"recipe {r['recipe']}: launches per step {r['launches']}")


# the benchmark modules' depth in the smoke: one warm call, two timed
# repetitions of three calls (the profiled repetition: three calls)
BENCHMARK_FLAGS = ["--warm", "1", "--steps", "3", "--reps", "2"]
# mh_breakdown's stages that normalize with a kernel (alpha 2): the entmax
# forward (K1 on the last axis, K2 on the fields-major gates) once a call,
# the backward's VJP (K3, K4) once more in each *_bwd of them
MH_ENTMAX_STAGES = ("entmax_fwd", "entmax_bwd", "interaction_fwd",
                    "interaction_bwd", "interaction_fm_fwd",
                    "interaction_fm_bwd")


def check_stages(module, rows, names, launches):
    """The lines of a stage breakdown: one per stage of `names` in order,
    every time finite and > 0 (the device ms from the profiled repetition
    too), the launches per call launches(stage)."""
    check([r["stage"] for r in rows] == list(names),
          f"{module}: stages {[r['stage'] for r in rows]}")
    for r in rows:
        times = {f"step_ms.{k}": v for k, v in r["step_ms"].items()}
        times["device_ms_per_step"] = r["device_ms_per_step"]
        bad = {k: v for k, v in times.items() if not (
            isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
        check(not bad, f"{module} {r['stage']}: not finite and > 0: {bad}")
        want = {**dict.fromkeys(read_counts(), 0), **launches(r["stage"])}
        check(r["launches"] == want, f"{module} {r['stage']}: launches per "
                                     f"call {r['launches']}, expected {want}")


def last_axis_kernels():
    """K1 and K3 on the last axis of mh_breakdown's gates [4096, 4, 64, 39]
    (the (outer, d, inner) = (1048576, 39, 1) view), in this process: its
    entmax_fwd and entmax_bwd stages launched with the counts set to 0
    just before and read just after, their outputs held to the plain
    versions on the card at the kernel phases' tolerances (max abs 5e-6
    forward and 2e-5 backward, and within KERNELS_VS_PLAIN_RTOL of their
    norms), then timed beside the plain versions and the bounds. Returns
    (launches, {"fwd"|"bwd": record})."""
    from armnet_tpu_torch.benchmarks import mh_breakdown

    inp = mh_breakdown.inputs(device="cuda")
    stages = dict(mh_breakdown.stages(inp))
    g0, alpha = inp["gates"], mh_breakdown.ALPHA
    zero_counts()
    (y,) = stages["entmax_fwd"]()
    (dx,) = stages["entmax_bwd"]()
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts == {**dict.fromkeys(counts, 0), "entmax_fwd": 2,
                     "entmax_bwd": 1},
          f"entmax_fwd and entmax_bwd stages launched {counts}")
    outer, d = math.prod(g0.shape[:-1]), g0.shape[-1]
    view, numel = [outer, d, 1], g0.numel()
    recs = {}
    for kind, got, plain, kernel, tol, (bound_ms, by) in (
            ("fwd", y, lambda: entmax_cuda.entmax_plain(g0, alpha, -1),
             lambda: entmax_cuda.entmax_kernel(g0, alpha, -1), 5e-6,
             entmax_bound_ms(view, alpha)),
            ("bwd", dx, lambda: entmax_cuda.entmax_bwd_plain(y, g0, alpha,
                                                              -1),
             lambda: entmax_cuda.entmax_bwd_kernel(y, g0, alpha, -1), 2e-5,
             bound(3 * 4 * numel,
                   entmax_bwd_ops_per_element(alpha) * numel))):
        want = plain()
        err = float((got - want).abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol
              and within(got - want, want, KERNELS_VS_PLAIN_RTOL, 0.0),
              f"entmax_{kind} kernel vs plain on the last axis {view}: max "
              f"abs err {err} (tol {tol})")
        recs[kind] = {"shape": view, "alpha": alpha,
                      "stages": "mh_breakdown entmax_fwd, entmax_bwd",
                      "launches": counts[f"entmax_{kind}"],
                      "max_abs_err": err, "tol": tol,
                      "ms": time_ms(kernel),
                      "plain_ms": time_ms(plain, PLAIN_REPS, 1),
                      "bound_ms": bound_ms, "bound_by": by}
    recs["fwd"]["route"] = entmax_cuda.route_for(d, 1, outer, alpha)
    recs["fwd"]["blocks_per_sm"] = entmax_cuda.fwd_blocks_per_sm(
        d, 1, outer, alpha)
    recs["bwd"]["route"] = entmax_cuda.bwd_route_for(d, 1)
    recs["bwd"]["blocks_per_sm"] = entmax_cuda.bwd_blocks_per_sm(d, alpha, 1)
    for kind in recs:
        log("benchmarks", name=f"entmax_{kind}", last_axis=recs[kind])
    return counts, recs


def phase_benchmarks():
    """The rest of the harness (armnet_tpu_torch/benchmarks/): K1 and K3 on
    the last axis held and timed in this process (last_axis_kernels), the
    table_grad stage of tablegrad_breakdown held to index_add_ on the card;
    then each module in a fresh process at BENCHMARK_FLAGS' depth:
    mh_breakdown (every stage, the launches of each), tablegrad_breakdown
    and tablegrad_prep_bench (K7 once in each table-gradient stage, and the
    split), fastpow_accuracy (the kernel at its compiled budget within
    REL of the newton build's worst at each alpha, the plain solver's (12,
    4) passing), scaling --max_devices 1 (one row) and paired_ab (one A/A
    pair of the bench at BENCH_SHORT: the ratio). Returns (launches of the
    in-process stages, the K1/K3 records)."""
    from armnet_tpu_torch.benchmarks import mh_breakdown, tablegrad_prep_bench
    from armnet_tpu_torch.benchmarks import tablegrad_breakdown as tb

    with timed("benchmarks.last_axis"):
        counts, last_axis = last_axis_kernels()
    ids, g = tb.inputs(device="cuda")
    zero_counts()
    (got,) = dict(tb.stages(ids, g, tb.NROWS))["full"]()
    torch.cuda.synchronize()
    tg_counts = read_counts()
    check(tg_counts["table_grad"] == 1, f"full launched {tg_counts}")
    counts = {k: v + tg_counts[k] for k, v in counts.items()}
    card = scatter_cuda.table_grad_plain(g, ids, tb.NROWS)
    spread = scatter_cuda.table_grad_plain(g.abs(), ids, tb.NROWS)
    err = float((got - card).abs().max())
    check(bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all()),
          f"tablegrad full vs index_add_ on the card: max abs err {err}")
    log("benchmarks", name="tablegrad_full", max_abs_err_vs_index_add=err,
        launches=tg_counts)
    module = "armnet_tpu_torch.benchmarks."
    with timed("benchmarks.mh_breakdown"):
        rows = harness_lines(module + "mh_breakdown", BENCHMARK_FLAGS)
    check_stages("mh_breakdown", rows, mh_breakdown.STAGES, lambda s: {
        "entmax_fwd": int(s in MH_ENTMAX_STAGES),
        "entmax_bwd": int(s in MH_ENTMAX_STAGES and s.endswith("_bwd"))})
    for r in rows:
        log("benchmarks_mh", **r)
    with timed("benchmarks.tablegrad"):
        rows = harness_lines(module + "tablegrad_breakdown", BENCHMARK_FLAGS)
        *prep, split = harness_lines(module + "tablegrad_prep_bench",
                                     BENCHMARK_FLAGS)
    check_stages("tablegrad_breakdown", rows, tb.STAGES,
                 lambda s: {"table_grad": int(s == "full")})
    check_stages("tablegrad_prep_bench", prep, tablegrad_prep_bench.STAGES,
                 lambda s: {"table_grad": int(s.startswith(("kernel_",
                                                             "reshape")))})
    check(split["stage"] == "k7_split" and all(
        split[k] > 0 for k in ("whole_ms", "sort_ms", "kernel_ms",
                               "library_ms")), f"k7_split: {split}")
    for r in rows + prep + [split]:
        log("benchmarks_tablegrad", **r)
    with timed("benchmarks.fastpow_accuracy"):
        *solvers, summary = harness_lines(module + "fastpow_accuracy", [])
    for r in solvers:
        log("benchmarks_fastpow", **r)
    log("benchmarks_fastpow", **summary)
    check(summary["kernel_ok"] and all(summary["kernel_ok_by_alpha"].values())
          and [12, 4] in [r["budget"] for r in solvers
                          if r["solver"] == "plain_fastpow" and r["ok"]],
          f"fastpow_accuracy: the kernel or (12, 4) misses the newton bar: "
          f"{summary}")
    with timed("benchmarks.scaling"):
        *rows, table = harness_lines(module + "scaling", [
            "--max_devices", "1", "--warm", "5", "--steps", "20", "--reps",
            "3"])
    check(len(rows) == 1 and table["rows"] == rows
          and rows[0]["devices"] == 1 and rows[0]["examples_per_sec"] > 0
          and rows[0]["launches"] == want_per_step("auto", 1),
          f"scaling --max_devices 1: {rows}")
    log("benchmarks_scaling", **table)
    with timed("benchmarks.paired_ab"):
        (ab,) = harness_lines(module + "paired_ab", [
            "--a", "", "--b", "", "--pairs", "1", "--cmd",
            f"{sys.executable} -m armnet_tpu_torch.bench "
            + " ".join(BENCH_SHORT)])
    check(len(ab["ratios"]) == 1 and math.isfinite(ab["median_ratio"])
          and ab["median_ratio"] > 0, f"paired_ab A/A: {ab}")
    log("benchmarks_paired_ab", **ab)
    return counts, last_axis


def phase_feeds(data):
    """Warm train rows/s of cr_armnet1h (ensemble off, auto) on the
    synthetic Criteo split, each batch gathered from the card's resident
    rows, fed through the iterator's streaming lookahead, through it with
    the prefetch thread, and copied at the head of its step (the loop
    before the lookahead), in the order A B C D D C B A in this call;
    and the lookahead trainer's train-step profile (host share)."""
    cfg = criteo_config(False)
    rates = {feed: [] for feed in FEEDS}
    for feed in FEEDS + FEEDS[::-1]:
        r, _, trainer = warm_train_rate(cfg, data, feed=feed)
        rates[feed] += r
        del trainer
        torch.cuda.empty_cache()
    med = {feed: float(np.median(r)) for feed, r in rates.items()}
    log("feeds", width="cr_armnet1h", warm_rows_per_s=rates,
        median_rows_per_s=med,
        resident_over_lookahead=med["resident"] / med["lookahead"],
        lookahead_over_head_copy=med["lookahead"] / med["head_copy"],
        thread_over_lookahead=med["thread"] / med["lookahead"])


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def sharded_steps(first):
    """A one-process NCCL group in this process: cr_armnet1h's table cut
    by shard_tables on a model axis of 1 (each exchange's collectives run
    over the one rank), one train step a exchange through
    make_train_step(mesh) against the replicated step on the same batch
    and weights: loss within 1e-6 relative, K7 once a step (into the
    shard's R = nfeat / 1 rows), arm_bn's K9 once a step (its sums over
    the one rank). Returns the launches."""
    import torch.distributed as dist

    from armnet_tpu_torch.parallel.mesh import make_mesh
    from armnet_tpu_torch.parallel.sharding import shard_tables
    from armnet_tpu_torch.train.step import (create_train_state,
                                             init_meters, make_train_step)

    cfg = criteo_config(False)
    batch = {k: v.to("cuda") for k, v in first.items()}
    base = create_model(cfg, seed=SEED, device="cuda").state_dict()

    def step(mesh=None, exchange=None):
        model = create_model(cfg, seed=SEED, device="cuda")
        model.load_state_dict(base)
        if mesh is not None:
            names = shard_tables(model, mesh, cfg.nfeat, exchange, 2.0)
            check(names == ["embedding.weight"], f"sharded {names}")
        zero_counts()
        m = make_train_step(mesh=mesh)(create_train_state(model, cfg.lr),
                                       init_meters("cuda"), batch)
        torch.cuda.synchronize()
        return float(m["loss_last"]), read_counts()

    ref, _ = step()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    totals = dict.fromkeys(read_counts(), 0)
    try:
        mesh = make_mesh("data:1,model:1")
        for exchange in ("psum", "a2a"):
            loss, counts = step(mesh, exchange)
            check(counts == {**dict.fromkeys(counts, 0), "entmax_fwd": 1,
                             "entmax_bwd": 1, "table_grad": 1,
                             **bn_want(1, 1)},
                  f"{exchange} sharded step launched {counts}")
            check(abs(loss - ref) <= 1e-6 * abs(ref),
                  f"{exchange} sharded step loss {loss} against {ref}")
            log("sharded_step", exchange=exchange, mesh=mesh.shape,
                loss=loss, replicated_loss=ref, launches=counts)
            for k in totals:
                totals[k] += counts[k]
    finally:
        dist.destroy_process_group()
    return totals


def phase_distributed(tmp, data, first):
    """torchrun (one process, NCCL) of the training CLI at cr_armnet1h
    width, --mesh data:1,model:1 --shard_embedding, 2 epochs on the
    synthetic Criteo split, against cli.main of the same flags and seed in
    this process: the per-step losses as logged, the last checkpoint's
    parameters within 1e-6 and predict's logits of the valid file's first
    batch within 1e-5; then sharded_steps."""
    flags = criteo_flags(False) + [
        "--dataset", "criteo", "--data_dir", data, "--epoch", "2",
        "--patience", "5", "--report_freq", "1", "--seed", str(SEED),
        "--log_dir", os.path.join(tmp, "log"), "--ckpt_dir",
        os.path.join(tmp, "ckpt"), "--device", "cuda"]
    with timed("distributed.single"):
        _, counts, single_s = run_cli(flags + ["--exp_name", "dist_single"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", "armnet_tpu_torch.train", *flags,
           "--exp_name", "dist_torchrun", "--mesh", "data:1,model:1",
           "--shard_embedding"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    with timed("distributed.torchrun"):
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=600)
    torchrun_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun exited {proc.returncode}:\n"
                                f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    logs = {exp: os.path.join(tmp, "log", f"{exp}_{SEED}", "stdout.log")
            for exp in ("dist_single", "dist_torchrun")}
    losses = {exp: train_losses(path)[0] for exp, path in logs.items()}
    check(losses["dist_single"] == losses["dist_torchrun"]
          and len(sum(losses["dist_single"], [])) == 2 * TRAIN_BATCHES,
          f"per-step losses differ: {losses}")
    with open(logs["dist_torchrun"]) as f:
        text = f.read()
    check("mesh {'data': 1, 'model': 1}" in text and "read by" in text,
          "the torchrun log lacks its mesh or parse line")
    ckpts = {exp: os.path.join(tmp, "ckpt", f"{exp}_{SEED}")
             for exp in logs}
    states = {exp: load_checkpoint(c, "last")[0] for exp, c in ckpts.items()}
    param_gap = max(float((states["dist_single"][k]
                           - states["dist_torchrun"][k]).abs().max())
                    for k in states["dist_single"])
    check(param_gap <= 1e-6, f"last checkpoints differ by {param_gap}")
    cfg = criteo_config(False)
    valid = os.path.join(data, "criteo", "valid.libsvm")
    logits = {exp: first_batch_logits(c, cfg, valid, "cuda")
              for exp, c in ckpts.items()}
    logit_gap = float((logits["dist_single"]
                       - logits["dist_torchrun"]).abs().max())
    check(logit_gap <= 1e-5, f"predict logits differ by {logit_gap}")
    with timed("distributed.sharded_steps"):
        sharded = sharded_steps(first)
    log("distributed", command=" ".join(cmd[1:8]) + " ...", steps=2 *
        TRAIN_BATCHES, losses_equal=True, param_max_abs_gap=param_gap,
        logit_max_abs_gap=logit_gap, single_cli_seconds=single_s,
        torchrun_seconds=torchrun_s, single_launches=counts,
        sharded_step_launches=sharded)
    for k in counts:
        counts[k] += sharded[k]
    return counts, sharded


def main():
    smi = phase_device()
    # full-f32 GEMMs on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with timed("build"):
        phase_build()
    with timed("kernel"):
        fwd_all = phase_kernel()
    with timed("kernel_bwd"):
        bwd_all = phase_kernel_bwd()
    fwd, bwd = fwd_all[2.0], bwd_all[2.0]         # cr_armnet1h's alpha
    with timed("kernel_table_grad"):
        tg = phase_kernel_table_grad()
    with timed("kernel_arm"):
        arm = phase_kernel_arm()
    with timed("kernel_multihead"):
        mh = phase_kernel_multihead()
    with timed("kernel_cin"):
        cin = phase_kernel_cin()
    with timed("kernel_bn"):
        bn = phase_kernel_bn()
    with tempfile.TemporaryDirectory() as tmp:
        # the row cache of every phase's parses lives and dies with tmp
        os.environ["ARMNET_CACHE_DIR"] = os.path.join(tmp, "row_cache")
        with timed("data_path"):
            phase_data_path(tmp)
        with timed("serve"):
            inp, serve = phase_serve_criteo(tmp)
        with timed("serve_fused"):
            serve_fused = phase_serve_fused(tmp, inp)
        with timed("frappe"):
            serve += phase_serve_frappe(tmp)
        with timed("serve_armnet"):
            serve += phase_serve_armnet(tmp, inp)
        with timed("profile"):
            phase_profile(inp)
        data, first = criteo_split(tmp)
        with timed("train"):
            runs = [phase_train(tmp, data, first)]
        with timed("bench"):
            phase_bench()
        with timed("benchmarks"):
            bench_counts, last_axis = phase_benchmarks()
            runs.append(bench_counts)
        with timed("feeds"):
            phase_feeds(data)
        with timed("distributed"):
            dist_counts, sharded = phase_distributed(tmp, data, first)
            runs.append(dist_counts)
        with timed("train_armnet"):
            runs.append(phase_train_armnet(tmp, data, first))
        with timed("frappe_train"):
            runs.append(phase_frappe_train(tmp))
        with timed("diabetes_train"):
            runs.append(phase_diabetes_train(tmp))
        with timed("diabetes_parity"):
            runs.append(phase_diabetes_parity(tmp))
        with timed("diabetes_armnet"):
            runs.append(phase_diabetes_armnet(tmp))
        with timed("frappe_zoo"):
            runs.append(phase_frappe_zoo(tmp))
        with timed("criteo_zoo"):
            runs.append(phase_criteo_zoo(tmp, data, first, inp))
        with timed("uci_train"):
            runs.append(phase_uci_train(tmp))
        with timed("bf16"):
            runs.append(phase_bf16(tmp, smi))
    with timed("entmax_alpha"):
        phase_entmax_alpha()
    log("seconds", **SECONDS)
    log("profiler", empty_sessions=bench.EMPTY_SESSIONS,
        tries_per_profile=bench.PROFILE_TRIES)
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    launches["entmax_fwd"] += serve
    launches["arm1h_fwd"] += serve_fused
    arm_lines = [
        {"name": f"arm1h_{kind}", "route": "cuda",
         "source": f"armnet_tpu_torch/kernels/csrc/{source}",
         "replaces": f"armnet_tpu/kernels/arm_pallas.py:{line}",
         "launches": launches[f"arm1h_{kind}"],
         **arm[(kind, 2.0)], "library_ms": None,
         "shape": dict(zip("BFEDO", CRITEO_ARM)), "alpha": 2.0,
         "also_source": f"armnet_tpu_torch/kernels/csrc/{col}",
         "diabetes": {"shape": dict(zip("BFEDO", DIABETES_ARM)),
                      "alpha": 1.7, **arm[(kind, 1.7, "diabetes")]},
         "uci": {"shape": dict(zip("BFEDO", UCI_ARM)), "alpha": 1.7,
                 **arm[(kind, 1.7, "uci")]}}
        for kind, line, source, col in (
            ("fwd", 184, "arm1h.cu", "arm1h_col.cu"),
            ("bwd", 211, "arm1h_bwd.cuh", "arm1h_bwd_col.cu"))]

    def cin_err(kind, c):
        errs = cin[("check", c)]["errs"]
        return max(v for k, v in errs.items() if (k == "out") == (
            kind == "fwd"))

    cin_lines = [
        {"name": f"cin_{kind}", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/cin.cu",
         "replaces": None,
         "new": "the JAX package's CIN is XLA ops, with no Pallas kernel",
         "launches": launches[f"cin_{kind}"],
         "max_rel_err": cin_err(kind, 200),
         "ms": r["time_ms"], "host_incl_ms": r["host_incl_ms"],
         "plain_ms": r["plain_ms"], "plain_rows": r["plain_rows"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": None, "blocked_ms": r["blocked_ms"],
         "shape": r[f"cin_{kind}"],
         "layer0": {k: r0[k] for k in ("time_ms", "plain_ms", "blocked_ms",
                                       "bound_ms")} | {
             "shape": r0[f"cin_{kind}"],
             "max_rel_err": cin_err(kind, 39)}}
        for kind in ("fwd", "bwd")
        for r, r0 in ((cin[(kind, 200)], cin[(kind, 39)]),)]
    bn_lines = [
        {"name": f"bn_{kind}", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/batch_norm.cu",
         "replaces": None,
         "new": "the JAX package's BatchNorm is XLA ops, with no Pallas "
                "kernel",
         "launches": launches[f"bn_{kind}"],
         "library": "F.batch_norm in training mode (cuDNN), which the "
                    "port never calls",
         "shapes": {name: {k: bn[(kind, name)][k] for k in (
             "shape", "time_ms", "host_incl_ms", "plain_ms", "composed_ms",
             "library_ms", "bound_ms", "bound_by", "roofline_pct")} | {
             "max_rel_gap": max(bn[("check", name)]["rel_gaps"].values())}
             for name, _ in bench.BN_SHAPES}}
        for kind in ("fwd", "bwd")]
    crit, uci = tg["criteo_batch"], tg["uci_16_live"]
    zipf = {k[len("zipf_"):]: {"table_grad_ms": v["whole_ms"],
                               "library_ms": v["library_ms"]}
            for k, v in tg.items() if k.startswith("zipf_")}
    print(json.dumps({"kernels": [
        {"name": "entmax_fwd", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/entmax_fwd.cuh",
         "replaces": "armnet_tpu/kernels/entmax_pallas.py:151",
         "also_replaces": "armnet_tpu/kernels/entmax_pallas.py:40",
         "launches": launches["entmax_fwd"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "host_incl_ms": fwd["host_incl_ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": None,
         "shape": list(CRITEO_SHAPE), "alpha": 2.0,
         "bucket": entmax_cuda.route_for(39, 128, 4096, 2.0)[1],
         "frappe_ms": fwd["frappe_ms"],
         "frappe_bucket": entmax_cuda.route_for(10, 128, 4096, 2.0)[1],
         "also_source": "armnet_tpu_torch/kernels/csrc/entmax_fwd_column.cu",
         "diabetes": {"alpha": 1.7, **fwd_all[1.7]["diabetes"]},
         "d100": {"alpha": 2.0, **fwd["d100"]}, **mh["fwd"],
         "last_axis": last_axis["fwd"]},
        {"name": "entmax_bwd", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/entmax_bwd.cu",
         "replaces": "armnet_tpu/kernels/entmax_pallas.py:159",
         "also_replaces": "armnet_tpu/kernels/entmax_pallas.py:53",
         "launches": launches["entmax_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "host_incl_ms": bwd["host_incl_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None,
         "shape": list(CRITEO_SHAPE), "alpha": 2.0,
         "blocks_per_sm": bwd["blocks_per_sm"],
         "ms_by_alpha": {a: v["ms"] for a, v in bwd_all.items()},
         "frappe": {"alpha": 2.0, **bwd["frappe"]},
         "diabetes": {"alpha": 1.7, **bwd_all[1.7]["diabetes"]},
         "d100": {"alpha": 2.0, **bwd["d100"]}, **mh["bwd"],
         "last_axis": last_axis["bwd"]},
        {"name": "table_grad", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/table_grad.cu",
         "replaces": "armnet_tpu/kernels/scatter_pallas.py:122",
         "launches": launches["table_grad"],
         "max_abs_err": tg["max_abs_err"],
         "max_abs_err_vs_index_add_on_card":
             tg["max_abs_err_vs_index_add_on_card"], "ms": crit["kernel_ms"],
         "plain_ms": crit["plain_ms"], "bound_ms": crit["bound_ms"],
         "bound_by": crit["bound_by"], "library_ms": crit["library_ms"],
         "table_grad_ms_with_sort": crit["whole_ms"],
         "sharded_step_launches": sharded["table_grad"],
         "host_incl_ms": crit["whole_host_incl_ms"],
         "library_host_incl_ms": crit["library_host_incl_ms"],
         "table_grad_sort_ms": crit["sort_ms"],
         "table_grad_fill_ms": crit["fill_ms"],
         "table_grad_prep_ms": None,
         "table_grad_prep": "folded into the radix sort's first pass",
         "torch_prep_ms": crit["torch_prep_ms"],
         "torch_sort_ms": crit["torch_sort_ms"],
         "all_ids_equal_ms": tg["all_ids_equal"]["whole_ms"],
         "zipf": zipf,
         "shape": [4096 * 39, 10], "nrows": CRITEO_NFEAT,
         "zoo_widths": {f"e{e}": {
             "shape": [4096 * 39, e], "ms": w["kernel_ms"],
             "table_grad_ms_with_sort": w["whole_ms"],
             "host_incl_ms": w["whole_host_incl_ms"],
             "table_grad_sort_ms": w["sort_ms"], "plain_ms": w["plain_ms"],
             "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
             "library_ms": w["library_ms"],
             "library_host_incl_ms": w["library_host_incl_ms"]}
             for e in ZOO_WIDTHS for w in (tg[f"criteo_batch_e{e}"],)},
         "uci_16_live": {
             "shape": [UCI_BATCH * UCI_FIELDS, 10], "nrows": UCI_NFEAT,
             "live_rows": UCI_FIELDS, "ms": uci["kernel_ms"],
             "table_grad_ms_with_sort": uci["whole_ms"],
             "host_incl_ms": uci["whole_host_incl_ms"],
             "table_grad_sort_ms": uci["sort_ms"],
             "plain_ms": uci["plain_ms"], "bound_ms": uci["bound_ms"],
             "bound_by": uci["bound_by"], "library_ms": uci["library_ms"],
             "library_host_incl_ms": uci["library_host_incl_ms"]}},
        *arm_lines, *cin_lines, *bn_lines,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
