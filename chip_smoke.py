#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (armnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure with a non-zero exit:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc of every armnet_tpu_torch/kernels/csrc/*.cu, in parallel;
              ptxas registers and spills of every kernel, and of the
              instantiations the main paths launch apart
  3. card_tests  `python -m pytest --noconftest -q tests/test_torch_cuda.py`
              in a fresh process: every kernel against its plain PyTorch
              version on the card (the cases each kernel is held to,
              at the serving and step shapes and at every alpha among
              them), its refusals and its calls in the ledger; a non-zero
              exit fails the smoke
     kernel_times  kernels/bench.py's sections in this process: each
              kernel's device and host-inclusive ms beside its bound, its
              plain version and the composed path or library, its routes,
              registers, spills and blocks per SM (the numbers of the
              closing summary)
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
              calls per train step and per eval batch, one step on the
              card against the same step on the CPU from the run's
              checkpoint, and warm train rows/s over whole epochs
     bench    the measurement harness, each script in fresh processes:
              python -m armnet_tpu_torch.bench under auto and
              pallas-fused, the ensemble off and on (the headline, auto
              without the ensemble, at its defaults: 5 x 100 warm steps;
              the others at 3 x 50), the step breakdown of armnet_1h
              (3 x 30) under both kernel choices, and the recipes'
              --quick rows: every line parses, every time and rate finite
              and > 0, the calls per step of each kernel (K7 none in
              fwd and fwd_bwd_dense)
     benchmarks  the rest of the harness: K1 and K3 on the last axis of
              mh_breakdown's gates [4096, 4, 64, 39] (the (1048576, 39, 1)
              view) through its entmax stages in this process (their
              calls);
              tablegrad_breakdown's table gradient against index_add_ on
              the card; then in fresh processes mh_breakdown,
              tablegrad_breakdown and tablegrad_prep_bench (every stage,
              times finite and > 0, kernel calls a stage), fastpow_accuracy
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
              (K2, K4 and K7 a step, no K5/K6): calls, falling losses,
              one step on the card against the CPU on 1024 rows (the
              CPU step takes the card's outputs of the BatchNorms over
              channel axis 1), and for cr_armnet warm rows/s and the
              train-step profile
  8. frappe_train  3 epochs of the frappe_armnet1h recipe on data/frappe/:
              valid and test AUC per epoch beside the JAX package's curve
     diabetes_train  3 epochs of the db_armnet1h recipe (43 fields, alpha
              1.7) on data/uci_diabetes/ under --kernels auto and
              pallas-fused: calls per step, falling finite losses, one
              step on the card against the CPU, valid and test AUC
     diabetes_parity  15 epochs of the db_armnet1h recipe in process from
              the JAX package's seed-2025 init (data/parity/), under
              --kernels auto and pallas-fused: the best valid AUC within
              0.003 of the JAX package's from that init on the CPU; the
              per-epoch valid AUC beside the JAX and port CPU curves, the
              first epoch past 0.9, train losses, calls and seconds
     diabetes_armnet  3 epochs of the db_armnet recipe (K2/K4 at C = 32,
              alpha 1.7) on data/uci_diabetes/: the same checks
     frappe_zoo  afn, sa_glu and the other 16 zoo models (lr, fm, hofm,
              afm, nfm, dnn, wd, dfm, ipnn, kpnn, dcn, dcn+, cin, xdfm,
              gcn, gat) with the CLI defaults on data/frappe/, 2 epochs
              each (6-20 for the models with a first-order term): K7
              calls (twice a step where a FeaturesLinear sits beside
              the table) and, for cin and xdfm, K8's (a forward a layer a
              batch, a backward a layer a step), no other;
              valid and test AUC against the JAX
              package's over as many epochs, one step against the CPU
              (unpinned but for the channel-axis-1 BatchNorms and gcn's
              MLP BatchNorms), predict
              of the best checkpoint with GPU vs CPU logits, and AFN's
              main table at least 1e-4 at every forward
     criteo_zoo  xdfm and dfm at Criteo geometry (nfeat 2.1M, 39 fields,
              batch 4096) on the synthetic split: calls (K7 twice a
              step; xdfm's K8 a layer, CIN 3 x 128), falling losses, one
              step against the CPU, predict of the serving file with GPU
              vs CPU logits, peak device memory and warm train rows/s
     uci_train  the UCI multi-class path on a seeded ARFF at the UCI-121
              letter geometry (20,000 rows, 16 columns, 26 classes,
              conxuntos.dat 10,000 / 10,000): armnet at the CLI defaults
              and armnet_1h under pallas-fused, --batch_size 512
              --valid_perc 0.1, 10 epochs: calls, falling losses, one
              step against the CPU (pinned; armnet_1h unpinned too), best
              valid, test and train accuracy against the JAX package's
     bf16     --bf16 on Frappe: frappe_armnet1h under auto and
              pallas-fused and frappe_armnet, 2 epochs each: calls,
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
import importlib
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
from armnet_tpu_torch.benchmarks.timing import kernel_calls
from armnet_tpu_torch.bridge import from_jax_arrays
from armnet_tpu_torch.data import libsvm
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          make_dataloaders)
from armnet_tpu_torch.data.uci import uci_loader
from armnet_tpu_torch.kernels import (arm_cuda, bench, bn_cuda, build,
                                      cin_cuda, entmax_cuda, scatter_cuda)
from armnet_tpu_torch.kernels.bench import (CRITEO_SHAPE, DIABETES_SHAPE,
                                            FRAPPE_SHAPE,
                                            KERNELS_VS_PLAIN_RTOL, ZOO_WIDTHS,
                                            criteo_ids, device_events,
                                            ptxas_report, within)
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
# the packed routes' main-path views: the last axis of mh_breakdown's gates
# [4096, 4, 64, 39] as its (outer, d, inner) view, and db_armnet's gates
LAST_AXIS_VIEW = (4096 * 4 * 64, 39, 1)
DB_ARMNET_SHAPE = (1024, 43, 32)
CRITEO_NFEAT = 2_100_000
SEED = 2025
TRAIN_BATCHES, EVAL_ROWS = 10, 6000      # synthetic Criteo train split
CPU_ROWS = 1024     # rows of a scoring batch that the CPU scores to compare
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


# the card tests (the command in tests/test_torch_cuda.py's docstring):
# every kernel against its plain version, its launch path and its calls in
# the ledger
CARD_TESTS = ["-m", "pytest", "--noconftest", "-q", "tests/test_torch_cuda.py"]
CARD_TESTS_TIMEOUT = 1800


def phase_card_tests():
    """The card tests in a fresh process, on the libraries the build phase
    made: fails the smoke where pytest exits non-zero. Logs pytest's last
    line (the counts) and the seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *CARD_TESTS], cwd=REPO,
                       capture_output=True, text=True,
                       timeout=CARD_TESTS_TIMEOUT)
    lines = r.stdout.strip().splitlines()
    log("card_tests", command=" ".join(["python", *CARD_TESTS]),
        exit=r.returncode, result=lines[-1] if lines else None,
        seconds=round(time.perf_counter() - t0, 3))
    check(r.returncode == 0, f"the card tests exited {r.returncode}:\n"
                             f"{r.stdout[-8000:]}\n{r.stderr[-2000:]}")


# the times of a kernels/bench.py record, each timed on its own: the kernel
# (ms, time_ms), its plain version, the composed path, the library, the
# blocked route, and the bound
TIMED_KEYS = ("ms", "time_ms", "plain_ms", "composed_ms", "library_ms",
              "blocked_ms", "bound_ms")


def phase_kernel_times():
    """kernels/bench.py's sections in this process, one kernel_times line a
    record: each kernel's device and host-inclusive ms beside its bound,
    its plain version and the composed path or library, its routes,
    registers, spills and blocks per SM. Each time of TIMED_KEYS that a
    record holds is finite and > 0. Returns {section: [record]}."""
    recs = {}
    for name, section in bench.sections(arm1h_interaction).items():
        with timed(f"kernel_times.{name}"):
            recs[name] = list(section())
        for rec in recs[name]:
            log("kernel_times", section=name, **rec)
            bad = {k: rec[k] for k in TIMED_KEYS if k in rec and not (
                math.isfinite(rec[k]) and rec[k] > 0)}
            check(not bad, f"kernel_times {name}: times {bad} in {rec}")
    return recs


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


def run_predict(ckpt, inp, out, expect_rows, kernel="entmax_fwd",
                cin_layers=0):
    """predict.main on the card, its kernel calls read from the ledger
    around it; checks rows, finite scores and calls: `kernel`
    once per batch (entmax_fwd under auto, arm1h_fwd under pallas-fused,
    which predict restores from the checkpoint's sidecar), and K8's
    forward `cin_layers` times per batch (cin and xdfm), no other; none but
    K8's where `kernel` is None (a model without entmax)."""
    before = kernel_calls()
    with contextlib.redirect_stdout(io.StringIO()), timed("predict"):
        summary = predict.main(["--ckpt", ckpt, "--input", inp, "--output",
                                out, "--device", "cuda"])
    counts = kernel_calls(before)
    scores = np.loadtxt(out, ndmin=1)
    check(summary["rows"] == expect_rows == scores.shape[0],
          f"predict scored {summary['rows']} rows ({scores.shape[0]} "
          f"written), expected {expect_rows}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    want = dict.fromkeys(counts, 0)
    if kernel is not None:
        want[kernel] = summary["batches"]
    want["cin_fwd"] = summary["batches"] * cin_layers
    check(counts == want, f"predict called {counts} over "
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
    calls_total = 0
    for ensemble in (False, True):
        cfg = criteo_config(ensemble)
        ckpt = os.path.join(tmp, f"ckpt_criteo_ens{int(ensemble)}")
        save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
        out = os.path.join(tmp, f"criteo_ens{int(ensemble)}.scores")
        runs = []
        for _ in range(4):              # the first call includes warm-up
            runs.append(run_predict(ckpt, inp, out, rows))
            calls_total += runs[-1][1]
        err = first_batch_logit_err(ckpt, cfg, inp)
        for i, (s, calls) in enumerate(runs):
            log("serve", width="cr_armnet1h", ensemble=ensemble,
                call="cold" if i == 0 else "warm", rows=s["rows"],
                batches=s["batches"], calls=calls,
                rows_per_s=s["rows"] / s["score_seconds"],
                ms_per_batch=s["score_seconds"] / s["batches"] * 1e3,
                auc=s.get("auc"), gpu_vs_cpu_logit_err=err)
    return inp, calls_total


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
    for i, (s, calls) in enumerate(runs):
        log("serve_fused", width="cr_armnet1h", ensemble=False,
            kernels="pallas-fused", call="cold" if i == 0 else "warm",
            rows=s["rows"], batches=s["batches"], arm1h_fwd_calls=calls,
            rows_per_s=s["rows"] / s["score_seconds"],
            ms_per_batch=s["score_seconds"] / s["batches"] * 1e3,
            auc=s.get("auc"), gpu_vs_cpu_logit_err=err,
            fused_vs_auto_logit_err=auto_err)
    return sum(calls for _, calls in runs)


def phase_serve_frappe(tmp):
    cfg = ExperimentConfig(model="armnet_1h", nfeat=5500, nfield=10, nemb=10,
                           h=128, alpha=2.0, batch_size=4096, seed=SEED)
    ckpt = os.path.join(tmp, "ckpt_frappe")
    save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
    inp = os.path.join(REPO, "data", "frappe", "test.libsvm")
    summary, calls = run_predict(ckpt, inp,
                                    os.path.join(tmp, "frappe.scores"), 14430)
    err = first_batch_logit_err(ckpt, cfg, inp)
    log("frappe", rows=summary["rows"], batches=summary["batches"],
        calls=calls, auc=summary.get("auc"),
        rows_per_s=summary["rows"] / summary["score_seconds"],
        gpu_vs_cpu_logit_err=err)
    return calls


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
    """train.cli.main and its kernel calls, read from the ledger around it;
    its log lines go to the run's stdout.log only."""
    before = kernel_calls()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        results = cli.main(argv)
    torch.cuda.synchronize()
    return results, kernel_calls(before), time.perf_counter() - t0


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


# each kernel wrapper: (module, wrapper's name, plain version's name, its
# call's name in the ledger), from build.KERNELS
KERNEL_WRAPPERS = tuple(
    (importlib.import_module(f"armnet_tpu_torch.kernels.{mod}"), *names)
    for mod, *names in build.KERNELS)


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
    ensemble off under pallas-fused: calls, losses, the GPU-vs-CPU
    step, then the warm rate and, ensemble off, the train-step profile."""
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    totals = dict.fromkeys(kernel_calls(), 0)
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
        check(counts == want, f"train calls {counts}, expected {want} "
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
            scored, score_calls = run_predict(
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
            steps=steps, eval_batches=evals, calls=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, first_step_loss=flat[0],
            valid_auc=[r["valid"] for r in rows],
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "calls": score_calls},
            epoch_mean_loss=means, warm_rows_per_s=rates,
            warm_ms_per_step=ms_step,
            gpu_vs_cpu={k: gap[k] for k in (
                "loss_rel_gap", "logits_max_abs_gap", "u_kappa", "grad_rtol",
                "max_grad_rel_gap", "support_flip_columns", "pinned")})
        for k in totals:
            totals[k] += counts[k]
        totals[score_kernel] += score_calls
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
        calls=counts)
    check(len(rows) == 3 and valid[-1] >= 0.85,
          f"Frappe valid AUC after 3 epochs {valid} (needs >= 0.85)")
    return counts


def phase_diabetes_train(tmp):
    """3 epochs of the db_armnet1h recipe (armnet_tpu/utils/presets.py: 43
    fields, alpha 1.7, batch 1024) through cli.main on the bundled
    data/uci_diabetes/ split, under --kernels auto and pallas-fused: the
    kernel calls per step (K2/K4 under auto, K5/K6 under pallas-fused,
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
    totals = dict.fromkeys(kernel_calls(), 0)
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
        check(counts == want, f"diabetes calls {counts}, expected {want} "
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
            steps=steps, eval_batches=evals, calls=counts,
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
    totals = dict.fromkeys(kernel_calls(), 0)
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
        before = kernel_calls()
        t0 = time.perf_counter()
        trainer.fit(epochs, patience=epochs, report_freq=1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernel_calls(before)
        remove_logger(logger)
        steps = epochs * len(loaders[0])
        evals = epochs * (len(loaders[1]) + len(loaders[2]))
        fused = kernels == "pallas-fused"
        want = zoo_want(steps, evals, entmax=not fused, tables=1, bns=1)
        if fused:
            want.update(arm1h_fwd=steps + evals, arm1h_bwd=steps)
        check(counts == want, f"diabetes_parity calls {counts}, expected "
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
            calls=counts, seconds=seconds, jax=ref["versions"]["jax"])
        check(len(valid) == epochs and abs(best_gap) <= PARITY_BEST_ATOL,
              f"diabetes_parity ({kernels}): best valid AUC {max(valid)} "
              f"against the JAX package's {max(jax_curve)} from the same "
              f"init (limit {PARITY_BEST_ATOL})")
        for k in totals:
            totals[k] += counts[k]
    return totals


def phase_serve_armnet(tmp, inp):
    """predict at the cr_armnet and cr_armnet+ widths (the ensemble off
    and on) on the serving phase's synthetic file, a cold and a warm
    call: rows, finite scores, one K2 launch per batch and no other (no
    K5), and the first batch's GPU logits against the CPU's."""
    calls = 0
    for name in ("cr_armnet", "cr_armnet+"):
        cfg = flags_config(preset_flags(name))
        ckpt = os.path.join(tmp, f"ckpt_{name}")
        save_checkpoint(create_model(cfg, seed=SEED), cfg, ckpt, "best")
        out = os.path.join(tmp, f"{name}.scores")
        runs = [run_predict(ckpt, inp, out, 10_000) for _ in range(2)]
        calls += sum(n for _, n in runs)
        err = first_batch_logit_err(ckpt, cfg, inp)
        for i, (s, n) in enumerate(runs):
            log("serve_armnet", preset=name, ensemble=cfg.ensemble,
                channels=cfg.nattn_head * cfg.h,
                call="cold" if i == 0 else "warm", rows=s["rows"],
                batches=s["batches"], entmax_fwd_calls=n,
                rows_per_s=s["rows"] / s["score_seconds"],
                gpu_vs_cpu_logit_err=err)
    return calls


def train_run(tmp, exp, flags, data, split, batch, epochs, want,
              check_auc=None, pinned=True, enforce=True):
    """cli.main of `flags` for `epochs` on {data}/{split} with checkpoints,
    its kernel calls (run_cli) equal to `want`, finite step
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
    check(counts == want, f"{exp} calls {counts}, expected {want}")
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
    """K7's calls a train step of `model`: one per table."""
    return (2 if model in TWO_TABLES else 1) + int(ensemble)


def zoo_want(steps, evals, entmax, tables, cin=(0, 0), bns=0):
    """Kernel calls of a run: K2 once per train step and eval batch and K4
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
    """K9's calls in `steps` train steps that each call `bns` BatchNorms on
    the fused route: a forward and a backward call of each (eval batches
    take the running statistics on the composed ops)."""
    return {"bn_fwd": steps * bns, "bn_bwd": steps * bns}


def bn_wide(cfg):
    """The BatchNorms of cfg's model that take K9 in a float32 train step
    on the card: those over channel axis 1 (arm_bn, emb_bn, afn_bn over [B,
    C, E]: S = E > 1, ops/layers.bn_route); the others normalize [B, C]
    over its last axis (S = 1: the composed ops)."""
    from armnet_tpu_torch.ops.layers import BatchNorm

    return sum(isinstance(m, BatchNorm) and m.channel_axis == 1
               for m in create_model(cfg).modules())


def cin_want(cfg):
    """(K8 forward calls a batch, its backward calls a train step) of cfg's
    model: for cin and xdfm one of each a CIN layer; (0, 0) for every other
    model."""
    return (cfg.k, cfg.k) if cfg.model in ("cin", "xdfm") else (0, 0)


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
    totals = dict.fromkeys(kernel_calls(), 0)
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
            steps=steps, eval_batches=evals, calls=counts,
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
        * cfg.h, steps=steps, eval_batches=evals, calls=counts,
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
    rows): calls (K7 once per table a step, tables; K8's for cin and
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
    totals = dict.fromkeys(kernel_calls(), 0)

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
        cin = cin_want(flags_config(flags))
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
            calls=counts, per_step={k: counts[k] / steps for k in counts},
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
    totals = dict.fromkeys(kernel_calls(), 0)
    for model in ("xdfm", "dfm"):
        exp = f"cr_{model}"
        flags = ["--model", model, "--nfeat", str(CRITEO_NFEAT), "--nfield",
                 "39", "--batch_size", "4096"]
        cin = cin_want(flags_config(flags))
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
            eval_batches=evals, calls=counts,
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
    (train_run: calls, falling finite losses, one step against the CPU
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
    totals = dict.fromkeys(kernel_calls(), 0)
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
            steps=steps, eval_batches=evals, calls=counts,
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
    frappe_armnet, 2 epochs each (train_run: calls, falling finite
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
    totals = dict.fromkeys(kernel_calls(), 0)
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
                scored, score_calls = run_predict(ckpt, inp, out, 14430,
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
            eval_batches=evals, calls=counts,
            per_step={k: counts[k] / steps for k in counts},
            cli_seconds=seconds, embedding_dtype=str(emb_dtypes),
            mlp_input_dtype=str(head_dtypes),
            arm_bn_zero_variance_share_first_steps=flat_share,
            valid_auc=[r["valid"] for r in rows],
            test_auc=[r["test"] for r in rows], f32_valid_auc=f32_valid,
            jax_valid_floor=BF16_JAX[preset, kernels] - 0.02,
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "calls": score_calls,
                          "vs_bf16_model_max_abs": err},
            against_f32=rate, device=smi,
            gpu_vs_cpu={k: gap[k] for k in GAP_KEYS + (
                "kernels_at_boundary_max_rel_gap", "pinned") if k in gap})
        for k in totals:
            totals[k] += counts[k] + f32_counts[k]
        totals[score_kernel] += score_calls
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
            before = kernel_calls()
            t0 = time.perf_counter()
            y = entmax_bisect(xd, ad, axis=1)
            y.backward(dy.to(device))
            if device == "cuda":
                torch.cuda.synchronize()
            res[device] = (y.detach().cpu(), xd.grad.cpu(), ad.grad.cpu(),
                           (time.perf_counter() - t0) * 1e3,
                           kernel_calls(before))
        (yg, dxg, dag, ms, counts), (yc, dxc, dac, cpu_ms, _) = (
            res["cuda"], res["cpu"])
        errs = {"y": float((yg - yc).abs().max()),
                "dx": float((dxg - dxc).abs().max()),
                "dx_rel": float((dxg - dxc).norm() / dxc.norm()),
                "dalpha_rel": float((dag - dac).norm() / dac.norm())}
        log("entmax_alpha", alpha=kind, shape=list(CRITEO_SHAPE), axis=1,
            alpha_shape=list(alpha.shape), **errs, calls=counts,
            card_ms=ms, cpu_ms=cpu_ms, dalpha_norm=float(dac.norm()),
            tol="y 1e-5 elementwise; dx and dalpha 1e-5 of their norms")
        check(all(v == 0 for v in counts.values()),
              f"learned-alpha entmax called kernels: {counts}")
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
    """The port's calls per train step of armnet_1h under `kernels`:
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
    is finite and > 0, and the calls per step are the step's: one K2
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
              f"bench {argv}: calls per step {rec['launches']}, "
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
                  f"breakdown {kernels} {r['subset']}: calls per step "
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
              f"recipe {r['recipe']}: calls per step {r['launches']}")


# the benchmark modules' depth in the smoke: one warm call, two timed
# repetitions of three calls (the profiled repetition: three calls)
BENCHMARK_FLAGS = ["--warm", "1", "--steps", "3", "--reps", "2"]
# mh_breakdown's stages that normalize with a kernel (alpha 2): the entmax
# forward (K1 on the last axis, K2 on the fields-major gates) once a call,
# the backward's VJP (K3, K4) once more in each *_bwd of them
MH_ENTMAX_STAGES = ("entmax_fwd", "entmax_bwd", "interaction_fwd",
                    "interaction_bwd", "interaction_fm_fwd",
                    "interaction_fm_bwd")


def check_stages(module, rows, names, want_calls):
    """The lines of a stage breakdown: one per stage of `names` in order,
    every time finite and > 0 (the device ms from the profiled repetition
    too), the kernel calls of each want_calls(stage)."""
    check([r["stage"] for r in rows] == list(names),
          f"{module}: stages {[r['stage'] for r in rows]}")
    for r in rows:
        times = {f"step_ms.{k}": v for k, v in r["step_ms"].items()}
        times["device_ms_per_step"] = r["device_ms_per_step"]
        bad = {k: v for k, v in times.items() if not (
            isinstance(v, (int, float)) and math.isfinite(v) and v > 0)}
        check(not bad, f"{module} {r['stage']}: not finite and > 0: {bad}")
        want = {**dict.fromkeys(kernel_calls(), 0), **want_calls(r["stage"])}
        check(r["launches"] == want, f"{module} {r['stage']}: kernel calls "
                                     f"{r['launches']}, expected {want}")


def last_axis_calls():
    """mh_breakdown's entmax_fwd and entmax_bwd stages on the last axis of
    its gates [4096, 4, 64, 39] (K1 and K3 on the (1048576, 39, 1) view),
    in this process: K1 twice (the backward stage's forward too) and K3
    once, no other kernel. Returns the calls."""
    from armnet_tpu_torch.benchmarks import mh_breakdown

    stages = dict(mh_breakdown.stages(mh_breakdown.inputs(device="cuda")))
    before = kernel_calls()
    stages["entmax_fwd"]()
    stages["entmax_bwd"]()
    torch.cuda.synchronize()
    counts = kernel_calls(before)
    check(counts == {**dict.fromkeys(counts, 0), "entmax_fwd": 2,
                     "entmax_bwd": 1},
          f"entmax_fwd and entmax_bwd stages called {counts}")
    log("benchmarks", name="last_axis_stages", calls=counts)
    return counts


def phase_benchmarks():
    """The rest of the harness (armnet_tpu_torch/benchmarks/): K1 and K3 on
    the last axis in this process (last_axis_calls), the table_grad
    stage of tablegrad_breakdown held to index_add_ on the card; then each
    module in a fresh process at BENCHMARK_FLAGS' depth:
    mh_breakdown (every stage, the calls of each), tablegrad_breakdown
    and tablegrad_prep_bench (K7 once in each table-gradient stage, and the
    split), fastpow_accuracy (the kernel at its compiled budget within
    REL of the newton build's worst at each alpha, the plain solver's (12,
    4) passing), scaling --max_devices 1 (one row) and paired_ab (one A/A
    pair of the bench at BENCH_SHORT: the ratio). Returns the calls of the
    in-process stages."""
    from armnet_tpu_torch.benchmarks import mh_breakdown, tablegrad_prep_bench
    from armnet_tpu_torch.benchmarks import tablegrad_breakdown as tb

    with timed("benchmarks.last_axis"):
        counts = last_axis_calls()
    ids, g = tb.inputs(device="cuda")
    before = kernel_calls()
    (got,) = dict(tb.stages(ids, g, tb.NROWS))["full"]()
    torch.cuda.synchronize()
    tg_counts = kernel_calls(before)
    check(tg_counts["table_grad"] == 1, f"full called {tg_counts}")
    counts = {k: v + tg_counts[k] for k, v in counts.items()}
    card = scatter_cuda.table_grad_plain(g, ids, tb.NROWS)
    spread = scatter_cuda.table_grad_plain(g.abs(), ids, tb.NROWS)
    err = float((got - card).abs().max())
    check(bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all()),
          f"tablegrad full vs index_add_ on the card: max abs err {err}")
    log("benchmarks", name="tablegrad_full", max_abs_err_vs_index_add=err,
        calls=tg_counts)
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
    return counts


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
    the one rank). Returns the calls."""
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
        before = kernel_calls()
        m = make_train_step(mesh=mesh)(create_train_state(model, cfg.lr),
                                       init_meters("cuda"), batch)
        torch.cuda.synchronize()
        return float(m["loss_last"]), kernel_calls(before)

    ref, _ = step()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    totals = dict.fromkeys(kernel_calls(), 0)
    try:
        mesh = make_mesh("data:1,model:1")
        for exchange in ("psum", "a2a"):
            loss, counts = step(mesh, exchange)
            check(counts == {**dict.fromkeys(counts, 0), "entmax_fwd": 1,
                             "entmax_bwd": 1, "table_grad": 1,
                             **bn_want(1, 1)},
                  f"{exchange} sharded step called {counts}")
            check(abs(loss - ref) <= 1e-6 * abs(ref),
                  f"{exchange} sharded step loss {loss} against {ref}")
            log("sharded_step", exchange=exchange, mesh=mesh.shape,
                loss=loss, replicated_loss=ref, calls=counts)
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
        torchrun_seconds=torchrun_s, single_calls=counts,
        sharded_step_calls=sharded)
    for k in counts:
        counts[k] += sharded[k]
    return counts, sharded


def kernel_lines(times, calls, sharded):
    """The closing summary, a record a kernel: its source and the Pallas
    function it replaces, its calls over the smoke's runs (`calls`, the
    ledger's), and its times from phase_kernel_times' records at the
    cr_armnet1h step, alpha 2 unless said, and at the other steps
    kernels/bench.py times."""
    def at(section, **match):
        return next(r for r in times[section]
                    if all(r.get(k) == v for k, v in match.items()))

    def keep(rec, *keys):
        return {k: rec[k] for k in keys}

    src = "armnet_tpu_torch/kernels/csrc/"
    pallas = "armnet_tpu/kernels/"
    steps = [name for name, _, _ in bench.ENTMAX_STEPS
             if name != "armnet_1h"]
    entmax = []
    for kind, section, source, line, also in (
            ("fwd", "entmax", "entmax_fwd.cuh", 151, 40),
            ("bwd", "entmax_bwd", "entmax_bwd.cu", 159, 53)):
        name = f"entmax_{kind}"
        crit = at(section, **{name: list(CRITEO_SHAPE)}, alpha=2.0)
        entmax.append({
            "name": name, "route": "cuda", "source": src + source,
            "replaces": f"{pallas}entmax_pallas.py:{line}",
            "also_replaces": f"{pallas}entmax_pallas.py:{also}",
            "calls": calls[name],
            **keep(crit, "ms", "host_incl_ms", "bound_ms", "bound_by",
                   "max_abs_err"), "kernel_route": crit["route"],
            "plain_ms": at(section, **{name: "armnet_1h"})["plain_ms"],
            "library_ms": None, "shape": list(CRITEO_SHAPE), "alpha": 2.0,
            "ms_by_alpha": {a: at(section, **{name: list(CRITEO_SHAPE)},
                                  alpha=a)["ms"] for a in bench.ALPHAS},
            "frappe": at(section, **{name: list(FRAPPE_SHAPE)}, alpha=2.0),
            "diabetes": at(section, **{name: list(DIABETES_SHAPE)},
                           alpha=1.7),
            "d100": at(section, **{name: [512, 100, 128]}, alpha=2.0),
            **{step: at(section, **{name: step}) for step in steps}})
    entmax[0]["also_source"] = src + "entmax_fwd_column.cu"
    tg = {(r["table_grad"], r["e"]): r for r in times["table_grad"]}
    crit = tg["criteo_batch", 10]

    def tg_keys(r):
        return {"ms": r["kernel_ms"], "table_grad_ms_with_sort": r["whole_ms"],
                "host_incl_ms": r["whole_host_incl_ms"],
                "table_grad_sort_ms": r["sort_ms"], **keep(
                    r, "bound_ms", "bound_by", "library_ms",
                    "library_host_incl_ms", "split_by")}

    table_grad = {
        "name": "table_grad", "route": "cuda", "source": src + "table_grad.cu",
        "replaces": f"{pallas}scatter_pallas.py:122",
        "calls": calls["table_grad"],
        "sharded_step_calls": sharded["table_grad"], **tg_keys(crit),
        "table_grad_fill_ms": crit["fill_ms"],
        "table_grad_prep": "folded into the radix sort's first pass",
        **keep(crit, "torch_prep_ms", "torch_sort_ms"),
        "all_ids_equal_ms": tg["all_ids_equal", 10]["whole_ms"],
        "zipf": {k[len("zipf_"):]: {"table_grad_ms": r["whole_ms"],
                                    "library_ms": r["library_ms"]}
                 for (k, _), r in tg.items() if k.startswith("zipf_")},
        "shape": [4096 * 39, 10], "nrows": CRITEO_NFEAT,
        "zoo_widths": {f"e{e}": {"shape": [4096 * 39, e],
                                 **tg_keys(tg["criteo_batch", e])}
                       for e in ZOO_WIDTHS},
        "uci_16_live": {"shape": [UCI_BATCH * UCI_FIELDS, 10],
                        "nrows": UCI_NFEAT, "live_rows": UCI_FIELDS,
                        **tg_keys(tg["uci_16_live", 10])}}
    arm = [{"name": f"arm1h_{kind}", "route": "cuda", "source": src + source,
            "also_source": src + col,
            "replaces": f"{pallas}arm_pallas.py:{line}",
            "calls": calls[f"arm1h_{kind}"], "library_ms": None,
            **at("arm", **{f"arm1h_{kind}": "criteo"}, alpha=2.0),
            "diabetes": at("arm", **{f"arm1h_{kind}": "diabetes"}, alpha=1.7),
            "uci": at("arm", **{f"arm1h_{kind}": "uci"}, alpha=1.7)}
           for kind, line, source, col in (
               ("fwd", 184, "arm1h.cu", "arm1h_col.cu"),
               ("bwd", 211, "arm1h_bwd.cuh", "arm1h_bwd_col.cu"))]
    cin = [{"name": f"cin_{kind}", "route": "cuda", "source": src + "cin.cu",
            "replaces": None,
            "new": "the JAX package's CIN is XLA ops, with no Pallas kernel",
            "calls": calls[f"cin_{kind}"], "library_ms": None,
            **{f"C{c}": next(r for r in times["cin"]
                             if r.get(f"cin_{kind}", {}).get("C") == c)
               for c in (200, 39)}}
           for kind in ("fwd", "bwd")]
    bn = [{"name": f"bn_{kind}", "route": "cuda",
           "source": src + "batch_norm.cu", "replaces": None,
           "new": "the JAX package's BatchNorm is XLA ops, with no Pallas "
                  "kernel",
           "calls": calls[f"bn_{kind}"],
           "library": "F.batch_norm in training mode (cuDNN), which the "
                      "port never calls",
           "shapes": {name: at("bn", **{f"bn_{kind}": name})
                      for name, _ in bench.BN_SHAPES}}
          for kind in ("fwd", "bwd")]
    return [*entmax, table_grad, *arm, *cin, *bn]


def main():
    smi = phase_device()
    # full-f32 GEMMs on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with timed("build"):
        phase_build()
    with timed("card_tests"):
        phase_card_tests()
    with timed("kernel_times"):
        times = phase_kernel_times()
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
            bench_counts = phase_benchmarks()
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
    calls = {k: sum(r[k] for r in runs) for k in runs[0]}
    calls["entmax_fwd"] += serve
    calls["arm1h_fwd"] += serve_fused
    print(json.dumps({"kernels": kernel_lines(times, calls, sharded)}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
