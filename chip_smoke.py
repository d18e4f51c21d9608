#!/usr/bin/env python
"""Chip smoke test of the PyTorch/CUDA port (armnet_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one line each, stopping at the first failure with a non-zero exit:
  1. device   nvidia-smi name and power limit, torch's device name
  2. build    nvcc of every armnet_tpu_torch/kernels/csrc/*.cu, in parallel
  3. kernel   each CUDA kernel against its plain PyTorch version on the
              card: the entmax forward and backward at both Criteo and
              Frappe shapes, a 2-D last-axis and a ragged shape and a NaN
              column, at four alphas; the table gradient on a Criteo
              batch's ids, all ids equal, wrapped and dropped ids and a
              ragged table, twice (bitwise equal). Kernel, plain and
              library times (CUDA events, median) beside the bound
  4. serve    armnet_tpu_torch.predict at the Criteo width of the
              cr_armnet1h preset (nfeat 2.1M, 39 fields, E=10, h=128, MLP
              2x500, alpha 2.0), ensemble off and on, on a seeded synthetic
              10,000-row libsvm file, one cold and three warm calls each:
              rows, finite scores, one kernel launch per batch, and GPU
              logits against the CPU's for the first batch
  5. frappe   predict at frappe_armnet1h widths on data/frappe/test.libsvm:
              rows, one launch per batch, GPU vs CPU logits of the first batch
  6. profile  torch.profiler over one warm Criteo-width scoring pass:
              device time by kernel and the device's busy share
  7. train    armnet_tpu_torch.train.cli.main at cr_armnet1h widths,
              ensemble off and on (the cr_armnet1h+ tower), 2 epochs of 10
              batches on seeded synthetic files: finite losses that fall,
              the kernel launches per train step and per eval batch, one
              step on the card against the same step on the CPU from the
              run's checkpoint, and warm train rows/s over whole epochs
  8. frappe_train  3 epochs of the frappe_armnet1h recipe on data/frappe/:
              valid and test AUC per epoch beside the JAX package's curve
  9. profile_train  torch.profiler over one warm Criteo-width train step
Then one JSON line {"kernels": [...]} and, last, the device JSON line.
Weights are random, drawn from a seed. Exits non-zero without a result when
CUDA is absent. Imports nothing of JAX.
"""

import contextlib
import io
import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from armnet_tpu_torch import predict
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          make_dataloaders)
from armnet_tpu_torch.kernels import build, entmax_cuda, scatter_cuda
from armnet_tpu_torch.kernels.entmax_common import (N_BISECT, N_FAST,
                                                    N_NEWTON, N_POLISH,
                                                    solver_mode)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from armnet_tpu_torch.train.loop import Trainer, run_epoch
from armnet_tpu_torch.train.step import clamp_grads, forward_loss
from armnet_tpu_torch.utils.config import ExperimentConfig
from armnet_tpu_torch.utils.logging import get_logger, remove_logger

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# 67 TFLOP/s of f32 outside the tensor cores counts an FMA as two
# operations: one f32 instruction per lane per clock is half of it. The
# special-function unit (lg2, ex2, rcp) and int<->float conversions issue
# at 16 per clock per SM against 128 f32 lanes (CUDA programming guide,
# compute capability 9.0), so each takes 8 f32 instruction slots.
F32_INSTR_PER_S = 33.5e12
CRITEO_SHAPE = (4096, 39, 128)
FRAPPE_SHAPE = (4096, 10, 128)
CRITEO_NFEAT = 2_100_000
ALPHAS = (1.5, 1.7, 2.0, 2.5)
SEED = 2025
TRAIN_BATCHES, EVAL_ROWS = 10, 6000      # synthetic Criteo train split
# the JAX package's 3-epoch Frappe curve of this recipe (valid AUC)
FRAPPE_JAX_VALID = (0.8211, 0.8841, 0.9041)


def log(phase, **kw):
    print(f"{phase}: " + json.dumps(kw), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, reps=20, warmup=3):
    """Median ms of one call of fn, from CUDA events around each call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def entmax_ops_per_element(alpha, n_iter=30):
    """f32 instruction slots the entmax solve needs per input element, for
    the bound. A lower count: an add, max, compare or select is 1, an int
    add 2, an SFU op or a conversion 8; powf is at least lg2, multiply, ex2
    (17) and an IEEE divide at least a reciprocal and 3 refinements (11).
    Per-column scalar work is left out."""
    inv_am1 = 1.0 / (alpha - 1.0)
    mode = solver_mode(alpha)
    pow_cost = {1.0: 0, 2.0: 1, 3.0: 2}.get(inv_am1, 17)
    evaluate = 3 + pow_cost             # subtract, clamp, pow, add
    common = 2 + evaluate + 11          # scale, max; last pass, divide
    if mode == "bisect":                # f(tau_lo), then n_iter steps
        return common + evaluate * (min(n_iter, 30) + 1)
    # subtract, clamp, pow, add, compare, clamp, divide, select, add
    newton = evaluate + 4 + 11
    if mode == "fastpow":
        # subtract, clamp, int subtract, i2f, mul, add, max, min, f2i,
        # compare+select, add
        fast = 1 + 1 + 2 + 8 + 1 + 1 + 1 + 1 + 8 + 2 + 1
        return common + fast * N_FAST + newton * N_POLISH
    return common + evaluate * N_BISECT + newton * N_NEWTON


def entmax_bound_ms(shape, alpha):
    numel = math.prod(shape)
    return bound(2 * 4 * numel, entmax_ops_per_element(alpha) * numel)


def entmax_bwd_ops_per_element(alpha):
    """f32 instruction slots of the entmax backward per element, a lower
    count as above: compare and select (2), g (0 at alpha 2; an IEEE sqrt,
    at least a reciprocal square root and 3 refinements, 11; else a max
    and powf, 18), then dy*g, the two sums, q*g and a subtract (5)."""
    g_cost = {0.0: 0, 0.5: 11}.get(2.0 - alpha, 18)
    return 2 + g_cost + 5


def bound(nbytes, nops):
    """(bound ms, 'bytes' | 'operations'): the larger of bytes over the
    memory rate and f32 instruction slots over the instruction rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_INSTR_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def fused_arm_bounds():
    """Bounds of the fused ARM-1h Pallas kernels K5 (_fwd_kernel) and K6
    (_bwd_kernel) of armnet_tpu/kernels/arm_pallas.py, not ported yet, at
    the cr_armnet1h step (B 4096, F 39, E = d_k = 10, O 128, alpha 2), by
    the same counts as the ported kernels: bytes of each input read once
    and each output written once; f32 instruction slots with a
    multiply-add as one, exp as 8 plus 2, and the entmax solve and VJP as
    entmax_ops_per_element and entmax_bwd_ops_per_element."""
    b, f, e, dk, o = 4096, 39, 10, 10, 128
    bfo, boe, bfe = b * f * o, b * o * e, b * f * e
    keys, gates, cross = bfe * dk, b * f * dk * o, b * o * f * e
    fwd_ops = (keys + gates + entmax_ops_per_element(2.0) * bfo + bfo
               + cross + 10 * boe)
    # backward: the forward replay, then dz, dw, ds, the entmax VJP, dkeys,
    # the two terms of de, dWk, dquery and dvalues
    bwd_ops = (fwd_ops + boe + cross + bfo + entmax_bwd_ops_per_element(2.0)
               * bfo + gates + cross + keys + keys + gates + 2 * bfo)
    weights = 4 * (e * dk + o * dk + f * o)
    out = {}
    for name, nbytes, nops in (
            ("K5 arm_fwd", 4 * (bfe + boe) + weights, fwd_ops),
            ("K6 arm_bwd", 4 * (2 * bfe + boe) + 2 * weights, bwd_ops)):
        ms, by = bound(nbytes, nops)
        out[name] = {"bound_ms": ms, "bound_by": by, "bytes": nbytes,
                     "f32_instruction_slots": nops}
    log("bounds_unported", **out)


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


def phase_build():
    t0 = time.perf_counter()
    secs = build.build_all()
    regs = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                if "registers" in ln or "spill" in ln][:4]
            for n in secs}
    log("build", seconds=round(time.perf_counter() - t0, 3), per_source=secs,
        ptxas=regs)


def phase_kernel():
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # the serving shapes of the Criteo and Frappe phases (register buckets
    # 64 and 16), a 2-D last-axis case and a ragged one (bucket 8)
    cases = [(CRITEO_SHAPE, 1), (FRAPPE_SHAPE, 1), ((8192, 39), -1),
             ((7, 5, 13), 1)]
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
        plain_ms = time_ms(lambda: entmax_cuda.entmax_plain(x, alpha, 1))
        bound, by = entmax_bound_ms(CRITEO_SHAPE, alpha)
        stats[alpha] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "max_abs_err": max(errs)}
        log("kernel", name="entmax_fwd", alpha=alpha,
            shape=list(CRITEO_SHAPE), axis=1, ms=ms, plain_ms=plain_ms,
            bound_us=bound * 1e3, bound_by=by, max_abs_err=max(errs),
            tol=tol, library="none: no single PyTorch call computes entmax")
    return stats


def phase_kernel_bwd():
    """The entmax backward kernel against its plain version, y from the
    forward kernel, at the forward phase's shapes and alphas."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [(CRITEO_SHAPE, 1), (FRAPPE_SHAPE, 1), ((8192, 39), -1),
             ((7, 5, 13), 1)]
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
            check(err <= tol, f"entmax_bwd kernel vs plain at alpha={alpha} "
                              f"{shape}: {err} > {tol}")
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
        y = entmax_cuda.entmax_kernel(
            torch.randn(CRITEO_SHAPE, generator=g, device="cuda") * 3.0,
            alpha, 1)
        dy = torch.randn(CRITEO_SHAPE, generator=g, device="cuda")
        ms = time_ms(lambda: entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1))
        plain_ms = time_ms(lambda: entmax_cuda.entmax_bwd_plain(y, dy, alpha,
                                                                1))
        numel = math.prod(CRITEO_SHAPE)
        bound_ms, by = bound(3 * 4 * numel,
                             entmax_bwd_ops_per_element(alpha) * numel)
        stats[alpha] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, "max_abs_err": max(errs)}
        log("kernel", name="entmax_bwd", alpha=alpha,
            shape=list(CRITEO_SHAPE), axis=1, ms=ms, plain_ms=plain_ms,
            bound_us=bound_ms * 1e3, bound_by=by, max_abs_err=max(errs),
            tol=tol, library="none: no single PyTorch call computes the "
                             "entmax VJP")
    return stats


def criteo_rows(rows, nfeat, nfield, seed):
    """Seeded synthetic rows at Criteo geometry: 13 numeric fields with 100
    id buckets each and real values in (0, 1], 26 categorical fields that
    share the rest of the nfeat ids with value 1; ~25% positive labels.
    Returns (ids [rows, nfield] int64, values, labels)."""
    rng = np.random.RandomState(seed)
    n_num = 13
    sizes = [100] * n_num
    rest = nfeat - sum(sizes)
    ncat = nfield - n_num
    sizes += [rest // ncat + (1 if i < rest % ncat else 0)
              for i in range(ncat)]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    ids = offsets[None, :] + (rng.rand(rows, nfield)
                              * np.asarray(sizes)[None, :]).astype(np.int64)
    values = np.ones((rows, nfield))
    values[:, :n_num] = np.round(rng.uniform(1e-3, 1.0, (rows, n_num)), 6)
    labels = (rng.rand(rows) < 0.25).astype(int)
    return ids, values, labels


def write_criteo_libsvm(path, rows, nfeat, nfield, seed):
    """criteo_rows written as a libsvm file."""
    ids, values, labels = criteo_rows(rows, nfeat, nfield, seed)
    with open(path, "w") as f:
        for r in range(rows):
            f.write(str(labels[r]) + " " + " ".join(
                f"{i}:{v:g}" for i, v in zip(ids[r], values[r])) + "\n")


def phase_kernel_table_grad():
    """The table-gradient kernel against its plain version (index_add_) and
    against itself (bitwise), on the train step's shapes: g [4096*39, 10]
    and nrows 2.1M, which is not a multiple of the kernel's 128-row block.
    The plain version runs on a CPU copy of the inputs, where index_add_
    adds in the kernel's order (rtol 1e-5, atol 1e-6), and on the card,
    where its atomics add in no fixed order: there each element is held
    to 1e-6 + 1e-5 * sum|g| over its updates, a bound on any reordering of
    the sum."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    n, e, nrows = 4096 * 39, 10, CRITEO_NFEAT
    batch_ids = torch.from_numpy(criteo_rows(4096, nrows, 39, SEED)[0]).to(
        "cuda", torch.int32).reshape(-1)
    cases = {
        "criteo_batch": (batch_ids, nrows),
        "all_ids_equal": (torch.full((n,), 1234567, dtype=torch.int32,
                                     device="cuda"), nrows),
        "wrapped_and_dropped": (torch.randint(
            -2 * nrows, 2 * nrows, (n,), generator=g, device="cuda",
            dtype=torch.int32), nrows),
        "ragged_small": (torch.randint(0, 3001, (37,), generator=g,
                                       device="cuda", dtype=torch.int32),
                         3001),
    }
    errs, card_errs, out = [], [], {}
    for name, (ids, rows) in cases.items():
        gr = torch.randn((ids.shape[0], e), generator=g, device="cuda")
        got = scatter_cuda.table_grad(gr, ids, rows)
        again = scatter_cuda.table_grad(gr, ids, rows)
        want = scatter_cuda.table_grad_plain(gr.cpu(), ids.cpu(), rows)
        card = scatter_cuda.table_grad_plain(gr, ids, rows)
        spread = scatter_cuda.table_grad_plain(gr.abs(), ids, rows)
        torch.cuda.synchronize()
        got_cpu = got.cpu()
        err = float((got_cpu - want).abs().max())
        card_err = float((got - card).abs().max())
        check(torch.allclose(got_cpu, want, rtol=1e-5, atol=1e-6),
              f"table_grad kernel vs plain on {name}: max abs err {err}")
        check(bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all()),
              f"table_grad kernel vs index_add_ on the card on {name}: "
              f"max abs err {card_err}")
        check(torch.equal(got, again),
              f"table_grad kernel not bitwise deterministic on {name}")
        errs.append(err)
        card_errs.append(card_err)
        sid, order = scatter_cuda.sort_ids(ids, rows)
        ms = time_ms(lambda: scatter_cuda.table_grad_sorted(gr, sid, order,
                                                            rows))
        whole_ms = time_ms(lambda: scatter_cuda.table_grad(gr, ids, rows))
        plain_ms = time_ms(lambda: scatter_cuda.table_grad_plain(gr, ids,
                                                                 rows))
        library_ms = None
        if name == "criteo_batch":
            lib_ids = ids.long()
            library_ms = time_ms(lambda: torch.zeros(
                (rows, e), device="cuda").index_add_(0, lib_ids, gr))
        # each input read once (g f32, ids int32), the dense output written
        # once; one add per update element
        bound_ms, by = bound(4 * rows * e + 4 * gr.numel() + 4 * ids.numel(),
                             gr.numel())
        out[name] = {"ms": ms, "table_grad_ms": whole_ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bound_ms": bound_ms, "bound_by": by}
        log("kernel", name="table_grad", case=name, n=int(ids.shape[0]),
            e=e, nrows=rows, ms=ms, table_grad_ms_with_sort=whole_ms,
            plain_ms=plain_ms, library_ms=library_ms,
            library="torch.zeros(nrows, E).index_add_(0, ids, g)",
            bound_us=bound_ms * 1e3, bound_by=by, max_abs_err_cpu_plain=err,
            max_abs_err_card_plain=card_err,
            tol="rtol 1e-5, atol 1e-6 vs the CPU plain version; 1e-6 + "
                "1e-5 * sum|g| vs index_add_ on the card; bitwise equal to "
                "itself")
    out["max_abs_err"] = max(errs)
    out["max_abs_err_vs_index_add_on_card"] = max(card_errs)
    return out


def run_predict(ckpt, inp, out, expect_rows):
    """predict.main on the card with the kernel counts set to 0 just before
    and read just after; checks rows, finite scores and launches."""
    entmax_cuda.LAUNCHES = 0
    with contextlib.redirect_stdout(io.StringIO()):    # predict's summary
        summary = predict.main(["--ckpt", ckpt, "--input", inp, "--output",
                                out, "--device", "cuda"])
    launches = entmax_cuda.LAUNCHES
    scores = np.loadtxt(out, ndmin=1)
    check(summary["rows"] == expect_rows == scores.shape[0],
          f"predict scored {summary['rows']} rows ({scores.shape[0]} "
          f"written), expected {expect_rows}")
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(launches == summary["batches"],
          f"entmax kernel launched {launches} times over "
          f"{summary['batches']} batches")
    return summary, launches


def criteo_flags(ensemble):
    """The cr_armnet1h preset's flags (armnet_tpu/utils/presets.py), with
    the cr_armnet1h+ tower when the ensemble is on; lr 0.001 for both."""
    flags = ["--model", "armnet_1h", "--mlp_nlayer", "2", "--mlp_nhid", "500",
             "--h", "128", "--alpha", "2.0", "--lr", "0.001", "--nfield",
             "39", "--nfeat", str(CRITEO_NFEAT), "--batch_size", "4096"]
    if ensemble:
        flags += ["--ensemble", "--dnn_nlayer", "2", "--dnn_nhid", "500"]
    return flags


def criteo_config(ensemble):
    """cr_armnet1h widths (armnet_tpu/utils/presets.py); the ensemble tower
    takes cr_armnet1h+'s 2x500."""
    return ExperimentConfig(
        model="armnet_1h", nfeat=CRITEO_NFEAT, nfield=39, nemb=10, h=128,
        mlp_nlayer=2, mlp_nhid=500, alpha=2.0, ensemble=ensemble,
        dnn_nlayer=2, dnn_nhid=500, batch_size=4096, lr=0.001, seed=SEED,
        device="cuda")


def first_batch_logit_err(ckpt, cfg, inp):
    """Scores the file's first batch from the checkpoint on the card and on
    the CPU (the plain entmax); fails unless the logits agree within rtol
    1e-4, atol 1e-5. Returns the max abs difference."""
    first = next(iter(BatchIterator(LibsvmDataset(inp, cfg.nfield),
                                    cfg.batch_size)))
    with torch.inference_mode():
        lg = predict.load_model(ckpt, "best", cfg, "cuda")(
            {k: v.cuda() for k, v in first.items()}).cpu()
        lc = predict.load_model(ckpt, "best", cfg, "cpu")(first)
    check(bool(torch.isfinite(lg).all()), "non-finite GPU logits")
    err = float((lg - lc).abs().max())
    check(torch.allclose(lg, lc, rtol=1e-4, atol=1e-5),
          f"GPU vs CPU logits of the first batch differ by {err}")
    return err


def phase_serve_criteo(tmp):
    rows = 10_000
    inp = os.path.join(tmp, "criteo_synth.libsvm")
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = criteo_config(False)
    model = create_model(cfg, seed=SEED).to("cuda").eval()
    loader = BatchIterator(LibsvmDataset(inp, 39), 4096)
    predict.score(model, loader, "cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predict.score(model, loader, "cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): an aten op's own event
    # carries its kernels' time too and would count it twice
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    log("profile", batches=len(loader), wall_ms=wall_ms, device_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        top=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
             for e in top])


def zero_counts():
    entmax_cuda.LAUNCHES = entmax_cuda.BWD_LAUNCHES = scatter_cuda.LAUNCHES = 0


def read_counts():
    return {"entmax_fwd": entmax_cuda.LAUNCHES,
            "entmax_bwd": entmax_cuda.BWD_LAUNCHES,
            "table_grad": scatter_cuda.LAUNCHES}


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
def arm_probe(model, batch):
    """(entmax support y > 0 [B, F, O] on the CPU, u * kappa) for a batch,
    by the same ops as ops/interaction.arm1h_interaction. kappa is the
    largest |mean| / std over the channels of arm_bn's input, the
    exponential neurons exp(z): one f32 rounding (u = 2^-24) of that input
    is u * kappa of the spread arm_bn divides by, and every gradient above
    and below arm_bn inherits that relative error."""
    from armnet_tpu_torch.models.common import VALUE_CLAMP
    from armnet_tpu_torch.ops.entmax import entmax_bisect

    a = model.attn_layer
    emb = model.embedding(batch["id"], batch["value"].clamp(*VALUE_CLAMP))
    keys = torch.matmul(emb, a.bilinear_w)
    gates = torch.matmul(keys, a.query.t()) * (a.query.shape[-1] ** -0.5)
    support = (entmax_bisect(gates, a.alpha, axis=1) > 0).cpu()
    x = a(emb).transpose(0, 1).reshape(a.values.shape[0], -1)
    kappa = float((x.mean(1).abs() / x.std(1)).max())
    return support, kappa * 2.0 ** -24


@contextlib.contextmanager
def plain_versions_on_card():
    """While active, CUDA tensors take the plain PyTorch versions instead of
    the kernels (the wrappers are swapped; no kernel launches)."""
    saved = (entmax_cuda.entmax_kernel, entmax_cuda.entmax_bwd_kernel,
             scatter_cuda.table_grad)
    entmax_cuda.entmax_kernel = entmax_cuda.entmax_plain
    entmax_cuda.entmax_bwd_kernel = entmax_cuda.entmax_bwd_plain
    scatter_cuda.table_grad = scatter_cuda.table_grad_plain
    try:
        yield
    finally:
        (entmax_cuda.entmax_kernel, entmax_cuda.entmax_bwd_kernel,
         scatter_cuda.table_grad) = saved


def one_step_grads(state, cfg, batch, device):
    """(loss, logits, {name: clamped grad}, arm_probe), on the CPU, of one
    train step from the model state `state` on `device`."""
    model = create_model(cfg, seed=SEED)
    model.load_state_dict(state)
    model.to(device)
    batch = {k: v.to(device) for k, v in batch.items()}
    probe = arm_probe(model, batch)
    loss, logits = forward_loss(model, batch)
    loss.backward()
    clamp_grads(model.parameters(), 1.0)
    return (loss.item(), logits.detach().cpu(),
            {n: p.grad.cpu() for n, p in model.named_parameters()}, probe)


def within(delta, ref, rtol, atol=1e-6):
    """||delta|| <= atol * sqrt(numel) + rtol * ||ref|| (2-norms)."""
    return float(delta.norm()) <= (atol * delta.numel() ** 0.5
                                   + rtol * float(ref.norm()))


def gpu_vs_cpu_step(ckpt, ensemble, batch):
    """One train step (masked BN forward, BCE, backward, clamp) from the
    checkpoint on the card, on the card with the plain versions swapped in
    (which isolates the kernels' share of any gap), and on the CPU.

    The loss is held to 1e-5 relative. Each clamped gradient is held
    norm-wise to atol 1e-6 plus rtol = max(1e-4, 16 u kappa) (arm_probe):
    rtol 1e-4 where the forward allows it; where arm_bn magnifies one f32
    rounding of exp(z) to u kappa of its spread, two correct f32 steps
    differ by that much times the depth below, and the bound follows the
    conditioning this run measures. The card with the kernels is held both
    to the CPU and to the card with the plain versions. Also logged: the
    elements outside the elementwise rtol 1e-4, atol 1e-6 and the entmax
    columns whose support differs between card and CPU."""
    state, _ = load_checkpoint(ckpt, "last")
    cfg = criteo_config(ensemble)
    lg, yg, gg, (sg, cond) = one_step_grads(state, cfg, batch, "cuda")
    with plain_versions_on_card():
        _, yq, gq, _ = one_step_grads(state, cfg, batch, "cuda")
    lc, yc, gc, (sc, _) = one_step_grads(state, cfg, batch, "cpu")
    rtol = max(1e-4, 16 * cond)
    flips = (sg != sc).any(1)                        # [B, O] columns
    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    per_param, bad, strict_outside = {}, [], {}
    for name, ref in gc.items():
        dg = (gg[name] - ref).abs()
        tol = 1e-6 + 1e-4 * ref.abs()
        out = int((dg > tol).sum())
        per_param[name] = {"norm": float(ref.norm()), "numel": ref.numel(),
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
        if not (within(gg[name] - ref, ref, rtol)
                and within(gg[name] - gq[name], ref, rtol)):
            bad.append(name)
    res = {"loss_gpu": lg, "loss_cpu": lc,
           "loss_rel_gap": abs(lg - lc) / abs(lc),
           "logits_max_abs_gap": float((yg - yc).abs().max()),
           "logits_max_abs_gap_plain_on_card": float((yq - yc).abs().max()),
           "u_kappa": cond, "grad_rtol": rtol,
           # over the gradients above the atol floor (the biases that a
           # BatchNorm follows have a true gradient of 0)
           "max_grad_rel_gap": max(
               v["gpu_rel_gap"] for v in per_param.values()
               if v["norm"] > 1e-6 * v["numel"] ** 0.5),
           "support_flip_columns": int(flips.sum()),
           "strict_elementwise_outside": {
               n: v["elements"] for n, v in strict_outside.items()}}
    log("train_gpu_vs_cpu", ensemble=ensemble, **res,
        outside_bound=bad, per_param=per_param,
        strict_worst=strict_outside)
    check(res["loss_rel_gap"] <= 1e-5,
          f"GPU vs CPU train loss: relative gap {res['loss_rel_gap']}")
    check(not bad, f"GPU vs CPU clamped gradients outside norm-wise rtol "
                   f"{rtol:.3g}, atol 1e-6: {bad}")
    return res


def warm_train_rate(ensemble, data, epochs=4):
    """Host-clock rows/s of whole train epochs (run_epoch over the
    TRAIN_BATCHES batches: host batch assembly, copies, steps) on a fresh
    trainer, the first epoch being the warm-up. Returns (warm rates, warm
    ms per step, the trainer)."""
    cfg = criteo_config(ensemble)
    loaders = make_dataloaders("criteo", data, 39, 4096, seed=SEED)
    logger = get_logger(None, to_stdout=False, name="chip_smoke.train_rate")
    trainer = Trainer(cfg, *loaders, logger, seed=SEED)
    rows = len(loaders[0].ds)
    secs = []
    for ep in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_epoch(ep, trainer.state, loaders[0], logger,
                  device=trainer.device, train_step=trainer.train_step,
                  report_freq=10 ** 9)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    remove_logger(logger)
    warm = secs[1:]
    return ([rows / t for t in warm],
            [t / len(loaders[0]) * 1e3 for t in warm], trainer)


def phase_train(tmp):
    """cli.main at Criteo width, ensemble off and on: launches, losses, the
    GPU-vs-CPU step, then the warm rate and the train-step profile."""
    data = os.path.join(tmp, "train_data")
    os.makedirs(os.path.join(data, "criteo"))
    for i, (name, rows) in enumerate((("train", TRAIN_BATCHES * 4096),
                                      ("valid", EVAL_ROWS),
                                      ("test", EVAL_ROWS))):
        write_criteo_libsvm(os.path.join(data, "criteo", f"{name}.libsvm"),
                            rows, CRITEO_NFEAT, 39, SEED + 10 + i)
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    first = next(iter(BatchIterator(LibsvmDataset(
        os.path.join(data, "criteo", "train.libsvm"), 39), 4096)))
    totals = dict.fromkeys(read_counts(), 0)
    for ensemble in (False, True):
        exp = f"criteo_ens{int(ensemble)}"
        _, counts, seconds = run_cli(criteo_flags(ensemble) + [
            "--dataset", "criteo", "--data_dir", data, "--epoch", "2",
            "--patience", "5", "--report_freq", "1", "--seed", str(SEED),
            "--exp_name", exp, "--log_dir", os.path.join(tmp, "log"),
            "--ckpt_dir", os.path.join(tmp, "ckpt"), "--device", "cuda"])
        want = {"entmax_fwd": steps + evals, "entmax_bwd": steps,
                "table_grad": steps * (2 if ensemble else 1)}
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
        # the run's best checkpoint scores through predict on the card
        scored, score_launches = run_predict(
            ckpt, os.path.join(data, "criteo", "valid.libsvm"),
            os.path.join(tmp, f"{exp}.scores"), EVAL_ROWS)
        gap = gpu_vs_cpu_step(ckpt, ensemble, first)
        rates, ms_step, trainer = warm_train_rate(ensemble, data)
        log("train", width="cr_armnet1h", ensemble=ensemble, steps=steps,
            eval_batches=evals, launches=counts,
            per_step={k: counts[k] / steps for k in ("entmax_bwd",
                                                     "table_grad")},
            cli_seconds=seconds, first_step_loss=flat[0],
            valid_auc=[r["valid"] for r in rows],
            predict_best={"rows": scored["rows"], "auc": scored.get("auc"),
                          "launches": score_launches},
            epoch_mean_loss=means, warm_rows_per_s=rates,
            warm_ms_per_step=ms_step,
            gpu_vs_cpu={k: gap[k] for k in (
                "loss_rel_gap", "logits_max_abs_gap", "u_kappa", "grad_rtol",
                "max_grad_rel_gap", "support_flip_columns")})
        for k in totals:
            totals[k] += counts[k]
        totals["entmax_fwd"] += score_launches
        if not ensemble:
            phase_profile_train(trainer, first)
        del trainer
        torch.cuda.empty_cache()
    return totals


def phase_profile_train(trainer, batch):
    """torch.profiler over one warm Criteo-width train step (ensemble off),
    the batch's copy to the card included: device time by kernel and the
    device's busy share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from armnet_tpu_torch.train.step import init_meters

    def step():
        dev = {k: v.to("cuda", non_blocking=True) for k, v in batch.items()}
        trainer.train_step(trainer.state, init_meters("cuda"), dev)

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:14]
    log("profile_train", wall_ms=wall_ms, device_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
        top=[[e.key[:80], e.count, e.self_device_time_total / 1e3]
             for e in top])


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


def main():
    phase_device()
    # full-f32 GEMMs on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    fused_arm_bounds()
    fwd = phase_kernel()[2.0]                 # cr_armnet1h's alpha
    bwd = phase_kernel_bwd()[2.0]
    tg = phase_kernel_table_grad()
    with tempfile.TemporaryDirectory() as tmp:
        inp, serve = phase_serve_criteo(tmp)
        serve += phase_serve_frappe(tmp)
        phase_profile(inp)
        train = phase_train(tmp)
        frappe = phase_frappe_train(tmp)
    launches = {k: train[k] + frappe[k] for k in train}
    launches["entmax_fwd"] += serve

    crit = tg["criteo_batch"]
    print(json.dumps({"kernels": [
        {"name": "entmax_fwd", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/entmax.cu",
         "replaces": "armnet_tpu/kernels/entmax_pallas.py:151",
         "also_replaces": "armnet_tpu/kernels/entmax_pallas.py:40",
         "launches": launches["entmax_fwd"],
         "max_abs_err": fwd["max_abs_err"], "ms": fwd["ms"],
         "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": None,
         "shape": list(CRITEO_SHAPE), "alpha": 2.0},
        {"name": "entmax_bwd", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/entmax.cu",
         "replaces": "armnet_tpu/kernels/entmax_pallas.py:159",
         "also_replaces": "armnet_tpu/kernels/entmax_pallas.py:53",
         "launches": launches["entmax_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None,
         "shape": list(CRITEO_SHAPE), "alpha": 2.0},
        {"name": "table_grad", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/table_grad.cu",
         "replaces": "armnet_tpu/kernels/scatter_pallas.py:122",
         "launches": launches["table_grad"],
         "max_abs_err": tg["max_abs_err"],
         "max_abs_err_vs_index_add_on_card":
             tg["max_abs_err_vs_index_add_on_card"], "ms": crit["ms"],
         "plain_ms": crit["plain_ms"], "bound_ms": crit["bound_ms"],
         "bound_by": crit["bound_by"], "library_ms": crit["library_ms"],
         "table_grad_ms_with_sort": crit["table_grad_ms"],
         "all_ids_equal_ms": tg["all_ids_equal"]["ms"],
         "shape": [4096 * 39, 10], "nrows": CRITEO_NFEAT},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
