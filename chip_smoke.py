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
              Frappe shapes, a 2-D last-axis and a ragged shape and a NaN
              column, at four alphas (the forward timed at both shapes);
              the table gradient on a Criteo batch's int32 and int64 ids,
              Zipf-skewed ids, all ids equal, wrapped and dropped ids and
              a ragged table, twice (bitwise equal), its radix sort
              against a stable torch.sort, and its time split into the
              sort and the fill and segmented sums. Kernel, plain and
              library times (device ms of one call, and host-inclusive
              ms beside them: armnet_tpu_torch/kernels/bench.py) beside
              the bound
     kernel_arm  the fused ARM-1h forward (K5) and recompute backward (K6)
              against their plain versions at the Criteo and Frappe steps,
              a ragged batch, one row, O 200 and 96, F 16 and 17, fewer
              rows than K6's grid, and wide embeddings (Frappe at nemb
              100 with h 10, Criteo's fields at nemb 40), at four
              alphas, K6 twice (bitwise equal); kernel, plain and
              composed-path times beside the bound, blocks per SM, K6's
              grid and its split into its main kernel and the ordered
              sum of the blocks' partials
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
  6. profile  torch.profiler over one warm Criteo-width scoring pass:
              device time by kernel and the device's busy share
  7. train    armnet_tpu_torch.train.cli.main at cr_armnet1h widths,
              ensemble off and on (the cr_armnet1h+ tower), and with the
              ensemble off under --kernels pallas-fused (K5 and K6 per
              step, no entmax launch), 2 epochs of 10 batches on seeded
              synthetic files: finite losses that fall, the kernel
              launches per train step and per eval batch, one step on the
              card against the same step on the CPU from the run's
              checkpoint, and warm train rows/s over whole epochs
  8. frappe_train  3 epochs of the frappe_armnet1h recipe on data/frappe/:
              valid and test AUC per epoch beside the JAX package's curve
  9. profile_train  torch.profiler over one warm Criteo-width train step,
              under auto and under pallas-fused
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
import tempfile
import time

import numpy as np
import torch

from armnet_tpu_torch import predict
from armnet_tpu_torch.data.libsvm import (BatchIterator, LibsvmDataset,
                                          make_dataloaders)
from armnet_tpu_torch.kernels import (arm_cuda, build, entmax_cuda,
                                      scatter_cuda)
from armnet_tpu_torch.kernels.bench import (CRITEO_ARM, FRAPPE_ARM,
                                            FRAPPE_NEMB100_ARM,
                                            arm_bwd_split, arm_inputs,
                                            criteo_ids, host_incl_ms,
                                            ptxas_report, table_grad_cases,
                                            table_grad_split, time_ms)
from armnet_tpu_torch.kernels.bounds import (bound, entmax_bound_ms,
                                             entmax_bwd_ops_per_element,
                                             fused_arm_bounds)
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.ops.interaction import arm1h_interaction
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from armnet_tpu_torch.train.loop import Trainer, run_epoch
from armnet_tpu_torch.train.step import clamp_grads, forward_loss
from armnet_tpu_torch.utils.config import ExperimentConfig
from armnet_tpu_torch.utils.logging import get_logger, remove_logger

REPO = os.path.dirname(os.path.abspath(__file__))
CRITEO_SHAPE = (4096, 39, 128)
FRAPPE_SHAPE = (4096, 10, 128)
CRITEO_NFEAT = 2_100_000
ALPHAS = (1.5, 1.7, 2.0, 2.5)
SEED = 2025
TRAIN_BATCHES, EVAL_ROWS = 10, 6000      # synthetic Criteo train split
CPU_ROWS = 1024     # rows of a scoring batch that the CPU scores to compare
PLAIN_REPS = 5      # timings of a plain version (10-40 ms a call on the card)
# the JAX package's 3-epoch Frappe curve of this recipe (valid AUC)
FRAPPE_JAX_VALID = (0.8211, 0.8841, 0.9041)


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
    2, int32 ids), as ptxas_report names them."""
    fwd, bwd = entmax_cuda.mode_id(2.0), entmax_cuda.g_mode_id(2.0)
    names = {f"entmax_fwd_kernel<{entmax_cuda.bucket_for(d)},{fwd}>"
             for d in (39, 10)}
    names |= {f"entmax_bwd_kernel<{b},{bwd}>" for b in (64, 16)}
    names |= {f"arm1h_fwd_kernel<40,{fwd}>", f"arm1h_bwd_kernel<40,{fwd},"
              f"{bwd},0>", "sum_rows_kernel"}
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
    # 40 and 16), a 2-D last-axis case and a ragged one (bucket 8)
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
        incl_ms = host_incl_ms(lambda: entmax_cuda.entmax_kernel(x, alpha, 1))
        plain_ms = time_ms(lambda: entmax_cuda.entmax_plain(x, alpha, 1),
                           PLAIN_REPS, 1)
        xf = torch.randn(FRAPPE_SHAPE, generator=g, device="cuda") * 3.0
        frappe_ms = time_ms(lambda: entmax_cuda.entmax_kernel(xf, alpha, 1))
        bound, by = entmax_bound_ms(CRITEO_SHAPE, alpha)
        stats[alpha] = {"ms": ms, "host_incl_ms": incl_ms,
                        "plain_ms": plain_ms, "bound_ms": bound,
                        "bound_by": by, "max_abs_err": max(errs),
                        "frappe_ms": frappe_ms}
        log("kernel", name="entmax_fwd", alpha=alpha,
            shape=list(CRITEO_SHAPE), axis=1,
            bucket=entmax_cuda.bucket_for(CRITEO_SHAPE[1]), ms=ms,
            host_incl_ms=incl_ms, plain_ms=plain_ms, bound_us=bound * 1e3, bound_by=by,
            frappe_shape=list(FRAPPE_SHAPE),
            frappe_bucket=entmax_cuda.bucket_for(FRAPPE_SHAPE[1]),
            frappe_ms=frappe_ms,
            frappe_bound_us=entmax_bound_ms(FRAPPE_SHAPE, alpha)[0] * 1e3,
            max_abs_err=max(errs), tol=tol,
            library="none: no single PyTorch call computes entmax")
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
        incl_ms = host_incl_ms(
            lambda: entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1))
        plain_ms = time_ms(lambda: entmax_cuda.entmax_bwd_plain(y, dy, alpha,
                                                                1),
                           PLAIN_REPS, 1)
        numel = math.prod(CRITEO_SHAPE)
        bound_ms, by = bound(3 * 4 * numel,
                             entmax_bwd_ops_per_element(alpha) * numel)
        stats[alpha] = {"ms": ms, "host_incl_ms": incl_ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": by, "max_abs_err": max(errs)}
        log("kernel", name="entmax_bwd", alpha=alpha,
            shape=list(CRITEO_SHAPE), axis=1, ms=ms, host_incl_ms=incl_ms,
            plain_ms=plain_ms,
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


def phase_kernel_table_grad():
    """The table-gradient kernels against their plain version (index_add_)
    and against themselves (bitwise), on the train step's shapes: g
    [4096*39, 10] and nrows 2.1M. The plain version runs on a CPU copy of
    the inputs, where index_add_ adds in the kernel's order: where no row
    has more than scatter_cuda.CHUNK updates (which the kernel sums whole,
    in that order) the result is held at rtol 1e-5, atol 1e-6; where one
    has more (the Zipf cases, all ids equal; the kernel adds its pieces'
    sums in order) at 1e-6 + 1e-5 * sum|g| over the row's updates, a bound
    on any reordering of the sum. On the card index_add_'s atomics add in
    no fixed order, so there every case is held to that bound. The radix
    sort is held to a stable torch.sort (the same keys and permutation).
    Timed on bench.table_grad_cases (a Criteo batch with ids uniform
    within each field, the same Zipf-skewed, all ids equal): the whole
    call, its kernels' device time split into the sort (the key prep
    folded into its first pass) and the zero fill with the segmented sums,
    the PyTorch route it replaced (elementwise prep, stable torch.sort)
    and zeros + index_add_, one PyTorch call for the same sums."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e, nrows = 10, CRITEO_NFEAT
    timed_cases = table_grad_cases()
    n = timed_cases["criteo_batch"].numel()
    cases = {name: (ids, nrows) for name, ids in timed_cases.items()}
    cases["criteo_batch_int64"] = (timed_cases["criteo_batch"].long(),
                                   nrows)
    cases["wrapped_and_dropped"] = (torch.randint(
        -2 * nrows, 2 * nrows, (n,), generator=g, device="cuda",
        dtype=torch.int32), nrows)
    cases["ragged_small"] = (torch.randint(
        0, 3001, (37,), generator=g, device="cuda", dtype=torch.int32), 3001)
    errs, card_errs, out = [], [], {}
    for name, (ids, rows) in cases.items():
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
        if name in timed_cases:
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
    fields at nemb 40), at four alphas: the forward within rtol/atol
    2e-5, the four gradients within rtol 5e-4, atol 5e-5
    (the JAX package's tolerances for its fused kernel,
    tests/test_arm_pallas.py), and K6 equal to itself bit for bit. Times
    at the Criteo step: kernel, plain version and the composed path of
    --kernels auto (GEMMs, the entmax kernel, einsum and exp, and its
    autograd backward), which is the yardstick: no single PyTorch call
    computes this function."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cases = [CRITEO_ARM, FRAPPE_ARM, (4095, 39, 10, 10, 128),
             (1, 39, 10, 10, 128), (512, 39, 10, 10, 200),
             (512, 39, 10, 10, 96), (512, 16, 10, 10, 128),
             (512, 17, 10, 10, 128), (100, 39, 10, 10, 128),
             FRAPPE_NEMB100_ARM, (512, 39, 40, 40, 128)]
    rows, f, e, dk, o = CRITEO_ARM
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
        emb, wk, q, vt, dout = arm_inputs(g, CRITEO_ARM)
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
        bounds = fused_arm_bounds(CRITEO_ARM, alpha)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grid = arm_cuda.bwd_grid(rows, f, e, dk, o, alpha, emb.device)
        launch = {"fwd": {"blocks_per_sm": arm_cuda.fwd_blocks_per_sm(
                      f, e, dk, CRITEO_ARM[4], alpha)},
                  "bwd": {"blocks_per_sm": arm_cuda.bwd_blocks_per_sm(
                      f, e, dk, o, alpha), "grid": grid,
                      "grid_blocks_per_sm": grid / sms,
                      **arm_bwd_split(emb, wk, q, vt, dout, alpha)}}
        for kind, errs in (("fwd", ferrs), ("bwd", berrs)):
            kernel, plain, comp = times[kind]
            ms, plain_ms, composed_ms = (time_ms(kernel),
                                         time_ms(plain, PLAIN_REPS, 1),
                                         time_ms(comp))
            incl_ms = host_incl_ms(kernel)
            bound_ms, by, nbytes, nops = bounds[kind]
            stats[(kind, alpha)] = {
                "ms": ms, "host_incl_ms": incl_ms, "plain_ms": plain_ms,
                "composed_ms": composed_ms, "bound_ms": bound_ms,
                "bound_by": by, "max_abs_err": max(errs), **launch[kind]}
            log("kernel_arm", name=f"arm1h_{kind}", alpha=alpha,
                shape=dict(zip("BFEDO", CRITEO_ARM)), ms=ms,
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


def run_predict(ckpt, inp, out, expect_rows, kernel="entmax_fwd"):
    """predict.main on the card with the kernel counts set to 0 just before
    and read just after; checks rows, finite scores and launches: `kernel`
    once per batch (entmax_fwd under auto, arm1h_fwd under pallas-fused,
    which predict restores from the checkpoint's sidecar), no other."""
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
    want[kernel] = summary["batches"]
    check(counts == want, f"predict launched {counts} over "
                          f"{summary['batches']} batches, expected {want}")
    return summary, counts[kernel]


def criteo_flags(ensemble, kernels="auto"):
    """The cr_armnet1h preset's flags (armnet_tpu/utils/presets.py), with
    the cr_armnet1h+ tower when the ensemble is on; lr 0.001 for both."""
    flags = ["--model", "armnet_1h", "--mlp_nlayer", "2", "--mlp_nhid", "500",
             "--h", "128", "--alpha", "2.0", "--lr", "0.001", "--nfield",
             "39", "--nfeat", str(CRITEO_NFEAT), "--batch_size", "4096",
             "--kernels", kernels]
    if ensemble:
        flags += ["--ensemble", "--dnn_nlayer", "2", "--dnn_nhid", "500"]
    return flags


def criteo_config(ensemble, kernels="auto"):
    """cr_armnet1h widths (armnet_tpu/utils/presets.py); the ensemble tower
    takes cr_armnet1h+'s 2x500."""
    return ExperimentConfig(
        model="armnet_1h", nfeat=CRITEO_NFEAT, nfield=39, nemb=10, h=128,
        mlp_nlayer=2, mlp_nhid=500, alpha=2.0, ensemble=ensemble,
        dnn_nlayer=2, dnn_nhid=500, batch_size=4096, lr=0.001, seed=SEED,
        device="cuda", kernels=kernels)


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
    arm_cuda.LAUNCHES = arm_cuda.BWD_LAUNCHES = 0


def read_counts():
    return {"entmax_fwd": entmax_cuda.LAUNCHES,
            "entmax_bwd": entmax_cuda.BWD_LAUNCHES,
            "table_grad": scatter_cuda.LAUNCHES,
            "arm1h_fwd": arm_cuda.LAUNCHES,
            "arm1h_bwd": arm_cuda.BWD_LAUNCHES}


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
    """The entmax support y > 0 [B, F, O] of the batch's ARM gates (of its
    first `rows` rows if given: a row's gates depend on that row alone), on
    the CPU, by the same ops as ops/interaction.arm1h_interaction."""
    from armnet_tpu_torch.models.common import VALUE_CLAMP
    from armnet_tpu_torch.ops.entmax import entmax_bisect

    a = model.attn_layer
    emb = model.embedding(batch["id"][:rows],
                          batch["value"][:rows].clamp(*VALUE_CLAMP))
    keys = torch.matmul(emb, a.bilinear_w)
    gates = torch.matmul(keys, a.query.t()) * (a.query.shape[-1] ** -0.5)
    return (entmax_bisect(gates, a.alpha, axis=1) > 0).cpu()


@torch.no_grad()
def u_kappa(model, batch):
    """u * kappa for a batch. kappa is the largest |mean| / std over the
    channels of arm_bn's input, the exponential neurons exp(z): one f32
    rounding (u = 2^-24) of that input is u * kappa of the spread arm_bn
    divides by, and every gradient above and below arm_bn inherits that
    relative error."""
    from armnet_tpu_torch.models.common import VALUE_CLAMP

    a = model.attn_layer
    emb = model.embedding(batch["id"], batch["value"].clamp(*VALUE_CLAMP))
    x = a(emb).transpose(0, 1).reshape(a.values.shape[0], -1)
    kappa = float((x.mean(1).abs() / x.std(1)).max())
    return kappa * 2.0 ** -24


@contextlib.contextmanager
def plain_versions_on_card():
    """While active, CUDA tensors take the plain PyTorch versions instead of
    the kernels (the wrappers are swapped; no kernel launches)."""
    saved = (entmax_cuda.entmax_kernel, entmax_cuda.entmax_bwd_kernel,
             scatter_cuda.table_grad, arm_cuda.arm1h_fwd_kernel,
             arm_cuda.arm1h_bwd_kernel)
    entmax_cuda.entmax_kernel = entmax_cuda.entmax_plain
    entmax_cuda.entmax_bwd_kernel = entmax_cuda.entmax_bwd_plain
    scatter_cuda.table_grad = scatter_cuda.table_grad_plain
    arm_cuda.arm1h_fwd_kernel = arm_cuda.arm1h_fwd_plain
    arm_cuda.arm1h_bwd_kernel = arm_cuda.arm1h_bwd_plain
    try:
        yield
    finally:
        (entmax_cuda.entmax_kernel, entmax_cuda.entmax_bwd_kernel,
         scatter_cuda.table_grad, arm_cuda.arm1h_fwd_kernel,
         arm_cuda.arm1h_bwd_kernel) = saved


def one_step_grads(state, cfg, batch, device, probes=()):
    """(loss, logits, {name: clamped grad}, [probe(model, batch) for each
    of probes] taken before the step), on the CPU, of one train step from
    the model state `state` on `device`."""
    with timed(f"step_{device}.setup"):
        model = create_model(cfg, seed=SEED, kernels=cfg.kernels)
        model.load_state_dict(state)
        model.to(device)
        batch = {k: v.to(device) for k, v in batch.items()}
    with timed(f"step_{device}.probe"):
        seen = [probe(model, batch) for probe in probes]
    with timed(f"step_{device}.step"):
        loss, logits = forward_loss(model, batch)
        loss.backward()
        clamp_grads(model.parameters(), 1.0)
        return (loss.item(), logits.detach().cpu(),
                {n: p.grad.cpu() for n, p in model.named_parameters()},
                seen)


def within(delta, ref, rtol, atol=1e-6):
    """||delta|| <= atol * sqrt(numel) + rtol * ||ref|| (2-norms)."""
    return float(delta.norm()) <= (atol * delta.numel() ** 0.5
                                   + rtol * float(ref.norm()))


def gpu_vs_cpu_step(ckpt, ensemble, batch, kernels="auto", enforce=True):
    """One train step (masked BN forward, BCE, backward, clamp) from the
    checkpoint on the card, on the card with the plain versions swapped in
    (which isolates the kernels' share of any gap), and on the CPU.
    With enforce=False the same numbers are logged and nothing is held.

    The loss is held to 1e-5 relative. Each clamped gradient is held
    norm-wise to atol 1e-6 plus rtol = max(1e-4, 16 u kappa) (u_kappa):
    rtol 1e-4 where the forward allows it; where arm_bn magnifies one f32
    rounding of exp(z) to u kappa of its spread, two correct f32 steps
    differ by that much times the depth below, and the bound follows the
    conditioning this run measures. The card with the kernels is held both
    to the CPU and to the card with the plain versions. Also logged: the
    elements outside the elementwise rtol 1e-4, atol 1e-6 and, among the
    batch's first CPU_ROWS rows, the entmax columns whose support differs
    between card and CPU."""
    with timed("step.load"):
        state, _ = load_checkpoint(ckpt, "last")
    cfg = criteo_config(ensemble, kernels)
    lg, yg, gg, (sg, cond) = one_step_grads(state, cfg, batch, "cuda",
                                            (entmax_support, u_kappa))
    with plain_versions_on_card():
        _, yq, gq, _ = one_step_grads(state, cfg, batch, "cuda")
    lc, yc, gc, (sc,) = one_step_grads(
        state, cfg, batch, "cpu",
        (lambda model, b: entmax_support(model, b, CPU_ROWS),))
    rtol = max(1e-4, 16 * cond)
    flips = (sg[:CPU_ROWS] != sc).any(1)             # [rows, O] columns
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
           "support_rows": CPU_ROWS,
           "strict_elementwise_outside": {
               n: v["elements"] for n, v in strict_outside.items()}}
    log("train_gpu_vs_cpu", ensemble=ensemble, kernels=kernels, ckpt=ckpt,
        enforced=enforce, **res, outside_bound=bad, per_param=per_param,
        strict_worst=strict_outside)
    if not enforce:
        return res
    check(res["loss_rel_gap"] <= 1e-5,
          f"GPU vs CPU train loss: relative gap {res['loss_rel_gap']}")
    check(not bad, f"GPU vs CPU clamped gradients outside norm-wise rtol "
                   f"{rtol:.3g}, atol 1e-6: {bad}")
    return res


def warm_train_rate(ensemble, data, kernels="auto", epochs=4):
    """Host-clock rows/s of whole train epochs (run_epoch over the
    TRAIN_BATCHES batches: host batch assembly, copies, steps) on a fresh
    trainer, the first epoch being the warm-up. Returns (warm rates, warm
    ms per step, the trainer)."""
    cfg = criteo_config(ensemble, kernels)
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
    """cli.main at Criteo width, ensemble off and on under auto, and
    ensemble off under pallas-fused: launches, losses, the GPU-vs-CPU
    step, then the warm rate and, ensemble off, the train-step profile."""
    data = os.path.join(tmp, "train_data")
    os.makedirs(os.path.join(data, "criteo"))
    for i, (name, rows) in enumerate((("train", TRAIN_BATCHES * 4096),
                                      ("valid", EVAL_ROWS),
                                      ("test", EVAL_ROWS))):
        with timed("write_libsvm"):
            write_criteo_libsvm(os.path.join(data, "criteo",
                                             f"{name}.libsvm"),
                                rows, CRITEO_NFEAT, 39, SEED + 10 + i)
    steps = 2 * TRAIN_BATCHES
    evals = 2 * 2 * -(-EVAL_ROWS // 4096)
    first = next(iter(BatchIterator(LibsvmDataset(
        os.path.join(data, "criteo", "train.libsvm"), 39), 4096)))
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
                "arm1h_fwd": 0, "arm1h_bwd": 0}
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
            if not fused:
                gap = gpu_vs_cpu_step(ckpt, ensemble, first)
            else:
                # held from the state the auto run's step was held at, so
                # the two kernel choices are compared at one conditioning;
                # the fused run's own state is logged beside it
                gap = gpu_vs_cpu_step(state_ckpt, ensemble, first, kernels)
                gpu_vs_cpu_step(ckpt, ensemble, first, kernels,
                                enforce=False)
        if not ensemble and not fused:
            state_ckpt = ckpt
        with timed("train.warm_rate"):
            rates, ms_step, trainer = warm_train_rate(ensemble, data,
                                                      kernels)
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
                "max_grad_rel_gap", "support_flip_columns")})
        for k in totals:
            totals[k] += counts[k]
        totals[score_kernel] += score_launches
        if not ensemble:
            phase_profile_train(trainer, first, kernels)
        del trainer
        torch.cuda.empty_cache()
    return totals


def phase_profile_train(trainer, batch, kernels):
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
    port = ("entmax_", "radix_", "zero_kernel", "segment_kernel", "arm1h_",
            "sum_rows_kernel")
    log("profile_train", kernels=kernels, wall_ms=wall_ms, device_ms=busy_ms,
        device_busy_share=busy_ms / wall_ms,
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


def main():
    phase_device()
    # full-f32 GEMMs on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with timed("build"):
        phase_build()
    with timed("kernel"):
        fwd = phase_kernel()[2.0]                 # cr_armnet1h's alpha
    with timed("kernel_bwd"):
        bwd = phase_kernel_bwd()[2.0]
    with timed("kernel_table_grad"):
        tg = phase_kernel_table_grad()
    with timed("kernel_arm"):
        arm = phase_kernel_arm()
    with tempfile.TemporaryDirectory() as tmp:
        with timed("serve"):
            inp, serve = phase_serve_criteo(tmp)
        with timed("serve_fused"):
            serve_fused = phase_serve_fused(tmp, inp)
        with timed("frappe"):
            serve += phase_serve_frappe(tmp)
        with timed("profile"):
            phase_profile(inp)
        with timed("train"):
            train = phase_train(tmp)
        with timed("frappe_train"):
            frappe = phase_frappe_train(tmp)
    log("seconds", **SECONDS)
    launches = {k: train[k] + frappe[k] for k in train}
    launches["entmax_fwd"] += serve
    launches["arm1h_fwd"] += serve_fused
    arm_lines = [
        {"name": f"arm1h_{kind}", "route": "cuda",
         "source": f"armnet_tpu_torch/kernels/csrc/{source}",
         "replaces": f"armnet_tpu/kernels/arm_pallas.py:{line}",
         "launches": launches[f"arm1h_{kind}"],
         **arm[(kind, 2.0)], "library_ms": None,
         "shape": dict(zip("BFEDO", CRITEO_ARM)), "alpha": 2.0}
        for kind, line, source in (("fwd", 184, "arm1h.cu"),
                                   ("bwd", 211, "arm1h_bwd.cuh"))]

    crit = tg["criteo_batch"]
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
         "bucket": entmax_cuda.bucket_for(CRITEO_SHAPE[1]),
         "frappe_ms": fwd["frappe_ms"],
         "frappe_bucket": entmax_cuda.bucket_for(FRAPPE_SHAPE[1])},
        {"name": "entmax_bwd", "route": "cuda",
         "source": "armnet_tpu_torch/kernels/csrc/entmax.cu",
         "replaces": "armnet_tpu/kernels/entmax_pallas.py:159",
         "also_replaces": "armnet_tpu/kernels/entmax_pallas.py:53",
         "launches": launches["entmax_bwd"],
         "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
         "host_incl_ms": bwd["host_incl_ms"],
         "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
         "bound_by": bwd["bound_by"], "library_ms": None,
         "shape": list(CRITEO_SHAPE), "alpha": 2.0},
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
         "shape": [4096 * 39, 10], "nrows": CRITEO_NFEAT},
        *arm_lines,
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
