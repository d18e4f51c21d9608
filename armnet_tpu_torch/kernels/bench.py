"""Kernel measurements on one GPU: the entmax forward (K1/K2) at the serving
shapes and every alpha, the table gradient (K7) on a Criteo batch with
uniform and Zipf-skewed ids and all ids equal, split into its sort and its
fill and segmented sums beside the PyTorch route it replaced and
`zeros + index_add_`, the fused ARM-1h forward and backward (K5/K6) at the
Criteo and Frappe steps (and Frappe at nemb 100) and every alpha beside
the composed path and the bound, K6 split into its kernels, and the
registers and spills that ptxas reports.

    python -m armnet_tpu_torch.kernels.bench [--out FILE] [SECTION ...]

SECTION is entmax, table_grad or arm (all three if none is named).

`time_ms` is the device's time of one call: the median of 20 CUDA-event
timings after 3 warm calls, with the device held busy while the host
enqueues the call, so that the wrapper's host time is not counted.
`host_incl_ms` is the same median with the device idle while the host
enqueues: the method of the port's records before this module, which
counts a wrapper's host time wherever it is longer than its kernels'. A
split of one call into its kernels is their device time from
torch.profiler. One JSON object per line goes to stdout (and to --out)."""

import argparse
import json
import re
import statistics
import subprocess

import numpy as np
import torch

from armnet_tpu_torch.kernels import arm_cuda, build, entmax_cuda, scatter_cuda
from armnet_tpu_torch.kernels.bounds import fused_arm_bounds

CRITEO_SHAPE = (4096, 39, 128)
FRAPPE_SHAPE = (4096, 10, 128)
# (B, F, E, dk, O) of the fused ARM-1h kernels at the cr_armnet1h and
# frappe_armnet1h steps
CRITEO_ARM = (4096, 39, 10, 10, 128)
FRAPPE_ARM = (4096, 10, 10, 10, 128)
# the ARM-Net reference's Frappe embedding sweep at its best AUC (armnet_1h
# --nemb 100 --h 10 --alpha 1.7, BASELINE.md): embeddings wider than K6's
# 16-wide register sums
FRAPPE_NEMB100_ARM = (4096, 10, 100, 100, 10)
CRITEO_NFEAT = 2_100_000
ALPHAS = (1.5, 1.7, 2.0, 2.5)
SEED = 2025
# Zipf exponents of the skewed table-gradient cases: 0.99 is YCSB's
# Zipfian constant (Cooper et al., "Benchmarking Cloud Serving Systems with
# YCSB", SoCC 2010), 1.5 the power-law ids of the JAX package's own tests
# (tests/test_parallel.py); neither is measured on Criteo's ids
ZIPF_EXPONENTS = (0.99, 1.5)
HOLD_CYCLES = 2_000_000   # ~1 ms of the card's clock: longer than any enqueue


def _event_ms(fn, reps, warmup, hold):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_ms(fn, reps=20, warmup=3):
    """Median device ms of one call of fn, from CUDA events around each
    call. The device is held busy (torch.cuda._sleep) while the host
    enqueues the events and the call, so the time is the device's from the
    call's first kernel to the end of its last, without the host time of
    its Python wrapper."""
    return _event_ms(fn, reps, warmup, hold=True)


def host_incl_ms(fn, reps=20, warmup=3):
    """Median ms of one call of fn from CUDA events around each call, the
    device idle while the host enqueues it: the wrapper's host time counts
    wherever it is longer than the kernels' (the port's earlier method)."""
    return _event_ms(fn, reps, warmup, hold=False)


def _pretty(mangled):
    """'entmax_fwd_kernel<40,0>' or 'radix_count_kernel<int>' from an
    Itanium-mangled kernel name with integer or int-type template
    arguments."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():   # <length><name> ...
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:Li-?\d+E|[ilx])+)E", mangled[i:])
    if not args:
        return name
    types = {"i": "int", "l": "long", "x": "long long"}
    return name + "<" + ",".join(
        num or types[t] for num, t in re.findall(r"Li(-?\d+)E|([ilx])",
                                                 args.group(1))) + ">"


def ptxas_report(log):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v output."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            current = _pretty(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and current:
            out.setdefault(current, {}).update(
                spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out.setdefault(current, {})["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if "registers" in v}


def field_sizes(nfeat=CRITEO_NFEAT, nfield=39):
    """Ids per field at Criteo geometry: 13 numeric fields of 100 ids each,
    the other fields sharing the rest of the nfeat ids."""
    rest, ncat = nfeat - 1300, nfield - 13
    return np.asarray([100] * 13 + [rest // ncat + (1 if i < rest % ncat
                                                     else 0)
                                    for i in range(ncat)])


def criteo_ids(rows=4096, nfeat=CRITEO_NFEAT, nfield=39, rng=None,
               zipf=None):
    """ids [rows, nfield] int64 of seeded rows at Criteo geometry
    (field_sizes), drawn from rng (RandomState(SEED) if None): uniform
    within each field, or, with zipf=s, the k-th most frequent id of each
    field drawn with probability proportional to k^-s, the ranks scattered
    over the field's ids by a seeded permutation."""
    rng = np.random.RandomState(SEED) if rng is None else rng
    sizes = field_sizes(nfeat, nfield)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    if zipf is None:
        return offsets[None, :] + (rng.rand(rows, nfield)
                                   * sizes[None, :]).astype(np.int64)
    cols = []
    for size in sizes:
        cdf = np.cumsum(np.arange(1, size + 1, dtype=np.float64) ** -zipf)
        rank = np.minimum(np.searchsorted(cdf, rng.rand(rows) * cdf[-1],
                                          side="right"), size - 1)
        cols.append(rng.permutation(size)[rank])
    return offsets[None, :] + np.stack(cols, 1)


def table_grad_cases(device="cuda"):
    """{name: int32 ids [4096 * 39]} of the table gradient's timed cases,
    all into CRITEO_NFEAT rows: a seeded batch at Criteo geometry with ids
    uniform within each field, the same with Zipf-skewed ids at each of
    ZIPF_EXPONENTS, and all ids equal."""
    def flat(ids):
        return torch.from_numpy(ids.reshape(-1)).to(device, torch.int32)

    cases = {"criteo_batch": flat(criteo_ids())}
    for s in ZIPF_EXPONENTS:
        cases[f"zipf_{s}"] = flat(criteo_ids(zipf=s))
    cases["all_ids_equal"] = torch.full((4096 * 39,), 1234567,
                                        dtype=torch.int32, device=device)
    return cases


def kernel_device_ms(fn, reps=5):
    """{kernel name: device ms per call of fn}, from torch.profiler over
    reps calls after one warm call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}


def _elementwise_prep(ids, nrows):
    """The key prep as a chain of PyTorch ops (wrap, mask, key nrows for a
    dropped id): what the table gradient ran before its sort had a kernel."""
    ids = ids.reshape(-1).long()
    wrapped = torch.where(ids < 0, ids + nrows, ids)
    valid = (wrapped >= 0) & (wrapped < nrows)
    return torch.where(valid, wrapped, nrows).to(torch.int32)


def table_grad_split(gr, ids, nrows):
    """ms of the table gradient on one case: the whole call (time_ms, and
    host_incl_ms beside it), its kernels' device time per call split into
    the sort (radix_*) and the zero fill with the segmented sums (the fill
    alone beside it), from torch.profiler; the PyTorch route it replaced
    (elementwise prep, stable torch.sort), torch.zeros, and
    zeros + index_add_ (one PyTorch call for the same sums)."""
    keys = _elementwise_prep(ids, nrows)
    kept = keys < nrows                 # index_add_ takes no dropped id
    lib_ids, lib_g = keys[kept].long(), gr[kept]
    e = gr.shape[1]

    def whole():
        return scatter_cuda.table_grad(gr, ids, nrows)

    def library():
        return torch.zeros((nrows, e), device=gr.device).index_add_(
            0, lib_ids, lib_g)

    by_kernel = kernel_device_ms(whole)
    sort = [ms for k, ms in by_kernel.items() if "radix_" in k]
    fill = [ms for k, ms in by_kernel.items() if "zero_kernel" in k]
    sums = [ms for k, ms in by_kernel.items() if "segment_kernel" in k]
    if len(sort) < 2 or len(fill) != 1 or not sums:
        raise RuntimeError(f"table_grad's kernels not found in the "
                           f"profile: {sorted(by_kernel)}")
    return {
        "whole_ms": time_ms(whole),
        "whole_host_incl_ms": host_incl_ms(whole),
        "sort_ms": sum(sort),
        "kernel_ms": fill[0] + sum(sums),
        "fill_ms": fill[0],
        "torch_prep_ms": time_ms(lambda: _elementwise_prep(ids, nrows)),
        "torch_sort_ms": time_ms(lambda: torch.sort(keys, stable=True)),
        "torch_zeros_ms": time_ms(lambda: torch.zeros(
            (nrows, e), device=gr.device)),
        "library_ms": time_ms(library),
        "library_host_incl_ms": host_incl_ms(library),
    }


def bench_table_grad():
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    e, nrows = 10, CRITEO_NFEAT
    for name, ids in table_grad_cases().items():
        gr = torch.randn((ids.numel(), e), generator=g, device="cuda")
        yield {"table_grad": name, "n": ids.numel(), "e": e, "nrows": nrows,
               **table_grad_split(gr, ids, nrows)}


def bench_entmax():
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in (CRITEO_SHAPE, FRAPPE_SHAPE):
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        for alpha in ALPHAS:
            err = float((entmax_cuda.entmax_kernel(x, alpha, 1)
                         - entmax_cuda.entmax_plain(x, alpha, 1)).abs().max())
            def call():
                return entmax_cuda.entmax_kernel(x, alpha, 1)

            yield {"entmax_fwd": list(shape), "alpha": alpha,
                   "bucket": entmax_cuda.bucket_for(shape[1]),
                   "ms": time_ms(call), "host_incl_ms": host_incl_ms(call),
                   "max_abs_err": err}


def arm_inputs(g, shape):
    """Seeded emb, wk, q, vt and dout of the fused ARM-1h kernels at
    (B, F, E, dk, O), on the card."""
    b, f, e, dk, o = shape
    return (torch.randn((b, f, e), generator=g, device="cuda") * 0.5,
            torch.randn((e, dk), generator=g, device="cuda"),
            torch.randn((o, dk), generator=g, device="cuda"),
            torch.randn((f, o), generator=g, device="cuda") * 0.5,
            torch.randn((b, o, e), generator=g, device="cuda"))


def arm_bwd_split(emb, wk, q, vt, dout, alpha):
    """K6's device ms per call split by torch.profiler into its main kernel
    (arm1h_bwd_kernel), the ordered sum of the per-block partials
    (sum_rows_kernel) and any other kernel of the call."""
    by_kernel = kernel_device_ms(
        lambda: arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha))
    main = [ms for k, ms in by_kernel.items() if "arm1h_bwd_kernel" in k]
    sums = [ms for k, ms in by_kernel.items() if "sum_rows_kernel" in k]
    if len(main) != 1 or len(sums) != 1:
        raise RuntimeError(f"arm1h_bwd's kernels not found in the profile: "
                           f"{sorted(by_kernel)}")
    return {"main_ms": main[0], "sum_rows_ms": sums[0],
            "other_ms": sum(by_kernel.values()) - main[0] - sums[0]}


def arm_times(shape, alpha, g, composed):
    """{"fwd"|"bwd": record} of K5 and K6 at one shape and alpha: device
    and host-inclusive ms of the kernel, the composed path's device ms
    (`composed(emb, wk, q, values, alpha)` with values [O, F], the
    interaction of --kernels auto, and its autograd backward), the bound,
    the resident blocks per SM (and K6's grid), the max abs difference
    from the plain version and, for K6, its split and whether two calls
    agree bit for bit."""
    emb, wk, q, vt, dout = arm_inputs(g, shape)
    dev = emb.device
    f, e, dk, o = shape[1:]
    leaves = [t.clone().requires_grad_() for t in (emb, wk, q, vt)]
    graph = composed(leaves[0], leaves[1], leaves[2], leaves[3].t(), alpha)
    got = arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha)
    grads = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    again = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    fwd_err = float((got - arm_cuda.arm1h_fwd_plain(
        emb, wk, q, vt, alpha)).abs().max())
    bwd_err = max(float((a - w).abs().max()) for a, w in zip(
        grads, arm_cuda.arm1h_bwd_plain(emb, wk, q, vt, dout, alpha)))
    bounds = fused_arm_bounds(shape, alpha)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = {
        "fwd": (lambda: arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha),
                lambda: composed(emb, wk, q, vt.t(), alpha)),
        "bwd": (lambda: arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout,
                                                  alpha),
                lambda: torch.autograd.grad(graph, leaves, dout,
                                            retain_graph=True))}
    out = {}
    for kind, (kernel, comp) in calls.items():
        bound_ms, by, nbytes, nops = bounds[kind]
        out[kind] = {"ms": time_ms(kernel),
                     "host_incl_ms": host_incl_ms(kernel),
                     "composed_ms": time_ms(comp), "bound_ms": bound_ms,
                     "bound_by": by, "bytes": nbytes,
                     "f32_instruction_slots": nops}
    out["fwd"].update(max_abs_err=fwd_err,
                      blocks_per_sm=arm_cuda.fwd_blocks_per_sm(f, e, dk, o,
                                                               alpha))
    grid = arm_cuda.bwd_grid(shape[0], f, e, dk, o, alpha, dev)
    out["bwd"].update(
        max_abs_err=bwd_err, bitwise_equal=all(
            torch.equal(a, b) for a, b in zip(grads, again)),
        blocks_per_sm=arm_cuda.bwd_blocks_per_sm(f, e, dk, o, alpha),
        grid=grid, grid_blocks_per_sm=grid / sms,
        **arm_bwd_split(emb, wk, q, vt, dout, alpha))
    return out


def bench_arm(composed):
    """K5/K6 records (arm_times) at the Criteo and Frappe steps, and Frappe
    at nemb 100, at every alpha, after the registers and spills of their
    40-field bucket; `composed` is the interaction they are timed beside
    (arm_times)."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ptxas = {}
    for n in (n for n in build.sources() if n.startswith("arm1h")):
        ptxas.update({k: v for k, v in ptxas_report(build.build_log(
            n)).items() if "<40," in k or k == "sum_rows_kernel"})
    yield {"arm_ptxas": ptxas}
    for name, shape in (("criteo", CRITEO_ARM), ("frappe", FRAPPE_ARM),
                        ("frappe_nemb100", FRAPPE_NEMB100_ARM)):
        for alpha in ALPHAS:
            for kind, rec in arm_times(shape, alpha, g, composed).items():
                yield {f"arm1h_{kind}": name,
                       "shape": dict(zip("BFEDO", shape)), "alpha": alpha,
                       **rec}


def main(composed_arm, argv=None):
    """Runs the named sections; `composed_arm` is the interaction that the
    arm section times K5/K6 beside."""
    sections = {"entmax": bench_entmax, "table_grad": bench_table_grad,
                "arm": lambda: bench_arm(composed_arm)}
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out")
    p.add_argument("sections", nargs="*", choices=list(sections),
                   help="what to measure (default: all)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    out = open(args.out, "w") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    emit({"device": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    emit({"build_s": build.build_all()})
    emit({"ptxas": {n: ptxas_report(build.build_log(n))
                    for n in build.sources()}})
    for section in args.sections or sections:
        for rec in sections[section]():
            emit(rec)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    # the program's entry wires in the composed path from the ops layer;
    # nothing else of this module imports above the kernels
    from armnet_tpu_torch.ops.interaction import arm1h_interaction

    raise SystemExit(main(composed_arm=arm1h_interaction))
