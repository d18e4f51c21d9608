"""Kernel measurements on one GPU: the entmax forward (K1/K2) and backward
(K3/K4) at the serving shapes, the Diabetes130 step and columns past the
forward's register buckets, every alpha, beside their bounds, with the
backward's registers, spills and blocks per SM; both at ENTMAX_STEPS (the
last axis of mh_breakdown's gates and the multi-head presets' gates)
beside the bound and the plain version, and there on every route their C
entries take (`entmax_routes`); the table gradient (K7) on a Criteo batch
with uniform and Zipf-skewed ids and all ids equal (and on the uniform
batch at the zoo's widths E = 1 and 20) and on the UCI step, split into
its sort and its fill and segmented sums beside the PyTorch route it
replaced, `zeros + index_add_` and the bound, the fused ARM-1h forward and
backward (K5/K6) at the Criteo, Frappe, Diabetes130 and UCI steps (and
Frappe at nemb 100) and every alpha beside the composed path and the
bound, K6 split into its kernels, the CIN layer (K8) at the xdfm_criteo
step, BatchNorm's train-mode kernels (K9) at the cells' BatchNorms beside
the plain version and the composed path, and the registers and spills
that ptxas reports.

    python -m armnet_tpu_torch.kernels.bench [--out FILE] [SECTION ...]

SECTION is entmax, entmax_bwd, entmax_routes, table_grad, arm, cin or bn
(all if none is named).

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
import torch.nn.functional as F

from armnet_tpu_torch.kernels import (arm_cuda, bn_cuda, build, cin_cuda,
                                      entmax_cuda, scatter_cuda)
from armnet_tpu_torch.kernels.bounds import (bn_bounds, bound, cin_bounds,
                                             entmax_bound_ms,
                                             entmax_bwd_ops_per_element,
                                             fused_arm_bounds)
from armnet_tpu_torch.kernels.entmax_common import solver_mode
from armnet_tpu_torch.ops import interaction

CRITEO_SHAPE = (4096, 39, 128)
FRAPPE_SHAPE = (4096, 10, 128)
# the db_armnet1h step (armnet_tpu/utils/presets.py: batch 1024, 43 fields)
DIABETES_SHAPE = (1024, 43, 128)
# (name, the (outer, d, inner) view, alpha) of the entmax kernels' steps
# where inner is small or wide: the last axis of mh_breakdown's gates [4096,
# 4, 64, 39] (K1/K3), the gates [B, F, nattn_head x h] of the multi-head
# presets (utils/presets.py, batch 4096 but db_armnet's 1024; the UCI
# armnet step: 4 heads of 128 over 16 fields, batch 512) and the armnet_1h
# gates [4096, 39, 128] (K2/K4)
ENTMAX_STEPS = (("last_axis", (4096 * 4 * 64, 39, 1), 2.0),
                ("db_armnet", (1024, 43, 32), 1.7),
                ("uci_armnet", (512, 16, 512), 1.7),
                ("av_armnet", (4096, 22, 32), 1.5),
                ("av_armnet+", (4096, 22, 64), 2.0),
                ("frappe_armnet+", (4096, 10, 16), 1.5),
                ("ml_armnet+", (4096, 3, 8), 2.5),
                ("cr_armnet", (4096, 39, 256), 2.0),
                ("armnet_1h", CRITEO_SHAPE, 2.0))
# the entmax kernels' shapes timed at every alpha: the steps, then columns
# past the forward's register buckets
ENTMAX_SHAPES = (CRITEO_SHAPE, FRAPPE_SHAPE, DIABETES_SHAPE,
                 (512, 100, 128), (128, 300, 128))
# (B, F, E, dk, O) of the fused ARM-1h kernels at the cr_armnet1h and
# frappe_armnet1h steps
CRITEO_ARM = (4096, 39, 10, 10, 128)
FRAPPE_ARM = (4096, 10, 10, 10, 128)
# the db_armnet1h step: past the 40-field register bucket
DIABETES_ARM = (1024, 43, 10, 10, 128)
# the armnet_1h step on the UCI letter geometry (batch 512, 16 fields,
# alpha 1.7)
UCI_ARM = (512, 16, 10, 10, 128)
# the ARM-Net reference's Frappe embedding sweep at its best AUC (armnet_1h
# --nemb 100 --h 10 --alpha 1.7, BASELINE.md): embeddings wider than K6's
# 16-wide register sums
FRAPPE_NEMB100_ARM = (4096, 10, 100, 100, 10)
CRITEO_NFEAT = 2_100_000
# (B, E, F, C, N) of the CIN's layers at the xdfm_criteo step (65,536
# rows, 39 fields, E 10, 200 maps): layer 0 reads the fields, 1 and 2 the
# maps; the plain version is timed on PLAIN_CIN_ROWS of them (its outer
# product of the whole step would not fit), the blocked route
# (ops/interaction's, as the program runs it) on all
CIN_LAYERS = ((65536, 10, 39, 39, 200), (65536, 10, 39, 200, 200))
PLAIN_CIN_ROWS = 8192
# [N, C, S] of the train-mode BatchNorms that take K9 at the cells'
# 65,536-row step: arm_bn of cr_armnet1h ([B, O, E]: 128 x 10) and of
# cr_armnet (4 heads of 64); the MLPs' [B, C] BatchNorms (S = 1) stay on
# the composed ops (ops/layers.bn_route)
BN_SHAPES = (("cr_armnet1h.arm_bn", (65536, 128, 10)),
             ("cr_armnet.arm_bn", (65536, 256, 10)))
ALPHAS = (1.5, 1.7, 2.0, 2.5)
SEED = 2025
# Zipf exponents of the skewed table-gradient cases: 0.99 is YCSB's
# Zipfian constant (Cooper et al., "Benchmarking Cloud Serving Systems with
# YCSB", SoCC 2010), 1.5 the power-law ids of the JAX package's own tests
# (tests/test_parallel.py); neither is measured on Criteo's ids
ZIPF_EXPONENTS = (0.99, 1.5)
# the table gradient's widths beside nemb 10: FeaturesLinear's weight (E =
# 1) and HOFM's table at the CLI defaults (E = nemb * (k - 1) = 20)
ZOO_WIDTHS = (1, 20)
HOLD_CYCLES = 2_000_000   # ~1 ms of the card's clock: longer than any enqueue
PROFILE_TRIES = 3
EMPTY_SESSIONS = 0        # profiler sessions that recorded no device event
# the kernels against their plain versions inside one train step on the
# card (the smoke and tests/test_torch_cuda.py): the loss and each clamped
# gradient, norm-wise (largest gradient gap read 8.4e-7 over every phase of
# the smoke, the loss 0)
KERNELS_VS_PLAIN_RTOL = 1e-5


def within(delta, ref, rtol, atol=1e-6):
    """||delta|| <= atol * sqrt(numel) + rtol * ||ref|| (2-norms)."""
    return float(delta.norm()) <= (atol * delta.numel() ** 0.5
                                   + rtol * float(ref.norm()))


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
    Itanium-mangled kernel name with integer, bool (as 0 or 1) or int-type
    template arguments."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, name = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():   # <length><name> ...
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    args = re.match(r"I((?:L[ib]-?\d+E|[ilx])+)E", mangled[i:])
    if not args:
        return name
    types = {"i": "int", "l": "long", "x": "long long"}
    return name + "<" + ",".join(
        num or types[t] for num, t in re.findall(r"L[ib](-?\d+)E|([ilx])",
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


def device_events(run, activities=None, tries=PROFILE_TRIES):
    """(the device events with device time of prof.key_averages(), what
    run() returned) of the first of `tries` torch.profiler sessions over
    run() (activities: CUDA alone by default) that records a device event
    at all: on the card under torch 2.11 a session now and then recorded
    none, at any point of a process. ([], the last return) if none does;
    every empty session adds one to EMPTY_SESSIONS."""
    global EMPTY_SESSIONS
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=activities
                     or [ProfilerActivity.CUDA]) as prof:
            ret = run()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if events:
            return events, ret
        EMPTY_SESSIONS += 1
    return [], ret


def kernel_device_ms(fn, reps=5):
    """{kernel name: device ms per call of fn}, from torch.profiler over
    reps calls after one warm call ({} if no session records an event:
    device_events)."""
    def run():
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in device_events(run)[0]}


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
    zeros + index_add_ (one PyTorch call for the same sums). Where the
    profiler records no device event (kernel_device_ms), the split is
    taken from CUDA events instead: the sort alone (sort_ids, the same
    radix passes), the fill with the sums as the whole call less the sort,
    no fill alone; `split_by` says which."""
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
    whole_ms = time_ms(whole)
    if by_kernel:
        sort = [ms for k, ms in by_kernel.items() if "radix_" in k]
        fill = [ms for k, ms in by_kernel.items() if "zero_kernel" in k]
        sums = [ms for k, ms in by_kernel.items() if "segment_kernel" in k]
        if len(sort) < 2 or len(fill) != 1 or not sums:
            raise RuntimeError(f"table_grad's kernels not found in the "
                               f"profile: {sorted(by_kernel)}")
        split = {"split_by": "torch.profiler", "sort_ms": sum(sort),
                 "kernel_ms": fill[0] + sum(sums), "fill_ms": fill[0]}
    else:
        sort_ms = time_ms(lambda: scatter_cuda.sort_ids(ids, nrows))
        split = {"split_by": "cuda events", "sort_ms": sort_ms,
                 "kernel_ms": whole_ms - sort_ms, "fill_ms": None}
    return {
        "whole_ms": whole_ms,
        "whole_host_incl_ms": host_incl_ms(whole),
        **split,
        "torch_prep_ms": time_ms(lambda: _elementwise_prep(ids, nrows)),
        "torch_sort_ms": time_ms(lambda: torch.sort(keys, stable=True)),
        "torch_zeros_ms": time_ms(lambda: torch.zeros(
            (nrows, e), device=gr.device)),
        "library_ms": time_ms(library),
        "library_host_incl_ms": host_incl_ms(library),
    }


def bench_table_grad():
    """K7 (table_grad_split) on table_grad_cases at E 10, on the Criteo
    batch at ZOO_WIDTHS, and on the UCI step (batch 512 of 16 fields: 16
    live rows of the 5,500-row table, 512 updates each), beside its bound:
    g read once, the ids once, the dense output written once, one add an
    update element."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    cases = table_grad_cases()
    runs = [(name, ids, 10, CRITEO_NFEAT) for name, ids in cases.items()]
    runs += [("criteo_batch", cases["criteo_batch"], e, CRITEO_NFEAT)
             for e in ZOO_WIDTHS]
    runs.append(("uci_16_live", torch.arange(
        16, dtype=torch.int32, device="cuda").repeat(512), 10, 5500))
    for name, ids, e, nrows in runs:
        gr = torch.randn((ids.numel(), e), generator=g, device="cuda")
        bound_ms, by = bound(4 * nrows * e + 4 * gr.numel()
                             + ids.element_size() * ids.numel(), gr.numel())
        yield {"table_grad": name, "n": ids.numel(), "e": e, "nrows": nrows,
               **table_grad_split(gr, ids, nrows), "bound_ms": bound_ms,
               "bound_by": by}


def bench_entmax():
    """K1/K2 at ENTMAX_SHAPES and every alpha beside the bound, then at
    ENTMAX_STEPS beside the bound and the plain version: device and
    host-inclusive ms, the route and its blocks per SM, the max abs
    difference from the plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for shape in ENTMAX_SHAPES:
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        for alpha in ALPHAS:
            err = float((entmax_cuda.entmax_kernel(x, alpha, 1)
                         - entmax_cuda.entmax_plain(x, alpha, 1)).abs().max())

            def call():
                return entmax_cuda.entmax_kernel(x, alpha, 1)

            bound_ms, by = entmax_bound_ms(shape, alpha)
            yield {"entmax_fwd": list(shape), "alpha": alpha,
                   "route": entmax_cuda.route_for(shape[1], shape[2],
                                                  shape[0], alpha),
                   "ms": time_ms(call), "host_incl_ms": host_incl_ms(call),
                   "bound_ms": bound_ms, "bound_by": by, "max_abs_err": err}
    for name, shape, alpha in ENTMAX_STEPS:
        outer, d, inner = shape
        x = torch.randn(shape, generator=g, device="cuda") * 3.0

        def call():
            return entmax_cuda.entmax_kernel(x, alpha, 1)

        def plain():
            return entmax_cuda.entmax_plain(x, alpha, 1)

        err = float((call() - plain()).abs().max())
        bound_ms, by = entmax_bound_ms(shape, alpha)
        yield {"entmax_fwd": name, "shape": list(shape), "alpha": alpha,
               "route": entmax_cuda.route_for(d, inner, outer, alpha),
               "blocks_per_sm": entmax_cuda.fwd_blocks_per_sm(d, inner, outer,
                                                              alpha),
               "ms": time_ms(call), "host_incl_ms": host_incl_ms(call),
               "plain_ms": time_ms(plain, 5, 1), "bound_ms": bound_ms,
               "bound_by": by, "max_abs_err": err}


def bench_entmax_bwd():
    """K3/K4 at ENTMAX_SHAPES and every alpha, then at ENTMAX_STEPS
    beside the plain version, y from the forward kernel: device and
    host-inclusive ms, the bound, the max abs difference from the plain
    version, the route and its blocks per SM; first the registers and
    spills of its instantiations."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    yield {"entmax_bwd_ptxas": ptxas_report(build.build_log("entmax_bwd"))}
    steps = [(list(shape), shape, alpha) for shape in ENTMAX_SHAPES
             for alpha in ALPHAS] + list(ENTMAX_STEPS)
    for name, shape, alpha in steps:
        d, inner = shape[1], shape[2]
        y = entmax_cuda.entmax_kernel(
            torch.randn(shape, generator=g, device="cuda") * 3.0, alpha, 1)
        dy = torch.randn(shape, generator=g, device="cuda")

        def call():
            return entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)

        def plain():
            return entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1)

        err = float((call() - plain()).abs().max())
        numel = shape[0] * d * inner
        bound_ms, by = bound(12 * numel,
                             entmax_bwd_ops_per_element(alpha) * numel)
        rec = {"entmax_bwd": name, "shape": list(shape), "alpha": alpha,
               "ms": time_ms(call), "host_incl_ms": host_incl_ms(call),
               "bound_ms": bound_ms, "bound_by": by,
               "route": entmax_cuda.bwd_route_for(d, inner),
               "blocks_per_sm": entmax_cuda.bwd_blocks_per_sm(d, alpha,
                                                              inner),
               "max_abs_err": err}
        if isinstance(name, str):
            rec["plain_ms"] = time_ms(plain, 5, 1)
        yield rec


def fwd_on_route(x, alpha, route):
    """y = the forward kernel over axis 1 of the contiguous 3-D CUDA tensor
    x on `route` (any route its C entries take there, not only route_for's;
    no call is counted in the ledger)."""
    outer, d, inner = x.shape
    y = torch.empty_like(x)
    build.launch(*entmax_cuda.fwd_entry(alpha, route), x.device,
                 *entmax_cuda.fwd_args(x, y, alpha, outer, d, inner, route))
    return y


def bwd_on_route(y, dy, alpha, per_block):
    """dx = the backward kernel over axis 1 of contiguous 3-D CUDA tensors
    with `per_block` outer indices a block (0: the staged route; no call is
    counted in the ledger)."""
    outer, d, inner = y.shape
    dx = torch.empty_like(y)
    build.launch("entmax_bwd", "armnet_entmax_bwd", entmax_cuda.BWD_ARGTYPES,
                 y.device, y.data_ptr(), dy.data_ptr(), dx.data_ptr(), outer,
                 d, inner, per_block, entmax_cuda.g_mode_id(alpha),
                 2.0 - alpha)
    return dx


def fwd_routes(d, inner, alpha):
    """The forward's routes whose C entries take (d, inner) at alpha with d
    <= REGISTER_D and inner <= PACKED_LANES_INNER: the wide register route
    (the only one before the packed route), and the packed route at 1, 2
    and 4 lanes a column (the buckets csrc/entmax_fwd.cuh instantiates; one
    lane in the newton mode)."""
    routes = [("register", entmax_cuda.bucket_for(d))]
    newton = solver_mode(alpha) == "newton"
    for lanes, top in ((1, 64),) if newton else ((1, 64), (2, 32), (4, 16)):
        bucket = entmax_cuda.bucket_for(d, lanes)
        if bucket <= top and lanes * inner <= entmax_cuda.PACKED_THREADS:
            routes.append(("packed", bucket, lanes))
    return routes


def bench_entmax_routes():
    """Each of ENTMAX_STEPS on every route the kernels' C entries take
    there, beside the one that route_for and bwd_route_for choose: the
    forward on fwd_routes where its inner is small (the wide route, then
    the packed one by lanes), the backward on the staged route (the only
    one before the packed route) and the packed one with as many outer
    indices a block as bwd_route_for gives and half as many; device ms,
    blocks per SM and the max abs difference from the plain version."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for name, shape, alpha in ENTMAX_STEPS:
        outer, d, inner = shape
        x = torch.randn(shape, generator=g, device="cuda") * 3.0
        yp = entmax_cuda.entmax_plain(x, alpha, 1)
        chosen = entmax_cuda.route_for(d, inner, outer, alpha)
        small = d <= entmax_cuda.REGISTER_D and \
            inner <= entmax_cuda.PACKED_LANES_INNER
        for route in fwd_routes(d, inner, alpha) if small else [chosen]:
            def call():
                return fwd_on_route(x, alpha, route)

            yield {"entmax_fwd_route": name, "shape": list(shape),
                   "alpha": alpha, "route": route, "chosen": route == chosen,
                   "ms": time_ms(call),
                   "blocks_per_sm": entmax_cuda.fwd_blocks_per_sm(
                       d, inner, outer, alpha, route=route),
                   "max_abs_err": float((call() - yp).abs().max())}
        dy = torch.randn(shape, generator=g, device="cuda")
        want = entmax_cuda.entmax_bwd_plain(yp, dy, alpha, 1)
        top = entmax_cuda.bwd_route_for(d, inner)[1]
        for per_block in sorted({0, top, top // 2}):
            def call():
                return bwd_on_route(yp, dy, alpha, per_block)

            yield {"entmax_bwd_route": name, "shape": list(shape),
                   "alpha": alpha, "per_block": per_block,
                   "chosen": per_block == top, "ms": time_ms(call),
                   "blocks_per_sm": entmax_cuda.bwd_blocks_per_sm(
                       d, alpha, inner, per_block=per_block),
                   "max_abs_err": float((call() - want).abs().max())}


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
    (sum_rows_kernel) and any other kernel of the call; None for each
    where the profiler records no device event (kernel_device_ms)."""
    by_kernel = kernel_device_ms(
        lambda: arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha))
    if not by_kernel:
        return {"split_by": None, "main_ms": None, "sum_rows_ms": None,
                "other_ms": None}
    main = [ms for k, ms in by_kernel.items() if "arm1h_bwd_kernel" in k]
    sums = [ms for k, ms in by_kernel.items() if "sum_rows_kernel" in k]
    if len(main) != 1 or len(sums) != 1:
        raise RuntimeError(f"arm1h_bwd's kernels not found in the profile: "
                           f"{sorted(by_kernel)}")
    return {"split_by": "torch.profiler", "main_ms": main[0],
            "sum_rows_ms": sums[0],
            "other_ms": sum(by_kernel.values()) - main[0] - sums[0]}


def arm_times(shape, alpha, g, composed, split=True):
    """{"fwd"|"bwd": record} of K5 and K6 at one shape and alpha: device
    and host-inclusive ms of the kernel, the composed path's device ms
    (`composed(emb, wk, q, values, alpha)` with values [O, F], the
    interaction of --kernels auto, and its autograd backward), the bound,
    the resident blocks per SM (and K6's grid), the max abs difference
    from the plain version and, for K6, whether two calls agree bit for
    bit and, with `split`, its split by torch.profiler."""
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
        grid=grid, grid_blocks_per_sm=grid / sms)
    if split:
        out["bwd"].update(arm_bwd_split(emb, wk, q, vt, dout, alpha))
    return out


def bench_arm(composed):
    """K5/K6 records (arm_times) at the Criteo and Frappe steps, Frappe at
    nemb 100, the Diabetes130 step (43 fields: the columns in shared
    memory) and the UCI step, at every alpha, after the registers and
    spills of their 40-field bucket and of the shared-memory route;
    `composed` is the interaction they are timed beside (arm_times). K6's
    profiler split is taken at the first three steps only: one process
    that opened more torch.profiler sessions saw the last of them return
    no events."""
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    ptxas = {}
    for n in (n for n in build.sources() if n.startswith("arm1h")):
        ptxas.update({k: v for k, v in ptxas_report(build.build_log(
            n)).items() if "<40," in k or "<0," in k or "_col_" in k
            or k == "sum_rows_kernel"})
    yield {"arm_ptxas": ptxas}
    for name, shape in (("criteo", CRITEO_ARM), ("frappe", FRAPPE_ARM),
                        ("frappe_nemb100", FRAPPE_NEMB100_ARM),
                        ("diabetes", DIABETES_ARM), ("uci", UCI_ARM)):
        for alpha in ALPHAS:
            for kind, rec in arm_times(shape, alpha, g, composed,
                                       name not in ("diabetes",
                                                    "uci")).items():
                yield {f"arm1h_{kind}": name,
                       "shape": dict(zip("BFEDO", shape)), "alpha": alpha,
                       **rec}


def cin_inputs(g, shape):
    """Seeded x0t [B, E, F], xkt [B, E, C], w [F*C, N] and dout [B, E, N]
    of one CIN layer, on the card (x_k as a ReLU output: half zeros)."""
    b, e, f, c, n = shape
    x0 = torch.randn((b, e, f), generator=g, device="cuda") * 0.5
    xk = torch.relu(torch.randn((b, e, c), generator=g, device="cuda"))
    w = torch.rand((f * c, n), generator=g, device="cuda").sub_(0.5).mul_(
        2 * (f * c) ** -0.5)
    dout = torch.randn((b, e, n), generator=g, device="cuda") * 1e-3
    return x0, xk, w, dout


def _blocked_route(x0, xk, w, dout):
    """(rows a block, forward, backward) of ops/interaction's blocked route
    on x0t [B, E, F], xkt [B, E, C] and w: the forward one apply of
    _CINBlocked, the backward its backward alone, over a graph kept for
    the repeats."""
    rows = interaction._block_rows(x0.transpose(1, 2), xk.transpose(1, 2))
    leaves = [t.detach().requires_grad_() for t in (x0, xk, w)]
    out = interaction._CINBlocked.apply(*leaves, rows, None)
    return (rows,
            lambda: interaction._CINBlocked.apply(x0, xk, w, rows, None),
            lambda: torch.autograd.grad(out, leaves, dout,
                                        retain_graph=True))


def bench_cin():
    """K8 at CIN_LAYERS: the fused forward and backward (device and
    host-inclusive ms, achieved TFLOP/s, each kernel's device ms), the
    bound, the plain version on PLAIN_CIN_ROWS rows and the blocked route
    on all, with TF32 off; the kernels' registers and spills first."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield {"cin_ptxas": ptxas_report(build.build_log("cin"))}
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    for shape in CIN_LAYERS:
        x0, xk, w, dout = cin_inputs(g, shape)
        out = cin_cuda.cin_fwd(x0, xk, w)
        rows, blocked_fwd, blocked_bwd = _blocked_route(x0, xk, w, dout)
        sub = (x0[:PLAIN_CIN_ROWS], xk[:PLAIN_CIN_ROWS])
        calls = {
            "fwd": (lambda: cin_cuda.cin_fwd(x0, xk, w),
                    lambda: cin_cuda.cin_fwd_plain(*sub, w), blocked_fwd),
            "bwd": (lambda: cin_cuda.cin_bwd(x0, xk, w, out, dout),
                    lambda: cin_cuda.cin_bwd_plain(
                        *sub, w, out[:PLAIN_CIN_ROWS],
                        dout[:PLAIN_CIN_ROWS]), blocked_bwd)}
        bounds = cin_bounds(shape)
        for kind, (kernel, plain, blocked) in calls.items():
            dev = time_ms(kernel, reps=5, warmup=1)
            bms, by, nbytes, nops = bounds[kind]
            yield {f"cin_{kind}": dict(zip("BEFCN", shape)),
                   "time_ms": dev,
                   "host_incl_ms": host_incl_ms(kernel, reps=5, warmup=1),
                   "bound_ms": bms, "bound_by": by,
                   "tflops": 2 * nops / dev / 1e9,
                   "roofline_pct": 100 * bms / dev,
                   "plain_ms": time_ms(plain, reps=3, warmup=1),
                   "plain_rows": PLAIN_CIN_ROWS,
                   "blocked_ms": time_ms(blocked, reps=3, warmup=1),
                   "block_rows": rows,
                   "kernels_ms": kernel_device_ms(kernel, reps=2)}
        del x0, xk, w, dout, out, calls, blocked_fwd, blocked_bwd
        torch.cuda.empty_cache()


def bn_inputs(g, shape):
    """Seeded x [N, C, S] (1 + 1e-3 noise: arm_bn's exp(.) near 1, where S >
    1; unit noise for an MLP's), dy, the rows' mask (every row real, as the
    cells' batches are), its count, weight and bias, on the card."""
    n, c, s = shape
    x = torch.randn(shape, generator=g, device="cuda")
    if s > 1:
        x = x.mul_(1e-3).add_(1.0)
    dy = torch.randn(shape, generator=g, device="cuda") * 1e-3
    rows = torch.ones(n, device="cuda")
    weight = torch.rand(c, generator=g, device="cuda") + 0.5
    bias = torch.randn(c, generator=g, device="cuda") * 0.1
    return x, dy, rows, rows.sum(), weight, bias


def bench_bn():
    """K9 at BN_SHAPES, masked as the trainer calls it: the forward and the
    backward (device and host-inclusive ms, each kernel's device ms, GB/s
    of the bytes the bound counts and of the design's: x read three times
    and y written (forward), x and dy read twice and dx written
    (backward)),
    the bound, the plain version, the composed path (the module's PyTorch
    ops, forward and autograd's backward) and the library (F.batch_norm in
    training mode, cuDNN: the same function where every row is real, as
    here; forward and autograd's backward); ptxas first."""
    from armnet_tpu_torch.ops.layers import BatchNorm, batch_mask_scope

    yield {"bn_ptxas": ptxas_report(build.build_log("batch_norm"))}
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    for name, shape in BN_SHAPES:
        x, dy, rows, count, weight, bias = bn_inputs(g, shape)
        c, s = shape[1], shape[2]
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        args = (rows, count, s, weight, bias, rm, rv, 1e-5, 0.9)
        y, mean, rstd = bn_cuda.bn_fwd(x, *args)
        bwd_args = (rows, count, s, weight, mean, rstd)
        module = BatchNorm(c, 1, device="cuda").train()
        leaf = x.detach().requires_grad_()
        with batch_mask_scope(rows):
            out = module._composed(leaf, 1, rows)
        params = [leaf, module.weight, module.bias]
        lib_rm, lib_rv = rm.clone(), rv.clone()
        lib_params = [t.detach().requires_grad_() for t in (x, weight, bias)]
        lib_out = F.batch_norm(lib_params[0], lib_rm, lib_rv, *lib_params[1:],
                               True, 0.1, 1e-5)

        def composed_fwd():
            with batch_mask_scope(rows):
                module._composed(x, 1, rows)

        def library_fwd():
            F.batch_norm(x, lib_rm, lib_rv, weight, bias, True, 0.1, 1e-5)

        calls = {
            "fwd": (lambda: bn_cuda.bn_fwd(x, *args),
                    lambda: bn_cuda.bn_fwd_plain(x, *args), composed_fwd,
                    library_fwd),
            "bwd": (lambda: bn_cuda.bn_bwd(x, dy, *bwd_args),
                    lambda: bn_cuda.bn_bwd_plain(x, dy, *bwd_args),
                    lambda: torch.autograd.grad(out, params, dy,
                                                retain_graph=True),
                    lambda: torch.autograd.grad(lib_out, lib_params, dy,
                                                retain_graph=True))}
        bounds = bn_bounds(shape)
        tensor = 4 * x.numel()
        for kind, (kernel, plain, composed, library) in calls.items():
            dev = time_ms(kernel)
            bms, by, nbytes, _ = bounds[kind]
            design = (4 if kind == "fwd" else 5) * tensor
            yield {f"bn_{kind}": name, "shape": dict(zip("NCS", shape)),
                   "time_ms": dev, "host_incl_ms": host_incl_ms(kernel),
                   "bound_ms": bms, "bound_by": by,
                   "roofline_pct": 100 * bms / dev,
                   "bound_gb_per_s": nbytes / dev / 1e6,
                   "design_gb_per_s": design / dev / 1e6,
                   "plain_ms": time_ms(plain, reps=5, warmup=1),
                   "composed_ms": time_ms(composed, reps=5, warmup=1),
                   "library_ms": time_ms(library),
                   "kernels_ms": kernel_device_ms(kernel, reps=2)}
        del x, dy, y, out, leaf, params, calls, module, lib_out, lib_params
        torch.cuda.empty_cache()


def sections(composed_arm):
    """{section: a generator function of its records}, in the order main
    runs them; `composed_arm` is the interaction that the arm section times
    K5/K6 beside."""
    return {"entmax": bench_entmax, "entmax_bwd": bench_entmax_bwd,
            "entmax_routes": bench_entmax_routes,
            "table_grad": bench_table_grad,
            "arm": lambda: bench_arm(composed_arm), "cin": bench_cin,
            "bn": bench_bn}


def main(composed_arm, argv=None):
    """Runs the named sections; `composed_arm` is the interaction that the
    arm section times K5/K6 beside."""
    named = sections(composed_arm)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out")
    p.add_argument("sections", nargs="*", choices=list(named),
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
    for section in args.sections or named:
        for rec in named[section]():
            emit(rec)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    # the program's entry wires in the composed path from the ops layer;
    # nothing else of this module imports above the kernels
    from armnet_tpu_torch.ops.interaction import arm1h_interaction

    raise SystemExit(main(composed_arm=arm1h_interaction))
