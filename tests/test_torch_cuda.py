"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the entmax forward and backward, the table gradient (also at the zoo's
widths E = 1 and 20 into 2.1M rows) and the fused ARM-1h forward and
backward, and one train step on the card against the same step on the
CPU, through the composed and the fused interaction; the entmax kernels at
the multi-head channel counts; the CIN layer's fused kernels (K8) against
its plain version and blocked route, the route it takes under TF32 and
bfloat16, and its memory at the xdfm_criteo step; BatchNorm's train-mode
kernels (K9) against their plain version at the cells' shapes, bit for
bit on a second call, the module's route and a one-rank group; for every
other zoo
model eval logits and
one train step against the CPU with the kernels it launches, and AFN's
table gradient through its clamp-abs; the learned-alpha entmax on the card
against the CPU, and a --bf16 train step against the CPU's.

Skipped where CUDA is absent. On a GPU machine, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: the suite's conftest sets up JAX, which this file does not
use.) This file is the one card-side check of each kernel against its plain
version, the serving and step shapes among its cases; chip_smoke.py runs
it right after its build. What ran is read from the ledger of kernel calls
(utils/tracing's armnet.kernel.* counters, which kernels/build.launch adds
to once a wrapper's call has succeeded).
"""

import math

import numpy as np
import pytest
import torch

from armnet_tpu_torch import set_matmul_precision
from armnet_tpu_torch.kernels import (arm_cuda, bench, bn_cuda, build,
                                      cin_cuda, entmax_cuda, scatter_cuda)
from armnet_tpu_torch.kernels.bench import KERNELS_VS_PLAIN_RTOL, within
from armnet_tpu_torch.kernels.entmax_common import solve_tau_axis0
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.entmax import entmax_bisect
from armnet_tpu_torch.ops import interaction
from armnet_tpu_torch.ops.interaction import arm1h_fused
from armnet_tpu_torch.train.step import clamp_grads, forward_loss
from armnet_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda
ALPHAS = [1.5, 1.7, 2.0, 2.5]


def calls():
    """{kernel: calls of its wrapper} so far, from the ledger."""
    return {k[len("armnet.kernel."):]: v
            for k, v in tracing.counts("armnet.kernel.").items()}


def called(before):
    """{kernel: calls since `before`} (a return of calls()), the kernels
    not called left out."""
    return {k: v - before.get(k, 0) for k, v in calls().items()
            if v != before.get(k, 0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# every register bucket (8/16/32/64) and its edges, middle and last axes,
# and columns past the buckets (the forward's shared-memory route)
SHAPES = [((3, 1, 5), 1), ((64, 8), 0), ((5, 9, 7), 1), ((2, 16, 33), 1),
          ((4, 17, 3), 1), ((40, 33), 0), ((6, 64, 10), 1), ((2, 3, 39), -1),
          ((3, 65, 37), 1), ((100, 21), 0), ((2, 7, 300), -1)]
# the serving and step shapes: the Criteo and Frappe gates [4096, F, 128]
# (register buckets 40 and 16), a 2-D last axis and a ragged shape, the
# Diabetes130 step (bucket 48), columns past the buckets (the shared-memory
# route, cut in batch), then the packed routes' (inner small): the last
# axis of mh_breakdown's gates [4096, 4, 64, 39] as its (outer, d, inner)
# view and the multi-head presets' gates [B, F, C] (utils/presets.py)
STEP_SHAPES = [((4096, 39, 128), 1), ((4096, 10, 128), 1), ((8192, 39), -1),
               ((7, 5, 13), 1), ((1024, 43, 128), 1), ((256, 65, 128), 1),
               ((128, 100, 128), 1), ((32, 300, 128), 1)]
PACKED_STEP_SHAPES = [((4096 * 4 * 64, 39, 1), 1), ((1024, 43, 32), 1),
                      ((4096, 22, 32), 1), ((4096, 22, 64), 1),
                      ((4096, 10, 16), 1), ((4096, 3, 8), 1)]
# (alpha, shape, axis, a step shape): SHAPES at seven alphas, the step
# shapes at four
FWD_CASES = ([(a, s, ax, False) for s, ax in SHAPES
              for a in ALPHAS + [4 / 3, 1.2, 3.0]]
             + [(a, s, ax, True) for s, ax in STEP_SHAPES + PACKED_STEP_SHAPES
                for a in ALPHAS])


@pytest.mark.parametrize("alpha,shape,axis,step", FWD_CASES)
def test_entmax_kernel_matches_plain(cuda, alpha, shape, axis, step):
    """Each entry within 5e-6 of the plain version (1e-5 past alpha 2),
    each row summing to 1 within 1e-5; at the step shapes also within 1e-5
    of the plain version's norm."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    yk = entmax_cuda.entmax_kernel(x, alpha, axis)
    yp = entmax_cuda.entmax_plain(x, alpha, axis)
    torch.cuda.synchronize()
    # the two sum in different orders; alpha > 2 has unbounded slope at the
    # support boundary (see tests/test_kernels.py)
    tol = 1e-5 if alpha > 2 else 5e-6
    torch.testing.assert_close(yk, yp, rtol=0, atol=tol)
    torch.testing.assert_close(yk.sum(axis), torch.ones_like(yk.sum(axis)),
                               rtol=0, atol=1e-5)
    assert not step or within(yk - yp, yp, 1e-5, 0.0)


# (shape, the NaN's index): a packed route of 4 lanes a column, and of one
NAN_CASES = [((3, 39, 16), (1, 7, 5)), ((7, 5, 13), (3, 2, 4))]


@pytest.mark.parametrize("shape,at", NAN_CASES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_entmax_kernel_nan_column_matches_plain(cuda, alpha, shape, at):
    """A NaN in a column (an out-of-range id's embedding row) makes that
    whole column NaN, as in the plain version; other columns are untouched."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    x[at] = float("nan")
    yk = entmax_cuda.entmax_kernel(x, alpha, 1)
    yp = entmax_cuda.entmax_plain(x, alpha, 1)
    torch.cuda.synchronize()
    assert bool(yk[at[0], :, at[2]].isnan().all())
    assert int(yk.isnan().sum()) == shape[1]
    tol = 1e-5 if alpha > 2 else 5e-6
    torch.testing.assert_close(yk, yp, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("d", [8, 9, 16, 17, 39, 40, 41, 64])
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernel_bucket_edges(cuda, alpha, d):
    """Each register bucket's edges (d = 8k and 8k + 1), on an odd number of
    columns so that the last block's threads hold some columns past the
    end."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((3, d, 37), generator=g, device=cuda) * 3.0
    yk = entmax_cuda.entmax_kernel(x, alpha, 1)
    yp = entmax_cuda.entmax_plain(x, alpha, 1)
    torch.cuda.synchronize()
    tol = 1e-5 if alpha > 2 else 5e-6
    torch.testing.assert_close(yk, yp, rtol=0, atol=tol)


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_fwd_refuses_a_bucket_it_lacks(cuda, alpha):
    """Each forward C entry of the register buckets takes only the buckets
    it instantiates (multiples of 8 up to 64, d <= bucket) and only its own
    solver modes (entmax.cu the bisection modes, entmax_fastpow.cu and
    entmax_newton.cu one powf mode each); the column entry takes blocks of
    32, 64 or 128 columns whose shared memory fits a block, and every
    mode."""
    entry = entmax_cuda.fwd_entry(alpha, ("register", 16))
    x = torch.randn((2, 10, 5), device=cuda)
    y = torch.empty_like(x)

    def refused(entry, *args):
        with pytest.raises(RuntimeError, match="cudaError"):
            build.launch(*entry, x.device, *args)

    for bucket in (12, 8, 72):
        refused(entry, *entmax_cuda.fwd_args(x, y, alpha, 2, 10, 5,
                                             ("register", bucket)))
    args = list(entmax_cuda.fwd_args(x, y, alpha, 2, 10, 5,
                                     ("register", 16)))
    build.launch(*entry, x.device, *args)
    args[6] = entmax_cuda.mode_id(2.5 if alpha < 2.5 else 2.0)
    refused(entry, *args)
    col = entmax_cuda.fwd_entry(alpha, ("shared", 128))
    for route in (("shared", 96), ("shared", 256)):
        refused(col, *entmax_cuda.fwd_args(x, y, alpha, 2, 10, 5, route))
    x = torch.randn((1, 500, 128), device=cuda)
    y = torch.empty_like(x)
    refused(col, *entmax_cuda.fwd_args(x, y, alpha, 1, 500, 128,
                                       ("shared", 128)))
    for route in (("shared", 64), ("global", 128)):
        build.launch(*col, x.device,
                     *entmax_cuda.fwd_args(x, y, alpha, 1, 500, 128, route))
    torch.cuda.synchronize()


def test_entmax_kernel_counts_launches_and_rejects(cuda):
    """One launch a call, past the register buckets too (no length of the
    axis is refused); a transposed or float64 input is."""
    x = torch.randn(4, 39, 16, device=cuda)
    before = calls()
    entmax_bisect(x, 2.0, axis=1)
    assert called(before) == {"entmax_fwd": 1}
    with pytest.raises(ValueError, match="contiguous"):
        entmax_cuda.entmax_kernel(x.transpose(1, 2), 2.0, 1)
    with pytest.raises(TypeError):
        entmax_cuda.entmax_kernel(x.double(), 2.0, 1)
    entmax_cuda.entmax_kernel(torch.randn(2, 65, device=cuda), 2.0, 1)
    assert called(before) == {"entmax_fwd": 2}


@pytest.mark.parametrize("d", [65, 100, 300, 2000])
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernel_past_the_register_buckets(cuda, alpha, d):
    """d > 64: the column in shared memory (blocks of 128 columns at 65,
    100 and 300) or, at 2000, in the output, against the plain version,
    with a NaN column; on an odd number of columns, so that the last
    block's threads hold some past the end."""
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((2, d, 37), generator=g, device=cuda) * 3.0
    x[1, d // 2, 5] = float("nan")
    yk = entmax_cuda.entmax_kernel(x, alpha, 1)
    yp = entmax_cuda.entmax_plain(x, alpha, 1)
    torch.cuda.synchronize()
    assert bool(yk[1, :, 5].isnan().all()) and int(yk.isnan().sum()) == d
    tol = 1e-5 if alpha > 2 else 5e-6
    torch.testing.assert_close(yk, yp, rtol=0, atol=tol, equal_nan=True)


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
@pytest.mark.parametrize("ensemble", [False, True])
def test_armnet1h_gpu_matches_cpu(cuda, ensemble, kernels):
    cfg = ModelConfig(model="armnet_1h", nfeat=1000, nfield=39, nemb=10,
                      h=128, mlp_nlayer=2, mlp_nhid=64, alpha=2.0,
                      ensemble=ensemble)
    model = create_model(cfg, seed=1, kernels=kernels).eval()
    rng = np.random.RandomState(0)
    batch = {"id": torch.from_numpy(rng.randint(0, 1000, (256, 39))),
             "value": torch.from_numpy(rng.rand(256, 39).astype(np.float32))}
    with torch.inference_mode():
        lc = model(batch)
        lg = model.to(cuda)({k: v.to(cuda) for k, v in batch.items()}).cpu()
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)


# (alpha, shape, axis, a step shape, a packed step shape): SHAPES at six
# alphas, the step shapes at four
BWD_CASES = ([(a, s, ax, False, False) for s, ax in SHAPES
              for a in ALPHAS + [1.2, 3.0]]
             + [(a, s, ax, True, False) for s, ax in STEP_SHAPES
                for a in ALPHAS]
             + [(a, s, ax, True, True) for s, ax in PACKED_STEP_SHAPES
                for a in ALPHAS])


@pytest.mark.parametrize("alpha,shape,axis,step,packed", BWD_CASES)
def test_entmax_bwd_kernel_matches_plain(cuda, alpha, shape, axis, step,
                                         packed):
    """Each entry within 2e-5 of the plain version from the kernel's y,
    and at the step shapes within 1e-5 of its norm; at the packed step
    shapes past alpha 2 within 1e-5 of the float64 VJP's norm instead
    (_bwd_vs_plain)."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    y = entmax_cuda.entmax_kernel(x, alpha, axis)
    dy = torch.randn(shape, generator=g, device=cuda)
    dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, axis)
    torch.cuda.synchronize()
    if packed and alpha > 2.0:
        _bwd_vs_plain(dk, y, dy, alpha, axis)
        return
    dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, axis)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5)
    assert not step or within(dk - dp, dp, 1e-5, 0.0)


@pytest.mark.parametrize("d", [1, 5, 39, 64, 65, 100, 300])
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_bwd_kernel_any_d(cuda, alpha, d):
    """The backward takes any d: on the staged route in one stage of its
    slabs and in several (d > 64), on 128 columns a row (its bulk copies)
    and on 130 (the threads' own loads), and on the packed route at 37
    columns, with a NaN column, against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for inner in (128, 130, 37):
        x = torch.randn((3, d, inner), generator=g, device=cuda) * 3.0
        x[1, d // 2, 5] = float("nan")
        y = entmax_cuda.entmax_kernel(x, alpha, 1)
        dy = torch.randn((3, d, inner), generator=g, device=cuda)
        dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)
        dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1)
        torch.cuda.synchronize()
        assert bool(dk[1, :, 5].isnan().all()) and int(dk.isnan().sum()) == d
        torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5, equal_nan=True)


def test_entmax_bwd_launch_after_an_occupancy_query(cuda):
    """An occupancy query at a short column leaves the kernel's shared
    memory limit where a later, longer launch (d = 47, 47 KB of slabs)
    still fits."""
    assert entmax_cuda.bwd_blocks_per_sm(10, 2.0, 128) >= 8
    x = torch.randn((4, 47, 128), device=cuda)
    y = entmax_cuda.entmax_kernel(x, 2.0, 1)
    dy = torch.randn_like(y)
    torch.testing.assert_close(entmax_cuda.entmax_bwd_kernel(y, dy, 2.0, 1),
                               entmax_cuda.entmax_bwd_plain(y, dy, 2.0, 1),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,at", NAN_CASES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_entmax_bwd_kernel_nan_column_matches_plain(cuda, alpha, shape, at):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    x[at] = float("nan")
    y = entmax_cuda.entmax_kernel(x, alpha, 1)
    dy = torch.randn(shape, generator=g, device=cuda)
    dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)
    dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1)
    torch.cuda.synchronize()
    assert bool(dk[at[0], :, at[2]].isnan().all())
    assert int(dk.isnan().sum()) == shape[1]
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5, equal_nan=True)


def test_entmax_autograd_launches_the_bwd_kernel(cuda):
    x = torch.randn(4, 39, 16, device=cuda, requires_grad=True)
    before = calls()
    entmax_bisect(x, 2.0, axis=1).square().sum().backward()
    assert called(before) == {"entmax_fwd": 1, "entmax_bwd": 1}
    with pytest.raises(ValueError, match="differ"):
        entmax_cuda.entmax_bwd_kernel(x.detach(), x.detach()[:2], 2.0, 1)
    assert called(before) == {"entmax_fwd": 1, "entmax_bwd": 1}


def _bwd_vs_plain(dk, y, dy, alpha, axis, nan=False):
    """The backward kernel's dk against the plain version from y and dy at
    2e-5; past alpha 2 against the float64 VJP of the same y and dy within
    1e-5 of its norm (see _fwd_bwd_vs_plain)."""
    dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, axis)
    if alpha <= 2.0:
        torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5, equal_nan=nan)
        return
    assert bool((dk.isnan() == dp.isnan()).all())
    d64 = entmax_cuda.entmax_bwd_plain(y.double(), dy.double(),
                                       alpha, axis).nan_to_num(0.0)
    gap = float((dk.double().nan_to_num(0.0) - d64).norm())
    assert gap <= 1e-5 * float(d64.norm()), (gap, float(d64.norm()))


def _fwd_bwd_vs_plain(x, alpha, axis, dy=None, nan=False):
    """The entmax forward and backward kernels against their plain versions
    on x (dy: the cotangent, drawn like x where None), at the tolerances of
    the tests above; on a 3-D x over axis 1 also against the routes they
    replace, bit for bit: a packed forward of one lane a column against the
    wide register route (the same solve), the packed backward against the
    staged route (the same sums in the same order). Past alpha 2, where g =
    y^(2 - alpha) is unbounded as y -> 0 and dx = dy*g - q*g cancels, two
    float32 computations of dx differ by more than 2e-5 on large draws (the
    staged route, the parent design, read 3.1e-5 from the plain version on
    4.3M entries at alpha 2.5): there the backward is held to the float64
    VJP of the same y and dy within 1e-5 of its norm, the norm-wise
    tolerance chip_smoke.py holds every kernel to."""
    yk = entmax_cuda.entmax_kernel(x, alpha, axis)
    yp = entmax_cuda.entmax_plain(x, alpha, axis)
    dy = torch.randn_like(x) if dy is None else dy
    dk = entmax_cuda.entmax_bwd_kernel(yk, dy, alpha, axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(yk, yp, rtol=0,
                               atol=1e-5 if alpha > 2 else 5e-6,
                               equal_nan=nan)
    _bwd_vs_plain(dk, yk, dy, alpha, axis, nan)
    if x.ndim == 3 and axis == 1:
        outer, d, inner = x.shape
        route = entmax_cuda.route_for(d, inner, outer, alpha)
        if route[0] == "packed" and route[2] == 1:
            torch.testing.assert_close(
                yk, bench.fwd_on_route(x, alpha, ("register", route[1])),
                rtol=0, atol=0, equal_nan=True)
        if entmax_cuda.bwd_route_for(d, inner)[0] == "packed":
            torch.testing.assert_close(
                dk, bench.bwd_on_route(yk, dy, alpha, 0), rtol=0, atol=0,
                equal_nan=True)
    return yk, dk


@pytest.mark.parametrize("d", [3, 10, 39, 43, 65])
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernels_every_small_inner(cuda, alpha, d):
    """Every inner from 1 to 130, across the packed routes' edges (the
    forward's 16 / 17 and 32 / 33, the backward's 127 / 128), on 257 outer
    indices (no multiple of a block's): the forward with 2 or 4 lanes a
    column there up to inner 32 below alpha 2, and one lane on as many
    outer indices as fill FILL_COLUMNS columns at inner 1, 16 and 32; both
    kernels against their plain versions and the routes they replace."""
    g = torch.Generator(device=cuda).manual_seed(d)
    torch.manual_seed(d)
    for inner in range(1, 131):
        outers = [257]
        if inner in (1, 16, 32):
            outers.append(entmax_cuda.FILL_COLUMNS // inner + 3)
        for outer in outers:
            x = torch.randn((outer, d, inner), generator=g,
                            device=cuda) * 3.0
            _fwd_bwd_vs_plain(x, alpha, 1)


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernels_unaligned_span(cuda, alpha):
    """Inputs that start 4 bytes past a 16-byte boundary (a contiguous view
    at storage offset 1): the packed routes' thread loads instead of their
    16-byte loads and bulk copies, on the last axis and at db_armnet's
    [B, 43, 32]."""
    torch.manual_seed(11)
    for shape, axis in (((1000, 39), -1), ((300, 43, 32), 1),
                        ((129, 10, 3), 1)):
        n = math.prod(shape)
        x = (torch.randn(n + 1, device=cuda) * 3.0)[1:].view(shape)
        dy = torch.randn(n + 1, device=cuda)[1:].view(shape)
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        yk = entmax_cuda.entmax_kernel(x, alpha, axis)
        y = torch.empty(n + 1, device=cuda)[1:].view(shape)
        y.copy_(yk)
        dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, axis)
        torch.cuda.synchronize()
        torch.testing.assert_close(yk, entmax_cuda.entmax_plain(x, alpha,
                                                                axis),
                                   rtol=0, atol=1e-5 if alpha > 2 else 5e-6)
        _bwd_vs_plain(dk, y, dy, alpha, axis)


@pytest.mark.parametrize("shape", [(257, 39, 1), (257, 10, 2),
                                   (300, 43, 32), (4096, 22, 32)])
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernels_packed_nan_column(cuda, alpha, shape):
    """A NaN in one column makes that column NaN in y and dx, and no other,
    on the packed routes (one lane a column and several)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    x[17, shape[1] // 2, shape[2] - 1] = float("nan")
    yk, dk = _fwd_bwd_vs_plain(x, alpha, 1, nan=True)
    for t in (yk, dk):
        assert bool(t[17, :, -1].isnan().all())
        assert int(t.isnan().sum()) == shape[1]


def test_entmax_autograd_on_the_last_axis_launches_once_each(cuda):
    """ops/entmax.entmax_bisect over the last axis of [B, K, O, F] (the
    packed routes, inner 1): one forward and one backward launch, and its
    gradient the plain VJP's."""
    x = torch.randn(64, 4, 8, 39, device=cuda, requires_grad=True)
    dy = torch.randn(64, 4, 8, 39, device=cuda)
    before = calls()
    y = entmax_bisect(x, 2.0, axis=-1)
    y.backward(dy)
    assert called(before) == {"entmax_fwd": 1, "entmax_bwd": 1}
    torch.testing.assert_close(x.grad, entmax_cuda.entmax_bwd_plain(
        y.detach(), dy, 2.0, -1), rtol=0, atol=2e-5)


def _tg_case(cuda, n, e, nrows, lo=0, hi=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = torch.randint(lo, nrows if hi is None else hi, (n,), generator=g,
                        device=cuda)
    return torch.randn((n, e), generator=g, device=cuda), ids


# the step cases of bench: table_grad_cases at E 10 (a Criteo batch with
# ids uniform within each field, Zipf-skewed, all ids equal), the Criteo
# batch at the zoo's widths and as int64, the UCI step (16 live rows of
# 5,500, 512 updates each), wrapped and dropped ids at the batch's size and
# a ragged table
TG_STEP_CASES = ["criteo_batch", "zipf_0.99", "zipf_1.5", "all_ids_equal",
                 "criteo_batch_e1", "criteo_batch_e20", "criteo_batch_int64",
                 "uci_16_live", "wrapped_and_dropped", "ragged_small"]


def _tg_step_case(cuda, name):
    """(g, ids, nrows) of one of TG_STEP_CASES."""
    g = torch.Generator(device=cuda).manual_seed(2)
    cases = bench.table_grad_cases(cuda)
    crit, nrows, e = cases["criteo_batch"], bench.CRITEO_NFEAT, 10
    if name in cases:
        ids = cases[name]
    elif name.startswith("criteo_batch_e"):
        ids, e = crit, int(name[len("criteo_batch_e"):])
    elif name == "criteo_batch_int64":
        ids = crit.long()
    elif name == "uci_16_live":
        ids, nrows = torch.arange(16, dtype=torch.int32,
                                  device=cuda).repeat(512), 5500
    elif name == "wrapped_and_dropped":
        ids = torch.randint(-2 * nrows, 2 * nrows, crit.shape, generator=g,
                            device=cuda, dtype=torch.int32)
    else:
        ids, nrows = torch.randint(0, 3001, (37,), generator=g, device=cuda,
                                   dtype=torch.int32), 3001
    return torch.randn((ids.numel(), e), generator=g, device=cuda), ids, nrows


@pytest.mark.parametrize("case", [
    (5000, 10, 6000, 0, None),          # duplicates
    (37, 4, 3001, 0, None),             # nrows not a multiple of the block
    (4 * 256 + 57, 6, 8192, 0, 100),    # long segments
    (300, 6, 2048, -2048, None),        # negative ids wrap
    (400, 4, 700, -1400, 1400),         # ids outside [-nrows, nrows) drop
    (500, 1, 16999, 0, None),           # e = 1
    (0, 10, 50, 0, None),               # no update at all
    (4096 * 39, 1, 2100000, 0, None),   # FeaturesLinear at Criteo geometry
    (4096 * 39, 20, 2100000, 0, None),  # HOFM's table, nemb * (k - 1) = 20
    *TG_STEP_CASES], ids=str)
def test_table_grad_kernel_matches_plain(cuda, case):
    """Against index_add_ on a CPU copy (the kernel's summation order) at
    rtol 1e-5, atol 1e-6 where no row has more than CHUNK updates (which
    the kernel sums whole, in that order), else within 1e-6 + 1e-5 *
    sum|g| over the row's updates (any reordering's bound: the kernel adds
    its pieces' sums in order); against index_add_ on the card, whose
    atomics add in no fixed order, within that bound; bitwise against
    itself; and its radix sort against a stable torch.sort (the same keys
    and permutation)."""
    if isinstance(case, str):
        gr, ids, nrows = _tg_step_case(cuda, case)
    else:
        n, e, nrows, lo, hi = case
        gr, ids = _tg_case(cuda, n, e, nrows, lo, hi)
    got = scatter_cuda.table_grad(gr, ids, nrows)
    again = scatter_cuda.table_grad(gr, ids, nrows)
    want = scatter_cuda.table_grad_plain(gr.cpu(), ids.cpu(), nrows)
    spread = scatter_cuda.table_grad_plain(gr.abs(), ids, nrows)
    keys = scatter_cuda.keys_plain(ids, nrows)
    kept = keys[keys < nrows]
    if not kept.numel() or int(torch.bincount(kept).max()) <= \
            scatter_cuda.CHUNK:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    else:
        assert bool(((got.cpu() - want).abs()
                     <= 1e-6 + 1e-5 * spread.cpu()).all())
    card = scatter_cuda.table_grad_plain(gr, ids, nrows)
    assert bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all())
    assert torch.equal(got, again)              # deterministic bits
    if ids.numel():
        sid, perm = scatter_cuda.sort_ids(ids, nrows)
        want_sid, want_perm = scatter_cuda.sort_ids_plain(ids, nrows)
        assert torch.equal(sid, want_sid) and torch.equal(perm, want_perm)


@pytest.mark.parametrize("length", [scatter_cuda.CHUNK, scatter_cuda.CHUNK + 1,
                                    3 * scatter_cuda.CHUNK + 5])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_table_grad_kernel_long_segment(cuda, length, dtype):
    """One row with `length` updates among others, at the edge of the
    kernel's uncut segment (CHUNK) and past it: up to CHUNK updates the row
    is summed in the stable order (rtol 1e-5, atol 1e-6 against index_add_
    on the CPU); past it in ordered pieces, held to 1e-6 + 1e-5 * sum|g|,
    a bound on any reordering of the sum. Bitwise equal run to run."""
    g = torch.Generator(device=cuda).manual_seed(4)
    nrows = 5000
    ids = torch.randint(100, nrows, (3 * length,), generator=g, device=cuda)
    ids[torch.randperm(3 * length, generator=g, device=cuda)[:length]] = 77
    ids = ids.to(dtype)
    gr = torch.randn((3 * length, 10), generator=g, device=cuda)
    got = scatter_cuda.table_grad(gr, ids, nrows)
    again = scatter_cuda.table_grad(gr, ids, nrows)
    want = scatter_cuda.table_grad_plain(gr.cpu(), ids.cpu(), nrows)
    spread = scatter_cuda.table_grad_plain(gr.abs().cpu(), ids.cpu(), nrows)
    rows = torch.ones(nrows, dtype=torch.bool)
    rows[77] = length <= scatter_cuda.CHUNK
    torch.testing.assert_close(got.cpu()[rows], want[rows], rtol=1e-5,
                               atol=1e-6)
    assert bool(((got.cpu() - want).abs() <= 1e-6 + 1e-5 * spread).all())
    assert torch.equal(got, again)


def test_table_grad_kernel_all_ids_dropped(cuda):
    gr = torch.randn((1000, 10), device=cuda)
    ids = torch.full((1000,), 3000, device=cuda)
    ids[::2] = -3001
    got = scatter_cuda.table_grad(gr, ids, 3000)
    assert got.shape == (3000, 10) and int(torch.count_nonzero(got)) == 0


@pytest.mark.parametrize("n,nrows", [(1, 1), (5000, 6000), (159744, 2100000),
                                     (70000, 2 ** 31 - 2), (300, 50)])
def test_sort_ids_matches_plain(cuda, n, nrows):
    """The radix sort (one, two and three passes) gives torch.sort's stable
    order: the same keys and the same permutation."""
    g = torch.Generator(device=cuda).manual_seed(5)
    ids = torch.randint(-2 * nrows, 2 * nrows, (n,), generator=g,
                        device=cuda)
    ids[: n // 2] = ids[: n // 2] % 97          # duplicates
    for t in (ids, ids.to(torch.int32) if 2 * nrows < 2 ** 31 else ids):
        sid, perm = scatter_cuda.sort_ids(t, nrows)
        want_sid, want_perm = scatter_cuda.sort_ids_plain(t, nrows)
        assert perm.dtype == torch.int32
        assert torch.equal(sid, want_sid) and torch.equal(perm, want_perm)


def test_table_grad_kernel_all_ids_equal(cuda):
    gr = torch.ones((40000, 10), device=cuda)
    ids = torch.full((40000,), 1234, device=cuda)
    got = scatter_cuda.table_grad(gr, ids, 4096)
    assert float(got[1234, 0]) == 40000.0
    assert int(torch.count_nonzero(got)) == 10


def test_table_grad_counts_launches_and_rejects(cuda):
    gr, ids = _tg_case(cuda, 100, 4, 300)
    before = calls()
    scatter_cuda.table_grad(gr, ids, 300)
    assert called(before) == {"table_grad": 1}
    with pytest.raises(TypeError):
        scatter_cuda.table_grad(gr, ids.float(), 300)
    with pytest.raises(ValueError, match="fit"):
        scatter_cuda.table_grad(gr, ids[:5], 300)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_cuda.table_grad(gr, torch.stack([ids, ids], 1)[:, 0], 300)
    with pytest.raises(TypeError):
        scatter_cuda.sort_ids(ids.float(), 300)
    scatter_cuda.sort_ids(ids, 300)                 # the hook: not counted
    assert called(before) == {"table_grad": 1}


@pytest.mark.parametrize("profiled", [True, False])
def test_table_grad_split_with_and_without_profiler_events(cuda, profiled,
                                                           monkeypatch):
    from armnet_tpu_torch.kernels import bench

    if not profiled:      # every profiler session empty: CUDA-event split
        monkeypatch.setattr(bench, "kernel_device_ms", lambda fn: {})
    gr, ids = _tg_case(cuda, 4096 * 39, 10, bench.CRITEO_NFEAT)
    times = bench.table_grad_split(gr, ids.int(), bench.CRITEO_NFEAT)
    assert times["split_by"] == ("torch.profiler" if profiled
                                 else "cuda events")
    assert 0 < times["sort_ms"] < times["whole_ms"]
    assert 0 < times["kernel_ms"] < times["whole_ms"]
    assert (times["fill_ms"] > 0) if profiled else times["fill_ms"] is None


def _u_kappa(model, batch):
    """u * the largest |mean| / std over arm_bn's input channels: one f32
    rounding of exp(z), relative to the spread arm_bn divides by."""
    with torch.no_grad():
        a = model.attn_layer
        x = a(model.embedding(batch["id"], batch["value"].clamp(1e-3, 1.0)))
        x = x.transpose(0, 1).reshape(a.values.shape[0], -1)
        return float((x.mean(1).abs() / x.std(1)).max()) * 2.0 ** -24


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
@pytest.mark.parametrize("ensemble", [False, True])
def test_train_step_gpu_matches_cpu(cuda, ensemble, kernels):
    """One masked train-mode step of armnet_1h (padded batch, BCE, clamp)
    from the same weights: the loss agrees to 1e-5 relative, and every
    clamped gradient norm-wise to atol 1e-6 plus rtol max(1e-4, 16 u kappa)
    (the conditioning of arm_bn's input; see chip_smoke.gpu_vs_cpu_step).
    Under pallas-fused the card's step launches K5 and K6 once each and no
    entmax kernel."""
    cfg = ModelConfig(model="armnet_1h", nfeat=1000, nfield=39, nemb=10,
                      h=128, mlp_nlayer=2, mlp_nhid=64, alpha=2.0,
                      ensemble=ensemble, dnn_nlayer=2, dnn_nhid=64)
    rng = np.random.RandomState(0)
    batch = {"id": torch.from_numpy(rng.randint(0, 1000, (256, 39))),
             "value": torch.from_numpy(rng.rand(256, 39).astype(np.float32)),
             "y": torch.from_numpy((rng.rand(256) < 0.3).astype(np.float32)),
             "mask": torch.ones(256)}
    batch["mask"][200:] = 0.0
    out = []
    for dev in ("cpu", cuda):
        model = create_model(cfg, seed=1, kernels=kernels).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        cond = _u_kappa(model, b)
        before = calls()
        loss, _ = forward_loss(model, b)
        loss.backward()
        if dev != "cpu" and kernels == "pallas-fused":
            got = called(before)
            assert [got.get(k, 0) for k in ("entmax_fwd", "entmax_bwd",
                                            "arm1h_fwd", "arm1h_bwd")] == [
                0, 0, 1, 1]
        clamp_grads(model.parameters(), 1.0)
        out.append((loss.item(), cond, {n: p.grad.cpu()
                                        for n, p in model.named_parameters()}))
    (lc, cond, gc), (lg, _, gg) = out
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    rtol = max(1e-4, 16 * cond)
    for name, ref in gc.items():
        gap = float((gg[name] - ref).norm())
        assert gap <= 1e-6 * ref.numel() ** 0.5 + rtol * float(ref.norm()), \
            (name, gap, float(ref.norm()), rtol)


# (B, F, E, dk, O): the Criteo and Frappe steps at a cut batch, a ragged
# batch, small widths with O below and above the block's 128 threads, one
# row, and F at each register bucket's edge (16, 40); at Criteo widths O
# 200 (two chunks of neurons) and 96 (part of one), F 16 and 17, more rows
# than K6's grid (its blocks loop over rows), E = dk = 16 (one pass of K6's
# register sums), and wider embeddings that take several: Frappe at nemb
# 100 with h 10, widths that are not a multiple of 16, and 128, the widest
# K6's shared memory holds at 39 fields; past the 40-field bucket (the
# threads' columns in shared memory) F 41, 43 (the Diabetes130 step at
# batch 1024, and the wide build), 64 and 128; then the same at more rows:
# O 200 and 96, F 16 and 17 at 512 rows, 100 rows, Criteo's fields at nemb
# 40, and past the bucket F 41, 64 and 128 and the wide build at 43
ARM_SHAPES = [(256, 39, 10, 10, 128), (257, 10, 10, 10, 128),
              (24, 7, 6, 6, 9), (5, 16, 4, 3, 200), (1, 39, 10, 10, 128),
              (9, 40, 5, 7, 33), (3, 17, 4, 4, 130), (64, 39, 10, 10, 200),
              (64, 39, 10, 10, 96), (64, 16, 10, 10, 128),
              (64, 17, 10, 10, 128), (1100, 39, 10, 10, 128),
              (6, 5, 16, 16, 20), (64, 10, 100, 100, 10),
              (16, 39, 33, 20, 130), (4, 39, 128, 128, 16),
              (64, 41, 10, 10, 128), (1024, 43, 10, 10, 128),
              (16, 43, 33, 20, 130), (32, 64, 10, 10, 128),
              (16, 128, 10, 10, 128), (9, 45, 5, 7, 33),
              (512, 39, 10, 10, 200), (512, 39, 10, 10, 96),
              (512, 16, 10, 10, 128), (512, 17, 10, 10, 128),
              (100, 39, 10, 10, 128), (512, 39, 40, 40, 128),
              (256, 41, 10, 10, 128), (256, 64, 10, 10, 128),
              (128, 128, 10, 10, 128), (64, 43, 33, 20, 130)]


# the whole steps: Criteo's and Frappe's 4,096 rows, a ragged batch of
# 4,095, and Frappe at nemb 100 with h 10
ARM_STEP_SHAPES = [(4096, 39, 10, 10, 128), (4096, 10, 10, 10, 128),
                   (4095, 39, 10, 10, 128), (4096, 10, 100, 100, 10)]
# a gate whose (alpha - 1) * gate lies within this share of its column's
# largest from the plain version's threshold sits at the support's edge,
# where the kernel's float32 solve and the plain version's may put it on
# either side
EDGE_BAND = 1e-6


def _arm_inputs(cuda, shape, seed=0):
    b, f, e, dk, o = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((b, f, e), generator=g, device=cuda) * 0.5,
            torch.randn((e, dk), generator=g, device=cuda),
            torch.randn((o, dk), generator=g, device=cuda),
            torch.randn((f, o), generator=g, device=cuda) * 0.5,
            torch.randn((b, o, e), generator=g, device=cuda))


def _arm_edge_slack(emb, wk, q, vt, dout, alpha, band=EDGE_BAND):
    """(de, dwk, dq, dvt): how far each of K6's gradients may lie from the
    plain version's (arm_cuda.arm1h_bwd_plain) because a gate sits at its
    column's support edge, from alpha 2 on. There the entmax VJP jumps: a
    gate's g = y ** (2 - alpha) is 0 outside the support and 1 (alpha 2)
    or unbounded (past 2) just inside, and two float32 solves may round the
    gate to either side. The VJP of the gate's column is monotone in that
    g, so wherever it lands lies between g = 0 and g = 1 (alpha 2) or its
    limit as g grows (past 2). For each gate within `band` of the plain
    version's threshold, |that column's VJP at one end - at the other| is
    carried to the gradients through |the weights| of the backward's
    products; every other entry of a gradient gets no slack. dvt gets
    none: y, which it takes, is continuous at the edge."""
    keys, gates = arm_cuda._gates(emb, wk, q)
    xs, tau = solve_tau_axis0(gates.movedim(1, 0), alpha)
    xs, tau = xs.movedim(0, 1), tau.movedim(0, 1)           # [B, F, O]
    y = arm_cuda._replay(emb, wk, q, vt, alpha, 50)[1]
    scale = q.shape[-1] ** -0.5
    edge = ((xs - tau).abs()
            <= band * xs.abs().amax(1, keepdim=True)).nonzero().tolist()
    dz = dout * torch.exp(torch.einsum("bfo,bfe->boe", y * vt[None], emb))
    slack = torch.zeros(y.shape, dtype=torch.float64, device=y.device)
    for b, f, o in edge:
        col = y[b, :, o].double()
        dy = (torch.einsum("e,fe->f", dz[b, o], emb[b]) * vt[:, o]).double()
        g = torch.where(col > 0, col.clamp_min(1e-38) ** (2.0 - alpha), 0.0)
        g[f] = 0.0
        total, dot = g.sum(), (g * dy).sum()
        if alpha == 2.0:          # g = 1 in the support
            inside = g.clone()
            inside[f] = 1.0
            inside = inside * (dy - (dot + dy[f]) / (total + 1.0))
        else:                     # the limit as the gate's g grows
            inside = g * (dy - dy[f])
            inside[f] = dy[f] * total - dot
        slack[b, :, o] += (inside - g * (dy - dot / total)).abs()
    if not edge:
        return (0.0,) * 4
    slack = slack.float()
    dkeys = torch.einsum("bfo,od->bfd", slack, q.abs()) * scale
    return (torch.einsum("bfd,ed->bfe", dkeys, wk.abs()),
            torch.einsum("bfe,bfd->ed", emb.abs(), dkeys),
            torch.einsum("bfo,bfd->od", slack, keys.abs()) * scale, 0.0)


@pytest.mark.parametrize("shape", ARM_SHAPES + ARM_STEP_SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_fwd_kernel_matches_plain(cuda, alpha, shape):
    emb, wk, q, vt, _ = _arm_inputs(cuda, shape)
    got = arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha)
    want = arm_cuda.arm1h_fwd_plain(emb, wk, q, vt, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", ARM_SHAPES + ARM_STEP_SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_bwd_kernel_matches_plain(cuda, alpha, shape):
    """The four gradients at the JAX package's tolerances for its fused
    kernel (rtol 5e-4, atol 5e-5), and bit for bit run to run; at a whole
    step from alpha 2 on, plus each entry's slack for the gates at the
    support's edge (_arm_edge_slack), none elsewhere."""
    emb, wk, q, vt, dout = _arm_inputs(cuda, shape, seed=1)
    got = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    again = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    want = arm_cuda.arm1h_bwd_plain(emb, wk, q, vt, dout, alpha)
    slack = (_arm_edge_slack(emb, wk, q, vt, dout, alpha)
             if shape in ARM_STEP_SHAPES and alpha >= 2.0 else (0.0,) * 4)
    torch.cuda.synchronize()
    for name, a, b, c, s in zip(("de", "dwk", "dq", "dvt"), got, again, want,
                                slack):
        assert torch.equal(a, b), name
        if isinstance(s, float):
            torch.testing.assert_close(a, c, rtol=5e-4, atol=5e-5, msg=name)
            continue
        over = (a - c).abs() - (5e-5 + 5e-4 * c.abs() + s)
        assert bool(torch.isfinite(a).all()) and float(over.max()) <= 0, (
            name, float(over.max()))


def test_arm1h_kernels_count_launches_and_reject(cuda):
    emb, wk, q, vt, dout = _arm_inputs(cuda, (8, 39, 10, 10, 128))
    emb.requires_grad_()
    before = calls()
    arm1h_fused(emb, wk, q, vt.t(), 2.0).backward(dout)
    assert called(before) == {"arm1h_fwd": 1, "arm1h_bwd": 1}
    emb = emb.detach()
    fwd = arm_cuda.arm1h_fwd_kernel
    with pytest.raises(ValueError, match="CUDA"):
        fwd(emb.cpu(), wk.cpu(), q.cpu(), vt.cpu(), 2.0)
    with pytest.raises(TypeError):
        fwd(emb.double(), wk, q, vt, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(emb.transpose(0, 1).contiguous().transpose(0, 1), wk, q, vt, 2.0)
    # past 40 fields F is bounded by shared memory: K5's columns at 500
    # fields and K6's plan at 200 do not fit a block
    with pytest.raises(ValueError, match="shared memory"):
        fwd(torch.zeros((2, 500, 10), device=cuda), wk, q,
            torch.zeros((500, 128), device=cuda), 2.0)
    with pytest.raises(ValueError, match="shared memory"):
        arm_cuda.arm1h_bwd_kernel(torch.zeros((2, 200, 10), device=cuda),
                                  wk, q, torch.zeros((200, 128), device=cuda),
                                  dout[:2], 2.0)
    with pytest.raises(ValueError, match="alpha"):
        fwd(emb, wk, q, vt, 1.0)
    with pytest.raises(ValueError, match="fit"):
        arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout[:4], 2.0)
    wide = torch.zeros((2, 39, 200), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        arm_cuda.arm1h_bwd_kernel(wide, torch.zeros((200, 200), device=cuda),
                                  torch.zeros((128, 200), device=cuda), vt,
                                  torch.zeros((2, 128, 200), device=cuda),
                                  2.0)
    assert called(before) == {"arm1h_fwd": 1, "arm1h_bwd": 1}


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_bwd_grid_holds_16_warps_per_sm(cuda, alpha):
    """At the cr_armnet1h widths K6's grid is at least 4 blocks of 128
    threads (16 warps) per SM, as many as the occupancy calculator allows,
    and at most one block per row."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    per_sm = arm_cuda.bwd_blocks_per_sm(39, 10, 10, 128, alpha)
    assert per_sm >= 4
    assert arm_cuda.bwd_grid(4096, 39, 10, 10, 128, alpha, cuda) == \
        per_sm * sms
    assert arm_cuda.bwd_grid(7, 39, 10, 10, 128, alpha, cuda) == 7
    assert arm_cuda.fwd_blocks_per_sm(39, 10, 10, 128, alpha) >= 4


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_bwd_grid_at_wide_embeddings(cuda, alpha):
    """K6's wide build holds the 3 blocks per SM its registers are sized
    for at Frappe's fields with nemb 100 and h 10 (query and dz rows for 10
    neurons, fewer contraction groups), at least one up to E = dk = 128 at
    39 fields and 128 neurons, none past it, and its grid raises there."""
    assert arm_cuda.bwd_blocks_per_sm(10, 100, 100, 10, alpha) >= 3
    assert arm_cuda.bwd_blocks_per_sm(39, 128, 128, 128, alpha) >= 1
    assert arm_cuda.bwd_blocks_per_sm(39, 129, 129, 128, alpha) == 0
    with pytest.raises(ValueError, match="shared memory"):
        arm_cuda.bwd_grid(64, 39, 129, 129, 128, alpha, cuda)


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_plan_past_40_fields(cuda, alpha):
    """Past 40 fields the columns take shared memory: K5 and K6 hold at
    least one block per SM up to 128 fields at E = dk = 10, O = 128 (the
    Diabetes130 step's 43 too, and the wide build's E 33, dk 20 there), and
    none where the plan does not fit: K5 at 500 fields, K6 at 200."""
    for f in (41, 43, 64, 128):
        assert arm_cuda.fwd_blocks_per_sm(f, 10, 10, 128, alpha) >= 1
        assert arm_cuda.bwd_blocks_per_sm(f, 10, 10, 128, alpha) >= 1
    assert arm_cuda.bwd_blocks_per_sm(43, 33, 20, 130, alpha) >= 1
    assert arm_cuda.fwd_blocks_per_sm(500, 10, 10, 128, alpha) == 0
    assert arm_cuda.bwd_blocks_per_sm(200, 10, 10, 128, alpha) == 0


# the channel counts C = nattn_head * h of the multi-head presets (cr_armnet
# 256, db_armnet 32, db_armnet+ 512, av_armnet+ 64, frappe_armnet+ 16,
# ml_armnet+ 8) and a ragged 6, which takes the backward's per-thread loads
# (C % 4 != 0), at the Criteo and Diabetes130 field counts, on 67 and 256
# rows; then the presets' gates [B, F, C] at their alphas: cr_armnet,
# db_armnet, the UCI armnet step (4 heads of 128 over 16 fields, batch
# 512), av_armnet, av_armnet+, frappe_armnet+ and ml_armnet+
MULTIHEAD_CASES = ([(a, (b, f, c)) for b in (67, 256) for f in (39, 43)
                    for c in (6, 8, 16, 32, 64, 256, 512) for a in ALPHAS]
                   + [(2.0, (4096, 39, 256)), (1.7, (1024, 43, 32)),
                      (1.7, (512, 16, 512)), (1.5, (4096, 22, 32)),
                      (2.0, (4096, 22, 64)), (1.5, (4096, 10, 16)),
                      (2.5, (4096, 3, 8))])


@pytest.mark.parametrize("alpha,shape", MULTIHEAD_CASES, ids=str)
def test_entmax_kernels_at_multihead_channels(cuda, alpha, shape):
    """K2 and K4 on [B, F, C] over the fields (axis 1), against their
    plain versions at the tolerances of the tests above."""
    _, f, c = shape
    g = torch.Generator(device=cuda).manual_seed(c + f)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    yk = entmax_cuda.entmax_kernel(x, alpha, 1)
    yp = entmax_cuda.entmax_plain(x, alpha, 1)
    dy = torch.randn(shape, generator=g, device=cuda)
    dk = entmax_cuda.entmax_bwd_kernel(yk, dy, alpha, 1)
    dp = entmax_cuda.entmax_bwd_plain(yk, dy, alpha, 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(yk, yp, rtol=0,
                               atol=1e-5 if alpha > 2 else 5e-6)
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5)


def _zoo_config(model, ensemble=False, **kw):
    base = dict(model=model, nfeat=1000, nfield=39, nemb=10, h=16,
                nattn_head=4, mlp_nlayer=2, mlp_nhid=64, alpha=2.0,
                ensemble=ensemble, dnn_nlayer=2, dnn_nhid=64)
    base.update(kw)
    return ModelConfig(**base)


def _zoo_batch(rows=256, nfeat=1000, nfield=39):
    rng = np.random.RandomState(0)
    b = {"id": torch.from_numpy(rng.randint(0, nfeat, (rows, nfield))),
         "value": torch.from_numpy(rng.rand(rows, nfield).astype(np.float32)),
         "y": torch.from_numpy((rng.rand(rows) < 0.3).astype(np.float32)),
         "mask": torch.ones(rows)}
    b["mask"][rows - 56:] = 0.0
    return b


ZOO = ["armnet", "gc_arm", "sa_glu", "afn"]
# the models without a DNN ensemble: the rest of the zoo
PLAIN_ZOO = ["lr", "fm", "hofm", "afm", "nfm", "dnn", "wd", "dfm", "ipnn",
             "kpnn", "dcn", "dcn+", "cin", "xdfm", "gcn", "gat"]
ZOO_CASES = ([(m, e) for m in ZOO for e in (False, True)]
             + [(m, False) for m in PLAIN_ZOO])


@pytest.mark.parametrize("model,ensemble", ZOO_CASES)
def test_zoo_gpu_logits_match_cpu(cuda, model, ensemble):
    cfg = _zoo_config(model, ensemble, alpha=1.7)
    net = create_model(cfg, seed=1).eval()
    batch = {k: v for k, v in _zoo_batch().items() if k in ("id", "value")}
    with torch.inference_mode():
        lc = net(batch)
        lg = net.to(cuda)({k: v.to(cuda) for k, v in batch.items()}).cpu()
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
@pytest.mark.parametrize("model,ensemble", ZOO_CASES)
def test_zoo_train_step_gpu_matches_cpu(cuda, model, ensemble, kernels):
    """One masked train-mode step of each zoo model from the same weights
    (AFN after its positivity transform) on the card, on the card with the
    plain versions swapped in, and on the CPU with the card's outputs of
    the BatchNorms of chip_smoke.pinned_norms pinned (bn_tap): those over
    channel axis 1, where one rounding of exp(z) that such a BatchNorm
    magnifies moves the ReLUs below it across 0, and unpinned steps of
    armnet then differ by percents (ROADMAP.md §3); and GCN's MLP
    BatchNorms, which do the same. The other models' steps are not
    pinned. On the card the step launches K2 and K4 once for armnet and
    gc_arm and never for the others, K7 once per table (chip_smoke.tables:
    twice where a FeaturesLinear sits beside the embedding, once more with
    the ensemble), and no K5 or K6 under either kernel choice. Held, as
    chip_smoke.gpu_vs_cpu_step holds it: the loss to 1e-5 relative, each
    pinned BatchNorm's input to 1e-5 of its norm, and every clamped
    gradient norm-wise to atol 1e-6 plus rtol max(1e-4, 16 u kappa)
    against the CPU step, and plus KERNELS_VS_PLAIN_RTOL against the plain
    versions on the card. GCN's hidden MLP biases, which a BatchNorm
    follows (a gradient of 0 in exact arithmetic), are held at atol 4e-6
    per element: on an H100 they read 8.0e-6 apart over 64 elements,
    norm-wise, against the CPU, at atol 1e-6 (its graph convolutions over
    the all-ones adjacency give the MLP fields of one value, whose mean
    its BatchNorm takes out)."""
    from armnet_tpu_torch.models import param_transform_for
    from chip_smoke import (bn_tap, pinned_norms, plain_versions_on_card,
                            tables, u_kappa)

    cfg = _zoo_config(model, ensemble)
    batch = _zoo_batch()
    transform = param_transform_for(model)

    def step(dev, tap):
        net = create_model(cfg, seed=1, kernels=kernels).to(dev)
        if transform is not None:
            transform(net)
        b = {k: v.to(dev) for k, v in batch.items()}
        with bn_tap(net, *tap):
            loss, _ = forward_loss(net, b)
        loss.backward()
        clamp_grads(net.parameters(), 1.0)
        return (loss.item(), u_kappa(tap[0], net),
                {n: p.grad.cpu() for n, p in net.named_parameters()})

    before = calls()
    card_in, card_out = {}, {}
    lg, cond, gg = step(cuda, (card_in, card_out))
    got = called(before)
    arm = int(model in ("armnet", "gc_arm"))
    assert [got.get(k, 0) for k in ("entmax_fwd", "entmax_bwd", "table_grad",
                                    "arm1h_fwd", "arm1h_bwd")] == [
        arm, arm, tables(model, ensemble), 0, 0]
    with plain_versions_on_card():
        lq, _, gq = step(cuda, ({},))
    pinned = pinned_norms(create_model(cfg))
    assert pinned == {
        "armnet": {"arm_bn"}, "gc_arm": {"emb_bn", "arm_bn"},
        "afn": {"emb_bn", "afn_bn"},
        "gcn": {"affine.norms.0", "affine.norms.1"}}.get(model, set())
    cpu_in = {}
    lc, _, gc = step("cpu", (cpu_in, None,
                             {n: card_out[n] for n in pinned}))
    assert set(cpu_in) == set(card_in) == set(card_out) >= pinned
    for name in pinned:
        x = card_in[name]
        assert float((x - cpu_in[name]).norm()) <= 1e-5 * float(x.norm())
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(lg - lq) <= 1e-5 * abs(lq)
    rtol = max(1e-4, 16 * cond)
    for name, ref in gc.items():
        noise = (model == "gcn" and name.endswith(".bias") and name.replace(
            "linears", "norms").rpartition(".")[0] in pinned)
        atol = 4e-6 if noise else 1e-6
        for other, tol in ((ref, rtol), (gq[name], KERNELS_VS_PLAIN_RTOL)):
            gap = float((gg[name] - other).norm())
            assert gap <= (atol * ref.numel() ** 0.5
                           + tol * float(other.norm())), (name, gap, tol)


def test_afn_table_gradient_through_where_abs(cuda):
    """AFN's gathered rows come from where(|W| >= 1e-4, |W|, 1e-4), not from
    the leaf: K7's dense gradient flows on through where and abs to W. On a
    table with negative entries (the sign flips the gradient), entries
    under the clamp (gradient 0) and at it (gradient 1), untransformed,
    the table's gradient on the card is 0 where the CPU's is and matches
    it norm-wise (rtol 1e-4, atol 1e-6), with one K7 launch."""
    cfg = _zoo_config("afn", nfeat=300)
    batch = _zoo_batch(nfeat=300)
    grads = []
    for dev in ("cpu", cuda):
        net = create_model(cfg, seed=3).to(dev)
        with torch.no_grad():
            w = net.embedding.view(-1)
            w[0::7] *= -1.0
            w[1::7] = 5e-5
            w[2::7] = 1e-4
        b = {k: v.to(dev) for k, v in batch.items()}
        before = calls()
        loss, _ = forward_loss(net, b)
        loss.backward()
        if dev != "cpu":
            assert called(before).get("table_grad") == 1
        grads.append(net.embedding.grad.cpu())
    gc, gg = grads
    assert bool((gc.view(-1)[1::7] == 0).all())
    assert torch.equal(gg == 0, gc == 0) and float(gc.abs().max()) > 0
    gap = float((gg - gc).norm())
    assert gap <= 1e-6 * gc.numel() ** 0.5 + 1e-4 * float(gc.norm()), gap


@pytest.mark.parametrize("axis,ashape", [(1, ()), (1, (1, 1, 16)),
                                         (-1, (8, 13, 1))])
def test_learned_alpha_on_the_card_matches_cpu(cuda, axis, ashape):
    """A tensor alpha runs the same torch ops on the card as on the CPU
    (no kernel launch): y, dx within 1e-5, dalpha within 1e-5 of its
    norm."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8, 13, 16), generator=g) * 3.0
    dy = torch.randn((8, 13, 16), generator=g)
    alpha = 1.2 + torch.rand(ashape, generator=g)
    out = {}
    before = calls()
    for device in (cuda, torch.device("cpu")):
        xd = x.to(device, copy=True).requires_grad_()
        ad = alpha.to(device, copy=True).requires_grad_()
        y = entmax_bisect(xd, ad, axis=axis)
        y.backward(dy.to(device))
        out[device.type] = (y.detach().cpu(), xd.grad.cpu(), ad.grad.cpu())
    assert called(before) == {}
    (yg, dxg, dag), (yc, dxc, dac) = out["cuda"], out["cpu"]
    torch.testing.assert_close(yg, yc, rtol=0, atol=1e-5)
    torch.testing.assert_close(dxg, dxc, rtol=0, atol=1e-5)
    assert float((dag - dac).norm()) <= 1e-5 * float(dac.norm())


@pytest.mark.parametrize("model,kernels", [("armnet_1h", "auto"),
                                           ("armnet_1h", "pallas-fused"),
                                           ("armnet", "auto"),
                                           ("dnn", "auto")])
def test_bf16_train_step_on_the_card(cuda, model, kernels):
    """One --bf16 train step on the card against the same step on the CPU:
    the logits in the same dtype, the loss within 2e-2 (the card's and the
    CPU's bfloat16 GEMMs round apart), finite float32 gradients."""
    cfg = ModelConfig(model=model, nfeat=600, nfield=5, nemb=4, h=8,
                      nattn_head=2, mlp_nlayer=2, mlp_nhid=16, alpha=1.7)
    rng = np.random.RandomState(4)
    batch = {"id": torch.from_numpy(rng.randint(0, 600, (64, 5))),
             "value": torch.from_numpy(rng.uniform(0.1, 1.0, (64, 5))
                                       .astype(np.float32)),
             "y": torch.from_numpy((rng.rand(64) < 0.4).astype(np.float32)),
             "mask": torch.ones(64)}
    state = create_model(cfg, seed=1).state_dict()
    res = {}
    for device in (cuda, torch.device("cpu")):
        m = create_model(cfg, kernels=kernels, dtype=torch.bfloat16)
        m.load_state_dict(state)
        m.to(device)
        loss, logits = forward_loss(m, {k: v.to(device)
                                        for k, v in batch.items()})
        loss.backward()
        grads = [p.grad for p in m.parameters() if p.grad is not None]
        assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
                   for g in grads)
        res[device.type] = (loss.item(), logits.dtype)
    assert res["cuda"][1] == res["cpu"][1]
    assert abs(res["cuda"][0] - res["cpu"][0]) <= 2e-2 * abs(res["cpu"][0])


def _libsvm_rows(path, n, nfield, nfeat, seed):
    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            ids = rng.randint(0, nfeat, nfield)
            f.write(f"{int(ids[0] % 3 == 0)} " + " ".join(
                f"{i}:{rng.uniform(0.1, 1.0):.4f}" for i in ids) + "\n")
    return path


@pytest.mark.parametrize("thread,resident", [("0", False), ("1", False),
                                             ("0", True)])
def test_lookahead_iterator_on_the_card_yields_the_cpu_batches(
        cuda, tmp_path, monkeypatch, thread, resident):
    """The card's two feeds hand over the batches the CPU iterator yields,
    across epochs, the padded last batch and an early break included: the
    streaming lookahead (RESIDENT_SHARE 0: pinned memory, a copy stream,
    the consumer waiting on the copy's event), with and without the
    prefetch thread, and the resident rows gathered on the card (the
    epoch's order copied on the copy stream, its tail filled there)."""
    from armnet_tpu_torch.data import libsvm
    from armnet_tpu_torch.data.libsvm import BatchIterator, LibsvmDataset

    monkeypatch.setenv("ARMNET_PREFETCH_THREAD", thread)
    monkeypatch.setenv("ARMNET_CACHE_DIR", str(tmp_path / "cache"))
    if not resident:
        monkeypatch.setattr(libsvm, "RESIDENT_SHARE", 0.0)
    ds = LibsvmDataset(_libsvm_rows(str(tmp_path / "t.libsvm"), 1000, 39,
                                    2000, 0), 39)
    cpu = BatchIterator(ds, 96, True, seed=3)
    dev = BatchIterator(ds, 96, True, seed=3, device=cuda)
    for _ in range(2):
        for bc, bd in zip(cpu, dev):
            for k in bc:
                assert bd[k].device.type == "cuda"
                # work on the consumer's stream right after the hand-over
                torch.testing.assert_close((bd[k] * 1).cpu(), bc[k],
                                           rtol=0, atol=0)
    for i, _ in enumerate(dev):
        if i == 2:
            break
    assert dev.resident is resident
    assert (dev.orders_ahead, dev.orders_at_start) == (2, 1)
    assert dev._inflight == []
    if thread == "1":
        assert not dev.thread.is_alive()


def test_one_process_nccl_group_runs_the_multi_process_trainer(cuda,
                                                               tmp_path):
    """A one-process NCCL group: the mesh, the data group's all-reduces in
    the step, the sharded checkpoint path and both sharded lookups (model
    axis 1: the exchanges' collectives run over the one rank) with the
    table gradient through K7 on the card, against the replicated
    lookup."""
    import logging

    import torch.distributed as dist

    from armnet_tpu_torch.data.libsvm import make_dataloaders
    from armnet_tpu_torch.ops.embedding import embedding_bag
    from armnet_tpu_torch.parallel.embedding_parallel import (
        sharded_embedding_bag, sharded_embedding_bag_a2a)
    from armnet_tpu_torch.parallel.mesh import make_mesh
    from armnet_tpu_torch.train.checkpoint import load_checkpoint
    from armnet_tpu_torch.train.loop import Trainer
    from armnet_tpu_torch.utils.config import ExperimentConfig

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh("data:1,model:1")
        assert mesh.distributed
        rng = np.random.RandomState(0)
        table = torch.randn(500, 10, device=cuda)
        ids = torch.from_numpy(rng.randint(0, 500, (64, 39))).to(cuda)
        values = torch.rand(64, 39, device=cuda)
        w = torch.randn(64, 39, 10, device=cuda)
        t0 = table.clone().requires_grad_()
        (embedding_bag(t0, ids, values) * w).sum().backward()
        for fn in (sharded_embedding_bag, sharded_embedding_bag_a2a):
            t = table.clone().requires_grad_()
            before = calls()
            out = fn(t, ids, values, mesh)
            (out * w).sum().backward()
            assert called(before) == {"table_grad": 1}
            torch.testing.assert_close(out, embedding_bag(table, ids,
                                                          values))
            torch.testing.assert_close(t.grad, t0.grad, rtol=0, atol=1e-5)

        data = tmp_path / "d" / "tiny"
        data.mkdir(parents=True)
        for name, n in (("train", 300), ("valid", 100), ("test", 100)):
            _libsvm_rows(str(data / f"{name}.libsvm"), n, 5, 600, n)
        cfg = ExperimentConfig(model="armnet_1h", nfeat=600, nfield=5,
                               nemb=4, h=8, mlp_nhid=16, batch_size=64,
                               mesh="data:1,model:1", shard_embedding=True,
                               device="cuda")
        loaders = make_dataloaders("tiny", str(tmp_path / "d"), 5, 64,
                                   device=cuda)
        logger = logging.getLogger("test_torch_cuda.nccl")
        trainer = Trainer(cfg, *loaders, logger, seed=1,
                          ckpt_dir=str(tmp_path / "ckpt"), mesh=mesh)
        before = calls()
        best, _ = trainer.fit(epochs=1)
        assert called(before)["table_grad"] == 5        # one a train step
        assert 0.0 <= best <= 1.0
        state, _ = load_checkpoint(str(tmp_path / "ckpt"), "last")
        assert tuple(state["embedding.weight"].shape) == (600, 4)
    finally:
        dist.destroy_process_group()


# (B, E, F, C, N) of CIN layers: the published widths (layer 0 reads the
# fields, C = F; later layers the 200 maps) at 4,096 rows, then ragged
# rows and channels on each of the kernels' tile shapes (N past 128 and up
# to 128; dx's C up to 40 on its two-field tile, with an odd F leaving one
# field to the last pass, and at 40 itself; C past 200 spans two column
# tiles of the dx kernel); last the xdfm_criteo step's layers (bench.
# CIN_LAYERS: 65,536 rows)
CIN_SHAPES = [(4096, 10, 39, 39, 200), (4096, 10, 39, 200, 200),
              (1001, 10, 39, 37, 200), (333, 3, 7, 45, 60),
              (257, 4, 5, 201, 203), (97, 4, 6, 6, 5), (61, 10, 39, 39, 41),
              (130, 10, 4, 40, 128), *bench.CIN_LAYERS]
CIN_PLAIN_ROWS = 4096   # rows a block of the float64 plain version


def _cin_f64(x0, xk, w, out, dout):
    """The plain forward and backward in float64 from float32 inputs (the
    backward's ReLU mask from the kernel's `out`, so both take the same
    mask), over blocks of CIN_PLAIN_ROWS rows (the outer product of the
    step's 65,536 would not fit), dW summed over the blocks."""
    w64 = w.double()
    fwd, dx0, dxk, dw = [], [], [], torch.zeros_like(w64)
    for s0 in range(0, x0.shape[0], CIN_PLAIN_ROWS):
        rows = slice(s0, s0 + CIN_PLAIN_ROWS)
        d = [t[rows].double() for t in (x0, xk)]
        fwd.append(cin_cuda.cin_fwd_plain(*d, w64))
        a, b, c = cin_cuda.cin_bwd_plain(*d, w64, out[rows].double(),
                                         dout[rows].double())
        dx0.append(a)
        dxk.append(b)
        dw += c
    return torch.cat(fwd), (torch.cat(dx0), torch.cat(dxk), dw)


@pytest.mark.parametrize("shape", CIN_SHAPES, ids=str)
def test_cin_kernels_match_plain(cuda, shape):
    """K8's forward and backward against the plain version in float64:
    the kernels sum the F * C (forward, dW over the rows too) products in
    float32 in another order, so each is held to 2e-5 of its largest
    entry."""
    g = torch.Generator(device=cuda).manual_seed(shape[0])
    x0, xk, w, dout = bench.cin_inputs(g, shape)
    out = cin_cuda.cin_fwd(x0, xk, w)
    grads = cin_cuda.cin_bwd(x0, xk, w, out, dout)
    torch.cuda.synchronize()
    want, want_grads = _cin_f64(x0, xk, w, out, dout)
    assert (out == 0).any() and (out > 0).any()
    for got, ref in ((out, want), *zip(grads, want_grads)):
        assert got.shape == ref.shape and got.dtype == torch.float32
        torch.testing.assert_close(got.double(), ref, rtol=0,
                                   atol=2e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("shape", [(2048, 10, 39, 200, 200),
                                   *bench.CIN_LAYERS], ids=str)
def test_cin_backward_is_deterministic(cuda, shape):
    """dW sums its row slices and dx0 its rows in a fixed order: two calls
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(5)
    args = bench.cin_inputs(g, shape)
    out = cin_cuda.cin_fwd(*args[:3])
    a = cin_cuda.cin_bwd(*args[:3], out, args[3])
    b = cin_cuda.cin_bwd(*args[:3], out, args[3])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layer0", [True, False])
def test_cin_fused_route_matches_blocked(cuda, layer0):
    """The op on the card (fused) against its blocked route in full
    float32, through autograd, at layer 0 (x0 and xk the same tensor, whose
    two gradients add) and at a later layer; the blocked route in blocks
    of 1,000 rows that do not divide 4,096. The inputs are positive and
    the filter's first 100 maps positive, the rest negative, so every
    pre-activation lies far from ReLU's kink on the same side in both
    routes (one output rounded across 0 would move a whole row of dx)."""
    set_matmul_precision("highest")
    g = torch.Generator(device=cuda).manual_seed(7)
    x0 = torch.rand((4096, 39, 10), generator=g, device=cuda) + 0.1
    xk = x0 if layer0 else (torch.rand(
        (4096, 10, 200), generator=g, device=cuda) + 0.1).transpose(1, 2)
    w = (torch.rand((39 * xk.shape[1], 200), generator=g, device=cuda)
         + 0.1) * 0.01
    w[:, 100:] *= -1
    dy = torch.randn((4096, 200, 10), generator=g, device=cuda)
    grads = []
    for route in ("fused", "blocked"):
        a, w_ = x0.clone().requires_grad_(), w.clone().requires_grad_()
        b_ = a if layer0 else xk.clone().requires_grad_()
        if route == "fused":
            assert interaction.cin_route(a, b_, w_) == "fused"
            y = interaction.compressed_interaction_step(a, b_, w_, 0)
        else:
            y = interaction._CINBlocked.apply(
                a.transpose(1, 2), b_.transpose(1, 2), w_, 1000,
                0).transpose(1, 2)
        (y * dy).sum().backward()
        grads.append((y.detach(), a.grad, w_.grad,
                      None if layer0 else b_.grad))
    y = grads[0][0]
    assert (y[:, :100] > 0).all() and (y[:, 100:] == 0).all()
    for got, ref in zip(*grads):
        if ref is not None:
            torch.testing.assert_close(got, ref, rtol=0,
                                       atol=2e-5 * float(ref.abs().max()))


def test_cin_lower_precision_takes_blocked_route(cuda):
    """Under TF32 (--matmul_precision high) and bfloat16 activations the
    op takes the blocked route, whose GEMMs then run in that precision;
    in full float32 the fused one. The counters say which: the route's
    and, on the fused route alone, the ledger's K8 forward call."""
    x0 = torch.randn((64, 39, 10), device=cuda)
    w = torch.randn((39 * 39, 200), device=cuda) * 0.01
    try:
        for precision, dtype, route in (("highest", torch.float32, "fused"),
                                        ("high", torch.float32, "blocked"),
                                        ("highest", torch.bfloat16,
                                         "blocked")):
            set_matmul_precision(precision)
            x = x0.to(dtype)
            assert interaction.cin_route(x, x, w) == route
            with tracing.recording() as rec:
                interaction.compressed_interaction_step(x, x, w, 0)
            assert rec.counters[f"armnet.cin.{route}"] == 1
            assert rec.counters["armnet.cin.blocks"] == (route == "blocked")
            assert rec.counters["armnet.kernel.cin_fwd"] == (route == "fused")
    finally:
        set_matmul_precision("highest")


def test_cin_fused_peak_memory_at_the_criteo_step(cuda):
    """Three CIN layers at the xdfm_criteo step (65,536 rows, 39 fields, E
    10, 200 maps), forward and backward on the fused route: the peak stays
    under 10 GB (one whole outer product would be 20.4 GB a layer)."""
    set_matmul_precision("highest")
    g = torch.Generator(device=cuda).manual_seed(11)
    x0 = (torch.randn((65536, 39, 10), generator=g, device=cuda)
          * 0.5).requires_grad_()
    ws = [(torch.randn((39 * c, 200), generator=g, device=cuda)
           * (39 * c) ** -0.5).requires_grad_() for c in (39, 200, 200)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    xk, pooled = x0, []
    for k, w in enumerate(ws):
        xk = interaction.compressed_interaction_step(x0, xk, w, k)
        pooled.append(xk.sum(-1))
    torch.cat(pooled, 1).sum().backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    assert peak < 10e9, peak
    assert all(w.grad is not None and w.grad.abs().sum() > 0 for w in ws)


# [N, C, S] of BatchNorm's kernels (K9): the cells' arm_bn (bench.
# BN_SHAPES) and an MLP BatchNorm of the ARM cells (S = 1, which the module
# keeps on the composed ops), then rows whose C * S is no multiple of 4
# (the scalar loads), a row of many column tiles, fewer rows than a slab's
# lanes and one row
BN_CARD_SHAPES = [shape for _, shape in bench.BN_SHAPES] + [
    (65536, 500, 1), (1001, 7, 3), (333, 5, 1), (257, 600, 10),
    (7, 64, 10), (1, 4, 10)]


def _bn_args(g, shape, masked):
    """Kernel arguments at [N, C, S]: bench.bn_inputs, the last eighth of
    the rows pad rows of outliers (50) where masked, else no mask."""
    x, dy, rows, _, weight, bias = bench.bn_inputs(g, shape)
    if masked and shape[0] > 1:
        rows[-(-shape[0] // 8):] = 0.0
        x[rows == 0] = 50.0
    rows, count = (rows, rows.sum()) if masked else (None, None)
    spatial = shape[2] if masked else shape[0] * shape[2]
    return x, dy, rows, count, spatial, weight, bias


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", BN_CARD_SHAPES, ids=str)
def test_bn_kernels_match_plain(cuda, shape, masked):
    """K9's forward and backward against the plain version on the same
    inputs: y, mean, rstd, the running statistics, dx, dweight and dbias,
    each norm-wise within KERNELS_VS_PLAIN_RTOL (chip_smoke's kernels
    against their plain versions)."""
    g = torch.Generator(device=cuda).manual_seed(shape[0])
    x, dy, rows, count, spatial, weight, bias = _bn_args(g, shape, masked)
    c = shape[1]
    got, want = [], []
    for fwd, bwd, sink in ((bn_cuda.bn_fwd, bn_cuda.bn_bwd, got),
                           (bn_cuda.bn_fwd_plain, bn_cuda.bn_bwd_plain,
                            want)):
        rm = torch.full((c,), 0.5, device=cuda)
        rv = torch.full((c,), 2.0, device=cuda)
        y, mean, rstd = fwd(x, rows, count, spatial, weight, bias, rm, rv,
                            1e-5, 0.9)
        grads = bwd(x, dy, rows, count, spatial, weight, mean, rstd)
        sink += [y, mean, rstd, rm, rv, *grads]
    torch.cuda.synchronize()
    for name, a, b in zip(("y", "mean", "rstd", "running_mean",
                           "running_var", "dx", "dweight", "dbias"),
                          got, want):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert within(a - b, b, KERNELS_VS_PLAIN_RTOL, 0.0), (
            name, float((a - b).norm() / b.norm()))


@pytest.mark.parametrize("shape", [shape for _, shape in bench.BN_SHAPES],
                         ids=str)
def test_bn_kernels_are_deterministic(cuda, shape):
    """The slabs' partials are summed in a fixed order: two calls of the
    forward and of the backward give the same bits, at the cells' arm_bn
    (masked)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x, dy, rows, count, spatial, weight, bias = _bn_args(g, shape, True)
    c = shape[1]
    outs = []
    for _ in range(2):
        rm, rv = torch.zeros(c, device=cuda), torch.ones(c, device=cuda)
        y, mean, rstd = bn_cuda.bn_fwd(x, rows, count, spatial, weight, bias,
                                       rm, rv, 1e-5, 0.9)
        outs.append((y, mean, rstd, rm, rv, *bn_cuda.bn_bwd(
            x, dy, rows, count, spatial, weight, mean, rstd)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape,axis", [((4096, 128, 10), 1),
                                        ((512, 6, 20), 1),
                                        ((64, 4, 5, 3), 1)])
def test_bn_module_routes_on_the_card(cuda, shape, axis):
    """A float32 train-mode BatchNorm on the card with S > 1 takes the
    kernels (one fused call counted, and a call of each kernel wrapper in
    the ledger) and matches
    the composed path on the card: output, running statistics and the
    gradients of x, weight and bias, norm-wise within 1e-5, on an input
    whose mean and spread are alike (on 1 + 1e-3 noise the composed path's
    float32 mean is some ulps off, and its output 5e-5 from the kernels',
    which hold the plain version's float64 sums: test_bn_kernels_match_
    plain); a bfloat16 input, eval mode and S = 1 take the composed
    path."""
    from armnet_tpu_torch.ops.layers import (BatchNorm, batch_mask_scope,
                                             bn_route)
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(shape, generator=g, device=cuda) * 2 + 0.5
    dy = torch.randn(shape, generator=g, device=cuda)
    gamma = torch.rand(shape[axis], generator=g, device=cuda) + 0.5
    mask = torch.ones(shape[0], device=cuda)
    mask[-7:] = 0.0
    runs = []
    for route in ("fused", "composed"):
        bn = BatchNorm(shape[axis], axis, device=cuda).train()
        with torch.no_grad():
            bn.weight.copy_(gamma)
        leaf = x.clone().requires_grad_()
        with tracing.recording() as rec:
            with batch_mask_scope(mask):
                y = bn(leaf) if route == "fused" else bn._composed(
                    leaf, axis, mask)
            (y * dy).sum().backward()
        assert dict(rec.counters) == ({
            "armnet.bn.fused": 1, "armnet.kernel.bn_fwd": 1,
            "armnet.kernel.bn_bwd": 1} if route == "fused" else {})
        runs.append((y.detach(), bn.running_mean.clone(),
                     bn.running_var.clone(), leaf.grad, bn.weight.grad,
                     bn.bias.grad))
    for a, b in zip(*runs):
        assert within(a - b, b, 1e-5, 0.0), float((a - b).norm() / b.norm())
    assert bn_route(True, x.bfloat16(), axis) == "composed"
    assert bn_route(False, x, axis) == "composed"
    assert bn_route(True, x.flatten(2)[:, :, 0], axis) == "composed"
    bn = BatchNorm(shape[axis], axis, device=cuda)
    with tracing.recording() as rec:
        bn.eval()(x)
        bn.train()(x.bfloat16())
        BatchNorm(shape[-1], -1, device=cuda).train()(x)
    assert dict(rec.counters) == {"armnet.bn.composed": 3}


def test_bn_one_rank_group(cuda, tmp_path):
    """With a one-process NCCL group the kernels' channel sums go through
    the group's all-reduce: the same output, running statistics and
    gradients as without a group."""
    import torch.distributed as dist

    from armnet_tpu_torch.ops.layers import BatchNorm, batch_mask_scope

    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn((2048, 64, 10), generator=g, device=cuda)
    dy = torch.randn((2048, 64, 10), generator=g, device=cuda)
    mask = torch.ones(2048, device=cuda)
    mask[2000:] = 0.0
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1)
    try:
        group = dist.new_group([0])
        runs = []
        for grp in (None, group):
            bn = BatchNorm(64, 1, device=cuda).train()
            leaf = x.clone().requires_grad_()
            with batch_mask_scope(mask, grp):
                y = bn(leaf)
            (y * dy).sum().backward()
            runs.append((y.detach(), bn.running_mean, bn.running_var,
                         leaf.grad, bn.weight.grad, bn.bias.grad))
        for a, b in zip(*runs):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
