"""The port's entmax (armnet_tpu_torch) against the JAX package's solver and
its Pallas kernel (interpret mode) on the same seeded numpy inputs, forward
and backward, plus the port's CPU dispatch. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from armnet_tpu.kernels.entmax_common import \
    solve_entmax_axis0 as jax_solve_entmax_axis0
from armnet_tpu.kernels.entmax_pallas import entmax_pallas
from armnet_tpu.ops.entmax import entmax_bisect as jax_entmax_bisect
from armnet_tpu_torch.kernels import bench, entmax_cuda
from armnet_tpu_torch.kernels.entmax_common import (entmax_bwd_axis0,
                                                    solve_entmax_axis0,
                                                    solver_mode)
from armnet_tpu_torch.ops.entmax import entmax_bisect, sparse_normalizer
from armnet_tpu_torch.utils import tracing

ALPHAS = [1.5, 1.7, 2.0, 2.5]
# the mid-axis shapes of tests/test_kernels.py plus a ragged one (axis 1)
SHAPES = [(8, 13, 256), (6, 39, 128), (4, 7, 384), (7, 5, 13)]
BWD_ATOL = 2e-5


def _x(shape, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _tol(alpha):
    # alpha > 2: p = z^(1/(alpha-1)) has unbounded slope at the support
    # boundary, so two f32-converged solves can differ by ~1e-5 there
    return 1e-5 if alpha > 2 else 5e-6


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_plain_solver_matches_jax_solver(alpha, shape):
    x = np.moveaxis(_x(shape, seed=1), 1, 0)
    yt = solve_entmax_axis0(torch.from_numpy(np.ascontiguousarray(x)), alpha)
    yj = jax_solve_entmax_axis0(jnp.asarray(x), alpha)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=_tol(alpha))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_plain_solver_nan_column_matches_jax_solver(alpha):
    """A NaN in a column (an out-of-range id's embedding row) makes the
    whole column NaN on both sides; the CUDA kernel keeps the same rule."""
    x = _x((39, 3, 16), seed=7)
    x[7, 1, 5] = np.nan
    yt = solve_entmax_axis0(torch.from_numpy(x), alpha).numpy()
    yj = np.asarray(jax_solve_entmax_axis0(jnp.asarray(x), alpha))
    assert np.isnan(yt[:, 1, 5]).all() and np.isnan(yt).sum() == 39
    np.testing.assert_allclose(yt, yj, atol=_tol(alpha))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_entmax_bisect_matches_pallas_interpret(alpha, shape):
    """Port entmax on axis 1 vs the Pallas entries (mid-axis for a
    lane-aligned last dim, the general entry for the ragged shape)."""
    x = _x(shape, seed=2)
    with torch.no_grad():
        yt = entmax_bisect(torch.from_numpy(x), alpha, axis=1).numpy()
    with pltpu.force_tpu_interpret_mode():
        yk = np.asarray(entmax_pallas(jnp.asarray(x), alpha=alpha, axis=1))
    np.testing.assert_allclose(yt, yk, atol=_tol(alpha))
    np.testing.assert_allclose(yt.sum(1), 1.0, atol=1e-5)


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_entmax_bisect_matches_jax_default_path(alpha, axis):
    """Against the JAX package's own CPU path (the exponent-specialized
    50-step bisection), on the first and last axes."""
    x = _x((9, 33), seed=3)
    yt = entmax_bisect(torch.from_numpy(x), alpha, axis=axis).numpy()
    yj = np.asarray(jax_entmax_bisect(jnp.asarray(x), alpha, axis=axis))
    np.testing.assert_allclose(yt, yj, atol=_tol(alpha))


def test_solver_branches():
    assert solver_mode(2.0) == solver_mode(1.5) == "bisect"
    assert solver_mode(1.7) == "fastpow"
    assert solver_mode(2.5) == "newton"


@pytest.mark.parametrize("d", range(1, 66))
def test_forward_register_bucket(d):
    """The forward kernel's route at a wide inner (the armnet_1h gates'
    128 channels): up to 64 entries the register bucket, the least multiple
    of 8 that holds d (the Criteo d = 39 in 40, Frappe's 10 in 16,
    Diabetes130's 43 in 48); past 64 the shared-memory column in blocks of
    128 columns, with no raise."""
    where, n = entmax_cuda.route_for(d, 128, 4096, 2.0)
    if d > entmax_cuda.REGISTER_D:
        assert (where, n) == ("shared", 128)
        return
    assert where == "register"
    assert n % 8 == 0 and n - 8 < d <= n <= entmax_cuda.REGISTER_D


# (d, inner) over the packed routes' edges: the forward's inner 16 / 17 (one
# lane) and 32 / 33 (four lanes), the backward's 127 / 128, d 1, 64 (the
# last register bucket), 65 and 300 (past it), the shapes of the
# multi-head presets and the last axis
ROUTE_D = [1, 2, 3, 10, 22, 39, 43, 64, 65, 300]
ROUTE_INNER = [1, 2, 3, 8, 16, 17, 31, 32, 33, 64, 127, 128, 256]


def _packed_fwd_smem(d, inner, per_block):
    """csrc/entmax_fwd.cuh packed_smem: a column d + 1 floats apart at inner
    1 and an even d, else the outer indices' d * inner floats."""
    return 4 * per_block * (d + 1 if inner == 1 and d % 2 == 0 else d * inner)


@pytest.mark.parametrize("inner", ROUTE_INNER)
@pytest.mark.parametrize("d", ROUTE_D)
def test_routes_by_shape(d, inner):
    """route_for and bwd_route_for: the packed forward up to d 64 and inner
    16, or inner 32 where the view has too few columns to fill the card
    and a column takes 2 or 4 lanes (128 / (lanes * inner) outer indices a
    block of 128 threads, lanes * bucket
    >= d in an instantiated (lanes, bucket) pair, more than 8 entries a
    lane for a halved group, its span within the 48 KB a block gets
    without an attribute), the wide routes past them; the packed backward
    up to inner 127 wherever one outer index's two spans fit 64 KB
    (per_block * inner <= 128, 16-byte aligned starts where a multiple of
    4 floats allows), the staged route past it; every block's shared
    memory within Hopper's 232,448 B; the column count moves only the
    lanes and, through them, the forward's route between inner 17 and 32;
    the newton mode (alpha 2.5) keeps one lane."""
    for outer, alpha in itertools.product((1, 7, 1024, 1 << 20),
                                          (1.7, 2.0, 2.5)):
        route = entmax_cuda.route_for(d, inner, outer, alpha)
        if route[0] == "packed":
            where, bucket, lanes = route
            per_block = 128 // (lanes * inner)
            assert d <= entmax_cuda.REGISTER_D and lanes in (1, 2, 4)
            assert inner <= entmax_cuda.PACKED_FWD_INNER or lanes > 1
            step = 8 if lanes == 1 else 4
            assert bucket % step == 0 and 8 <= bucket and bucket * lanes <= 64
            assert (bucket - step) * lanes < d <= bucket * lanes
            assert per_block >= 1
            assert _packed_fwd_smem(d, inner, per_block) <= 48 * 1024
            if outer * inner >= entmax_cuda.FILL_COLUMNS or alpha > 2.0:
                assert lanes == 1
            elif lanes > 1:
                assert -(-d // (lanes // 2)) > 8
        elif d <= entmax_cuda.REGISTER_D:
            assert inner > entmax_cuda.PACKED_FWD_INNER
            assert route == ("register", -(-d // 8) * 8)
        else:
            assert route[0] in ("shared", "global")
            if route[0] == "shared":
                assert 4 * d * route[1] <= entmax_cuda.SMEM_BYTES
    where, per_block = entmax_cuda.bwd_route_for(d, inner)
    if inner <= entmax_cuda.PACKED_BWD_INNER and \
            8 * d * inner <= entmax_cuda.PACKED_BWD_SMEM:
        assert where == "packed" and 1 <= per_block * inner <= 128
        room = -(-per_block * d * inner // 32) * 32
        assert 8 * room <= entmax_cuda.PACKED_BWD_SMEM
        step = 4 // np.gcd(4, d * inner)
        assert per_block % step == 0 or per_block < step
        assert per_block > 128 // inner - 4 or 8 * (per_block + step) \
            * d * inner > entmax_cuda.PACKED_BWD_SMEM
    else:
        assert (where, per_block) == ("staged", 0)
        assert 8 * min(d, 64) * 128 <= entmax_cuda.SMEM_BYTES


@pytest.mark.parametrize("outer,inner,alpha,lanes", [
    (1 << 20, 1, 2.0, 1), (1024, 32, 1.7, 4), (512, 32, 1.5, 4),
    (4096, 16, 1.7, 1), (2048, 16, 2.0, 4), (100, 1, 1.7, 4),
    (100, 33, 1.7, 0), (4096, 32, 1.7, 0), (1 << 20, 17, 2.0, 0),
    (1024, 32, 2.5, 0), (1024, 16, 2.5, 1)])
def test_forward_lanes_by_column_count(outer, inner, alpha, lanes):
    """The packed forward spreads a column of 43 entries over 4 lanes where
    the view has fewer than FILL_COLUMNS columns (db_armnet's [1024, 43,
    32] at alpha 1.7) up to inner 32, and keeps one lane where the card is
    full (the last axis of mh_breakdown's gates, 1,048,576 columns) and in
    the newton mode (alpha 2.5); past inner 16 one lane takes the wide
    route (0 here)."""
    route = entmax_cuda.route_for(43, inner, outer, alpha)
    if lanes == 0:
        assert route == ("register", 48)
    else:
        assert route[0] == "packed" and route[2] == lanes


@pytest.mark.parametrize("mangled,name", [
    ("_ZN6armnet17entmax_fwd_kernelILi40ELi1EEEvPKfPflilifff",
     "entmax_fwd_kernel<40,1>"),
    ("_ZN12_GLOBAL__N_117entmax_bwd_kernelILi64ELi0EEEvPKfS2_Pflilif",
     "entmax_bwd_kernel<64,0>"),
    ("_ZN12_GLOBAL__N_118radix_count_kernelIiEEvPKT_iiiPil",
     "radix_count_kernel<int>"),
    ("_ZN12_GLOBAL__N_114segment_kernelEPKfPKiS3_iiiPfS4_Pi",
     "segment_kernel"),
    ("_ZN6armnet16arm1h_bwd_kernelILi40ELi0ELi0ELi1EEEvPKfS2_S2_S2_S2_PfS3_"
     "iiiiiiiiffff", "arm1h_bwd_kernel<40,0,0,1>"),
    ("_ZN40_GLOBAL__N__221e5152_8_arm1h_cu_7092d6f316arm1h_fwd_kernelILi40E"
     "Li3EEEvPKfS2_S2_S2_Pfiiiiiffff", "arm1h_fwd_kernel<40,3>")])
def test_ptxas_report_names_each_instantiation(mangled, name):
    """kernels/bench.ptxas_report reads nvcc's -Xptxas -v log into
    registers and spills by instantiation, the names the smoke's build
    phase looks up for the main path."""
    log = (f"ptxas info    : Compiling entry function '{mangled}' for "
           f"'sm_90a'\nptxas info    : Function properties for {mangled}\n"
           f"    0 bytes stack frame, 12 bytes spill stores, 8 bytes spill "
           f"loads\nptxas info    : Used 72 registers, 384 bytes cmem[0]\n")
    assert bench.ptxas_report(log) == {
        name: {"registers": 72, "spill_stores": 12, "spill_loads": 8}}


def test_cpu_tensor_takes_plain_version_without_launch():
    before = tracing.counts("armnet.kernel.")
    x = torch.from_numpy(_x((4, 39, 16), seed=4))
    y = entmax_bisect(x, 2.0, axis=1)
    assert tracing.counts("armnet.kernel.") == before
    np.testing.assert_array_equal(
        y.numpy(), entmax_cuda.entmax_plain(x, 2.0, axis=1).numpy())


def test_kernel_entry_raises_on_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        entmax_cuda.entmax_kernel(torch.zeros(4, 5), 2.0)


def test_kernel_build_raises_without_cuda_toolkit():
    from torch.utils.cpp_extension import CUDA_HOME

    from armnet_tpu_torch.kernels import build

    if CUDA_HOME:
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()


def test_entmax_rejects_what_is_not_ported():
    """A static alpha <= 1 still raises; a learned (tensor) alpha now takes
    the generic path: at a constant alpha it gives the static path's y,
    and alpha gets a gradient. The backward is ported: a requires_grad
    input gets the plain VJP as its gradient."""
    x = torch.randn(3, 4)
    with pytest.raises(ValueError):
        entmax_bisect(x, 1.0)
    alpha = torch.tensor(1.5, requires_grad=True)
    y = entmax_bisect(x, alpha)
    np.testing.assert_allclose(y.detach().numpy(),
                               entmax_bisect(x, 1.5).numpy(), atol=1e-6)
    (y * torch.arange(4.0)).sum().backward()
    assert alpha.grad.shape == () and torch.isfinite(alpha.grad)
    x = torch.from_numpy(_x((3, 4), seed=8)).requires_grad_()
    dy = torch.from_numpy(_x((3, 4), seed=9))
    y = entmax_bisect(x, 1.5)
    y.backward(dy)
    want = entmax_bwd_axis0(y.detach().t(), dy.t(), 1.5).t()
    np.testing.assert_array_equal(x.grad.numpy(), want.numpy())


def _jax_vjp(fn, x, dy):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(dy))[0])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_backward_matches_pallas_interpret(alpha, shape):
    """dx of the port (autograd through the plain backward) against
    jax.vjp of the Pallas entries: the mid-axis kernel K4 for a lane-aligned
    last dim, the general kernel K3 for the ragged shape."""
    x, dy = _x(shape, seed=10), _x(shape, seed=11, scale=1.0)
    with pltpu.force_tpu_interpret_mode():
        yj, dxj = _jax_vjp(lambda v: entmax_pallas(v, alpha=alpha, axis=1),
                           x, dy)
    # the plain backward from JAX's own y
    dxp = entmax_cuda.entmax_bwd_plain(torch.from_numpy(yj.copy()),
                                       torch.from_numpy(dy), alpha, 1)
    np.testing.assert_allclose(dxp.numpy(), dxj, atol=BWD_ATOL)
    xt = torch.from_numpy(x).requires_grad_()
    y = entmax_bisect(xt, alpha, axis=1)
    y.backward(torch.from_numpy(dy))
    if alpha <= 2.0:
        np.testing.assert_allclose(xt.grad.numpy(), dxj, atol=BWD_ATOL)
    else:
        # g = y^(2-alpha) = y^-0.5 at alpha 2.5: the forwards' 1e-5 gap at
        # the support edge (y ~ 1e-3) moves dx by ~1e-4, so autograd is
        # held to the plain backward of the port's own y instead
        np.testing.assert_array_equal(
            xt.grad.numpy(),
            entmax_cuda.entmax_bwd_plain(y.detach(), torch.from_numpy(dy),
                                         alpha, 1).numpy())


@pytest.mark.parametrize("entry", ["mid", "general"])
@pytest.mark.parametrize("d", [43, 65, 100])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_long_columns_match_pallas_interpret(alpha, d, entry):
    """Columns of the Diabetes130 recipe's 43 fields and past the CUDA
    forward's register buckets (65, 100): the port's plain forward and VJP
    against the Pallas entries in interpret mode, the mid-axis kernels
    (K2/K4) on a lane-aligned last dim and the general ones (K1/K3) on a
    ragged one, at the tolerances above (forward _tol, dx BWD_ATOL; dx from
    JAX's own y, as test_backward_matches_pallas_interpret holds it)."""
    shape = (2, d, 128) if entry == "mid" else (3, d, 5)
    x, dy = _x(shape, seed=d), _x(shape, seed=d + 1, scale=1.0)
    with torch.no_grad():
        yt = entmax_bisect(torch.from_numpy(x), alpha, axis=1).numpy()
    with pltpu.force_tpu_interpret_mode():
        yj, dxj = _jax_vjp(lambda v: entmax_pallas(v, alpha=alpha, axis=1),
                           x, dy)
    np.testing.assert_allclose(yt, yj, atol=_tol(alpha))
    dxp = entmax_cuda.entmax_bwd_plain(torch.from_numpy(yj.copy()),
                                       torch.from_numpy(dy), alpha, 1)
    np.testing.assert_allclose(dxp.numpy(), dxj, atol=BWD_ATOL)


# the packed routes' shapes at a small batch: the last axis of [B, K, O, F]
# (mh_breakdown's gates, F 39), the multi-head presets' gates [B, F, C]
# (db_armnet 43 x 32, frappe_armnet+ 10 x 16, ml_armnet+ 3 x 8, av_armnet
# 22 x 32, av_armnet+ 22 x 64) and inner 1-3 on a ragged outer
SMALL_INNER = [((2, 2, 3, 39), -1), ((3, 43, 32), 1), ((5, 10, 16), 1),
               ((6, 3, 8), 1), ((3, 22, 32), 1), ((3, 22, 64), 1),
               ((7, 11, 1), 1), ((5, 9, 2), 1), ((3, 13, 3), 1)]


@pytest.mark.parametrize("shape,axis", SMALL_INNER)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_small_inner_matches_jax(alpha, shape, axis):
    """The port's plain forward, VJP and autograd where inner is small (the
    packed routes' shapes on the card) against the JAX package: its Pallas
    entry in interpret mode (the general kernels K1/K3 on the last axis and
    a ragged inner, the mid-axis K2/K4 otherwise), whose solver the port's
    is, at the file's tolerances (autograd where alpha <= 2, as
    test_backward_matches_pallas_interpret holds it); and its default CPU
    path (50 plain bisections): the VJP from that path's own y at
    BWD_ATOL, the forward and autograd no farther from it than the Pallas
    kernel is, within the same tolerances. (On db_armnet's [3, 43, 32]
    here the Pallas solver itself misses the default path by 1.8e-5 at
    alpha 1.7 and 3.7e-4 at 2.5, on a column whose second entry sits at the
    support's edge: ROADMAP.md section 3.)"""
    x, dy = _x(shape, seed=len(shape) + shape[1]), _x(shape, seed=3,
                                                       scale=1.0)
    xt = torch.from_numpy(x).requires_grad_()
    yt = entmax_bisect(xt, alpha, axis=axis)
    yt.backward(torch.from_numpy(dy))
    yt, gt = yt.detach().numpy(), xt.grad.numpy()
    with pltpu.force_tpu_interpret_mode():
        yk, dxk = _jax_vjp(lambda v: entmax_pallas(v, alpha=alpha, axis=axis),
                           x, dy)
    yj, dxj = _jax_vjp(lambda v: jax_entmax_bisect(v, alpha, axis=axis), x,
                       dy)
    np.testing.assert_allclose(yt, yk, atol=_tol(alpha))
    if alpha <= 2.0:
        np.testing.assert_allclose(gt, dxk, atol=BWD_ATOL)
    for y_ref, dx_ref in ((yk, dxk), (yj, dxj)):
        dxp = entmax_cuda.entmax_bwd_plain(torch.from_numpy(y_ref.copy()),
                                           torch.from_numpy(dy), alpha, axis)
        np.testing.assert_allclose(dxp.numpy(), dx_ref, atol=BWD_ATOL)
    assert (np.abs(yt - yj) <= np.abs(yk - yj) + _tol(alpha)).all()
    if alpha <= 2.0:
        assert (np.abs(gt - dxj) <= np.abs(dxk - dxj) + BWD_ATOL).all()


@pytest.mark.parametrize("axis", [0, -1])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_backward_matches_jax_default_path(alpha, axis):
    """dx against jax.vjp of the JAX package's CPU entmax_bisect (its
    exponent-specialized custom VJP), on the first and last axes."""
    x, dy = _x((9, 33), seed=12), _x((9, 33), seed=13, scale=1.0)
    _, dxj = _jax_vjp(lambda v: jax_entmax_bisect(v, alpha, axis=axis), x,
                      dy)
    xt = torch.from_numpy(x).requires_grad_()
    entmax_bisect(xt, alpha, axis=axis).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), dxj, atol=BWD_ATOL)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_plain_backward_nan_column(alpha):
    """A NaN column of y gives a NaN column of dx (0/0), and no other NaN;
    the CUDA backward kernel keeps the same rule."""
    y = entmax_cuda.entmax_plain(torch.from_numpy(_x((3, 39, 16), seed=14)),
                                 alpha, 1)
    y[1, :, 5] = float("nan")
    dx = entmax_cuda.entmax_bwd_plain(
        y, torch.from_numpy(_x((3, 39, 16), seed=15)), alpha, 1)
    assert bool(dx[1, :, 5].isnan().all()) and int(dx.isnan().sum()) == 39


def test_backward_sums_to_zero_and_vanishes_off_support():
    """dx sums to 0 along the axis (the output stays on the simplex) and is
    0 wherever y is 0."""
    x = torch.from_numpy(_x((6, 39, 16), seed=16))
    y = entmax_bisect(x, 2.0, axis=1)
    dx = entmax_cuda.entmax_bwd_plain(
        y, torch.from_numpy(_x((6, 39, 16), seed=17)), 2.0, 1)
    assert float((y == 0).float().mean()) > 0.5
    assert bool((dx[y == 0] == 0).all())
    np.testing.assert_allclose(dx.sum(1).numpy(), 0.0, atol=1e-5)


def test_cpu_backward_takes_plain_version_without_launch():
    before = tracing.counts("armnet.kernel.")
    x = torch.from_numpy(_x((4, 39, 16), seed=18)).requires_grad_()
    entmax_bisect(x, 2.0, axis=1).sum().backward()
    assert tracing.counts("armnet.kernel.") == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        entmax_cuda.entmax_bwd_kernel(torch.zeros(4, 5), torch.zeros(4, 5),
                                      2.0)


def test_sparse_normalizer_is_softmax_at_one():
    x = torch.from_numpy(_x((5, 7), seed=5))
    torch.testing.assert_close(sparse_normalizer(1.0, axis=1)(x),
                               torch.softmax(x, 1))
    torch.testing.assert_close(sparse_normalizer(1.5, axis=1)(x),
                               entmax_bisect(x, 1.5, axis=1))


def test_n_iter_is_capped_at_f32_convergence():
    x = torch.from_numpy(_x((6, 11), seed=6))
    np.testing.assert_array_equal(entmax_bisect(x, 2.0, n_iter=50).numpy(),
                                  entmax_bisect(x, 2.0, n_iter=30).numpy())


# learned (tensor) alpha: (x shape, axis, alpha shape), alpha broadcast to x
# with `axis` collapsed: a scalar, one per row of a 2-D input, and one per
# column of the [B, F, C] gates over fields (axis 1)
ALPHA_CASES = [((8, 13), -1, ()), ((8, 13), -1, (8, 1)),
               ((6, 9, 7), 1, ()), ((6, 9, 7), 1, (1, 1, 7)),
               ((6, 9, 7), 1, (6, 1, 7)), ((6, 9, 7), -1, (6, 9, 1))]


@pytest.mark.parametrize("shape,axis,ashape", ALPHA_CASES)
def test_learned_alpha_matches_jax(shape, axis, ashape):
    """y, dx and dalpha of a tensor alpha in (1.2, 2.4) against the JAX
    entmax_bisect with an array alpha (its generic path, Tsallis term
    included), within 1e-5; dalpha keeps alpha's shape."""
    rng = np.random.RandomState(len(shape) * 7 + len(ashape))
    x = _x(shape, seed=21)
    alpha = np.asarray(1.2 + 1.2 * rng.rand(*ashape), np.float32)
    dy = _x(shape, seed=22, scale=1.0)
    yj, vjp = jax.vjp(lambda v, a: jax_entmax_bisect(v, a, axis=axis),
                      jnp.asarray(x), jnp.asarray(alpha))
    dxj, daj = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    at = torch.from_numpy(alpha).requires_grad_()
    yt = entmax_bisect(xt, at, axis=axis)
    yt.backward(torch.from_numpy(dy))
    assert at.grad.shape == alpha.shape
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dxj), atol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(daj), atol=1e-5)


@pytest.mark.parametrize("a0", [1.3, 1.6, 2.0])
def test_learned_alpha_gradient_finite_difference(a0):
    """dalpha against a central difference of the loss in alpha (eps 1e-3,
    atol 5e-3, as tests/test_entmax.py checks the JAX package's)."""
    x = torch.from_numpy(_x((8, 6), seed=6, scale=1.0))
    w = torch.arange(6.0)

    def loss(a):
        return (entmax_bisect(x, a).square() * w).sum()

    alpha = torch.tensor(a0, requires_grad=True)
    loss(alpha).backward()
    eps = 1e-3
    fd = (float(loss(torch.tensor(a0 + eps)))
          - float(loss(torch.tensor(a0 - eps)))) / (2 * eps)
    np.testing.assert_allclose(float(alpha.grad), fd, atol=5e-3)


def test_learned_alpha_takes_no_kernel_and_casts_back():
    """A tensor alpha runs torch ops on every device (no entmax kernel is
    launched, as the JAX package runs it in XLA ops); the solve is float32
    and y takes x's dtype."""
    before = tracing.counts("armnet.kernel.")
    x = torch.from_numpy(_x((4, 9, 5), seed=23)).to(torch.bfloat16)
    x.requires_grad_()
    alpha = torch.full((1, 1, 5), 1.5, requires_grad=True)
    y = entmax_bisect(x, alpha, axis=1)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and alpha.grad.shape == (1, 1, 5)
    assert tracing.counts("armnet.kernel.") == before
    want = entmax_bisect(x.detach().float(), 1.5, axis=1)
    np.testing.assert_allclose(y.detach().float().numpy(), want.numpy(),
                               atol=4e-3)
