"""The port's entmax (armnet_tpu_torch) against the JAX package's solver and
its Pallas kernel (interpret mode) on the same seeded numpy inputs, forward
and backward, plus the port's CPU dispatch. The CUDA kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

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
    """The forward kernel's bucket is the least multiple of 8 that holds d
    (the Criteo d = 39 in 40, Frappe's 10 in 16); past 64 it raises."""
    if d > entmax_cuda.MAX_D:
        with pytest.raises(ValueError, match="64"):
            entmax_cuda.bucket_for(d)
        return
    b = entmax_cuda.bucket_for(d)
    assert b % 8 == 0 and b - 8 < d <= b <= entmax_cuda.MAX_D


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
    before = entmax_cuda.LAUNCHES
    x = torch.from_numpy(_x((4, 39, 16), seed=4))
    y = entmax_bisect(x, 2.0, axis=1)
    assert entmax_cuda.LAUNCHES == before
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
    """alpha <= 1 and a learned (tensor) alpha still raise; the backward is
    ported: a requires_grad input gets the plain VJP as its gradient."""
    x = torch.randn(3, 4)
    with pytest.raises(ValueError):
        entmax_bisect(x, 1.0)
    with pytest.raises(NotImplementedError, match="learned"):
        entmax_bisect(x, torch.tensor(1.5))
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
    before = entmax_cuda.BWD_LAUNCHES
    x = torch.from_numpy(_x((4, 39, 16), seed=18)).requires_grad_()
    entmax_bisect(x, 2.0, axis=1).sum().backward()
    assert entmax_cuda.BWD_LAUNCHES == before
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
