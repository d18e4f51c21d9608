"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the entmax forward and backward and the table gradient, and one train step
on the card against the same step on the CPU.

Skipped where CUDA is absent. On a GPU machine, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: the suite's conftest sets up JAX, which this file does not
use.) chip_smoke.py holds the same kernels to their plain versions at the
serving shapes.
"""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.kernels import entmax_cuda, scatter_cuda
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.entmax import entmax_bisect
from armnet_tpu_torch.train.step import clamp_grads, forward_loss

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# every register bucket (8/16/32/64) and its edges, middle and last axes
SHAPES = [((3, 1, 5), 1), ((64, 8), 0), ((5, 9, 7), 1), ((2, 16, 33), 1),
          ((4, 17, 3), 1), ((40, 33), 0), ((6, 64, 10), 1), ((2, 3, 39), -1)]


@pytest.mark.parametrize("shape,axis", SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5, 4 / 3, 1.2, 3.0])
def test_entmax_kernel_matches_plain(cuda, alpha, shape, axis):
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


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_kernel_nan_column_matches_plain(cuda, alpha):
    """A NaN in a column (an out-of-range id's embedding row) makes that
    whole column NaN, as in the plain version; other columns are untouched."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((3, 39, 16), generator=g, device=cuda) * 3.0
    x[1, 7, 5] = float("nan")
    yk = entmax_cuda.entmax_kernel(x, alpha, 1)
    yp = entmax_cuda.entmax_plain(x, alpha, 1)
    torch.cuda.synchronize()
    assert bool(yk[1, :, 5].isnan().all())
    assert int(yk.isnan().sum()) == 39
    tol = 1e-5 if alpha > 2 else 5e-6
    torch.testing.assert_close(yk, yp, rtol=0, atol=tol, equal_nan=True)


def test_entmax_kernel_counts_launches_and_rejects(cuda):
    x = torch.randn(4, 39, 16, device=cuda)
    before = entmax_cuda.LAUNCHES
    entmax_bisect(x, 2.0, axis=1)
    assert entmax_cuda.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        entmax_cuda.entmax_kernel(x.transpose(1, 2), 2.0, 1)
    with pytest.raises(TypeError):
        entmax_cuda.entmax_kernel(x.double(), 2.0, 1)
    with pytest.raises(ValueError, match="at most"):
        entmax_cuda.entmax_kernel(torch.randn(2, 65, device=cuda), 2.0, 1)
    assert entmax_cuda.LAUNCHES == before + 1


@pytest.mark.parametrize("ensemble", [False, True])
def test_armnet1h_gpu_matches_cpu(cuda, ensemble):
    cfg = ModelConfig(model="armnet_1h", nfeat=1000, nfield=39, nemb=10,
                      h=128, mlp_nlayer=2, mlp_nhid=64, alpha=2.0,
                      ensemble=ensemble)
    model = create_model(cfg, seed=1).eval()
    rng = np.random.RandomState(0)
    batch = {"id": torch.from_numpy(rng.randint(0, 1000, (256, 39))),
             "value": torch.from_numpy(rng.rand(256, 39).astype(np.float32))}
    with torch.inference_mode():
        lc = model(batch)
        lg = model.to(cuda)({k: v.to(cuda) for k, v in batch.items()}).cpu()
    torch.testing.assert_close(lg, lc, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,axis", SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5, 1.2, 3.0])
def test_entmax_bwd_kernel_matches_plain(cuda, alpha, shape, axis):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=g, device=cuda) * 3.0
    y = entmax_cuda.entmax_kernel(x, alpha, axis)
    dy = torch.randn(shape, generator=g, device=cuda)
    dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, axis)
    dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, axis)
    torch.cuda.synchronize()
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5)


@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_entmax_bwd_kernel_nan_column_matches_plain(cuda, alpha):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((3, 39, 16), generator=g, device=cuda) * 3.0
    x[1, 7, 5] = float("nan")
    y = entmax_cuda.entmax_kernel(x, alpha, 1)
    dy = torch.randn((3, 39, 16), generator=g, device=cuda)
    dk = entmax_cuda.entmax_bwd_kernel(y, dy, alpha, 1)
    dp = entmax_cuda.entmax_bwd_plain(y, dy, alpha, 1)
    torch.cuda.synchronize()
    assert bool(dk[1, :, 5].isnan().all()) and int(dk.isnan().sum()) == 39
    torch.testing.assert_close(dk, dp, rtol=0, atol=2e-5, equal_nan=True)


def test_entmax_autograd_launches_the_bwd_kernel(cuda):
    x = torch.randn(4, 39, 16, device=cuda, requires_grad=True)
    before = entmax_cuda.BWD_LAUNCHES
    entmax_bisect(x, 2.0, axis=1).square().sum().backward()
    assert entmax_cuda.BWD_LAUNCHES == before + 1
    with pytest.raises(ValueError, match="differ"):
        entmax_cuda.entmax_bwd_kernel(x.detach(), x.detach()[:2], 2.0, 1)
    assert entmax_cuda.BWD_LAUNCHES == before + 1


def _tg_case(cuda, n, e, nrows, lo=0, hi=None, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    ids = torch.randint(lo, nrows if hi is None else hi, (n,), generator=g,
                        device=cuda)
    return torch.randn((n, e), generator=g, device=cuda), ids


@pytest.mark.parametrize("n,e,nrows,lo,hi", [
    (5000, 10, 6000, 0, None),          # duplicates
    (37, 4, 3001, 0, None),             # nrows not a multiple of the block
    (4 * 256 + 57, 6, 8192, 0, 100),    # long segments
    (300, 6, 2048, -2048, None),        # negative ids wrap
    (400, 4, 700, -1400, 1400),         # ids outside [-nrows, nrows) drop
    (500, 1, 16999, 0, None),           # e = 1
    (0, 10, 50, 0, None),               # no update at all
])
def test_table_grad_kernel_matches_plain(cuda, n, e, nrows, lo, hi):
    """Against index_add_ on a CPU copy (the kernel's summation order) at
    rtol 1e-5, atol 1e-6; against index_add_ on the card, whose atomics add
    in no fixed order, within 1e-5 * sum|g| (any reordering's bound); and
    bitwise against itself."""
    gr, ids = _tg_case(cuda, n, e, nrows, lo, hi)
    got = scatter_cuda.table_grad(gr, ids, nrows)
    again = scatter_cuda.table_grad(gr, ids, nrows)
    torch.testing.assert_close(
        got.cpu(), scatter_cuda.table_grad_plain(gr.cpu(), ids.cpu(), nrows),
        rtol=1e-5, atol=1e-6)
    card = scatter_cuda.table_grad_plain(gr, ids, nrows)
    spread = scatter_cuda.table_grad_plain(gr.abs(), ids, nrows)
    assert bool(((got - card).abs() <= 1e-6 + 1e-5 * spread).all())
    assert torch.equal(got, again)              # deterministic bits


def test_table_grad_kernel_all_ids_equal(cuda):
    gr = torch.ones((40000, 10), device=cuda)
    ids = torch.full((40000,), 1234, device=cuda)
    got = scatter_cuda.table_grad(gr, ids, 4096)
    assert float(got[1234, 0]) == 40000.0
    assert int(torch.count_nonzero(got)) == 10


def test_table_grad_counts_launches_and_rejects(cuda):
    gr, ids = _tg_case(cuda, 100, 4, 300)
    before = scatter_cuda.LAUNCHES
    scatter_cuda.table_grad(gr, ids, 300)
    assert scatter_cuda.LAUNCHES == before + 1
    sid, order = scatter_cuda.sort_ids(ids, 300)
    with pytest.raises(TypeError):
        scatter_cuda.table_grad_sorted(gr.double(), sid, order, 300)
    with pytest.raises(ValueError, match="fit"):
        scatter_cuda.table_grad_sorted(gr, sid[:5], order, 300)
    assert scatter_cuda.LAUNCHES == before + 1


def _u_kappa(model, batch):
    """u * the largest |mean| / std over arm_bn's input channels: one f32
    rounding of exp(z), relative to the spread arm_bn divides by."""
    with torch.no_grad():
        a = model.attn_layer
        x = a(model.embedding(batch["id"], batch["value"].clamp(1e-3, 1.0)))
        x = x.transpose(0, 1).reshape(a.values.shape[0], -1)
        return float((x.mean(1).abs() / x.std(1)).max()) * 2.0 ** -24


@pytest.mark.parametrize("ensemble", [False, True])
def test_train_step_gpu_matches_cpu(cuda, ensemble):
    """One masked train-mode step of armnet_1h (padded batch, BCE, clamp)
    from the same weights: the loss agrees to 1e-5 relative, and every
    clamped gradient norm-wise to atol 1e-6 plus rtol max(1e-4, 16 u kappa)
    (the conditioning of arm_bn's input; see chip_smoke.gpu_vs_cpu_step)."""
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
        model = create_model(cfg, seed=1).to(dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        cond = _u_kappa(model, b)
        loss, _ = forward_loss(model, b)
        loss.backward()
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
