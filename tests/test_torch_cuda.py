"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the entmax forward and backward, the table gradient and the fused ARM-1h
forward and backward, and one train step on the card against the same step
on the CPU, through the composed and the fused interaction.

Skipped where CUDA is absent. On a GPU machine, from the repository root:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(--noconftest: the suite's conftest sets up JAX, which this file does not
use.) chip_smoke.py holds the same kernels to their plain versions at the
serving shapes.
"""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.kernels import arm_cuda, entmax_cuda, scatter_cuda
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.entmax import entmax_bisect
from armnet_tpu_torch.ops.interaction import arm1h_fused
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
    """Each forward C entry takes only the buckets it instantiates
    (multiples of 8 up to 64, d <= bucket) and only its own solver modes
    (entmax.cu the bisection modes, entmax_fastpow.cu and entmax_newton.cu
    one powf mode each)."""
    fn = entmax_cuda.fwd_function(alpha)
    x = torch.randn((2, 10, 5), device=cuda)
    y = torch.empty_like(x)
    for bucket in (12, 8, 72):
        assert fn(*entmax_cuda.fwd_args(x, y, alpha, 2, 10, 5, bucket)) != 0
    args = list(entmax_cuda.fwd_args(x, y, alpha, 2, 10, 5, 16))
    assert fn(*args) == 0
    args[6] = entmax_cuda.mode_id(2.5 if alpha < 2.5 else 2.0)
    assert fn(*args) != 0
    torch.cuda.synchronize()


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
    before = scatter_cuda.LAUNCHES
    scatter_cuda.table_grad(gr, ids, 300)
    assert scatter_cuda.LAUNCHES == before + 1
    with pytest.raises(TypeError):
        scatter_cuda.table_grad(gr, ids.float(), 300)
    with pytest.raises(ValueError, match="fit"):
        scatter_cuda.table_grad(gr, ids[:5], 300)
    with pytest.raises(ValueError, match="contiguous"):
        scatter_cuda.table_grad(gr, torch.stack([ids, ids], 1)[:, 0], 300)
    with pytest.raises(TypeError):
        scatter_cuda.sort_ids(ids.float(), 300)
    assert scatter_cuda.LAUNCHES == before + 1


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
        before = (entmax_cuda.LAUNCHES, entmax_cuda.BWD_LAUNCHES,
                  arm_cuda.LAUNCHES, arm_cuda.BWD_LAUNCHES)
        loss, _ = forward_loss(model, b)
        loss.backward()
        if dev != "cpu" and kernels == "pallas-fused":
            after = (entmax_cuda.LAUNCHES, entmax_cuda.BWD_LAUNCHES,
                     arm_cuda.LAUNCHES, arm_cuda.BWD_LAUNCHES)
            assert [a - b for a, b in zip(after, before)] == [0, 0, 1, 1]
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
# K6's shared memory holds at 39 fields
ARM_SHAPES = [(256, 39, 10, 10, 128), (257, 10, 10, 10, 128),
              (24, 7, 6, 6, 9), (5, 16, 4, 3, 200), (1, 39, 10, 10, 128),
              (9, 40, 5, 7, 33), (3, 17, 4, 4, 130), (64, 39, 10, 10, 200),
              (64, 39, 10, 10, 96), (64, 16, 10, 10, 128),
              (64, 17, 10, 10, 128), (1100, 39, 10, 10, 128),
              (6, 5, 16, 16, 20), (64, 10, 100, 100, 10),
              (16, 39, 33, 20, 130), (4, 39, 128, 128, 16)]


def _arm_inputs(cuda, shape, seed=0):
    b, f, e, dk, o = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    return (torch.randn((b, f, e), generator=g, device=cuda) * 0.5,
            torch.randn((e, dk), generator=g, device=cuda),
            torch.randn((o, dk), generator=g, device=cuda),
            torch.randn((f, o), generator=g, device=cuda) * 0.5,
            torch.randn((b, o, e), generator=g, device=cuda))


@pytest.mark.parametrize("shape", ARM_SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_fwd_kernel_matches_plain(cuda, alpha, shape):
    emb, wk, q, vt, _ = _arm_inputs(cuda, shape)
    got = arm_cuda.arm1h_fwd_kernel(emb, wk, q, vt, alpha)
    want = arm_cuda.arm1h_fwd_plain(emb, wk, q, vt, alpha)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", ARM_SHAPES)
@pytest.mark.parametrize("alpha", [1.5, 1.7, 2.0, 2.5])
def test_arm1h_bwd_kernel_matches_plain(cuda, alpha, shape):
    """The four gradients at the JAX package's tolerances for its fused
    kernel (rtol 5e-4, atol 5e-5), and bit for bit run to run."""
    emb, wk, q, vt, dout = _arm_inputs(cuda, shape, seed=1)
    got = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    again = arm_cuda.arm1h_bwd_kernel(emb, wk, q, vt, dout, alpha)
    want = arm_cuda.arm1h_bwd_plain(emb, wk, q, vt, dout, alpha)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("de", "dwk", "dq", "dvt"), got, again, want):
        torch.testing.assert_close(a, c, rtol=5e-4, atol=5e-5, msg=name)
        assert torch.equal(a, b), name


def test_arm1h_kernels_count_launches_and_reject(cuda):
    emb, wk, q, vt, dout = _arm_inputs(cuda, (8, 39, 10, 10, 128))
    emb.requires_grad_()
    before = (arm_cuda.LAUNCHES, arm_cuda.BWD_LAUNCHES, entmax_cuda.LAUNCHES,
              entmax_cuda.BWD_LAUNCHES)
    arm1h_fused(emb, wk, q, vt.t(), 2.0).backward(dout)
    assert (arm_cuda.LAUNCHES, arm_cuda.BWD_LAUNCHES, entmax_cuda.LAUNCHES,
            entmax_cuda.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1,
                                          before[2], before[3])
    emb = emb.detach()
    fwd = arm_cuda.arm1h_fwd_kernel
    with pytest.raises(ValueError, match="CUDA"):
        fwd(emb.cpu(), wk.cpu(), q.cpu(), vt.cpu(), 2.0)
    with pytest.raises(TypeError):
        fwd(emb.double(), wk, q, vt, 2.0)
    with pytest.raises(ValueError, match="contiguous"):
        fwd(emb.transpose(0, 1).contiguous().transpose(0, 1), wk, q, vt, 2.0)
    with pytest.raises(ValueError, match="fields"):
        fwd(torch.zeros((2, 41, 10), device=cuda), wk, q,
            torch.zeros((41, 128), device=cuda), 2.0)
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
    assert arm_cuda.LAUNCHES == before[0] + 1
    assert arm_cuda.BWD_LAUNCHES == before[1] + 1


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
