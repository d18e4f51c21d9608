"""The plain reference against the program (armnet_tpu_torch) on the CPU at
small sizes, on the same seeded weights and rows: forward logits in train
and eval mode, a full train step (loss, clamped gradients, Adam), and the
pieces alone (entmax, ROC-AUC, Adam)."""

import numpy as np
import pytest
import torch

from armnet_tpu_torch.kernels.entmax_cuda import entmax_plain
from armnet_tpu_torch.train.metrics import masked_roc_auc
from portbench import gen, harness
from portbench.reference import common as ref

CELLS = ["cr_armnet1h.train", "cr_armnet.train"]


def _batch(cell, seed, n=128):
    rows = harness.make_rows(cell.config, cell.traffic, seed, "cpu")
    return rows, rows.batch(np.arange(n), "cpu")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_program(small_cell, name, train):
    cell = small_cell(name)
    rows, b = _batch(cell, 5)
    weights = harness.draw_weights(cell, 5, "cpu")
    model = harness.build_model(cell, weights, "cpu")
    model.train(train)
    b["mask"] = torch.ones(b["y"].shape[0])
    from armnet_tpu_torch.ops.layers import batch_mask_scope
    with torch.no_grad(), batch_mask_scope(b["mask"]):
        got = model(b)
    p = harness.draw_weights(cell, 5, "cpu")
    with torch.no_grad():
        want = cell.reference.forward(cell.config, p, b["id"], b["value"],
                                      train=train)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CELLS)
def test_train_steps_match_program(small_cell, name):
    cell = small_cell(name)
    seed = 9
    rows = harness.make_rows(cell.config, cell.traffic, seed, "cpu")
    prog = harness.TrainSession(cell, seed, torch.device("cpu"),
                                rows).first_steps()
    order = gen.epoch_order(len(rows), seed, 0)
    refr = harness.train_reference(cell, seed, rows, "cpu", order)
    numbers, left_out, _ = harness.train_numbers(prog, refr)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap_median"] < 1e-5
    assert numbers["change_gap"] < 1e-3
    # the Linear biases before a BatchNorm have no gradient but rounding
    assert "mlp.linears.0.bias" in left_out
    assert "mlp.linears.0.weight" not in left_out


@pytest.mark.parametrize("alpha", [1.5, 2.0])
def test_entmax_matches_program_plain(alpha):
    x = torch.randn(64, 39, 16, generator=torch.Generator().manual_seed(1))
    want = entmax_plain(x, alpha, 1, 50)
    got = ref.entmax(x, alpha, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    assert torch.allclose(got.sum(1), torch.ones(64, 16), atol=1e-5)


def test_entmax_backward_matches_autograd_of_bisection():
    # the closed-form VJP against float64 finite differences
    x = torch.randn(4, 7, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    x.requires_grad_(True)
    f = lambda t: (ref.entmax(t, 1.5, 1, 200)
                   * torch.arange(7.0, dtype=torch.float64)[None, :, None]
                   ).sum()
    assert torch.autograd.gradcheck(f, (x,), eps=1e-6, atol=1e-5)


def test_roc_auc_matches_program():
    g = torch.Generator().manual_seed(3)
    scores = torch.randint(0, 20, (500,), generator=g).float()   # ties
    labels = (torch.rand(500, generator=g) < 0.3).float()
    want = float(masked_roc_auc(scores, labels))
    assert abs(ref.roc_auc(scores, labels) - want) < 1e-6


def test_adam_matches_torch():
    g = torch.Generator().manual_seed(4)
    w = torch.randn(10, generator=g)
    p = {"w": w.clone()}
    opt = ref.Adam(p, 1e-3)
    tw = torch.nn.Parameter(w.clone())
    topt = torch.optim.Adam([tw], lr=1e-3)
    for _ in range(3):
        grad = torch.randn(10, generator=g)
        opt.step(p, {"w": grad})
        tw.grad = grad.clone()
        topt.step()
    torch.testing.assert_close(p["w"], tw.detach(), rtol=0, atol=1e-7)
