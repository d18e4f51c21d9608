"""The CIN layer's blocked route (ops/interaction.compressed_interaction_step
on the CPU) against the materialised outer product it replaced and the JAX
CIN step, forward and float64 gradcheck of dX0, dXk and dW, at block sizes
that divide the batch and that do not, at layer 0 (C = F, xk is x0) and
past it; its spans and counters under tracing.recording(); and the port's
xDeepFM against the benchmark's plain reference (portbench/reference/
xdfm.py) at a small size: logits, one step's gradient of every leaf, and
the trainer's first three Adam steps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.ops.interaction import \
    compressed_interaction_step as jax_cin_step
from armnet_tpu_torch.ops import interaction
from armnet_tpu_torch.ops.interaction import compressed_interaction_step
from armnet_tpu_torch.ops.layers import batch_mask_scope
from armnet_tpu_torch.utils import tracing
from portbench import gen, harness, spec

B, F, E, N = 12, 6, 4, 5
# rows a block: the whole batch, 3 (divides 12), 5 (does not)
BLOCKS = [None, 3, 5]


def materialised(x0, xk, filt):
    """The CIN step as the port computed it before the blocked route (the
    tests' oracle): the whole outer product h [B, F*C, E], then
    relu(filt^T h)."""
    b, _, e = x0.shape
    h = (x0[:, :, None, :] * xk[:, None, :, :]).reshape(b, -1, e)
    return torch.relu(torch.matmul(filt.t(), h))


def _inputs(c, dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed + c)
    x0 = rng.randn(B, F, E)
    xk = x0 if c == F else rng.randn(B, c, E)
    filt = rng.randn(F * c, N) * 0.3
    return [torch.tensor(a, dtype=dtype) for a in (x0, xk, filt)]


@pytest.fixture
def block_rows(monkeypatch):
    """Sets the blocked route's byte budget to `rows` rows of a layer with
    C channels (None: the whole batch)."""
    def set_rows(rows, c, itemsize):
        if rows is not None:
            monkeypatch.setattr(interaction, "CIN_BLOCK_BYTES",
                                rows * F * c * E * itemsize)
    return set_rows


@pytest.mark.parametrize("rows", BLOCKS)
@pytest.mark.parametrize("c", [F, 7])
def test_blocked_forward_matches_materialised_and_jax(block_rows, c, rows):
    block_rows(rows, c, 4)
    x0, xk, filt = _inputs(c)
    assert interaction.cin_route(x0, xk, filt) == "blocked"
    got = compressed_interaction_step(x0, xk, filt)
    assert got.shape == (B, N, E) and (got == 0).any() and (got > 0).any()
    # the same products summed by another GEMM: float32 rounding
    torch.testing.assert_close(got, materialised(x0, xk, filt), rtol=1e-5,
                               atol=1e-5)
    want = np.asarray(jax_cin_step(*(jnp.asarray(t.numpy())
                                     for t in (x0, xk, filt))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rows", BLOCKS)
@pytest.mark.parametrize("c", [F, 7])
def test_blocked_gradcheck_float64(block_rows, c, rows):
    """dX0, dXk and dW of the blocked backward (each block's outer product
    recomputed) against finite differences in float64; at layer 0 xk is
    x0 itself, so its two gradients add."""
    block_rows(rows, c, 8)
    x0, xk, filt = (t.requires_grad_() for t in _inputs(c, torch.float64))
    if c == F:
        assert torch.autograd.gradcheck(
            lambda a, w: compressed_interaction_step(a, a, w), (x0, filt))
    else:
        assert torch.autograd.gradcheck(compressed_interaction_step,
                                        (x0, xk, filt))


@pytest.mark.parametrize("rows", BLOCKS)
@pytest.mark.parametrize("c", [F, 7])
def test_blocked_gradients_match_materialised(block_rows, c, rows):
    """The same gradients as autograd through the materialised product, in
    float32 (rounding of sums in another order)."""
    block_rows(rows, c, 4)
    dy = torch.randn(B, N, E, generator=torch.Generator().manual_seed(c))
    grads = []
    for fn in (compressed_interaction_step, materialised):
        x0, xk, filt = _inputs(c)
        x0.requires_grad_()
        filt.requires_grad_()
        if c == F:
            xk = x0
        else:
            xk.requires_grad_()
        (fn(x0, xk, filt) * dy).sum().backward()
        grads.append([x0.grad, filt.grad] + ([] if c == F else [xk.grad]))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_spans_and_counters_are_recorded():
    """Under tracing.recording() the step's forward and backward are the
    spans armnet.cin.forward and armnet.cin.backward, with the layer index
    as their id, and the counters hold the calls by route and the blocked
    route's blocks (forward and backward); off the recorder the
    process-wide counters still count."""
    x0, xk, filt = (t.requires_grad_() for t in _inputs(7))
    before = tracing.counts("armnet.cin.")
    with tracing.recording() as rec:
        compressed_interaction_step(x0, xk, filt, 2).sum().backward()
    assert [(s.name, s.ids) for s in rec.spans] == [
        ("armnet.cin.forward", {"layer": 2}),
        ("armnet.cin.backward", {"layer": 2})]
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    assert dict(rec.counters) == {"armnet.cin.blocked": 1,
                                  "armnet.cin.blocks": 2}
    after = tracing.counts("armnet.cin.")
    assert after["armnet.cin.blocked"] - before.get(
        "armnet.cin.blocked", 0) == 1
    compressed_interaction_step(x0, xk, filt, 0)
    assert tracing.counts("armnet.cin.")["armnet.cin.blocks"] == \
        after["armnet.cin.blocks"] + 1


# the port's xDeepFM against the reference: 39 fields of 15 ids, CIN 3 x
# 16 maps, MLP 2 x 32, 512-row batches (three of them for the Adam steps)
SMALL = {"nfeat": 600, "h": 16, "mlp_nhid": 32}


def _small_cell():
    cell = spec.load_cell("xdfm_criteo.train")
    full = cell.config["nfeat"] + cell.config["nemb"]
    cell.config.update(SMALL)
    cell.traffic.update(rows=1536, batch=512)
    # the table keeps the range of its entries at full size
    shrink = ((cell.config["nfeat"] + cell.config["nemb"]) / full) ** 0.5
    cell.traffic["weight_scale"] = {
        k: v * shrink for k, v in cell.traffic["weight_scale"].items()}
    return cell


def _model_and_batch(seed):
    cell = _small_cell()
    rows = harness.make_rows(cell.config, cell.traffic, seed, "cpu")
    batch = rows.batch(np.arange(512), "cpu")
    model = harness.build_model(cell, harness.draw_weights(cell, seed, "cpu"),
                                "cpu")
    return cell, model, batch, harness.draw_weights(cell, seed, "cpu")


@pytest.mark.parametrize("train", [True, False])
def test_xdfm_logits_match_reference(train):
    """Logits of one batch in train and eval mode (the same products in
    float32, the CIN in one block on both sides: rounding alone)."""
    cell, model, batch, p = _model_and_batch(4)
    model.train(train)
    mask = torch.ones(512)
    with torch.no_grad(), batch_mask_scope(mask):
        got = model(batch)
        want = cell.reference.forward(cell.config, p, batch["id"],
                                      batch["value"], train=train)
    assert got.shape == (512,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_xdfm_one_step_gradients_match_reference():
    """The BCE loss's gradient of every trained leaf: each within 1e-5 of
    its largest entry (float32 sums in another order; the Linear biases
    before a BatchNorm, whose gradient is rounding alone, against the
    median leaf's scale)."""
    cell, model, batch, p = _model_and_batch(6)
    model.train(True)
    names = harness.trainable(cell)
    with batch_mask_scope(torch.ones(512)):
        loss = harness.ref.bce(model(batch), batch["y"])
    loss.backward()
    got = {n: t.grad for n, t in model.named_parameters()}
    for n in names:
        p[n].requires_grad_(True)
    ref_loss = harness.ref.bce(cell.reference.forward(
        cell.config, p, batch["id"], batch["value"], train=True), batch["y"])
    want = dict(zip(names, torch.autograd.grad(ref_loss,
                                               [p[n] for n in names])))
    assert set(got) == set(names)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-6, atol=1e-6)
    scale = float(np.median([float(g.abs().max()) for g in want.values()]))
    for n in names:
        tol = 1e-5 * max(float(want[n].abs().max()), scale)
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=tol,
                                   msg=lambda m: f"{n}: {m}")


def test_xdfm_three_adam_steps_match_reference():
    """The trainer's first three steps (its feed, clamp and Adam) against
    the reference's on the same rows: losses to 1e-5 of themselves, the
    median leaf's gradient to 1e-5, every moved leaf's change to 1e-3 (Adam
    divides each gradient by its own root mean square, which turns
    rounding in a small entry into a change of up to lr)."""
    cell = _small_cell()
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
    assert set(left_out) == {"mlp.linears.0.bias", "mlp.linears.1.bias"}
