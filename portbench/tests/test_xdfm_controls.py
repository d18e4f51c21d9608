"""xdfm_criteo.train's limits against its controls and faults, through the
harness's own comparison: the program's TF32 products (--matmul_precision
high) and bfloat16 activations (--bf16), half of every batch left out, and
a fault in the CIN itself (its third layer's output left at zero: its
pool adds nothing to the logit and its filter gets no gradient) each come
out not correct, while the sound run is correct. At the cell's own batch
on the card; bf16 and the faults on the CPU at a small size too."""

import types

import pytest
import torch

from armnet_tpu_torch.ops.interaction import compressed_interaction_step
from portbench import calibrate, harness, result

NAME = "xdfm_criteo.train"


def _cin_layer2_zero(step, session):
    """The program's CIN with its third layer's output left at zero."""
    cin = session.model.cin

    def forward(self, x):
        pooled, xk = [], x
        for k in range(self.nlayers):
            xk = compressed_interaction_step(
                x, xk, getattr(self, f"filter_{k}"), k)
            pooled.append(xk.sum(-1) * (0.0 if k == 2 else 1.0))
        return self.affine(torch.cat(pooled, dim=1)).squeeze(-1)

    cin.forward = types.MethodType(forward, cin)
    return step


FAULTS = {"half_batch": calibrate._half_batch,
          "cin_layer2_zero": _cin_layer2_zero}


def _check(cell, device, seed, fault=None, control=None):
    hooks = {"step": FAULTS[fault]} if fault else None
    _, numbers, _ = harness.run(cell, seed, 0.3, False, device, hooks,
                                control)
    return result.check(numbers, cell.limits)


def _own_batch():
    """The cell at its configuration and batch, over four batches of rows
    (the check's three first steps lie in the first epoch)."""
    import conftest

    cell = conftest.cell(NAME)
    cell.traffic.update(rows=4 * cell.traffic["batch"])
    return cell


def test_sound_run_is_correct_on_the_cpu(small_cell):
    assert _check(small_cell(NAME), "cpu", 31)[0]


def test_bf16_fails_on_the_cpu(small_cell):
    assert not _check(small_cell(NAME), "cpu", 31, control="bf16")[0]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_fails_on_the_cpu(small_cell, fault):
    assert not _check(small_cell(NAME), "cpu", 31, fault)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [41, 42])
def test_sound_run_is_correct_on_the_card(need_cuda, seed):
    assert _check(_own_batch(), "cuda", seed)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("seed", [41, 42])
def test_lower_precision_fails_on_the_card(need_cuda, control, seed):
    assert not _check(_own_batch(), "cuda", seed, control=control)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("seed", [41, 42])
def test_fault_fails_on_the_card(need_cuda, fault, seed):
    assert not _check(_own_batch(), "cuda", seed, fault)[0]
