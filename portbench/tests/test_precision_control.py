"""The control: the program's own lower-precision paths put in its place
come out not correct at the cells' limits. TF32 products
(--matmul_precision high), the nearest precision below the
configurations' float32 with TF32 off, and bfloat16 activations (--bf16)
run on the card at each cell's own batch; bf16 runs on the CPU at a small
size too."""

import pytest

from portbench import harness, result

CELLS = ["cr_armnet1h.train", "cr_armnet.train"]


def _correct(cell, device, control, seed):
    _, numbers, _ = harness.run(cell, seed, 0.3, False, device,
                                   control=control)
    return result.check(numbers, cell.limits)[0]


@pytest.mark.parametrize("name", CELLS)
def test_bf16_fails_the_check(small_cell, name):
    assert not _correct(small_cell(name), "cpu", "bf16", 31)


def _own_batch(name):
    """The cell at its configuration and batch, over four batches of rows
    (the check's three first steps lie in the first epoch)."""
    import conftest

    cell = conftest.cell(name)
    cell.traffic.update(rows=4 * cell.traffic["batch"])
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("control", ["tf32", "bf16"])
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [41, 42, 43])
def test_lower_precision_fails_on_the_card(need_cuda, name, control, seed):
    assert not _correct(_own_batch(name), "cuda", control, seed)
