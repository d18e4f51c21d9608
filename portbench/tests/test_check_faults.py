"""The rest of a run with the timed path broken underneath (the look for a
card skipped; small cells on the CPU): each fault a cell can have makes
`correct` false, while the sound run is correct."""

import json

import pytest
import torch

from portbench import calibrate, harness, result


def _correct(cell, hooks=None, seed=21):
    _, numbers, _ = harness.run(cell, seed, 0.3, False, "cpu", hooks)
    return result.check(numbers, cell.limits)


def _state_unchanged(step, session):
    """A step that leaves the model and optimizer state as they were."""
    def frozen(state, meters, batch):
        saved = {k: v.clone() for k, v in state.model.state_dict().items()}
        meters = step(state, meters, batch)
        state.model.load_state_dict(saved)
        state.optimizer.state.clear()
        return meters
    return frozen


@pytest.mark.parametrize("name", ["cr_armnet1h.train", "cr_armnet.train"])
def test_sound_train_run_is_correct(small_cell, name):
    assert _correct(small_cell(name))[0]


@pytest.mark.parametrize("name", ["cr_armnet1h.train", "cr_armnet.train"])
def test_step_that_leaves_the_state_unchanged(small_cell, name):
    ok, checks = _correct(small_cell(name), {"step": _state_unchanged})
    assert not ok
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


def _logit_altered(step, session):
    """One logit of every forward moved by 0.01 where the model produces
    it (the loss and the step then use the altered answer)."""
    def alter(module, args, out):
        return torch.where(torch.arange(out.shape[0]) == 7, out + 0.01, out)
    session.model.register_forward_hook(alter)
    return step


@pytest.mark.parametrize("name", ["cr_armnet1h.train", "cr_armnet.train"])
def test_answer_altered_where_it_is_produced(small_cell, name):
    ok, checks = _correct(small_cell(name), {"step": _logit_altered})
    assert not ok
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]


@pytest.mark.parametrize("name", ["cr_armnet1h.train", "cr_armnet.train"])
def test_half_of_the_batch_left_out(small_cell, name):
    ok, checks = _correct(small_cell(name),
                          {"step": calibrate._half_batch})
    assert not ok
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"]


def _readings(loss, logits):
    return {"loss": [1.0, loss], "auc": [0.5, 0.5], "logits": logits,
            "grad": {"a": 1.0, "b": 1e-9}, "change": {"a": 1.0, "b": 0.0}}


def test_numbers_carry_a_nan():
    refr = _readings(1.0, torch.ones(8))
    numbers, left_out, _ = harness.train_numbers(
        _readings(float("nan"), torch.ones(8)), refr)
    assert left_out == ["b"]
    ok, checks = result.check(numbers, dict.fromkeys(numbers, 1.0))
    assert not ok
    assert checks["loss_gap"]["value"] == "nan"
    json.dumps(checks, allow_nan=False)


def test_logits_of_fewer_rows_fail():
    numbers, _, _ = harness.train_numbers(_readings(1.0, torch.ones(4)),
                                          _readings(1.0, torch.ones(8)))
    assert numbers["logit_gap"] == float("inf")
    assert not result.check(numbers, dict.fromkeys(numbers, 1.0))[0]


def test_check_steps_must_fit_the_first_epoch(small_cell):
    cell = small_cell("cr_armnet1h.train", rows=256)
    with pytest.raises(ValueError, match="first epoch"):
        harness.run(cell, 1, 0.1, False, "cpu")

