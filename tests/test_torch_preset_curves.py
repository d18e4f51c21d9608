"""The Diabetes130 armnet_1h recipe (db_armnet1h) from one shared
initialisation, and the curve tool that writes it (tests/preset_curves.py).

data/parity/db_armnet1h_2025.npz is the JAX package's seed-2025 init of the
db_armnet1h model; chip_smoke.py's diabetes_parity phase trains the port
from it on the card and holds its best valid AUC to the JAX package's curve
beside it (data/parity/db_armnet1h_2025.json). Here, on the CPU: the file
is that init, it loads into the port, and the first 12 train steps from it
(the first epoch, its padded tenth batch included, and two steps after it)
on the bundled data/uci_diabetes/ split agree with the JAX trainer's at
full width.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import preset_curves as pc
from armnet_tpu.train.step import init_meters as jax_init_meters
from armnet_tpu_torch.bridge import from_jax_arrays
from armnet_tpu_torch.train.step import init_meters

SEED = 2025
PARITY = os.path.join(pc.DATA, "parity", f"db_armnet1h_{SEED}")
# 12 of the recipe's first 20 steps: the full-width steps on the CPU are
# the slowest of the test run, and these still reach past the padded batch
STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's steps at full width in one thread. These tensors are
    large enough for torch to fork its whole thread pool at every op, and
    beside the test run's other workers the pools oversubscribe the cores
    and slow each other many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def committed_init():
    with np.load(PARITY + ".npz") as z:
        return {k: z[k] for k in z.files}


def test_committed_init_is_the_jax_seed_2025_init(committed_init, tmp_path,
                                                  capsys):
    """The committed file equals the JAX package's seed-2025 init of the
    db_armnet1h model, regenerated here by `preset_curves.py --export-init`
    (with --epochs 0: the init alone), leaf by leaf and bit for bit, and
    fills the port's model with no missing, extra or misshapen leaf."""
    pc.main(["--preset", "db_armnet1h", "--epochs", "0", "--seeds",
             str(SEED), "--export-init", str(tmp_path)])
    capsys.readouterr()
    with np.load(tmp_path / f"db_armnet1h_{SEED}.npz") as z:
        fresh = {k: z[k] for k in z.files}
    assert sorted(fresh) == sorted(committed_init)
    for k, v in fresh.items():
        assert committed_init[k].dtype == np.float32, k
        np.testing.assert_array_equal(committed_init[k], v, err_msg=k)
    # from_jax_arrays raises on a missing, extra or misshapen leaf, and the
    # strict load_state_dict on a key the model lacks
    port = pc.port_trainer(pc.recipe("db_armnet1h"), SEED)
    pc.load_init(port, committed_init)
    emb = port.state.model.state_dict()["embedding.weight"]
    np.testing.assert_array_equal(
        emb.numpy(), committed_init["params/embedding/embedding"].reshape(
            emb.shape))


def test_committed_curves_name_their_command():
    """The JSON beside the init names the command that wrote it, the JAX
    version, and holds the three 15-epoch curves that start from it."""
    with open(PARITY + ".json") as f:
        ref = json.load(f)
    assert ref["command"].startswith(
        "JAX_PLATFORMS=cpu python tests/preset_curves.py --preset "
        "db_armnet1h")
    assert "--export-init data/parity" in ref["command"]
    assert ref["versions"]["jax"] and ref["seed"] == SEED
    assert sorted(ref["valid_auc"]) == sorted(pc.RUNS)
    for curve in ref["valid_auc"].values():
        assert len(curve) == ref["epochs"] == 15
        assert all(0.5 < v < 1.0 for v in curve)


def _batches(trainer, steps):
    """The train loader's first `steps` batches, epoch after epoch."""
    while True:
        for batch in trainer.loaders[0]:
            if steps == 0:
                return
            steps -= 1
            yield batch


def _jax_steps(trainer, steps):
    state, meters, losses = trainer.state, jax_init_meters(), []
    for batch in _batches(trainer, steps):
        state, meters = trainer.train_step(state, meters, batch, trainer.rng)
        losses.append(float(meters["loss_last"]))
    trainer.state = state
    return np.asarray(losses)


def _port_steps(trainer, steps):
    meters, losses = init_meters("cpu"), []
    for batch in _batches(trainer, steps):
        meters = trainer.train_step(trainer.state, meters, batch)
        losses.append(float(meters["loss_last"]))
    return np.asarray(losses)


def test_first_steps_from_the_committed_init_match_jax(committed_init):
    """The first 12 train steps of the full-width db_armnet1h recipe (43
    fields, h 128, alpha 1.7, batch 1024) on the bundled split from the
    committed init, under --kernels auto (the JAX side on its default CPU
    path; the port's kernels' plain versions): per-step losses within 5e-4
    (tests/test_torch_fields43.py's tolerance) and arm_bn's running
    variance after the last step within rtol 1e-3. The split has 10,177
    rows, so each epoch's tenth batch is padded (63 rows)."""
    args = pc.recipe("db_armnet1h")
    jt = pc.jax_trainer(args, SEED)
    port = pc.port_trainer(args, SEED)
    pc.load_init(port, committed_init)
    assert len(port.loaders[0]) == len(jt.loaders[0]) == 10
    assert len(port.loaders[0].ds) == 10_177

    lj = _jax_steps(jt, STEPS)
    lt = _port_steps(port, STEPS)
    assert len(lt) == len(lj) == STEPS
    assert np.isfinite(lt).all() and lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, atol=5e-4)

    jax_state = from_jax_arrays(pc.jax_init(jt), port.cfg)
    var = [k for k in jax_state if k.startswith("arm_bn")
           and k.endswith("running_var")]
    assert var
    for k in var:
        np.testing.assert_allclose(
            port.state.model.state_dict()[k].numpy(), jax_state[k].numpy(),
            rtol=1e-3, err_msg=k)


def test_preset_curves_tool_runs_on_frappe(capsys):
    """`preset_curves.py --preset frappe_armnet1h --epochs 1 --seeds 2025`
    prints one JSON object with the three one-epoch curves."""
    pc.main(["--preset", "frappe_armnet1h", "--epochs", "1", "--seeds",
             "2025"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["preset"] == "frappe_armnet1h" and out["epochs"] == 1
    assert out["versions"]["jax"] == jax.__version__
    curves = out["valid_auc"]["2025"]
    assert sorted(curves) == sorted(pc.RUNS)
    for curve in curves.values():
        assert len(curve) == 1 and 0.5 < curve[0] < 1.0


@pytest.mark.parametrize("preset", ["frappe_armnet1h", "db_armnet1h",
                                    "db_armnet1h+", "db_armnet"])
def test_recipe_takes_presets_with_bundled_data(preset):
    """Every preset whose dataset is under data/ gives a recipe on it."""
    args = pc.recipe(preset)
    assert args[-2:] == ["--data_dir", pc.DATA]
    assert args[:-2] == pc.PRESETS[preset]


@pytest.mark.parametrize("preset", ["cr_armnet1h", "no_such_preset"])
def test_recipe_refuses_presets_without_bundled_data(preset):
    with pytest.raises((FileNotFoundError, KeyError)):
        pc.recipe(preset)
