"""--bf16 training in the port against the JAX package's, on the CPU at
small widths (the eval logits of every model: test_torch_bf16.py).

  * three clamp+Adam steps of armnet_1h (both kernel choices), armnet, afn
    and one model of each zoo family (fm, dnn, dcn+, gcn) from the same
    weights: each step's loss within BF16_RTOL of the JAX step's under
    set_compute_dtype("bfloat16"); the losses stay float32, the
    parameters float32;
  * --bf16 through the CLI and predict on the CPU: predict restores bf16
    from the checkpoint's sidecar and scores with the bfloat16 model.
"""

import numpy as np
import pytest
import torch

from armnet_tpu.kernels.config import set_compute_dtype
from armnet_tpu.models import param_transform_for as jax_transform
from armnet_tpu_torch import predict
from armnet_tpu_torch.data.libsvm import BatchIterator, LibsvmDataset
from armnet_tpu_torch.models import create_model, param_transform_for
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.train.checkpoint import load_checkpoint
from armnet_tpu_torch.train.step import (create_train_state, init_meters,
                                         make_train_step)
from test_torch_armnet import check_cli_and_predict, run_jax_steps, zoo_kw
from test_torch_bf16 import BF16_RTOL
from test_torch_train import init_pair, make_batches, to_torch


STEP_CASES = [("armnet_1h", "auto"), ("armnet_1h", "pallas-fused"),
              ("armnet", "auto"), ("afn", "auto"), ("fm", "auto"),
              ("dnn", "auto"), ("dcn+", "auto"), ("gcn", "auto")]


@pytest.mark.parametrize("name,kernels", STEP_CASES)
def test_train_step_losses_match_jax(name, kernels):
    """Three clamp+Adam steps under bf16 from the same weights (the last
    batch padded), the model's stored-parameter mutation first where it
    has one: each step's loss within BF16_RTOL of the JAX step's (the
    second and third through the first steps' bfloat16 backward)."""
    kw = zoo_kw(name)
    jm, params, stats, f32_model = init_pair(kw, seed=5, kernels=kernels)
    model = create_model(ModelConfig(**kw), kernels=kernels,
                         dtype=torch.bfloat16)
    model.load_state_dict(f32_model.state_dict())
    batches = make_batches(3, seed=6, pad_last=10)
    set_compute_dtype("bfloat16")
    try:
        lj, _, _ = run_jax_steps(jm, params, stats, batches, kernels,
                                 jax_transform(name))
    finally:
        set_compute_dtype("float32")
    state = create_train_state(model, 0.003)
    step = make_train_step(param_transform=param_transform_for(name))
    meters, lt = init_meters("cpu"), []
    for b in batches:
        meters = step(state, meters, to_torch(b))
        assert meters["loss_last"].dtype == torch.float32
        lt.append(float(meters["loss_last"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(lt, lj, rtol=BF16_RTOL)


@pytest.mark.parametrize("kernels", ["auto", "pallas-fused"])
def test_bf16_cli_and_predict_on_the_cpu(tmp_path, kernels):
    """--bf16 trains armnet_1h through the CLI on the CPU; predict restores
    bf16 (and the kernel choice) from the sidecar and writes the bfloat16
    model's probabilities, which are not the float32 model's."""
    state = check_cli_and_predict(tmp_path, "armnet_1h",
                                  ["--bf16", "--kernels", kernels])
    meta = load_checkpoint(str(tmp_path / "ckpt" / "t_3"))[1]["config"]
    assert meta["bf16"] is True and meta["kernels"] == kernels
    scores = np.loadtxt(tmp_path / "s.txt")
    cfg = ModelConfig(**{k: meta[k] for k in ModelConfig.__dataclass_fields__})
    loader = BatchIterator(LibsvmDataset(
        str(tmp_path / "data" / "tiny" / "test.libsvm"), cfg.nfield), 64)
    probs = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = create_model(cfg, kernels=kernels, dtype=dtype)
        model.load_state_dict(state)
        logits, _, masks = predict.score(model.eval(), loader, "cpu")
        probs[dtype] = torch.sigmoid(logits)[masks > 0].float().numpy()
    np.testing.assert_allclose(scores, probs[torch.bfloat16], atol=1e-6)
    assert np.abs(scores - probs[torch.float32]).max() > 1e-6
