"""The port's fused ARM-1h path (--kernels pallas-fused) against the JAX
package on the CPU, with inputs from seeded numpy: the port runs the plain
versions of its kernels (kernels/arm_cuda.py), the JAX side its fused
Pallas kernels in interpret mode, as tests/test_arm_pallas.py runs them.

  * arm1h_fused forward against JAX arm1h_fused (rtol/atol 2e-5, the JAX
    file's own), B = 11 included, and its four gradients against jax.grad
    (rtol 5e-4, atol 5e-5);
  * the fused path against the port's composed path;
  * armnet_1h eval logits and one train step under pallas-fused against
    the JAX model under set_kernel_backend("pallas-fused");
  * the kernel choice: flags, the refusal of xla, a checkpoint sidecar
    that routes predict through the fused function, and the build's hash
    of the headers the CUDA sources include.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.arm_pallas import arm1h_fused as jax_arm1h_fused
from armnet_tpu.kernels.config import set_kernel_backend
from armnet_tpu.ops.layers import batch_mask_scope as jax_batch_mask_scope
from armnet_tpu.train.metrics import masked_bce as jax_masked_bce
from armnet_tpu_torch import predict
from armnet_tpu_torch.bridge import from_jax_arrays, params_from_jax
from armnet_tpu_torch.kernels import arm_cuda, build
from armnet_tpu_torch.kernels.config import BACKENDS, use_fused_arm
from armnet_tpu_torch.models import create_model
from armnet_tpu_torch.models.config import ModelConfig
from armnet_tpu_torch.ops.interaction import arm1h_fused, arm1h_interaction
from armnet_tpu_torch.train import cli
from armnet_tpu_torch.train.checkpoint import save_checkpoint
from armnet_tpu_torch.train.step import forward_loss
from armnet_tpu_torch.utils import tracing
from armnet_tpu_torch.utils.config import (ExperimentConfig, build_arg_parser,
                                           check_supported)
from test_torch_armnet1h import (jax_armnet1h, jax_logits, random_batch,
                                 small_config)
from test_torch_train import init_pair, make_batches, small_kw, to_jax, \
    to_torch

ALPHAS = [1.5, 1.7, 2.0, 2.5]


def _inputs(b=24, f=7, e=6, dk=6, o=9, seed=0):
    """emb, wk, query, values at the scales of tests/test_arm_pallas.py."""
    rng = np.random.RandomState(seed)
    return ((rng.randn(b, f, e) * 0.5).astype(np.float32),
            (rng.randn(e, dk) * 0.3).astype(np.float32),
            (rng.randn(o, dk) * 0.3).astype(np.float32),
            (rng.randn(o, f) * 0.3).astype(np.float32))


def _port_grads(fn, arrays, alpha):
    """Gradients of sum(sin(fn(...))) in the port, by autograd."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*leaves, alpha)
    return out, torch.autograd.grad(out.sin().sum(), leaves)


@pytest.mark.parametrize("b", [24, 11])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_forward_matches_jax(alpha, b):
    arrays = _inputs(b=b, seed=b)
    want = np.asarray(jax_arm1h_fused(*map(jnp.asarray, arrays), alpha))
    got = arm1h_fused(*map(torch.from_numpy, arrays), alpha)
    assert got.shape == want.shape == (b, 9, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_gradients_match_jax(alpha):
    """The four gradients (emb, wk, query, values) against jax.grad of the
    JAX fused kernel's custom VJP, through a sin loss."""
    arrays = _inputs(b=16, f=5, e=4, dk=4, o=6, seed=3)
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_arm1h_fused(*a, alpha))),
                    argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrays))
    _, got = _port_grads(arm1h_fused, arrays, alpha)
    for name, g, w in zip(("emb", "wk", "query", "values"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_fused_matches_composed(alpha):
    """The fused path against the composed one (arm1h_interaction under
    auto), forward and the four gradients; only the sums' order differs."""
    arrays = _inputs(b=32, f=10, e=10, dk=10, o=16, seed=4)
    out_f, grads_f = _port_grads(arm1h_fused, arrays, alpha)
    out_c, grads_c = _port_grads(arm1h_interaction, arrays, alpha)
    torch.testing.assert_close(out_f, out_c, rtol=2e-5, atol=2e-5)
    for name, g, w in zip(("emb", "wk", "query", "values"), grads_f,
                          grads_c):
        torch.testing.assert_close(g, w, rtol=5e-4, atol=5e-5, msg=name)


# the kernels' edges (their plain versions are the yardstick on the card):
# more neurons than a block's 128 threads (K6 takes them in chunks), part
# of a block, F on each side of the 16-field register bucket's edge, and
# embeddings wider than K6's 16-wide register sums (Frappe at nemb 100
# with h 10; widths that are not a multiple of 16); one alpha per shape of
# each group, so each solver branch is met
EDGE_CASES = [((6, 7, 4, 4, 200), 2.0), ((6, 7, 4, 4, 96), 1.7),
              ((5, 17, 4, 4, 20), 2.5), ((5, 16, 4, 3, 130), 1.5),
              ((3, 10, 100, 100, 10), 2.0), ((4, 9, 33, 20, 12), 1.7),
              ((3, 17, 20, 35, 7), 2.5), ((3, 5, 40, 17, 9), 1.5)]


@pytest.mark.parametrize("shape,alpha", EDGE_CASES)
def test_plain_versions_match_jax_at_edge_shapes(shape, alpha):
    """The forward (rtol/atol 2e-5) and the four gradients (rtol 5e-4,
    atol 5e-5) of the plain versions against the JAX fused kernel in
    interpret mode and jax.grad through it."""
    b, f, e, dk, o = shape
    arrays = _inputs(b=b, f=f, e=e, dk=dk, o=o, seed=o + f)
    jarrays = list(map(jnp.asarray, arrays))
    want = np.asarray(jax_arm1h_fused(*jarrays, alpha))
    want_g = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_arm1h_fused(*a, alpha))),
                      argnums=(0, 1, 2, 3))(*jarrays)
    got, got_g = _port_grads(arm1h_fused, arrays, alpha)
    assert got.shape == want.shape == (b, o, e)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    for name, g, w in zip(("emb", "wk", "query", "values"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


@pytest.mark.parametrize("f", [41, 43, 64])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_plain_versions_match_jax_past_40_fields(alpha, f):
    """Past the kernels' 40-field register bucket (the Diabetes130 recipe's
    43 fields among them), where the CUDA kernels hold the gate column in
    shared memory: the plain versions' forward (rtol/atol 2e-5) and four
    gradients (rtol 5e-4, atol 5e-5) against the JAX fused kernel in
    interpret mode and jax.grad through it."""
    arrays = _inputs(b=3, f=f, e=4, dk=4, o=9, seed=f)
    jarrays = list(map(jnp.asarray, arrays))
    want = np.asarray(jax_arm1h_fused(*jarrays, alpha))
    want_g = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_arm1h_fused(*a, alpha))),
                      argnums=(0, 1, 2, 3))(*jarrays)
    got, got_g = _port_grads(arm1h_fused, arrays, alpha)
    assert got.shape == want.shape == (3, 9, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-5,
                               atol=2e-5)
    for name, g, w in zip(("emb", "wk", "query", "values"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5, err_msg=name)


def _pad4(n):
    return (n + 3) // 4 * 4


@pytest.mark.parametrize("f,e,dk,o", [(39, 10, 10, 128), (10, 10, 10, 128),
                                      (40, 16, 16, 200), (1, 1, 1, 1),
                                      (17, 5, 7, 96), (41, 10, 10, 128),
                                      (43, 10, 10, 128), (128, 5, 7, 96)])
def test_smem_bytes_follow_the_kernels_layouts(f, e, dk, o):
    """The forward wrapper's shared-memory size against the layout
    documented in csrc/arm1h.cu (fwd_smem): emb and keys with rows padded
    to 4 floats, then the row's outputs [O, E]; past 40 fields the
    threads' gate columns [F, 128] (csrc/arm1h_col.cu col_smem). (K6's
    layout has one owner, csrc/arm1h_bwd.cuh, which the wrapper asks
    through its C entry.)"""
    cols = f * 128 if f > 40 else 0
    assert arm_cuda.fwd_smem_bytes(f, e, dk, o) == 4 * (
        f * _pad4(e) + f * _pad4(dk) + o * e + cols)


def test_fused_kernels_refuse_only_past_shared_memory():
    """No field count is refused up front: K5 at 500 fields raises for the
    shared memory its columns need (309,120 bytes, more than a block's
    232,448), and 43 fields pass the checks to the CUDA-tensor test."""
    assert arm_cuda.fwd_smem_bytes(43, 10, 10, 128) <= arm_cuda.SMEM_BYTES
    assert arm_cuda.fwd_smem_bytes(500, 10, 10, 128) == 309_120
    with pytest.raises(ValueError, match="shared memory"):
        arm_cuda._smem_check("arm1h_fwd_kernel",
                             arm_cuda.fwd_smem_bytes(500, 10, 10, 128))
    arrays = [torch.from_numpy(a) for a in _inputs(b=2, f=43, seed=6)]
    with pytest.raises(ValueError, match="CUDA"):
        arm_cuda.arm1h_fwd_kernel(arrays[0], arrays[1], arrays[2],
                                  arrays[3].t().contiguous(), 1.7)


def test_fused_dispatch_and_refusals():
    """arm1h_interaction takes the fused path under pallas-fused only, and
    only for a static alpha > 1; the plain versions count no kernel call."""
    arrays = [torch.from_numpy(a) for a in _inputs(seed=5)]
    before = tracing.counts("armnet.kernel.")
    fused = arm1h_interaction(*arrays, 1.7, kernels="pallas-fused")
    torch.testing.assert_close(fused, arm1h_fused(*arrays, 1.7), rtol=0,
                               atol=0)
    composed = arm1h_interaction(*arrays, 1.7, kernels="pallas")
    torch.testing.assert_close(composed, arm1h_interaction(*arrays, 1.7),
                               rtol=0, atol=0)
    # softmax at alpha 1 stays on the composed path under pallas-fused
    soft = arm1h_interaction(*arrays, 1.0, kernels="pallas-fused")
    torch.testing.assert_close(soft, arm1h_interaction(*arrays, 1.0),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="alpha > 1"):
        arm1h_fused(*arrays, 1.0)
    with pytest.raises(ValueError, match="unknown kernel choice"):
        arm1h_interaction(*arrays, 1.7, kernels="triton")
    assert tracing.counts("armnet.kernel.") == before
    with pytest.raises(ValueError, match="CUDA"):
        arm_cuda.arm1h_fwd_kernel(arrays[0], arrays[1], arrays[2],
                                  arrays[3].t().contiguous(), 1.7)
    assert [use_fused_arm(b) for b in BACKENDS] == [False, False, False,
                                                    True]


@pytest.mark.parametrize("h,alpha,nfeat,ensemble", [(128, 2.0, 600, False),
                                                    (6, 1.7, 300, True)])
def test_eval_logits_match_jax(h, alpha, nfeat, ensemble):
    """armnet_1h under pallas-fused against the JAX model under
    set_kernel_backend("pallas-fused"), from one bridged JAX init."""
    kw = small_config(h=h, alpha=alpha, nfeat=nfeat, ensemble=ensemble)
    jm, v, flat = jax_armnet1h(kw, seed=h + 7)
    batch = random_batch(np.random.RandomState(2), 16, nfeat)
    set_kernel_backend("pallas-fused")
    try:
        yj = jax_logits(jm, v, batch)
    finally:
        set_kernel_backend("auto")
    cfg = ModelConfig(**kw)
    model = create_model(cfg, kernels="pallas-fused")
    model.load_state_dict(from_jax_arrays(flat, cfg))
    with torch.no_grad():
        yt = model.eval()({k: torch.from_numpy(a)
                           for k, a in batch.items()}).numpy()
    assert np.ptp(yj) > 1e-3
    np.testing.assert_allclose(yt, yj, rtol=1e-5, atol=1e-5)


def test_one_step_gradients_match_jax():
    """One train-mode step (masked BN on a padded batch, masked BCE) under
    pallas-fused on both sides: the loss within 1e-5 relative and every
    parameter's gradient at rtol 1e-4, atol 1e-6, as the composed path's
    test in test_torch_train.py holds them."""
    kw = small_kw()
    jm, params, stats, model = init_pair(kw, seed=1, kernels="pallas-fused")
    b = make_batches(1, seed=2, pad_last=20)[0]
    jb = to_jax(b)

    def loss_fn(p):
        with jax_batch_mask_scope(jb["mask"]):
            logits, _ = jm.apply(
                {"params": p, "batch_stats": stats},
                {"id": jb["id"], "value": jb["value"]}, train=True,
                rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jax_masked_bce(logits, jb["y"], jb["mask"])

    set_kernel_backend("pallas-fused")
    try:
        lj, gj = jax.value_and_grad(loss_fn)(params)
    finally:
        set_kernel_backend("auto")
    loss, _ = forward_loss(model, to_torch(b))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, gj), ModelConfig(**kw))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kernels", ["auto", "pallas", "pallas-fused"])
def test_kernels_flag_parses(kernels):
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
        ["--kernels", kernels])))
    assert cfg.kernels == kernels
    check_supported(cfg)


def test_xla_kernels_raise(tmp_path):
    cfg = ExperimentConfig(**vars(build_arg_parser().parse_args(
        ["--kernels", "xla"])))
    with pytest.raises(NotImplementedError, match="plain PyTorch versions"):
        check_supported(cfg)
    with pytest.raises(NotImplementedError, match="xla"):
        cli.main(["--kernels", "xla", "--device", "cpu", "--log_dir",
                  str(tmp_path)])
    with pytest.raises(SystemExit):
        build_arg_parser().parse_args(["--kernels", "triton"])


def test_sidecar_routes_predict_through_the_fused_function(tmp_path,
                                                           monkeypatch):
    """A checkpoint whose sidecar says pallas-fused scores through
    arm1h_fwd_plain on the CPU, once per batch, with the same scores as
    the composed path."""
    kw = small_config(h=8, alpha=1.7)
    cfg = ExperimentConfig(**kw, kernels="pallas-fused", device="cpu")
    model = create_model(cfg, seed=3, kernels=cfg.kernels)
    save_checkpoint(model, cfg, str(tmp_path / "ck"), "best")
    with open(tmp_path / "ck" / "best.meta.json") as f:
        assert json.load(f)["config"]["kernels"] == "pallas-fused"
    rng = np.random.RandomState(8)
    batch = random_batch(rng, 40, kw["nfeat"])
    inp = str(tmp_path / "rows.libsvm")
    with open(inp, "w") as f:
        for ids, vals in zip(batch["id"], batch["value"]):
            f.write(f"{rng.randint(2)} " + " ".join(
                f"{i}:{v:.6g}" for i, v in zip(ids, vals)) + "\n")
    calls = []
    plain = arm_cuda.arm1h_fwd_plain

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return plain(*args, **kwargs)

    monkeypatch.setattr(arm_cuda, "arm1h_fwd_plain", counted)
    argv = ["--ckpt", str(tmp_path / "ck"), "--input", inp, "--device",
            "cpu", "--batch_size", "16"]
    fused = predict.main(argv + ["--output", str(tmp_path / "f.txt")])
    assert len(calls) == fused["batches"] == 3
    composed = predict.main(argv + ["--kernels", "auto", "--output",
                                    str(tmp_path / "c.txt")])
    assert len(calls) == 3
    np.testing.assert_allclose(np.loadtxt(tmp_path / "f.txt"),
                               np.loadtxt(tmp_path / "c.txt"), atol=2e-6)
    assert fused["rows"] == composed["rows"] == 40


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    """A library is named by its source and every header in csrc/, so an
    edited header builds anew instead of loading a stale library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("arm1h.cu", "entmax.cu", "entmax_solver.cuh"):
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            (csrc / name).write_text(f.read())
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = {n: build._lib_path(n) for n in ("arm1h", "entmax")}
    (csrc / "entmax_solver.cuh").write_text(
        (csrc / "entmax_solver.cuh").read_text() + "\n// edited\n")
    after = {n: build._lib_path(n) for n in ("arm1h", "entmax")}
    assert all(before[n] != after[n] for n in before)
    assert build.sources() == ["arm1h", "entmax"]
