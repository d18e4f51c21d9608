"""--bf16 in the port against the JAX package's compute dtype, on the CPU at
small widths: the same JAX init is bridged into a port model built with
dtype=torch.bfloat16, and the JAX model runs under
set_compute_dtype("bfloat16") (reset in `finally`).

  * all 21 models (armnet_1h under both kernel choices), binary and
    multi-class heads: the logits' dtype, and the dtype of the output of
    the embedding and of the input to the MLP head, equal the JAX model's
    (a bfloat16 activation times a float32 parameter promotes in both);
    the logits agree within BF16_RTOL norm-wise plus BF16_ATOL per element:
    XLA on the CPU and torch round a bfloat16 product differently, so the
    float32 helpers' rtol 1e-5 does not apply;
  * create_model refuses a dtype other than float32 and bfloat16.

Train steps, the CLI and predict under --bf16: test_torch_bf16_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from armnet_tpu.kernels.config import set_compute_dtype, set_kernel_backend
from armnet_tpu_torch.models import MODEL_NAMES, create_model
from armnet_tpu_torch.models.config import ModelConfig
from test_torch_armnet import zoo_kw
from test_torch_armnet1h import jax_armnet1h, port_model, random_batch

# ||port - jax|| <= BF16_RTOL * ||jax|| + BF16_ATOL * sqrt(n): 2e-2 is five
# bfloat16 ulps (2^-8) of relative error; 2e-3 per element, a quarter of a
# bfloat16 ulp at 1.0, covers logits near 0 (read: at most 2.6e-2 relative
# and 1.5e-3 absolute, dnn and ipnn, whose heads stay in bfloat16)
BF16_RTOL, BF16_ATOL = 2e-2, 2e-3
SCALAR_HEAD = ("lr", "fm", "hofm", "afm", "dcn", "cin")
CASES = ([(m, 1, "auto") for m in MODEL_NAMES]
         + [(m, 3, "auto") for m in MODEL_NAMES if m not in SCALAR_HEAD]
         + [("armnet_1h", n, "pallas-fused") for n in (1, 3)])


def _close(got, want):
    gap = float(np.linalg.norm(got - want))
    return gap <= BF16_RTOL * float(np.linalg.norm(want)) \
        + BF16_ATOL * got.size ** 0.5


def _head(model):
    """The port model's MLP head (GCN and GAT call it `affine`)."""
    return getattr(model, "mlp", None) or getattr(model, "affine", None)


def _jax_bf16_forward(jm, v, batch, kernels):
    """(logits, {intermediate path: dtype}) of the JAX model under bf16."""
    set_compute_dtype("bfloat16")
    set_kernel_backend(kernels)
    try:
        y, st = jm.apply(v, {k: jnp.asarray(a) for k, a in batch.items()},
                         train=False, capture_intermediates=True,
                         mutable=["intermediates"])
    finally:
        set_compute_dtype("float32")
        set_kernel_backend("auto")
    leaves = jax.tree_util.tree_flatten_with_path(st["intermediates"])[0]
    return y, {"/".join(str(getattr(k, "key", k)) for k in path): a.dtype
               for path, a in leaves}


@pytest.mark.parametrize("name,noutput,kernels", CASES)
def test_eval_logits_dtype_and_values_match_jax(name, noutput, kernels):
    kw = zoo_kw(name, noutput=noutput)
    jm, v, flat = jax_armnet1h(kw, seed=3)
    batch = random_batch(np.random.RandomState(1), 16, kw["nfeat"])
    yj, dtypes = _jax_bf16_forward(jm, v, batch, kernels)

    cfg = ModelConfig(**kw)
    model = create_model(cfg, kernels=kernels, dtype=torch.bfloat16)
    model.load_state_dict(port_model(flat, kw).state_dict())
    model.eval()
    seen = {}
    hooks = []
    if isinstance(getattr(model, "embedding", None), torch.nn.Module):
        hooks.append(model.embedding.register_forward_hook(
            lambda m, a, out: seen.update(embedding=out.dtype)))
    head = _head(model)
    if head is not None:
        hooks.append(head.register_forward_pre_hook(
            lambda m, a: seen.update(head=a[0].dtype)))
    with torch.no_grad():
        yt = model({k: torch.from_numpy(a) for k, a in batch.items()})
    for h in hooks:
        h.remove()

    def jax_dtype(path):
        return str(dtypes[path]) if path in dtypes else None

    head_name = "mlp" if getattr(model, "mlp", None) is not None else "affine"
    want = {"logits": str(yj.dtype),
            "embedding": jax_dtype("embedding/__call__/[0]"),
            "head": jax_dtype(f"{head_name}/TorchLinear_0/__call__/[0]")}
    got = {"logits": str(yt.dtype).replace("torch.", ""),
           "embedding": str(seen.get("embedding")).replace("torch.", "")
           if "embedding" in seen else None,
           "head": str(seen["head"]).replace("torch.", "")
           if "head" in seen else None}
    assert got == want
    if "embedding" in seen:
        assert seen["embedding"] == torch.bfloat16
    assert _close(yt.float().numpy(), np.asarray(yj, np.float32)), (
        name, float(np.abs(yt.float().numpy() - np.asarray(yj,
                                                           np.float32)).max()))


def test_create_model_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float16"):
        create_model(ModelConfig(**zoo_kw("dnn")), dtype=torch.float16)
