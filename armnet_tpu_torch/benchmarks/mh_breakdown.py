"""Where the multi-head ARM interaction's time goes (the counterpart of the
JAX package's benchmarks/mh_breakdown.py): the [B, K, O, F] = [4096, 4, 64,
39] pipeline of the armnet and gc_arm Criteo recipes (E 10, alpha 2),
stage by stage, forward and backward.

    python -m armnet_tpu_torch.benchmarks.mh_breakdown [STAGE,...]
        [--warm 3] [--steps 10] [--reps 3] [--device cuda]

  gates        einsum('bfx,kxy,koy->bkof') * E^-0.5
  entmax       ops/entmax over the last axis of [B, K, O, F]: the entmax
               forward kernel (K1 in the JAX package: its 2-D entry) on
               the (outer, d, inner) = (B*K*O, 39, 1) view; its backward
               the VJP kernel (K3) on the same view
  entmax_jnp   the plain version (kernels/entmax_cuda.entmax_plain, 30
               bisections), the counterpart of the JAX stage's
               _entmax_core_static; the name is kept
  wcross       sparse * values -> exp(einsum('bfe,bkof->bkoe'))
  interaction  the whole chain gates -> entmax -> values -> exp-cross
  gates_fac    the gates through the folded [K, O, E] projection;
               gates_fac_bfo the fields-major [B, F, K*O] layout
  interaction_fm  the production fields-major path (ops/interaction:
               arm_attention_multihead + arm_exp_cross_fmajor), whose
               entmax runs over the middle axis of [B, F, K*O] (K2, K4)
  transpose    .t().contiguous() of the [B*K*O, F] view

Each *_bwd stage is torch.autograd.grad of the JAX stage's scalar
read-out with respect to the inputs whose gradients the JAX stage reads
(its jax.grad's other gradients are dead code there). The inputs are drawn
by RandomState(0) in the JAX script's order. Timing: benchmarks/timing.py
(host wall between two syncs, device ms and the kernels' launches from a
profiled repetition). stdout: one JSON line per stage; stderr: the JAX
script's table with the device ms beside it. STAGE (comma-separated)
picks stages by name, as the JAX script's first argument.
"""

import argparse

import numpy as np
import torch

from armnet_tpu_torch import resolve_device, set_matmul_precision
from armnet_tpu_torch.benchmarks.timing import (add_timing_args, parse_only,
                                                run_stages)
from armnet_tpu_torch.kernels.entmax_cuda import entmax_plain
from armnet_tpu_torch.ops.entmax import entmax_bisect, sparse_normalizer
from armnet_tpu_torch.ops.interaction import (arm_attention_multihead,
                                              arm_exp_cross_fmajor)

__all__ = ["B", "K", "O", "F", "E", "SHAPE", "ALPHA", "STAGES", "inputs",
           "stages", "main"]

B, K, O, F, E = 4096, 4, 64, 39, 10
SHAPE = (B, K, O, F, E)
ALPHA = 2.0
STAGES = ("gates_fwd", "gates_bwd", "entmax_fwd", "entmax_bwd",
          "entmax_jnp_fwd", "wcross_fwd", "wcross_bwd", "interaction_fwd",
          "interaction_bwd", "gates_fac_fwd", "gates_fac_bwd",
          "gates_fac_bfo_fwd", "interaction_fm_fwd", "interaction_fm_bwd",
          "transpose")


def inputs(shape=SHAPE, device="cpu"):
    """{emb, bw, q, v, gates}: the JAX script's emb0, bw0, q0, v0 and gates0,
    drawn by RandomState(0) in its order, float32 on `device`."""
    b, k, o, f, e = shape
    rng = np.random.RandomState(0)
    draws = {"emb": rng.randn(b, f, e) * 0.3, "bw": rng.randn(k, e, e) * 0.3,
             "q": rng.randn(k, o, e) * 0.3, "v": rng.randn(k, o, f) * 0.3,
             "gates": rng.randn(b, k, o, f)}
    return {n: torch.as_tensor(a, dtype=torch.float32).to(device)
            for n, a in draws.items()}


def _gates(emb, bw, q):
    scale = emb.shape[-1] ** -0.5
    return torch.einsum("bfx,kxy,koy->bkof", emb, bw, q) * scale


def _gates_fac(emb, bw, q):
    m = torch.einsum("kxy,koy->kox", bw, q)
    return torch.einsum("bfx,kox->bkof", emb, m) * emb.shape[-1] ** -0.5


def _gates_fac_bfo(emb, bw, q):
    m = torch.einsum("kxy,koy->kox", bw, q).reshape(-1, emb.shape[-1])
    return torch.einsum("bfx,ox->bfo", emb, m) * emb.shape[-1] ** -0.5


def _wcross(emb, sp, v):
    return torch.exp(torch.einsum("bfe,bkof->bkoe", emb, sp * v[None]))


def _interaction(emb, bw, q, v, alpha):
    return _wcross(emb, entmax_bisect(_gates(emb, bw, q), alpha), v)


def _interaction_fm(emb, bw, q, v, alpha):
    w = arm_attention_multihead(emb, bw, q, v,
                                sparse_normalizer(alpha, axis=1))
    return arm_exp_cross_fmajor(emb, w)


def _grads(f, inp, wrt):
    """torch.autograd.grad of the scalar f(**leaves) with respect to the
    inputs named in `wrt`, in that order; the others enter as constants."""
    leaves = {n: (t.detach().requires_grad_() if n in wrt else t)
              for n, t in inp.items() if n != "gates"}
    return torch.autograd.grad(f(**leaves), [leaves[n] for n in wrt])


def stages(inp, alpha=ALPHA):
    """((name, fn), ...) of STAGES on the inputs `inp` (inputs()): fn()
    returns the stage's outputs as a tuple, the arrays that the JAX
    stage's probe reads, in its order."""
    emb, bw, q, v, g0 = (inp[n] for n in ("emb", "bw", "q", "v", "gates"))
    f = emb.shape[1]

    def entmax_bwd():
        x = g0.detach().requires_grad_()
        return torch.autograd.grad((entmax_bisect(x, alpha) * g0).sum(), x)

    def wcross_bwd():
        e, sp = emb.detach().requires_grad_(), g0.detach().requires_grad_()
        return torch.autograd.grad(_wcross(e, sp, v).sum(), (e, sp))

    table = {
        "gates_fwd": lambda: (_gates(emb, bw, q),),
        "gates_bwd": lambda: _grads(
            lambda emb, bw, q, v: (_gates(emb, bw, q) * g0).sum(), inp,
            ("emb", "bw")),
        "entmax_fwd": lambda: (entmax_bisect(g0, alpha),),
        "entmax_bwd": entmax_bwd,
        "entmax_jnp_fwd": lambda: (entmax_plain(g0, alpha, -1, n_iter=30),),
        "wcross_fwd": lambda: (_wcross(emb, g0, v),),
        "wcross_bwd": wcross_bwd,
        "interaction_fwd": lambda: (_interaction(emb, bw, q, v, alpha),),
        "interaction_bwd": lambda: _grads(
            lambda emb, bw, q, v: _interaction(emb, bw, q, v, alpha).sum(),
            inp, ("emb", "v")),
        "gates_fac_fwd": lambda: (_gates_fac(emb, bw, q),),
        "gates_fac_bwd": lambda: _grads(
            lambda emb, bw, q, v: (_gates_fac(emb, bw, q) * g0).sum(), inp,
            ("emb", "bw")),
        "gates_fac_bfo_fwd": lambda: (_gates_fac_bfo(emb, bw, q),),
        "interaction_fm_fwd": lambda: (_interaction_fm(emb, bw, q, v,
                                                       alpha),),
        "interaction_fm_bwd": lambda: _grads(
            lambda emb, bw, q, v: _interaction_fm(emb, bw, q, v,
                                                  alpha).sum(),
            inp, ("emb", "v")),
        "transpose": lambda: (g0.reshape(-1, f).t().contiguous(),),
    }
    return tuple((name, table[name]) for name in STAGES)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="host wall and device time of the multi-head ARM "
                    "interaction's stages (one JSON line per stage)")
    p.add_argument("only", nargs="?", default=None,
                   help="comma-separated stages (default: all)")
    add_timing_args(p, warm=3, steps=10, reps=3, kernels=False)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_matmul_precision("default")
    run_stages(stages(inputs(SHAPE, device)), device, args.warm, args.steps, args.reps,
               parse_only(args.only), shape=dict(zip("BKOFE", SHAPE)),
               alpha=ALPHA)


if __name__ == "__main__":
    main()
