"""Least times an H100 could take for the port's kernels: the larger of the
bytes a function must move (each input read once, each output written
once) over the memory rate and the f32 instruction slots it needs over the
instruction rate. Used by chip_smoke.py and kernels/bench.py."""

import math

from armnet_tpu_torch.kernels.entmax_common import (N_BISECT, N_FAST,
                                                    N_NEWTON, N_POLISH,
                                                    solver_mode)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
# 67 TFLOP/s of f32 outside the tensor cores counts an FMA as two
# operations: one f32 instruction per lane per clock is half of it. The
# special-function unit (lg2, ex2, rcp) and int<->float conversions issue
# at 16 per clock per SM against 128 f32 lanes (CUDA programming guide,
# compute capability 9.0), so each takes 8 f32 instruction slots.
F32_INSTR_PER_S = 33.5e12


def entmax_ops_per_element(alpha, n_iter=30):
    """f32 instruction slots the entmax solve needs per input element, for
    the bound. A lower count: an add, max, compare or select is 1, an int
    add 2, an SFU op or a conversion 8; powf is at least lg2, multiply, ex2
    (17) and an IEEE divide at least a reciprocal and 3 refinements (11).
    Per-column scalar work is left out."""
    inv_am1 = 1.0 / (alpha - 1.0)
    mode = solver_mode(alpha)
    pow_cost = {1.0: 0, 2.0: 1, 3.0: 2}.get(inv_am1, 17)
    evaluate = 3 + pow_cost             # subtract, clamp, pow, add
    common = 2 + evaluate + 11          # scale, max; last pass, divide
    if mode == "bisect":                # f(tau_lo), then n_iter steps
        return common + evaluate * (min(n_iter, 30) + 1)
    # subtract, clamp, pow, add, compare, clamp, divide, select, add
    newton = evaluate + 4 + 11
    if mode == "fastpow":
        # subtract, clamp, int subtract, i2f, mul, add, max, min, f2i,
        # compare+select, add
        fast = 1 + 1 + 2 + 8 + 1 + 1 + 1 + 1 + 8 + 2 + 1
        return common + fast * N_FAST + newton * N_POLISH
    return common + evaluate * N_BISECT + newton * N_NEWTON


def entmax_bwd_ops_per_element(alpha):
    """f32 instruction slots of the entmax backward per element, a lower
    count as above: compare and select (2), g (0 at alpha 2; an IEEE sqrt,
    at least a reciprocal square root and 3 refinements, 11; else a max
    and powf, 18), then dy*g, the two sums, q*g and a subtract (5)."""
    g_cost = {0.0: 0, 0.5: 11}.get(2.0 - alpha, 18)
    return 2 + g_cost + 5


def bound(nbytes, nops):
    """(bound ms, 'bytes' | 'operations'): the larger of bytes over the
    memory rate and f32 instruction slots over the instruction rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / F32_INSTR_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def entmax_bound_ms(shape, alpha):
    numel = math.prod(shape)
    return bound(2 * 4 * numel, entmax_ops_per_element(alpha) * numel)


def fused_arm_bounds(shape, alpha):
    """{"fwd"|"bwd": (bound ms, bound_by, bytes, f32 instruction slots)} of
    the fused ARM-1h kernels K5 and K6 at (B, F, E, dk, O), by the same
    counts as the other kernels: bytes of each input read once and each
    output written once; f32 instruction slots with a multiply-add as
    one, exp as 8 plus 2, and the entmax solve and VJP as
    entmax_ops_per_element and entmax_bwd_ops_per_element."""
    b, f, e, dk, o = shape
    bfo, boe, bfe = b * f * o, b * o * e, b * f * e
    keys, gates, cross = bfe * dk, b * f * dk * o, b * o * f * e
    fwd_ops = (keys + gates + entmax_ops_per_element(alpha) * bfo + bfo
               + cross + 10 * boe)
    # backward: the forward replay, then dz, dw, ds, the entmax VJP, dkeys,
    # the two terms of de, dWk, dquery and dvalues
    bwd_ops = (fwd_ops + boe + cross + bfo
               + entmax_bwd_ops_per_element(alpha) * bfo + gates + cross
               + keys + keys + gates + 2 * bfo)
    weights = 4 * (e * dk + o * dk + f * o)
    out = {}
    for name, nbytes, nops in (
            ("fwd", 4 * (bfe + boe) + weights, fwd_ops),
            ("bwd", 4 * (2 * bfe + boe) + 2 * weights, bwd_ops)):
        out[name] = (*bound(nbytes, nops), nbytes, nops)
    return out
