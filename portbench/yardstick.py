"""The benchmark's fixed arithmetic: the card's published peaks, the least
time a kernel could take (a frozen copy of the measured program's
kernels/bounds.py counts, so that a later change to the program cannot
move the yardstick), and roofline and utilisation shares.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): HBM3
3.35 TB/s; 67 TFLOP/s of float32 outside the tensor cores, the precision
the configurations run their products in (TF32 off). One f32 instruction
per lane per clock is half of the FLOP rate (an FMA counts 2 FLOPs).
"""

__all__ = ["HBM_BYTES_PER_S", "F32_FLOPS", "F32_INSTR_PER_S",
           "entmax_ops_per_element", "entmax_bwd_ops_per_element", "bound_s",
           "entmax_fwd_bound_s", "entmax_bwd_bound_s", "table_grad_bound_s",
           "share"]

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F32_INSTR_PER_S = 33.5e12

# the kernels' solver budgets (frozen from the program's entmax solver)
_N_BISECT, _N_NEWTON, _N_FAST, _N_POLISH = 8, 6, 12, 4
_BISECT_CAP = 30


def _solver_mode(alpha):
    inv_am1 = 1.0 / (alpha - 1.0)
    if inv_am1 in (1.0, 2.0, 3.0):
        return "bisect"
    return "fastpow" if alpha <= 2.0 else "newton"


def entmax_ops_per_element(alpha, n_iter=50):
    """f32 instruction slots the entmax solve needs per input element, a
    lower count: an add, max, compare or select is 1, an int add 2, a
    special-function op or a conversion 8 (16 a clock per SM against 128
    lanes); powf at least 17, an IEEE divide at least 11. Per-column work
    is left out."""
    inv_am1 = 1.0 / (alpha - 1.0)
    mode = _solver_mode(alpha)
    pow_cost = {1.0: 0, 2.0: 1, 3.0: 2}.get(inv_am1, 17)
    evaluate = 3 + pow_cost             # subtract, clamp, pow, add
    common = 2 + evaluate + 11          # scale, max; last pass, divide
    if mode == "bisect":
        return common + evaluate * (min(n_iter, _BISECT_CAP) + 1)
    newton = evaluate + 4 + 11
    if mode == "fastpow":
        fast = 1 + 1 + 2 + 8 + 1 + 1 + 1 + 1 + 8 + 2 + 1
        return common + fast * _N_FAST + newton * _N_POLISH
    return common + evaluate * _N_BISECT + newton * _N_NEWTON


def entmax_bwd_ops_per_element(alpha):
    """f32 instruction slots of the entmax backward per element, a lower
    count: compare and select, g = y^(2-alpha) (0 at alpha 2, a square root
    11 at 1.5, else max and powf 18), then dy*g, two sums, q*g, subtract."""
    g_cost = {0.0: 0, 0.5: 11}.get(2.0 - alpha, 18)
    return 2 + g_cost + 5


def bound_s(nbytes, nops):
    """The least seconds: the larger of bytes over the memory rate and f32
    instruction slots over the instruction rate."""
    return max(nbytes / HBM_BYTES_PER_S, nops / F32_INSTR_PER_S)


def entmax_fwd_bound_s(numel, alpha):
    """The entmax forward over `numel` float32 entries: each read and each
    written once, and the solve's instruction slots."""
    return bound_s(2 * 4 * numel, entmax_ops_per_element(alpha) * numel)


def entmax_bwd_bound_s(numel, alpha):
    """The entmax backward: y and dy read, dx written."""
    return bound_s(3 * 4 * numel, entmax_bwd_ops_per_element(alpha) * numel)


def table_grad_bound_s(nrows_out, n, e, id_bytes=4):
    """The dense table gradient of n gathered rows of width e into
    nrows_out rows: g and the ids read once, the whole table written."""
    return bound_s(4 * n * e + id_bytes * n + 4 * nrows_out * e, 0)


def share(least_s, took_s):
    """A share in % of a bound, or None where nothing was timed."""
    if not took_s or took_s <= 0 or least_s is None:
        return None
    return 100.0 * least_s / took_s

