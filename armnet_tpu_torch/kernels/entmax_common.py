"""Alpha-entmax threshold solver: the plain PyTorch version of the CUDA
entmax kernel (port of armnet_tpu/kernels/entmax_common.py).

The solve: find tau with  f(tau) = sum_i max(x_i - tau, 0)^(1/(alpha-1)) = 1
(x pre-scaled by alpha-1), then p = max(x - tau, 0)^(1/(alpha-1)),
renormalized. Three solver branches, at the JAX package's production
budgets (its environment-variable knobs are not carried over):

  * alpha in {1.5, 2} (1/(alpha-1) in {1, 2, 3}: pow is 0-2 multiplies):
    plain bisection, capped at 30 iterations (an f32 bracket is exhausted
    after ~27 halvings);
  * other alpha <= 2: N_FAST bisections on a bit-trick pow, then N_POLISH
    safeguarded Newton steps on the exact pow;
  * alpha > 2: N_BISECT exact bisections, then N_NEWTON Newton steps.

The CUDA kernels (the column solve of csrc/entmax_solver.cuh) repeat this
arithmetic operation for operation, and the sums over the normalized axis
are taken in index order (`_sum0`) as a kernel thread takes them, so a
kernel and this version give the same bits from the same inputs wherever
they call the same pow: near the support boundary the solve is so
sensitive (at alpha > 2 its Newton budget leaves rare columns unconverged;
the VJP's y^(2-alpha) has an unbounded slope at 0) that one ulp of a sum
can move y or a gradient far past any useful tolerance. `solver_mode` is
the one place both read the branch from.

The backward (`entmax_bwd_axis0`, the plain version of the CUDA backward
kernel) needs only the output y: g = y^(2-alpha) on the support (y > 0),
dx = dy*g - (sum(dy*g) / sum(g)) * g.
"""

import torch

__all__ = ["pow_inv", "pow_static", "solve_entmax_axis0", "entmax_bwd_axis0",
           "solver_mode", "bisect_steps", "N_BISECT", "N_NEWTON", "N_FAST",
           "N_POLISH"]

N_BISECT = 8
N_NEWTON = 6
N_FAST = 12
N_POLISH = 4
BISECT_CONVERGED = 30    # f32 bracket is mantissa-exhausted after ~27 halvings
_TINY = 1e-30
# Blinn fast-pow: z^c ~= bitcast(c * (bits(z) - K) + K)
_FAST_K = int((127 - 0.0450466) * (1 << 23))
_FAST_K_F32 = float(torch.tensor(_FAST_K, dtype=torch.float32))


def solver_mode(alpha):
    """'bisect' | 'fastpow' | 'newton': the solver branch for a static alpha."""
    inv_am1 = 1.0 / (alpha - 1.0)
    if inv_am1 in (1.0, 2.0, 3.0):
        return "bisect"
    return "fastpow" if alpha <= 2.0 else "newton"


def bisect_steps(n_iter):
    """Bisection steps of the 'bisect' branch: n_iter, capped at the f32
    convergence limit as the JAX solver and kernels cap it."""
    return min(int(n_iter), BISECT_CONVERGED)


def pow_inv(z, inv_am1):
    """clamp(z, 0) ** (1/(alpha-1)) with static-exponent specialization."""
    z = torch.clamp_min(z, 0.0)
    if inv_am1 == 1.0:          # alpha = 2 (sparsemax)
        return z
    if inv_am1 == 2.0:          # alpha = 1.5
        return z * z
    if inv_am1 == 3.0:
        return z * z * z
    return torch.pow(z, inv_am1)


def pow_static(y, e):
    """y ** e for y >= 0 with static-exponent specialization (backward)."""
    if e == 0.0:                # alpha = 2
        return torch.ones_like(y)
    if e == 0.5:                # alpha = 1.5
        return torch.sqrt(y)
    if e == 1.0:
        return y
    return torch.pow(torch.clamp_min(y, 1e-38), e)


def _fast_pow(z, inv_am1):
    """Bit-trick z^inv_am1 (~±4% relative), 0 where z <= 0. The clamp to
    [0, 2.1e9] happens in f32 BEFORE the int cast (which truncates toward
    zero): at small alpha a tiny z gives a value past int32 range."""
    bits = torch.clamp_min(z, 1e-20).view(torch.int32)
    pb_f = inv_am1 * (bits - _FAST_K).to(torch.float32) + _FAST_K_F32
    pb = pb_f.clamp(0.0, 2.1e9).to(torch.int32)
    return torch.where(z > 0, pb.view(torch.float32), 0.0)


def _sum0(x):
    """Sum over axis 0, kept as a leading axis of 1, adding the entries in
    index order."""
    s = x[0:1]
    for k in range(1, x.shape[0]):
        s = s + x[k:k + 1]
    return s


def solve_entmax_axis0(x, alpha, n_iter=50):
    """alpha-entmax over axis 0 of a float32 tensor of any rank."""
    am1 = alpha - 1.0
    inv_am1 = 1.0 / am1
    x = x * am1
    d = x.shape[0]
    mode = solver_mode(alpha)

    def f_val(tau):
        return _sum0(pow_inv(x - tau, inv_am1)) - 1.0

    max_val = x.amax(0, keepdim=True)
    tau_lo = max_val - 1.0                      # f(tau_lo) >= 0 always
    tau_hi = max_val - (1.0 / d) ** am1         # f(tau_hi) <= 0 always

    if mode == "bisect":
        f_lo0 = f_val(tau_lo)
        dm = tau_hi - tau_lo
        t_lo = tau = tau_lo
        for _ in range(bisect_steps(n_iter)):
            dm = dm * 0.5
            tau = t_lo + dm
            t_lo = torch.where(f_val(tau) * f_lo0 >= 0, tau, t_lo)
        p = pow_inv(x - tau, inv_am1)
        return p / _sum0(p)

    if mode == "fastpow":
        # the fast bracket only seeds tau; the polish below re-derives its
        # bracket from exact f signs (the root can sit slightly outside)
        t_lo, t_hi = tau_lo, tau_hi
        for _ in range(N_FAST):
            t_m = 0.5 * (t_lo + t_hi)
            pos = _sum0(_fast_pow(x - t_m, inv_am1)) - 1.0 >= 0
            t_lo = torch.where(pos, t_m, t_lo)
            t_hi = torch.where(pos, t_hi, t_m)
        tau = 0.5 * (t_lo + t_hi)
        n_polish = N_POLISH
    else:
        for _ in range(N_BISECT):
            tau_m = 0.5 * (tau_lo + tau_hi)
            pos = f_val(tau_m) >= 0
            tau_lo = torch.where(pos, tau_m, tau_lo)
            tau_hi = torch.where(pos, tau_hi, tau_m)
        tau = 0.5 * (tau_lo + tau_hi)
        n_polish = N_NEWTON

    for _ in range(n_polish):
        z = torch.clamp_min(x - tau, 0.0)
        p = pow_inv(z, inv_am1)
        s1 = _sum0(p) - 1.0
        # f' = -inv_am1 * sum p/z over the support
        s2 = _sum0(torch.where(z > 0, p / torch.clamp_min(z, _TINY), 0.0))
        pos = s1 >= 0
        tau_lo = torch.where(pos, tau, tau_lo)
        tau_hi = torch.where(pos, tau_hi, tau)
        t_n = tau + s1 / (inv_am1 * torch.clamp_min(s2, _TINY))
        # non-strict bounds: a converged iterate (t_n == tau == a bound)
        # is kept, not kicked to the midpoint
        inside = (t_n >= tau_lo) & (t_n <= tau_hi)
        tau = torch.where(inside, t_n, 0.5 * (tau_lo + tau_hi))
    p = pow_inv(x - tau, inv_am1)
    return p / _sum0(p)


def entmax_bwd_axis0(y, dy, alpha):
    """Vector-Jacobian product of alpha-entmax over axis 0, from its output
    y and the output cotangent dy. A NaN column of y (y > 0 is false for
    NaN) gives a NaN column of dx through 0/0."""
    g = torch.where(y > 0, pow_static(y, 2.0 - alpha), 0.0)
    dx = dy * g
    q = dx.sum(0, keepdim=True) / g.sum(0, keepdim=True)
    return dx - q * g
