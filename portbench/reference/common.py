"""Plain float32 PyTorch pieces of the reference: the value-scaled
embedding gather, alpha-entmax by bisection with its closed-form backward,
masked BatchNorm, the MLP, BCE with logits, the elementwise clamp, Adam
with torch's (and optax's) defaults, and the tie-aware ROC-AUC.

Written from the published descriptions (ARM-Net, SIGMOD'21; entmax,
Peters et al. 2019 and Correia et al. 2019; Adam, Kingma and Ba 2015),
not from the measured program: this package imports nothing of it, nor
JAX. Every product runs in float32 with TF32 off (`no_tf32`).
"""

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["no_tf32", "draw_params", "xavier_bound", "bn_specs", "mlp_specs",
           "embed", "entmax", "batch_norm", "mlp", "mlp_flops", "bce",
           "clamp_", "Adam", "roc_auc", "VALUE_CLAMP"]

# ARM-Net clamps input values into [1e-3, 1] (its armnet_1h.py:81)
VALUE_CLAMP = (1e-3, 1.0)
BN_EPS = 1e-5
BN_KEEP = 0.9          # share of a running statistic kept each step


@contextlib.contextmanager
def no_tf32():
    """Full float32 products (cuBLAS and cuDNN), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def draw_params(specs, seed, device):
    """{name: float32 tensor} from specs [(name, shape, kind, arg)], kind
    'uniform' (U(-arg, arg)), 'const' (every entry arg) or 'buffer' (a
    constant that is not trained). Every uniform leaf is a slice of ONE
    draw of a torch.Generator on `device` seeded with `seed`, in spec
    order, so the weights cost a few large calls wherever they are made."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    total = sum(math.prod(shape) for _, shape, kind, _ in specs
                if kind == "uniform")
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind, arg in specs:
        n = math.prod(shape)
        if kind == "uniform":
            out[name] = flat[at:at + n].view(shape).mul(2 * arg).sub_(arg)
            at += n
        elif kind in ("const", "buffer"):
            out[name] = torch.full(shape, float(arg), device=device)
        else:
            raise ValueError(f"unknown init kind {kind!r} for {name}")
    return out


def xavier_bound(shape, gain=1.0):
    """torch.nn.init.xavier_uniform_'s bound: fan_in = shape[1] and fan_out
    = shape[0], each times the product of the dimensions past the second."""
    rf = math.prod(shape[2:])
    return gain * math.sqrt(6.0 / (shape[1] * rf + shape[0] * rf))


def bn_specs(prefix, n):
    """A BatchNorm's leaves at their published start: weight 1, bias 0,
    running mean 0 and variance 1."""
    return [(prefix + "weight", (n,), "const", 1.0),
            (prefix + "bias", (n,), "const", 0.0),
            (prefix + "running_mean", (n,), "buffer", 0.0),
            (prefix + "running_var", (n,), "buffer", 1.0)]


def mlp_specs(in_features, nlayer, nhid):
    """The MLP's leaves: nn.Linear's default U(+-1/sqrt(fan_in)) for weights
    and biases, and a BatchNorm after each hidden Linear."""
    widths = [in_features] + [nhid] * nlayer + [1]
    out = []
    for i, (a, b) in enumerate(zip(widths, widths[1:])):
        out += [(f"mlp.linears.{i}.weight", (b, a), "uniform", a ** -0.5),
                (f"mlp.linears.{i}.bias", (b,), "uniform", a ** -0.5)]
    for i in range(nlayer):
        out += bn_specs(f"mlp.norms.{i}.", nhid)
    return out


def mlp_flops(in_features, nlayer, nhid):
    """Multiply-adds of the MLP's products per example, times 2."""
    widths = [in_features] + [nhid] * nlayer + [1]
    return 2 * sum(a * b for a, b in zip(widths, widths[1:]))


def embed(table, ids, values):
    """table [R, E], ids [B, F], values [B, F] -> [B, F, E]: the rows at
    the ids times the clamped values. Autograd gives the table its dense
    gradient (a scatter-add over every id of the batch)."""
    v = values.clamp(*VALUE_CLAMP)
    return table[ids.long()] * v[..., None]


def _entmax_forward(x, alpha, dim, n_iter):
    """Bisection on the threshold tau of entmax: p = [(a-1) x - tau]_+ ^
    (1/(a-1)), normalised, with tau bracketed by [max - 1, max -
    d^(1-a)] (Peters et al. 2019, algorithm 1)."""
    am1 = alpha - 1.0
    d = x.shape[dim]
    xs = x * am1
    mx = xs.amax(dim, keepdim=True)
    lo = mx - 1.0
    hi = mx - (1.0 / d) ** am1
    inv = 1.0 / am1

    def mass(tau):
        return torch.clamp_min(xs - tau, 0.0).pow(inv)

    f_lo = mass(lo).sum(dim, keepdim=True) - 1.0
    width = hi - lo
    for _ in range(n_iter):
        width = width * 0.5
        mid = lo + width
        f_mid = mass(mid).sum(dim, keepdim=True) - 1.0
        lo = torch.where(f_mid * f_lo >= 0, mid, lo)
    p = mass(mid)
    return p / p.sum(dim, keepdim=True)


class _Entmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, alpha, dim, n_iter):
        y = _entmax_forward(x, alpha, dim, n_iter)
        ctx.save_for_backward(y)
        ctx.alpha, ctx.dim = alpha, dim
        return y

    @staticmethod
    def backward(ctx, dy):
        # dx = g dy - g (sum g dy / sum g), g = y^(2-a) on the support
        (y,) = ctx.saved_tensors
        g = torch.where(y > 0, y.pow(2.0 - ctx.alpha), 0.0)
        gdy = g * dy
        dx = gdy - g * (gdy.sum(ctx.dim, keepdim=True)
                        / g.sum(ctx.dim, keepdim=True))
        return dx, None, None, None


def entmax(x, alpha, dim, n_iter=50):
    """alpha-entmax (alpha > 1) of float32 x along `dim`."""
    if alpha <= 1.0:
        raise ValueError("the reference's entmax needs alpha > 1")
    return _Entmax.apply(x, float(alpha), dim, int(n_iter))


def batch_norm(x, p, prefix, channel_axis, train, mask=None):
    """BatchNorm over every axis of x but `channel_axis`, weight and bias
    p[prefix + 'weight'/'bias']. Train mode: the batch's mean and biased
    variance over the rows whose mask is 1, and the running statistics
    (p[prefix + 'running_mean'/'running_var'], updated in place) take the
    unbiased variance. Eval mode: the running statistics."""
    ch = channel_axis % x.ndim
    shape = [1] * x.ndim
    shape[ch] = x.shape[ch]
    red = tuple(i for i in range(x.ndim) if i != ch)
    if train:
        w = (torch.ones(x.shape[0], device=x.device) if mask is None
             else mask.float())
        w = w.view([x.shape[0]] + [1] * (x.ndim - 1))
        n = w.sum() * math.prod(x.shape[i] for i in red if i != 0)
        mean = (x * w).sum(red) / n
        var = ((x - mean.view(shape)).square() * w).sum(red) / n
        with torch.no_grad():
            rm, rv = p[prefix + "running_mean"], p[prefix + "running_var"]
            rm.mul_(BN_KEEP).add_((1 - BN_KEEP) * mean)
            rv.mul_(BN_KEEP).add_((1 - BN_KEEP) * var * n / (n - 1))
    else:
        mean, var = p[prefix + "running_mean"], p[prefix + "running_var"]
    scale = torch.rsqrt(var + BN_EPS) * p[prefix + "weight"]
    return ((x - mean.view(shape)) * scale.view(shape)
            + p[prefix + "bias"].view(shape))


def mlp(x, p, nlayer, train, mask=None):
    """nlayer x [Linear -> BatchNorm -> ReLU] -> Linear(1) -> logits [B]
    (dropout 0, as the configurations state). Leaves mlp.linears.<i>.weight
    [out, in], .bias [out], mlp.norms.<i>.*."""
    for i in range(nlayer):
        x = F.linear(x, p[f"mlp.linears.{i}.weight"],
                     p[f"mlp.linears.{i}.bias"])
        x = torch.relu(batch_norm(x, p, f"mlp.norms.{i}.", -1, train, mask))
    x = F.linear(x, p[f"mlp.linears.{nlayer}.weight"],
                 p[f"mlp.linears.{nlayer}.bias"])
    return x.squeeze(-1)


def bce(logits, labels, mask=None):
    """Mean binary cross-entropy with logits over the rows whose mask is 1."""
    losses = F.binary_cross_entropy_with_logits(logits, labels,
                                                reduction="none")
    if mask is None:
        return losses.mean()
    return (losses * mask).sum() / mask.sum().clamp_min(1.0)


def clamp_(grads, clip):
    """Clamp every gradient elementwise into [-clip, clip], in place."""
    for g in grads.values():
        g.clamp_(-clip, clip)


class Adam:
    """Adam with betas (0.9, 0.999), eps 1e-8 outside the square root and
    bias correction (torch.optim.Adam's and optax.adam's defaults)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.betas, self.eps = lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, g in grads.items():
            m, v = self.m[k], self.v[k]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v.sqrt() / math.sqrt(c2)).add_(self.eps)
            params[k].addcdiv_(m, denom, value=-self.lr / c1)


def roc_auc(scores, labels):
    """Tie-aware ROC-AUC (the Mann-Whitney U with average ranks) as a
    Python float; 0.0 where one class is absent."""
    scores = scores.double()
    order = torch.argsort(scores)
    s = scores[order]
    n = s.numel()
    ranks = torch.empty(n, dtype=torch.float64, device=s.device)
    # average rank of each run of equal scores
    new = torch.ones(n, dtype=torch.bool, device=s.device)
    new[1:] = s[1:] != s[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    first = torch.nonzero(new).squeeze(1)
    last = torch.cat([first[1:], torch.tensor([n], device=s.device)]) - 1
    avg = (first + last).double() / 2.0 + 1.0
    ranks[order] = avg[run]
    pos = labels > 0.5
    npos, nneg = int(pos.sum()), int((~pos).sum())
    if npos == 0 or nneg == 0:
        return 0.0
    u = float(ranks[pos].sum()) - npos * (npos + 1) / 2.0
    return u / (npos * nneg)
