"""The one traffic generator: CTR rows from a traffic file's parameters and
a seed, made on the device in a few large calls.

Each of the configuration's F fields owns an equal slice of the id space
(nfeat // F ids, as the program's data/synthetic.py lays fields out); ids
are drawn within the slice from a Zipf law of the traffic's exponent over
the slice's ranks, and a fixed bijection of the slice spreads the hot
ranks over the table, as hashed vocabularies do. Values are the traffic's
`value`. Labels follow the planted signal of data/synthetic.make_arrays
(frozen here): a fixed N(0, 1) weight per (field, id mod 64) from
RandomState(1234), label = Bernoulli(sigmoid(signal * the mean over
fields)), so an AUC meter reads above 0.5.
"""

import math

import numpy as np
import torch

__all__ = ["stream_seed", "zipf_cdf", "slice_bijection", "make_rows",
           "epoch_order"]

_DATA_STREAM, _WEIGHT_STREAM = 1, 2
_SIGNAL_BUCKETS = 64


def stream_seed(seed, stream):
    """A generator seed for one use of the run's seed (data, weights)."""
    return (int(seed) * 1_000_003 + stream) % (2 ** 63)


def zipf_cdf(n, exponent, device):
    """float64 CDF of P(rank r) proportional to r^-exponent, r = 1..n."""
    w = torch.arange(1, n + 1, dtype=torch.float64,
                     device=device).pow(-exponent)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def slice_bijection(n):
    """A multiplier a coprime to n: rank r -> (r * a) mod n is a fixed
    permutation of a slice."""
    a = 40_503
    while math.gcd(a, n) != 1:
        a += 2
    return a % n if n > 1 else 0


def make_rows(cfg, traffic, seed, device, rows=None):
    """(ids [N, F] int32, values [N, F] float32, labels [N] float32) on
    `device`, N = traffic['rows'] unless `rows` is given."""
    nfield, nfeat = cfg["nfield"], cfg["nfeat"]
    n = traffic["rows"] if rows is None else rows
    per = nfeat // nfield
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, _DATA_STREAM))
    cdf = zipf_cdf(per, traffic["zipf"], device)
    u = torch.rand((n, nfield), generator=gen, device=device,
                   dtype=torch.float64)
    rank = torch.searchsorted(cdf, u).clamp_max_(per - 1)
    del u
    base = torch.arange(nfield, device=device, dtype=torch.int64) * per
    ids = (rank * slice_bijection(per)) % per + base
    del rank
    w = torch.from_numpy(np.random.RandomState(1234).randn(
        nfield, _SIGNAL_BUCKETS).astype(np.float32)).to(device)
    logit = traffic["signal"] * w[torch.arange(nfield, device=device),
                                  ids % _SIGNAL_BUCKETS].mean(1)
    coin = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    labels = (coin < torch.sigmoid(logit)).float()
    values = torch.full((n, nfield), float(traffic["value"]), device=device)
    return ids.to(torch.int32), values, labels


def epoch_order(n, iter_seed, epoch):
    """The row order of a shuffled epoch as the program's BatchIterator
    states it: RandomState(seed + epoch).permutation(n)."""
    return np.random.RandomState(iter_seed + epoch).permutation(n)
