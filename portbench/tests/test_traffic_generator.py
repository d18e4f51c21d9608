"""The traffic generator: the same seed gives the same rows, ids stay in
their field's slice with the Zipf law's head, labels carry the planted
signal, and the reference's row order is the program's feed order."""

import numpy as np
import torch

from armnet_tpu_torch.data.libsvm import BatchIterator
from portbench import gen

CFG = {"nfield": 39, "nfeat": 3900}
TRAFFIC = {"rows": 4096, "zipf": 1.05, "value": 1.0, "signal": 2.0}


def test_same_seed_same_rows():
    a = gen.make_rows(CFG, TRAFFIC, 2 ** 31 + 5, "cpu")
    b = gen.make_rows(CFG, TRAFFIC, 2 ** 31 + 5, "cpu")
    c = gen.make_rows(CFG, TRAFFIC, 2 ** 31 + 6, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])


def test_ids_in_their_slices_with_a_zipf_head():
    ids, values, labels = gen.make_rows(CFG, dict(TRAFFIC, rows=50_000), 1,
                                        "cpu")
    per = CFG["nfeat"] // CFG["nfield"]
    field = ids.long() // per
    assert ids.dtype == torch.int32 and ids.shape == (50_000, 39)
    assert torch.equal(field, torch.arange(39).expand(50_000, 39))
    assert torch.all(values == 1.0)
    # rank 1 of a slice is drawn with the Zipf law's head probability
    cdf = gen.zipf_cdf(per, 1.05, "cpu")
    hot = (ids[:, 0].long() % per == 0).float().mean().item()
    assert abs(hot - cdf[0].item()) < 0.01
    # the ranks are spread over the slice by a bijection
    a = gen.slice_bijection(per)
    assert len({(r * a) % per for r in range(per)}) == per


def test_labels_carry_the_planted_signal():
    ids, _, labels = gen.make_rows(CFG, dict(TRAFFIC, rows=20_000), 3, "cpu")
    w = torch.from_numpy(np.random.RandomState(1234).randn(39, 64)
                         .astype(np.float32))
    score = w[torch.arange(39), ids.long() % 64].mean(1)
    pos = score[labels > 0.5]
    neg = score[labels <= 0.5]
    auc = (pos[:, None] > neg[None, :]).float().mean().item()
    assert 0.55 < auc < 0.9
    assert 0.3 < labels.mean().item() < 0.7


def test_epoch_order_is_the_feeds_order():
    n, b = 64, 16

    class Rows:
        ids = np.arange(n, dtype=np.int32)[:, None].repeat(3, 1)
        values = np.ones((n, 3), np.float32)
        labels = np.zeros(n, np.float32)
        nfield = 3

        def __len__(self):
            return n

    it = BatchIterator(Rows(), b, shuffle=True, seed=2 ** 31 - 3)
    for epoch in range(2):
        got = np.concatenate([x["id"][:, 0].numpy() for x in it])
        assert np.array_equal(got, gen.epoch_order(n, 2 ** 31 - 3, epoch))
