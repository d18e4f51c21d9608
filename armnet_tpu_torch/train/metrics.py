"""On-device losses and metrics (port of armnet_tpu/train/metrics.py).

ROC-AUC uses the tie-aware rank (Mann-Whitney) formulation, which matches
sklearn.roc_auc_score's average-rank tie handling, and is 0.0 when the
valid rows hold a single class, like the reference's exception path.

The losses are means over the rows with mask > 0. They zero the pad rows
with `where` before the sum, not with `* mask`: a pad row's logit may be
non-finite, and inf * 0 = NaN would poison the batch loss. `count` replaces
the divisor (the local mask count): a data-parallel step passes the global
count, so each process's loss is its share of the global mean.
"""

import torch
import torch.nn.functional as F

__all__ = ["masked_roc_auc", "masked_accuracy", "masked_bce",
           "masked_softmax_ce"]


def _masked_mean(losses, mask, count=None):
    losses = torch.where(mask > 0, losses, 0.0)
    count = mask.sum() if count is None else count
    return losses.sum() / torch.clamp_min(count, 1.0)


def masked_bce(logits, labels, mask, count=None):
    """Mean sigmoid binary cross-entropy over valid rows
    (BCEWithLogitsLoss parity)."""
    return _masked_mean(F.binary_cross_entropy_with_logits(
        logits.float(), labels.float(), reduction="none"), mask, count)


def masked_softmax_ce(logits, labels, mask, count=None):
    """Mean softmax cross-entropy over valid rows; logits [B, C], labels [B]
    class indices carried as floats in the batch schema."""
    return _masked_mean(F.cross_entropy(
        logits.float(), labels.long(), reduction="none"), mask, count)


def masked_roc_auc(logits, labels, mask=None):
    """Tie-aware ROC-AUC over entries with mask > 0, as a 0-d tensor."""
    logits = logits.float()
    if mask is None:
        mask = torch.ones_like(logits)
    valid = mask > 0
    npad = (~valid).sum()
    # pads rank below every valid entry; the rank sum is corrected below
    x = torch.where(valid, logits, -torch.inf)
    sorted_x = torch.sort(x).values
    left = torch.searchsorted(sorted_x, x, side="left")
    right = torch.searchsorted(sorted_x, x, side="right")
    avg_rank = (left + right + 1).float() / 2.0              # 1-based
    pos = valid & (labels > 0.5)
    neg = valid & (labels <= 0.5)
    npos = pos.sum().float()
    nneg = neg.sum().float()
    rank_sum = torch.where(pos, avg_rank, 0.0).sum()
    u = rank_sum - npad.float() * npos - npos * (npos + 1.0) / 2.0
    auc = u / torch.clamp_min(npos * nneg, 1.0)
    return torch.where((npos > 0) & (nneg > 0), auc, 0.0)


def masked_accuracy(logits, labels, mask):
    """Top-1 accuracy over rows with mask > 0, as a fraction in [0, 1]."""
    hit = (logits.argmax(-1) == labels.long()).float()
    return (hit * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
