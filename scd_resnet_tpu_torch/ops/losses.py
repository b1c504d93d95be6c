"""Detection losses: penalty-reduced focal and masked L1 / smooth-L1.

Counterpart of ``scd_resnet_tpu/ops/losses.py`` (reference
models/losses/focal.py:25-53, regression.py:28-44), as masked sums with
no boolean indexing, and the associative-embedding pull/push loss
(embeddings.py:32-77). Heatmaps are NCHW here; the sums do not care.

Under :func:`global_counts` (a ``data`` mesh axis) the focal loss's
positive count and the regression's object count are those of the
global batch, summed over the group without a gradient, as in the JAX
step over a data-sharded batch: each rank's loss is its local sums over
the global counts, so the ranks' losses and gradients sum to the global
batch's. The embedding loss normalises per sample, so its local sum is
already that share.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Sequence

import torch

from scd_resnet_tpu_torch.parallel.collectives import reduce_sum_

_COUNTS = threading.local()


@contextlib.contextmanager
def global_counts(group) -> Iterator[None]:
    """While active on this thread, the losses' counts are summed over
    ``group`` (no-op for None)."""
    before = getattr(_COUNTS, "group", None)
    _COUNTS.group = group
    try:
        yield
    finally:
        _COUNTS.group = before


def _count(total: torch.Tensor) -> torch.Tensor:
    group = getattr(_COUNTS, "group", None)
    if group is None:
        return total
    return reduce_sum_(total.detach().clone(), group)


def focal_loss(predictions: Sequence[torch.Tensor], ground_truth: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """CornerNet-style focal loss over Gaussian heatmaps.

    ``predictions`` are probability maps (one per stack), already
    clamped; positives are the pixels where ``ground_truth`` is exactly
    1.0. The positive count normalises the sum; with no positive at all
    the negative term alone is returned (focal.py:25-53)."""
    gt = ground_truth.to(torch.float32)
    pos = (gt == 1.0).to(torch.float32)
    neg = (gt < 1.0).to(torch.float32)
    neg_weights = torch.pow(1.0 - gt, beta)
    num_pos = _count(pos.sum())

    loss = torch.zeros((), dtype=torch.float32, device=gt.device)
    for pred in predictions:
        pred = pred.to(torch.float32)
        pos_loss = (torch.log(pred) * torch.pow(1.0 - pred, alpha) * pos).sum()
        neg_loss = (torch.log(1.0 - pred) * torch.pow(pred, alpha)
                    * neg_weights * neg).sum()
        loss = loss - torch.where(
            num_pos > 0, (pos_loss + neg_loss) / torch.clamp(num_pos, min=1.0),
            neg_loss)
    return loss


def _masked_regression(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    mask = mask.to(torch.float32)
    return (err * mask[:, :, None]).sum() / (_count(mask.sum()) + 1e-4)


def l1_loss_mask(regression: torch.Tensor, ground_truth: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 over gathered (B, K, D) features, divided by the object
    count + 1e-4, not the element count (regression.py:37-44)."""
    return _masked_regression((regression - ground_truth).abs(), mask)


def smooth_l1_loss_mask(regression: torch.Tensor, ground_truth: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Masked smooth-L1 (Huber, beta 1), regression.py:28-35."""
    d = (regression - ground_truth).abs()
    err = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    return _masked_regression(err, mask)


def embedding_loss(tag_tl: torch.Tensor, tag_br: torch.Tensor,
                   mask: torch.Tensor):
    """Associative-embedding pull/push loss for corner pairing
    (embeddings.py:32-77) on (B, K) or (B, K, 1) tags gathered at the
    ground-truth corners and the (B, K) tag mask: the pull draws each
    pair's tags to their mean, the push drives the means of different
    objects at least 1 apart over the (B, K, K) pair grid. Returns
    ``(pull, push)``."""
    tag_tl = tag_tl.to(torch.float32).reshape(mask.shape)
    tag_br = tag_br.to(torch.float32).reshape(mask.shape)
    maskf = mask.to(torch.float32)

    num_objs = maskf.sum(dim=1, keepdim=True)  # (B, 1)
    tag_mean = (tag_tl + tag_br) / 2.0
    pull_tl = ((tag_tl - tag_mean) * (tag_tl - tag_mean)
               / (num_objs + 1e-4) * maskf).sum()
    pull_br = ((tag_br - tag_mean) * (tag_br - tag_mean)
               / (num_objs + 1e-4) * maskf).sum()

    pair_mask = maskf[:, None, :] * maskf[:, :, None]  # (B, K, K)
    n = num_objs[:, :, None]  # (B, 1, 1)
    n_sq = (n - 1.0) * n
    dist = tag_mean[:, None, :] - tag_mean[:, :, None]
    dist = torch.clamp(1.0 - dist.abs(), min=0.0)
    dist = dist - 1.0 / (n + 1e-4)
    dist = dist / (n_sq + 1e-4)
    return pull_tl + pull_br, (dist * pair_mask).sum()
