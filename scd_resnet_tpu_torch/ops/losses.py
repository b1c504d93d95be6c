"""Detection losses: penalty-reduced focal and masked L1 / smooth-L1.

Counterpart of ``scd_resnet_tpu/ops/losses.py`` (reference
models/losses/focal.py:25-53, regression.py:28-44), as masked sums with
no boolean indexing. Heatmaps are NCHW here; the sums do not care. The
associative-embedding loss comes with corner training.
"""

from __future__ import annotations

from typing import Sequence

import torch


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
    num_pos = pos.sum()

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
    return (err * mask[:, :, None]).sum() / (mask.sum() + 1e-4)


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
