"""Per-clip standardisation (counterpart of
``scd_resnet_tpu/ops/augment.normalize``; the augmentations proper come
with the training slice)."""

from __future__ import annotations

import torch


def normalize(images: torch.Tensor) -> torch.Tensor:
    """Standardise each image of an (..., H, W) stack to zero mean and
    unit population variance, with no epsilon (reference
    argumentations.py:40-44). A constant image maps to zeros instead of
    0/0 = NaN."""
    images = images.to(torch.float32)
    mean = images.mean(dim=(-2, -1), keepdim=True)
    centred = images - mean
    var = centred.square().mean(dim=(-2, -1), keepdim=True)
    safe_var = torch.where(var > 0, var, torch.ones_like(var))
    return torch.where(var > 0, centred / torch.sqrt(safe_var),
                       torch.zeros_like(images))
