"""Per-clip standardisation and the loc-record flips of the training
batch transform (counterparts of ``scd_resnet_tpu/ops/augment.py``:
``normalize``, ``flip_locs_horizontal``, ``flip_locs_vertical``)."""

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


def flip_locs_horizontal(locs: torch.Tensor, heat_size: int) -> torch.Tensor:
    """Loc records (..., K, 8) under a horizontal image flip
    (scdx16p100.py:424-429): x mirrored on the heatmap grid, the x
    components of the offset and major-axis vectors negated."""
    out = locs.clone()
    out[..., 0] = heat_size - 1 - locs[..., 0]
    out[..., 2] = -locs[..., 2]
    out[..., 4] = -locs[..., 4]
    return out


def flip_locs_vertical(locs: torch.Tensor, heat_size: int) -> torch.Tensor:
    """Loc records under a vertical image flip (scdx16p100.py:430-436)."""
    out = locs.clone()
    out[..., 1] = heat_size - 1 - locs[..., 1]
    out[..., 3] = -locs[..., 3]
    out[..., 5] = -locs[..., 5]
    return out
