"""Heatmap decode: clamped sigmoid, 3x3 peak NMS, top-K, feature gather.

Counterpart of ``scd_resnet_tpu/ops/decode.py`` (reference
models/backbones/utility.py:76-122). Maps are NCHW here, so the flat
top-K index is ``c*H*W + y*W + x`` straight from a reshape — the order
the JAX package gets by transposing its NHWC maps first.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clamp_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """Sigmoid clamped to [eps, 1-eps] (utility.py:120-122)."""
    return torch.clamp(torch.sigmoid(x), eps, 1.0 - eps)


def non_maximum_suppression(heat: torch.Tensor, kernel_size: int = 3
                            ) -> torch.Tensor:
    """Keep only the local maxima of an NCHW heatmap; every other
    position becomes 0. The window pads with -inf, as the JAX
    ``reduce_window`` does."""
    if kernel_size == 1:
        return heat
    pad = (kernel_size - 1) // 2
    hmax = F.max_pool2d(heat, kernel_size, stride=1, padding=pad)
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def extract_topk(scores: torch.Tensor, k: int = 20):
    """Top-K peaks of an NCHW score map across all categories.

    Returns ``(values, index, category, y, x)``, each (B, K); ``index``
    is the within-category flat index ``y*W + x``."""
    b, c, h, w = scores.shape
    top_scores, top_indices = torch.topk(scores.reshape(b, c * h * w), k)
    top_categories = torch.div(top_indices, h * w, rounding_mode="floor")
    top_indices = top_indices % (h * w)
    top_y = torch.div(top_indices, w, rounding_mode="floor").float()
    top_x = (top_indices % w).float()
    return top_scores, top_indices, top_categories, top_y, top_x


def reshape_gather_features(feat: torch.Tensor, ind: torch.Tensor
                            ) -> torch.Tensor:
    """Gather an NCHW feature map at (B, K) flat indices ``y*W + x``;
    returns (B, K, C)."""
    b, c, h, w = feat.shape
    flat = feat.reshape(b, c, h * w)
    index = ind[:, None, :].expand(b, c, ind.shape[1])
    return flat.gather(2, index).permute(0, 2, 1)
