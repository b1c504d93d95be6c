"""The size-regression CenterNet (the ``centerSize`` family).

Counterpart of ``scd_resnet_tpu/models/center_net.py`` (reference
models/centerNet.py:138-254): the ResNet backbone with two terminal
heads, heatmap(1) and size(2); the loss focal + smooth-L1 of size /
(DOWNSAMPLE * SIZE_REGR_FACTOR) at the ground-truth peaks; the decode
sigmoid -> 3x3 NMS -> top-K with the sizes gathered; and the validation
battery, box IoU and peak hits. The size targets come from the SCD loc
records as (2 |maj|, 2 minL) in heatmap coordinates, as the JAX package
derives them. Maps are NCHW here.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from scd_resnet_tpu_torch.evaluations.detection import iou
from scd_resnet_tpu_torch.models.resnet import (
    DEFAULT_DIMENSIONS,
    ResNetBackbone,
    TerminalSpec,
)
from scd_resnet_tpu_torch.ops.decode import (
    clamp_sigmoid,
    extract_topk,
    non_maximum_suppression,
    reshape_gather_features,
)
from scd_resnet_tpu_torch.ops.losses import focal_loss, smooth_l1_loss_mask

CLASS_DIMENSION = 1
SIZE_REGR_FACTOR = 10  # centerNet.py:47
DOWNSAMPLE = 4


class CenterNetSizeResidual(ResNetBackbone):
    """ResNet backbone with heatmap + size heads, hidden 128
    (centerNet.py:138-150)."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS):
        super().__init__(num_layers, [
            TerminalSpec("heatmap", CLASS_DIMENSION, 128, final_bias=-2.19),
            TerminalSpec("size", 2, 128, small_init=True),
        ], dims)


def _size_targets(regr_gt_full: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) = (2 |maj|, 2 minL) of the (B, K, 6) regr records."""
    maj_l = torch.sqrt(regr_gt_full[:, :, 2] ** 2 + regr_gt_full[:, :, 3] ** 2)
    return torch.stack([2 * maj_l, 2 * regr_gt_full[:, :, 4]], dim=-1)


class CenterNetSizeLoss:
    """focal + smooth-L1(size / (DOWNSAMPLE * SIZE_REGR_FACTOR)), divided
    by the number of stacks (centerNet.py:152-192). Returns ``(loss,
    [focal, size])``."""

    def __init__(self, regression_weight: float = 1.0):
        self.regression_weight = regression_weight

    def __call__(self, outs, ys):
        heat_gt, tag_mask, regr_gt_full, indices = ys[0], ys[1], ys[2], ys[3]
        size_gt = _size_targets(regr_gt_full) / (DOWNSAMPLE * SIZE_REGR_FACTOR)
        heats = [clamp_sigmoid(out["heatmap"].float()) for out in outs]
        focal = focal_loss(heats, heat_gt)
        size_l = 0.0
        for out in outs:
            size = reshape_gather_features(out["size"].float(), indices)
            size_l = size_l + smooth_l1_loss_mask(size, size_gt, tag_mask)
        size_l = self.regression_weight * size_l
        loss = (focal + size_l) / len(heats)
        return loss, [focal, size_l]


def decode_center_net_size(out_dict: Dict[str, torch.Tensor], k: int = 100,
                           nms_kernel_size: int = 3):
    """sigmoid -> NMS -> top-K -> size gather (centerNet.py:194-222).

    Returns ``[scores, indices, y, x, size(B,K,2), out_dict]``."""
    heat = non_maximum_suppression(torch.sigmoid(out_dict["heatmap"].float()),
                                   nms_kernel_size)
    scores, indices, _categories, ys, xs = extract_topk(heat, k)
    regression = reshape_gather_features(out_dict["size"].float(), indices)
    return [scores, indices, ys, xs, regression, out_dict]


def center_net_size_evaluation(xs, ys, ct_scores, ct_indices, ct_y, ct_x,
                               regression, out_dict):
    """IoU of the size-regressed boxes against the ground truth, and the
    ground-truth heat at each decoded peak (the metrics centerNet.py:224-254
    names). The head learns size / (DOWNSAMPLE * SIZE_REGR_FACTOR) in
    heatmap units, so that factor is undone here. ``ys[3]`` is the (B, K)
    flat indices of a training batch or the (B, K, 8) loc records of a
    validation batch."""
    tag_mask, regr_gt = ys[1], ys[2]
    half = 0.5 * regression * (DOWNSAMPLE * SIZE_REGR_FACTOR)
    bounds = torch.stack([ct_x - half[:, :, 0], ct_y - half[:, :, 1],
                          ct_x + half[:, :, 0], ct_y + half[:, :, 1]], dim=-1)
    heat_size = out_dict["heatmap"].shape[3]
    if ys[3].dim() == 2:
        cx = (ys[3] % heat_size).to(torch.float32)
        cy = torch.div(ys[3], heat_size, rounding_mode="floor").to(
            torch.float32)
    else:
        cx, cy = ys[3][:, :, 0], ys[3][:, :, 1]
    size_gt = _size_targets(regr_gt)
    gt_bounds = torch.stack(
        [cx - 0.5 * size_gt[:, :, 0], cy - 0.5 * size_gt[:, :, 1],
         cx + 0.5 * size_gt[:, :, 0], cy + 0.5 * size_gt[:, :, 1]], dim=-1)
    valid = ct_scores >= 0.5
    flat = ys[0][:, 0].reshape(ys[0].shape[0], -1)
    gt_at_peak = torch.gather(flat, 1, ct_indices)
    return {
        "iou": iou(bounds, gt_bounds, valid),
        "heat": (gt_at_peak, ct_scores, ct_scores >= 0.3),
        "objs": tag_mask.to(torch.float32).sum(dim=1),
    }
