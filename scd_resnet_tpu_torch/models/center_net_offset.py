"""CenterNet-with-offset, the production SCD detector.

Counterpart of ``scd_resnet_tpu/models/center_net_offset.py``: three
terminal heads on the upsampled ResNet features — heatmap(1),
regr(4: majX, majY, minL, halo), offset(2) — the focal + masked-L1 loss
(reference centerNetOffset.py:170-217), the sigmoid -> NMS -> top-K
decode (219-251) and the validation metric battery (253-353). The module *is* the
backbone, so its state dict carries the reference's own names
(``preprocess.*``, ``layer{i}.{j}.*``, ``deconvolutionLayers.*``,
``heatmap/regr/offset.{0,2}.*``) and reference-trained ``.pth`` files
load with ``strict=True``.

``CenterNetHourglass`` is the stacked-hourglass center detector
(centerNetOffset.py:78-101) with the same heads on every stack; the
loss averages over the stacks and decode reads the last.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from scd_resnet_tpu_torch.evaluations.detection import (
    iou,
    iou_confidence,
    mae,
    orthogonality,
)

from scd_resnet_tpu_torch.models.hourglass import StackHourglass
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
from scd_resnet_tpu_torch.ops.losses import focal_loss, l1_loss_mask

CLASS_DIMENSION = 1


def as_stack_list(outs):
    """Model output as a list of per-stack head dicts (a ResNet returns
    one dict, a stacked hourglass a list)."""
    return outs if isinstance(outs, (list, tuple)) else [outs]


def _terminals(hidden: int) -> List[TerminalSpec]:
    return [
        TerminalSpec("heatmap", CLASS_DIMENSION, hidden, final_bias=-2.19),
        TerminalSpec("regr", 4, hidden, small_init=True),
        TerminalSpec("offset", 2, hidden, small_init=True),
    ]


class CenterNetResidual(ResNetBackbone):
    """ResNet-backed center detector (centerNetOffset.py:150-168);
    ``terminal_hidden=64`` is the ``h``/``q`` variant, ``dcn=True`` the
    deformable prologue before the first deconv (``centerOffsetRes10dcn``)."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS,
                 terminal_hidden: int = 128, dcn: bool = False):
        super().__init__(num_layers, _terminals(terminal_hidden), dims,
                         deconv_dcn=dcn)


#: The production hourglass geometry (centerNetOffset.py:80-101; the JAX
#: package's ``HOURGLASS_*`` constants)
HOURGLASS_ITERATIONS = 5
HOURGLASS_DIMENSIONS = (128, 128, 192, 192, 192, 256)
HOURGLASS_MODULES = (2, 2, 2, 2, 2, 4)
HOURGLASS_PREDICTION_DIM = 256
HOURGLASS_TERMINALS = (
    ("heatmap", CLASS_DIMENSION, -2.19),
    ("regr", 4, None),
    ("offset", 2, None),
)


class CenterNetHourglass(StackHourglass):
    """Stacked-hourglass center detector (centerNetOffset.py:78-101):
    stride-2 downsampling, heads heatmap(1)/regr(4)/offset(2) on every
    stack. The geometry defaults to the production constants; the tests
    build it smaller."""

    def __init__(self, stacks: int = 1, remat: bool = False,
                 iterations: int = HOURGLASS_ITERATIONS,
                 dimensions: Sequence[int] = HOURGLASS_DIMENSIONS,
                 modules: Sequence[int] = HOURGLASS_MODULES,
                 prediction_dim: int = HOURGLASS_PREDICTION_DIM):
        super().__init__(iterations, stacks, dimensions, modules,
                         prediction_dim, HOURGLASS_TERMINALS,
                         pool_downsample=False, remat=remat)


def decode_center_net(out_dict: Dict[str, torch.Tensor], k: int = 100,
                      nms_kernel_size: int = 3):
    """sigmoid -> NMS -> top-K -> gather on NCHW heads.

    Returns ``[scores, indices, y, x, offset(B,K,2), regr(B,K,4),
    out_dict]``."""
    heat = out_dict["heatmap"].float()
    heat = non_maximum_suppression(torch.sigmoid(heat), nms_kernel_size)
    scores, indices, _categories, ys, xs = extract_topk(heat, k)
    regression = reshape_gather_features(out_dict["regr"], indices)
    offset = reshape_gather_features(out_dict["offset"], indices)
    return [scores, indices, ys, xs, offset, regression, out_dict]


class CenterNetLoss:
    """Focal + weighted masked-L1 regression and offset losses
    (centerNetOffset.py:170-217), averaged over the stacks.

    ``ys`` is the batch transform's ``[heat (B,1,H,W), tag mask (B,K),
    regr (B,K,6) = [offX, offY, majX, majY, minL, halo], indices (B,K)]``.
    Returns ``(loss, [focal, size, offset])``."""

    def __init__(self, regression_weight: float = 1.0,
                 offset_weight: float = 0.5):
        self.regression_weight = regression_weight
        self.offset_weight = offset_weight

    def __call__(self, outs, ys):
        heat_gt, tag_mask, regr_gt_full, indices = ys[0], ys[1], ys[2], ys[3]
        regr_gt = regr_gt_full[:, :, 2:6]
        offset_gt = regr_gt_full[:, :, 0:2]

        heats = [clamp_sigmoid(out["heatmap"].float()) for out in outs]
        focal = focal_loss(heats, heat_gt)
        size_l = offset_l = 0.0
        for out in outs:
            regr = reshape_gather_features(out["regr"].float(), indices)
            off = reshape_gather_features(out["offset"].float(), indices)
            size_l = size_l + l1_loss_mask(regr, regr_gt, tag_mask)
            offset_l = offset_l + l1_loss_mask(off, offset_gt, tag_mask)
        size_l = self.regression_weight * size_l
        offset_l = self.offset_weight * offset_l
        loss = (focal + size_l + offset_l) / len(heats)
        return loss, [focal, size_l, offset_l]


def _summed(vals, mask, nan_filter: bool = False):
    """(sum, count) of the masked values; masked lanes are zeroed before
    the product, since they may hold inf (an IoU over a zero union)."""
    maskf = mask.to(torch.float32)
    if nan_filter:
        maskf = maskf * torch.isfinite(vals)
    vals = torch.where(maskf > 0, vals, torch.zeros_like(vals))
    return (vals * maskf).sum(), maskf.sum()


def center_net_evaluation(xs, ys, ct_scores, ct_indices, ct_y, ct_x, offset,
                          regression, out_dict, score_threshold: float = 0.3):
    """Validation metric battery (centerNetOffset.py:253-353) on one
    decoded batch: predicted and ground-truth boxes in heatmap
    coordinates, then IoU, orthogonality and MAE. Returns a dict of
    ``(values..., mask)`` grids and (sum, count) pairs plus the per-clip
    object counts, for ``train/expression.py``.

    ``ys[3]`` is either the (B, K) flat indices of a training batch or
    the (B, K, 8) loc records of a validation batch (the reference
    branches the same way, centerNetOffset.py:287-292)."""
    tag_mask, regr_gt = ys[1], ys[2]
    obj_num = tag_mask.to(torch.float32).sum(dim=1)
    heat_size = out_dict["heatmap"].shape[3]
    if ys[3].dim() == 2:
        indices_gt = ys[3]
        center_y_gt = torch.div(indices_gt, heat_size,
                                rounding_mode="floor").to(torch.float32)
        center_x_gt = (indices_gt % heat_size).to(torch.float32)
    else:
        center_x_gt, center_y_gt = ys[3][:, :, 0], ys[3][:, :, 1]

    def box(cx, cy, half_x, half_y, dx, dy):
        return torch.stack([cx - half_x + dx, cy - half_y + dy,
                            cx + half_x + dx, cy + half_y + dy], dim=-1)

    maj_l = torch.sqrt(regression[:, :, 0] ** 2 + regression[:, :, 1] ** 2)
    off_x, off_y = offset[:, :, 0] / 4, offset[:, :, 1] / 4
    bounds = box(ct_x, ct_y, maj_l, regression[:, :, 2], off_x, off_y)
    bounds_center = torch.stack([ct_x - 2, ct_y - 2, ct_x + 2, ct_y + 2],
                                dim=-1)
    bounds_offset = box(ct_x, ct_y, 2, 2, off_x, off_y)

    maj_l_gt = torch.sqrt(regr_gt[:, :, 2] ** 2 + regr_gt[:, :, 3] ** 2)
    gt_x, gt_y = regr_gt[:, :, 0] / 4, regr_gt[:, :, 1] / 4
    gt_locs = box(center_x_gt, center_y_gt, maj_l_gt, regr_gt[:, :, 4],
                  gt_x, gt_y)
    gt_locs_center = torch.stack([center_x_gt - 2, center_y_gt - 2,
                                  center_x_gt + 2, center_y_gt + 2], dim=-1)
    gt_locs_offset = box(center_x_gt, center_y_gt, 2, 2, gt_x, gt_y)

    maj_pred = torch.stack([regression[:, :, 0], regression[:, :, 1], maj_l],
                           dim=-1)
    regr_pred = torch.stack([maj_l, regression[:, :, 2], regression[:, :, 3]],
                            dim=-1)
    maj_gt = torch.stack([regr_gt[:, :, 2], regr_gt[:, :, 3], maj_l_gt],
                         dim=-1)
    regr_gt3 = torch.stack([maj_l_gt, regr_gt[:, :, 4], regr_gt[:, :, 5]],
                           dim=-1)

    valid = ct_scores >= score_threshold
    ortho_vals, ortho_mask = orthogonality(bounds, gt_locs, maj_pred, maj_gt,
                                           valid)
    ae_maj, ae_min, ae_rad, mae_mask = mae(bounds, gt_locs, regr_pred,
                                           regr_gt3, valid)
    return {
        "iouscore": iou_confidence(bounds, gt_locs, ct_scores, valid),
        "ortho": _summed(ortho_vals, ortho_mask, nan_filter=True),
        "ioucenter": _summed(*iou(bounds_center, gt_locs_center, valid)),
        "iouoffsetwo": _summed(*iou(bounds_center, gt_locs_offset, valid)),
        "iouoffset": _summed(*iou(bounds_offset, gt_locs_offset, valid)),
        "maes": (_summed(ae_maj, mae_mask), _summed(ae_min, mae_mask),
                 _summed(ae_rad, mae_mask)),
        "objs": obj_num,
    }
