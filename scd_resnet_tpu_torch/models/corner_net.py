"""CornerNet-style detectors on the ResNet backbone, their loss, decode
and evaluation.

Counterpart of ``scd_resnet_tpu/models/corner_net.py`` (reference
cornerNet.py, cornerNetCPool.py, cornerNetCombined.py), NCHW:

- ``CornerNetResidual``: heads heatmap(1), tl(1), br(1), plain terminals;
- ``CornerNetCPoolResidual``: a plain center heatmap head beside tl/br
  heads whose prologue is the corner-pool fusion block. Top and left
  pools feed ``tl_head``, bottom and right ``br_head``: four launches of
  the corner-pool kernel per forward on the card, and four of its
  backward kernel per backward;
- ``CornerNetCombined``: one heatmap(3) terminal whose channels are
  center/tl/br (``_split_combined``).

Every head's final 1x1 conv computes in float32 under autocast
(``models/resnet.TerminalHead``), as the JAX heads' final ``nn.Conv``
with no ``dtype`` promotes to its float32 parameters. Batches carry
``ys = [heat, tag mask, regr, indices, tl, br]``
(``data/pipeline.augment_and_render_batch(..., corner_targets=True)``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scd_resnet_tpu_torch.evaluations.detection import iou_confidence
from scd_resnet_tpu_torch.models.layers import ConvBlock, batch_norm, conv1x1, conv3x3
from scd_resnet_tpu_torch.models.resnet import (
    DEFAULT_DIMENSIONS,
    ResNetBackbone,
    TerminalHead,
    TerminalSpec,
)
from scd_resnet_tpu_torch.ops.corner_pool import (
    bottom_pool,
    left_pool,
    right_pool,
    top_pool,
)
from scd_resnet_tpu_torch.ops.decode import (
    clamp_sigmoid,
    extract_topk,
    non_maximum_suppression,
)
from scd_resnet_tpu_torch.ops.losses import focal_loss

CLASS_DIMENSION = 1
POOL_WIDTH = 128
HEAD_HIDDEN = 128


def _heat_spec(name: str, out_features: int = CLASS_DIMENSION
               ) -> TerminalSpec:
    """Conv3x3(128, bias) + ReLU + Conv1x1(out, bias), heat prior -2.19."""
    return TerminalSpec(name, out_features, HEAD_HIDDEN, final_bias=-2.19)


class CornerNetResidual(ResNetBackbone):
    """Plain-terminal corner detector (cornerNet.py:200-230)."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS):
        super().__init__(num_layers, [_heat_spec(name) for name in
                                      ("heatmap", "tl", "br")], dims)


class CornerNetCombined(ResNetBackbone):
    """One heatmap(3) terminal, channels center/tl/br
    (cornerNetCombined.py:213-230)."""

    combined = True  # loss and decode split the channels

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS):
        super().__init__(num_layers, [_heat_spec("heatmap", 3)], dims)


class CornerPoolBlock(nn.Module):
    """Corner-pool fusion block (cornerNetCPool.py:53-122): two 128-wide
    conv branches with directional pools, merged 3x3 conv + BN, plus a
    1x1 conv + BN shortcut, ReLU, and a final 3x3 conv block."""

    def __init__(self, features: int,
                 pools: Tuple[Callable[[torch.Tensor], torch.Tensor], ...]):
        super().__init__()
        self.pools = pools
        self.branch1 = ConvBlock(features, POOL_WIDTH)
        self.branch2 = ConvBlock(features, POOL_WIDTH)
        self.merge_conv = conv3x3(POOL_WIDTH, features)
        self.merge_bn = batch_norm(features)
        self.skip_conv = conv1x1(features, features)
        self.skip_bn = batch_norm(features)
        self.out = ConvBlock(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.pools[0](self.branch1(x))
        p2 = self.pools[1](self.branch2(x))
        merged = self.merge_bn(self.merge_conv(p1 + p2))
        shortcut = self.skip_bn(self.skip_conv(x))
        return self.out(torch.relu(merged + shortcut))


class CornerHead(nn.Module):
    """CornerPool prologue + Conv3x3(128)+ReLU+Conv1x1 terminal
    (cornerNetCPool.py:163-199)."""

    def __init__(self, features: int,
                 pools: Tuple[Callable[[torch.Tensor], torch.Tensor], ...]):
        super().__init__()
        self.pool_block = CornerPoolBlock(features, pools)
        self.terminal = TerminalHead(features, _heat_spec("terminal"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.terminal(self.pool_block(x))


class CornerNetCPoolResidual(nn.Module):
    """Corner detector with real corner pooling on the tl/br heads
    (cornerNetCPool.py:220-236)."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS):
        super().__init__()
        self.backbone = ResNetBackbone(num_layers, (), dims)
        features = self.backbone.out_features
        self.heatmap = TerminalHead(features, _heat_spec("heatmap"))
        self.tl_head = CornerHead(features, (top_pool, left_pool))
        self.br_head = CornerHead(features, (bottom_pool, right_pool))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        features = self.backbone(x)
        return {"heatmap": self.heatmap(features),
                "tl": self.tl_head(features),
                "br": self.br_head(features)}


def _split_combined(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    heat = out["heatmap"]
    return {"heatmap": heat[:, 0:1], "tl": heat[:, 1:2], "br": heat[:, 2:3]}


class CornerNetLoss:
    """3x penalty-reduced focal over the center/tl/br heatmaps
    (cornerNet.py:234-270; the combined model's channels sliced,
    cornerNetCombined.py:242-270). Returns ``(loss, [focal])``."""

    def __init__(self, combined: bool = False):
        self.combined = combined

    def __call__(self, outs, ys):
        heat_gt, tl_gt, br_gt = ys[0], ys[4], ys[5]
        heats, tls, brs = [], [], []
        for out in outs:
            if self.combined:
                out = _split_combined(out)
            heats.append(clamp_sigmoid(out["heatmap"].float()))
            tls.append(clamp_sigmoid(out["tl"].float()))
            brs.append(clamp_sigmoid(out["br"].float()))
        focal = (focal_loss(heats, heat_gt) + focal_loss(tls, tl_gt)
                 + focal_loss(brs, br_gt))
        return focal / len(heats), [focal]


def decode_corner_net(out_dict: Dict[str, torch.Tensor], k: int = 100,
                      nms_kernel_size: int = 3, combined: bool = False):
    """3x sigmoid -> NMS -> top-K (cornerNet.py:272-304; plain sigmoid,
    not clamped). Returns ``[ctS, ctI, ctY, ctX, tlS, tlI, tlY, tlX,
    brS, brI, brY, brX, out_dict]``, the combined model's out_dict split
    into its three heads."""
    if combined:
        out_dict = _split_combined(out_dict)
    rows = []
    for head in ("heatmap", "tl", "br"):
        heat = non_maximum_suppression(torch.sigmoid(out_dict[head].float()),
                                       nms_kernel_size)
        scores, inds, _cats, ys, xs = extract_topk(heat, k)
        rows += [scores, inds, ys, xs]
    return rows + [out_dict]


def pair_corner_boxes(ct_heat, tl_s, tl_y, tl_x, br_s, br_y, br_x,
                      detection_count: int = 1000,
                      center_threshold: float = 0.05,
                      center_window: int = 5, center_gate: str = "point"):
    """Geometric tl/br peak pairing into boxes, gated by the center head
    (``scd_resnet_tpu/models/corner_net.pair_corner_boxes``): every (tl,
    br) pair scores (tlS + brS) / 2 and is rejected (score -1) when br is
    not below-right of tl or when the center heat (sigmoid) at the pair's
    floored midpoint is below ``center_threshold``. ``center_gate``:
    ``point`` samples the heat there; ``window`` takes the max over a
    ``center_window``^2 neighbourhood; ``peak`` suppresses non-maxima
    first, then takes the window max.

    ``ct_heat`` is the (B, C, H, W) center logits (channel 0 is read).
    The pairs are ranked by a stable descending sort, so equal scores
    keep the lower pair index first, as ``lax.top_k`` does. Returns
    ``(boxes (B, D, 4) [tlX, tlY, brX, brY], scores (B, D))``."""
    b, k = tl_s.shape
    hs_y, hs_x = ct_heat.shape[2], ct_heat.shape[3]
    tlx, tly = tl_x[:, :, None], tl_y[:, :, None]
    brx, bry = br_x[:, None, :], br_y[:, None, :]

    ct = torch.sigmoid(ct_heat[:, :1].float())
    if center_gate == "peak":
        ct = non_maximum_suppression(ct)
    if center_gate != "point" and center_window > 1:
        pad = (center_window - 1) // 2
        ct = F.max_pool2d(ct, center_window, stride=1, padding=pad)
    heat = ct[:, 0].reshape(b, -1)
    mid_x = torch.clamp(torch.floor((tlx + brx) / 2.0), 0, hs_x - 1)
    mid_y = torch.clamp(torch.floor((tly + bry) / 2.0), 0, hs_y - 1)
    mid_i = (mid_y * hs_x + mid_x).long().reshape(b, -1)
    mid_score = heat.gather(1, mid_i).reshape(b, k, k)

    scores = (tl_s[:, :, None] + br_s[:, None, :]) / 2.0
    reject = (brx < tlx) | (bry < tly) | (mid_score < center_threshold)
    scores = torch.where(reject, torch.full_like(scores, -1.0), scores)

    count = min(detection_count, k * k)
    top_scores, top_inds = torch.sort(scores.reshape(b, -1), dim=1,
                                      descending=True, stable=True)
    top_scores, top_inds = top_scores[:, :count], top_inds[:, :count]
    boxes = torch.stack([tlx.expand(b, k, k), tly.expand(b, k, k),
                         brx.expand(b, k, k), bry.expand(b, k, k)],
                        dim=3).reshape(b, -1, 4)
    boxes = boxes.gather(1, top_inds[:, :, None].expand(b, count, 4))
    return boxes, top_scores


def corner_net_evaluation(xs, ys, ct_s, ct_i, ct_y, ct_x, tl_s, tl_i, tl_y,
                          tl_x, br_s, br_i, br_y, br_x, out_dict):
    """Peak AP battery + box AP (``scd_resnet_tpu/models/corner_net.
    corner_net_evaluation``): a decoded peak is a true positive when the
    ground-truth Gaussian at its pixel is at least the AP threshold;
    center-gated tl/br pairs are scored against the ground-truth boxes,
    center -/+ (|maj|, minL). The pairing gate is
    ``SCD_CORNER_CENTER_GATE`` (point, window or peak; default point)
    with ``SCD_CORNER_CENTER_WINDOW`` (default 5), as in the JAX package.
    Returns per-head (gt value, score, mask) triples, the box
    (iou, score, mask) grid and the per-clip object counts."""

    def gt_at(gt_heat, inds):
        flat = gt_heat[:, 0].reshape(gt_heat.shape[0], -1)
        return flat.gather(1, inds)

    tag_mask, regr, inds = ys[1], ys[2], ys[3]
    obj_num = tag_mask.to(torch.float32).sum(dim=1)
    hs = ys[0].shape[3]
    cx = (inds % hs).to(torch.float32)
    cy = torch.div(inds, hs, rounding_mode="floor").to(torch.float32)
    maj_l = torch.sqrt(regr[:, :, 2] ** 2 + regr[:, :, 3] ** 2)
    min_l = regr[:, :, 4]
    gt_boxes = torch.stack([cx - maj_l, cy - min_l, cx + maj_l, cy + min_l],
                           dim=-1)
    gt_boxes = torch.where(tag_mask[:, :, None], gt_boxes,
                           torch.zeros_like(gt_boxes))

    boxes, box_scores = pair_corner_boxes(
        out_dict["heatmap"], tl_s, tl_y, tl_x, br_s, br_y, br_x,
        center_window=int(os.environ.get("SCD_CORNER_CENTER_WINDOW", "5")),
        center_gate=os.environ.get("SCD_CORNER_CENTER_GATE", "point"))
    return {
        "heat": (gt_at(ys[0], ct_i), ct_s, ct_s >= 0.3),
        "tl": (gt_at(ys[4], tl_i), tl_s, tl_s >= 0.3),
        "br": (gt_at(ys[5], br_i), br_s, br_s >= 0.3),
        "box": iou_confidence(boxes, gt_boxes, box_scores, box_scores >= 0.3),
        "objs": obj_num,
    }
