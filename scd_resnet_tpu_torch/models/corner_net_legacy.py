"""The original CornerNet: a stacked hourglass with per-stack tl/br
heat, embedding-tag and offset heads behind corner pools, its loss, the
associative-embedding pairing decode and its evaluation.

Counterpart of ``scd_resnet_tpu/models/corner_net_legacy.py`` (reference
models/cornerNetLegacy.py: the network 54-130, the loss 558-627, the
paired decode 332-446), NCHW. Each stack's prediction features feed a
top-left and a bottom-right :class:`CornerBranch`: the port's
``CornerPoolBlock`` (top + left or bottom + right pools, the corner-pool
kernels on the card) and three heads, ConvBlock(3x3, 256, biased, no BN)
+ Conv1x1, whose final conv computes in float32 under autocast, as the
JAX heads' final ``nn.Conv`` with no ``dtype`` promotes to its float32
parameters. Two stacks launch the pool kernel 8 times a forward.

``remat=True`` recomputes each stack's hourglass and each branch in the
backward (``models/layers.checkpointed``), as the JAX model's ``nn.remat``
does: 8 more pool launches a train step. The state-dict keys are the
same either way: ``preprocess``, ``hourglassStack.{s}``,
``redimConvolution.{s}``, ``tl.{s}`` / ``br.{s}`` (``pool_block``,
``heat``, ``tag``, ``regr``), and between stacks ``shortcutLayers``,
``convPrevHourglass`` and ``interHourglassLayers``, as in
``models/hourglass.StackHourglass``.

Batches carry ``ys = [tlHeat, brHeat, mask, tlRegr (B, K, 2), brRegr,
tlInds (B, K), brInds]`` (``data/pipeline.augment_and_render_batch(...,
corner_targets="legacy")``); the decode returns (B, 1000, 8) rows
``[tlX, tlY, brX, brY, score, tlScore, brScore, category]``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
from torch import nn

from scd_resnet_tpu_torch.evaluations.detection import iou
from scd_resnet_tpu_torch.models.corner_net import CornerPoolBlock
from scd_resnet_tpu_torch.models.hourglass import StackHourglass
from scd_resnet_tpu_torch.models.layers import checkpointed
from scd_resnet_tpu_torch.models.resnet import TerminalHead, TerminalSpec
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
    reshape_gather_features,
)
from scd_resnet_tpu_torch.ops.losses import (
    embedding_loss,
    focal_loss,
    smooth_l1_loss_mask,
)

HEAD_HIDDEN = 256
BRANCH_HEADS = ("heat", "tag", "regr")


class CornerBranch(nn.Module):
    """Corner-pool block, then the heat (prior -2.19), tag and regr heads
    (cornerNetLegacy.py:131-199)."""

    def __init__(self, features: int,
                 pools: Tuple[Callable[[torch.Tensor], torch.Tensor], ...],
                 categories: int = 1):
        super().__init__()
        self.pool_block = CornerPoolBlock(features, pools)
        for name, out, bias in (("heat", categories, -2.19), ("tag", 1, None),
                                ("regr", 2, None)):
            setattr(self, name, TerminalHead(
                features, TerminalSpec(name, out, HEAD_HIDDEN,
                                       final_bias=bias), block=True))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feat = self.pool_block(x)
        return tuple(getattr(self, name)(feat) for name in BRANCH_HEADS)


class CornerNetLegacy(StackHourglass):
    """Stacked-hourglass CornerNet (cornerNetLegacy.py:540-556), at the
    JAX package's scaled-down widths by default."""

    def __init__(self, categories: int = 1, stacks: int = 2,
                 iterations: int = 5,
                 dimensions: Sequence[int] = (128, 128, 192, 192, 192, 256),
                 modules: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 prediction_dim: int = 256, remat: bool = False):
        super().__init__(iterations, stacks, dimensions, modules,
                         prediction_dim, terminals=(), pool_downsample=False,
                         remat=remat)
        self.tl = nn.ModuleList(
            CornerBranch(prediction_dim, (top_pool, left_pool), categories)
            for _ in range(stacks))
        self.br = nn.ModuleList(
            CornerBranch(prediction_dim, (bottom_pool, right_pool),
                         categories)
            for _ in range(stacks))

    def heads(self, stack: int, cnv: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = {}
        for corner in ("tl", "br"):
            branch = getattr(self, corner)[stack]
            for name, value in zip(BRANCH_HEADS, checkpointed(
                    branch, cnv, enabled=self.remat)):
                out["{}_{}".format(corner, name)] = value
        return out


class CornerNetLegacyLoss:
    """focal(tl) + focal(br) + pull + push + smooth-L1 offsets, over the
    stacks (cornerNetLegacy.py:558-627); the tags and offsets are gathered
    at the ground-truth corner indices first. Returns ``(loss, [focal,
    pull, push, regr])``."""

    def __init__(self, pull_weight: float = 1.0, push_weight: float = 1.0,
                 regression_weight: float = 1.0):
        self.pull_weight = pull_weight
        self.push_weight = push_weight
        self.regression_weight = regression_weight

    def __call__(self, outs, ys):
        tl_heat_gt, br_heat_gt, mask = ys[0], ys[1], ys[2]
        tl_regr_gt, br_regr_gt = ys[3], ys[4]
        tl_inds, br_inds = ys[5], ys[6]

        focal = focal_loss([clamp_sigmoid(o["tl_heat"].float())
                            for o in outs], tl_heat_gt)
        focal = focal + focal_loss([clamp_sigmoid(o["br_heat"].float())
                                    for o in outs], br_heat_gt)
        pull_l = push_l = regr_l = 0.0
        for out in outs:
            tl_tag = reshape_gather_features(out["tl_tag"].float(), tl_inds)
            br_tag = reshape_gather_features(out["br_tag"].float(), br_inds)
            pull, push = embedding_loss(tl_tag, br_tag, mask)
            pull_l = pull_l + pull
            push_l = push_l + push
            tl_regr = reshape_gather_features(out["tl_regr"].float(),
                                              tl_inds)
            br_regr = reshape_gather_features(out["br_regr"].float(),
                                              br_inds)
            regr_l = regr_l + smooth_l1_loss_mask(tl_regr, tl_regr_gt, mask)
            regr_l = regr_l + smooth_l1_loss_mask(br_regr, br_regr_gt, mask)
        pull_l = pull_l * self.pull_weight
        push_l = push_l * self.push_weight
        regr_l = regr_l * self.regression_weight
        loss = (focal + pull_l + push_l + regr_l) / len(outs)
        return loss, [focal, pull_l, push_l, regr_l]


def decode_corner_net_legacy(out_dict: Dict[str, torch.Tensor], k: int = 100,
                             nms_kernel_size: int = 1,
                             avg_embedding_threshold: float = 1.0,
                             detection_count: int = 1000) -> torch.Tensor:
    """Associative-embedding pairing decode (cornerNetLegacy.py:332-446):
    every (tl, br) pair of the top-``k`` corners scores (tlS + brS) / 2
    and is rejected (score -1) when the categories differ, the tags are
    more than ``avg_embedding_threshold`` apart, or br is not below-right
    of tl (offsets added). The pairs are ranked by a stable descending
    sort, so equal scores, the rejected -1s among them, keep the lower
    pair index first, as ``lax.top_k`` does. Returns (B, D, 8) rows
    ``[tlX, tlY, brX, brY, score, tlScore, brScore, category]``."""
    tl_heat = non_maximum_suppression(
        torch.sigmoid(out_dict["tl_heat"].float()), nms_kernel_size)
    br_heat = non_maximum_suppression(
        torch.sigmoid(out_dict["br_heat"].float()), nms_kernel_size)
    tl_s, tl_i, tl_c, tl_y, tl_x = extract_topk(tl_heat, k)
    br_s, br_i, br_c, br_y, br_x = extract_topk(br_heat, k)
    b = tl_s.shape[0]

    tl_regr = reshape_gather_features(out_dict["tl_regr"].float(), tl_i)
    br_regr = reshape_gather_features(out_dict["br_regr"].float(), br_i)
    tl_xk = tl_x[:, :, None] + tl_regr[:, :, None, 0]
    tl_yk = tl_y[:, :, None] + tl_regr[:, :, None, 1]
    br_xk = br_x[:, None, :] + br_regr[:, None, :, 0]
    br_yk = br_y[:, None, :] + br_regr[:, None, :, 1]
    boxes = torch.stack([tl_xk.expand(b, k, k), tl_yk.expand(b, k, k),
                         br_xk.expand(b, k, k), br_yk.expand(b, k, k)], dim=3)

    tl_tag = reshape_gather_features(out_dict["tl_tag"].float(),
                                     tl_i)[:, :, None, 0]
    br_tag = reshape_gather_features(out_dict["br_tag"].float(),
                                     br_i)[:, None, :, 0]
    scores = (tl_s[:, :, None] + br_s[:, None, :]) / 2.0
    reject = ((tl_c[:, :, None] != br_c[:, None, :])
              | ((tl_tag - br_tag).abs() > avg_embedding_threshold)
              | (br_xk < tl_xk) | (br_yk < tl_yk))
    scores = torch.where(reject, torch.full_like(scores, -1.0), scores)

    count = min(detection_count, k * k)
    top_scores, top_inds = torch.sort(scores.reshape(b, -1), dim=1,
                                      descending=True, stable=True)
    top_scores, top_inds = top_scores[:, :count], top_inds[:, :count]

    def pick(grid: torch.Tensor) -> torch.Tensor:
        return grid.expand(b, k, k).reshape(b, -1).gather(1, top_inds)

    boxes = boxes.reshape(b, -1, 4).gather(
        1, top_inds[:, :, None].expand(b, count, 4))
    return torch.cat([boxes, top_scores[:, :, None],
                      pick(tl_s[:, :, None])[:, :, None],
                      pick(br_s[:, None, :])[:, :, None],
                      pick(tl_c[:, :, None]).float()[:, :, None]], dim=2)


def decode_corner_net_legacy_list(out_dict: Dict[str, torch.Tensor],
                                  k: int = 100, nms_kernel_size: int = 1
                                  ) -> List[torch.Tensor]:
    """The trainer's decode contract: a list holding the detections."""
    return [decode_corner_net_legacy(out_dict, k, nms_kernel_size)]


def corner_net_legacy_evaluation(xs, ys, detections,
                                 score_threshold: float = 0.3):
    """IoU of the paired boxes against the ground-truth corner boxes,
    rebuilt from the legacy targets (indices + fractional offsets), for
    ``train/expression.expression_corner_net_legacy``: the (iou, score,
    mask) grid and the per-clip object counts."""
    mask = ys[2]
    tl_regr, br_regr = ys[3], ys[4]
    tl_inds, br_inds = ys[5], ys[6]
    heat_size = ys[0].shape[3]

    def to_xy(inds, frac):
        x = (inds % heat_size).to(torch.float32) + frac[:, :, 0]
        y = torch.div(inds, heat_size, rounding_mode="floor").to(
            torch.float32) + frac[:, :, 1]
        return x, y

    tlx, tly = to_xy(tl_inds, tl_regr)
    brx, bry = to_xy(br_inds, br_regr)
    gt_boxes = torch.stack([tlx, tly, brx, bry], dim=-1)
    gt_boxes = torch.where(mask[:, :, None], gt_boxes,
                           torch.zeros_like(gt_boxes))
    scores = detections[:, :, 4]
    vals, pair_mask = iou(detections[:, :, 0:4], gt_boxes,
                          scores >= score_threshold)
    return {"iouscore": (vals, scores[:, :, None].expand(vals.shape),
                         pair_mask),
            "objs": mask.to(torch.float32).sum(dim=1)}
