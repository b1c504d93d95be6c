"""Batched detection metrics: IoU, orthogonality, MAE, IoU + confidence,
and the interpolated AP.

Counterpart of ``scd_resnet_tpu/evaluations/detection.py`` (reference
evaluations/detection.py: IoU 12-49, Orthogonity 55-105, MAE 109-161,
IoUConfidence 164-204, AP 207-267). Each metric returns its full (N, K, L)
value grid and a boolean mask in place of the reference's
``masked_select``; the masking predicates are the reference's (strict
``> 1e-5`` overlaps, ground-truth area and major-length guards, the score
threshold through ``valid_mask``). The AP sweep runs on the host in
numpy over the masked values.
"""

from __future__ import annotations

import numpy as np
import torch


def _pairwise(det_boxes, gt_boxes, valid_mask):
    """The (N, K, L) pieces every metric shares."""
    tlx1, tly1 = det_boxes[:, :, None, 0], det_boxes[:, :, None, 1]
    brx1, bry1 = det_boxes[:, :, None, 2], det_boxes[:, :, None, 3]
    tlx2, tly2 = gt_boxes[:, None, :, 0], gt_boxes[:, None, :, 1]
    brx2, bry2 = gt_boxes[:, None, :, 2], gt_boxes[:, None, :, 3]

    det_area = (brx1 - tlx1) * (bry1 - tly1)
    gt_area = (brx2 - tlx2) * (bry2 - tly2)
    dx = torch.minimum(brx1, brx2) - torch.maximum(tlx1, tlx2)
    dy = torch.minimum(bry1, bry2) - torch.maximum(tly1, tly2)
    inter = dx * dy
    mask = (dx > 1e-5) & (dy > 1e-5) & (gt_area > 1e-5) \
        & valid_mask[:, :, None]
    return inter, det_area, gt_area, mask


def iou(det_boxes, gt_boxes, valid_mask):
    """IoU of every detection/ground-truth pair, ``(values, mask)``."""
    inter, det_area, gt_area, mask = _pairwise(det_boxes, gt_boxes, valid_mask)
    return inter / (det_area + gt_area - inter), mask


def iou_confidence(det_boxes, gt_boxes, scores, valid_mask):
    """IoU plus the detection's score, ``(ious, scores, mask)``."""
    inter, det_area, gt_area, mask = _pairwise(det_boxes, gt_boxes, valid_mask)
    vals = inter / (det_area + gt_area - inter)
    return vals, scores[:, :, None].expand(vals.shape), mask


def orthogonality(det_boxes, gt_boxes, maj_det, maj_gt, valid_mask):
    """Sine of the angle between matched major axes; ``maj_*`` are
    (.., 3) of (majX, majY, majL). NaN where |cos| rounds above 1; the
    aggregation filters it, as the reference does."""
    _, _, _, mask = _pairwise(det_boxes, gt_boxes, valid_mask)
    cos = (maj_det[:, :, None, 0] * maj_gt[:, None, :, 0]
           + maj_det[:, :, None, 1] * maj_gt[:, None, :, 1]) \
        / (maj_det[:, :, None, 2] * maj_gt[:, None, :, 2])
    sin = torch.sqrt(1.0 - cos * cos)
    return sin, mask & (maj_gt[:, None, :, 2] > 1e-5)


def mae(det_boxes, gt_boxes, regr_det, regr_gt, valid_mask):
    """|major|, |minor|, |radius| errors of overlapping pairs; ``regr_*``
    are (.., 3) of (majL, minL, radius). Returns ``(maj, min, rad, mask)``."""
    _, _, _, mask = _pairwise(det_boxes, gt_boxes, valid_mask)
    errors = [(regr_det[:, :, None, i] - regr_gt[:, None, :, i]).abs()
              for i in range(3)]
    return (*errors, mask & (regr_gt[:, None, :, 0] > 1e-5))


# ---- AP (host, numpy) --------------------------------------------------


def average_precision_plots(ious: np.ndarray, scores: np.ndarray,
                            obj_num: float, threshold: float) -> np.ndarray:
    """(recall, precision) rows of the score-descending sweep
    (detection.py:207-231), as an (N, 2) array."""
    ious, scores = np.asarray(ious), np.asarray(scores)
    order = np.argsort(scores, kind="stable")[::-1]
    acc_true = np.cumsum(ious[order] >= threshold)
    recall = acc_true / max(obj_num, 1e-9)
    precision = acc_true / np.arange(1, len(order) + 1)
    return np.stack([recall, precision], axis=1)


def average_precision_all(plots) -> float:
    """Interpolated AP from the plot rows (detection.py:233-255): the
    reference's reversed sweep, where each point whose precision beats
    every later one opens a step."""
    plots = np.asarray(plots, np.float64).reshape(-1, 2)
    if len(plots) == 0:
        return 0.0
    recall, precision = plots[::-1, 0], plots[::-1, 1]
    prev_max = np.concatenate(([0.0], np.maximum.accumulate(precision)[:-1]))
    records = np.flatnonzero(precision > prev_max)
    if len(records) == 0:
        return 0.0
    x2, y = recall[records], precision[records]
    x1_entering = np.where(records > 0, recall[np.maximum(records - 1, 0)],
                           1.0)
    ap = float(np.sum((x2[:-1] - x1_entering[1:]) * y[:-1]))
    return ap + float(x2[-1] * y[-1])

