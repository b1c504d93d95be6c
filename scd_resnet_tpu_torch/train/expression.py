"""Validation metric aggregation and the report line.

Counterpart of ``scd_resnet_tpu/train/expression.py`` for the
centerOffset family (reference trainer/model/centerOffsetRes10.py:18-106):
the masked selections of every validation batch are joined, the means
taken (orthogonality NaN-filtered), AP computed at 0.3/0.5/0.7/0.9, and
the ``[mIoU] ... [avgS]`` line formatted exactly as the reference appends
it to ``evals.{trainName}.txt`` (``factory.parse_metric_line`` reads it);
and for the corner families: peak AP50/AP75 per head and box AP50, the
``[heatPeakAP50] ... [boxAP50]`` line; for the cornerLegacy family the
``[mIoU] ... [AP50]`` line of its embedding-paired boxes; and for the
centerSize family the ``[mIoU] ... [peakAP75]`` line of its
size-regressed boxes and peaks.

Inputs are ``center_net_evaluation``'s, ``corner_net_evaluation``'s,
``corner_net_legacy_evaluation``'s or ``center_net_size_evaluation``'s
dicts, as tensors or numpy.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from scd_resnet_tpu_torch.evaluations.detection import (
    average_precision_all,
    average_precision_plots,
)


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _masked(values, mask) -> np.ndarray:
    return _np(values)[_np(mask)]


def _mean(x: np.ndarray) -> float:
    return float(x.mean()) if x.size else 0.0


def _sum_count_mean(batches: List[Dict], key: str, index=None) -> float:
    total = count = 0.0
    for batch in batches:
        entry = batch[key] if index is None else batch[key][index]
        total += float(_np(entry[0]))
        count += float(_np(entry[1]))
    return total / count if count > 0 else 0.0


def aggregate_center_net(batches: List[Dict]) -> Dict[str, float]:
    """The scalar report metrics of a list of evaluated batches."""
    ious, scores = [], []
    obj_num = 0.0
    for batch in batches:
        obj_num += float(_np(batch["objs"]).sum())
        vals, svals, mask = batch["iouscore"]
        ious.append(_masked(vals, mask))
        scores.append(_masked(svals, mask))
    ious = np.concatenate(ious) if ious else np.zeros(0)
    scores = np.concatenate(scores) if scores else np.zeros(0)

    result = {
        "mIoU": _mean(ious),
        "mIoUC": _sum_count_mean(batches, "ioucenter"),
        "mIoUO": _sum_count_mean(batches, "iouoffset"),
        "mIoUwoO": _sum_count_mean(batches, "iouoffsetwo"),
        "orthogonity": _sum_count_mean(batches, "ortho"),
        "avgScore": _mean(scores),
        "majMAE": _sum_count_mean(batches, "maes", 0),
        "minMAE": _sum_count_mean(batches, "maes", 1),
        "radMAE": _sum_count_mean(batches, "maes", 2),
    }
    obj_num = max(obj_num, float(len(ious)))
    for t in (30, 50, 70, 90):
        plots = average_precision_plots(ious, scores, obj_num, t / 100.0)
        result[f"ap{t}"] = average_precision_all(plots)
    return result


def expression_center_net(batches: List[Dict]) -> str:
    """The report line (centerOffsetRes10.py:88-106)."""
    e = aggregate_center_net(batches)
    return (
        "[mIoU] {}    [mIoUC] {}    [mIoUwoO] {}    [mIoUO] {}    "
        "[AP30] {}    [AP50] {}    [AP70] {}    [AP90] {}    [Orth] {}    "
        "[majMAE] {}    [minMAE] {}    [radMAE] {}    [avgS] {}".format(
            format(e["mIoU"] * 100, "-10.8f"),
            format(e["mIoUC"] * 100, "-10.8f"),
            format(e["mIoUwoO"] * 100, "-10.8f"),
            format(e["mIoUO"] * 100, "-10.8f"),
            format(e["ap30"] * 100, "-5.2f"),
            format(e["ap50"] * 100, "-5.2f"),
            format(e["ap70"] * 100, "-5.2f"),
            format(e["ap90"] * 100, "-5.2f"),
            format(e["orthogonity"], "-8.6f"),
            format(e["majMAE"], "-8.6f"),
            format(e["minMAE"], "-8.6f"),
            format(e["radMAE"], "-8.6f"),
            format(e["avgScore"], "-6.4f"),
        )
    )


def aggregate_corner_net(batches: List[Dict]) -> Dict[str, float]:
    """Peak AP50/AP75 per head for the corner families: a decoded peak
    is a true positive when the ground-truth Gaussian at its pixel is at
    least the threshold; and box AP50 over the center-gated tl/br pairs
    (``models/corner_net.pair_corner_boxes``)."""
    result: Dict[str, float] = {}
    obj_num = sum(float(_np(batch["objs"]).sum()) for batch in batches)
    for head in ("heat", "tl", "br"):
        gts = [_masked(batch[head][0], batch[head][2]) for batch in batches]
        scores = [_masked(batch[head][1], batch[head][2])
                  for batch in batches]
        gts = np.concatenate(gts) if gts else np.zeros(0)
        scores = np.concatenate(scores) if scores else np.zeros(0)
        denom = max(obj_num, float(len(gts)))
        for t in (50, 75):
            plots = average_precision_plots(gts, scores, denom, t / 100.0)
            result[f"{head}AP{t}"] = average_precision_all(plots)
    if any("box" not in batch for batch in batches):
        result["boxAP50"] = 0.0
        return result
    ious = [_masked(batch["box"][0], batch["box"][2]) for batch in batches]
    scores = [_masked(batch["box"][1], batch["box"][2]) for batch in batches]
    ious = np.concatenate(ious) if ious else np.zeros(0)
    scores = np.concatenate(scores) if scores else np.zeros(0)
    denom = max(obj_num, float(len(ious)))
    result["boxAP50"] = average_precision_all(
        average_precision_plots(ious, scores, denom, 0.5))
    return result


def expression_corner_net(batches: List[Dict]) -> str:
    """The corner families' report line, key for key the JAX package's."""
    e = aggregate_corner_net(batches)
    return (
        "[heatPeakAP50] {}    [heatPeakAP75] {}    [tlPeakAP50] {}    "
        "[tlPeakAP75] {}    [brPeakAP50] {}    [brPeakAP75] {}    "
        "[boxAP50] {}".format(
            *(format(e[k] * 100, "-5.2f")
              for k in ("heatAP50", "heatAP75", "tlAP50", "tlAP75",
                        "brAP50", "brAP75", "boxAP50"))))


def expression_corner_net_legacy(batches: List[Dict]) -> str:
    """The cornerLegacy report line (``scd_resnet_tpu/models/
    corner_net_legacy.expression_corner_net_legacy``): the mean IoU of
    the matched paired boxes and their AP50, ``bestSnapshotMetric:
    "AP50"``'s source."""
    ious, scores = [], []
    obj_num = 0.0
    for batch in batches:
        obj_num += float(_np(batch["objs"]).sum())
        vals, svals, mask = batch["iouscore"]
        ious.append(_masked(vals, mask))
        scores.append(_masked(svals, mask))
    ious = np.concatenate(ious) if ious else np.zeros(0)
    scores = np.concatenate(scores) if scores else np.zeros(0)
    miou = float(ious.mean()) if ious.size else 0.0
    denom = max(obj_num, float(len(ious)))
    ap50 = average_precision_all(
        average_precision_plots(ious, scores, denom, 0.5))
    return "[mIoU] {}    [AP50] {}".format(
        format(miou * 100, "-10.8f"), format(ap50 * 100, "-5.2f"))


def expression_center_net_size(batches: List[Dict]) -> str:
    """The centerSize report line (``scd_resnet_tpu/train/expression.py:
    130-158``): the mean IoU of the size-regressed boxes and the peak AP
    at 0.3/0.5/0.75, ``bestSnapshotMetric: "peakAP50"``'s source."""
    ious, gts, scores = [], [], []
    obj_num = 0.0
    for batch in batches:
        obj_num += float(_np(batch["objs"]).sum())
        vals, mask = batch["iou"]
        ious.append(_masked(vals, mask))
        gt, sc, mask = batch["heat"]
        gts.append(_masked(gt, mask))
        scores.append(_masked(sc, mask))
    ious = np.concatenate(ious) if ious else np.zeros(0)
    gts = np.concatenate(gts) if gts else np.zeros(0)
    scores = np.concatenate(scores) if scores else np.zeros(0)
    denom = max(obj_num, float(len(gts)))
    aps = {t: average_precision_all(average_precision_plots(
        gts, scores, denom, t / 100.0)) for t in (30, 50, 75)}
    return "[mIoU] {}    [peakAP30] {}    [peakAP50] {}    [peakAP75] {}" \
        .format(format(_mean(ious) * 100, "-10.8f"),
                format(aps[30] * 100, "-5.2f"),
                format(aps[50] * 100, "-5.2f"),
                format(aps[75] * 100, "-5.2f"))
