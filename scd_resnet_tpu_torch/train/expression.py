"""Validation metric aggregation and the report line.

Counterpart of ``scd_resnet_tpu/train/expression.py`` for the
centerOffset family (reference trainer/model/centerOffsetRes10.py:18-106):
the masked selections of every validation batch are joined, the means
taken (orthogonality NaN-filtered), AP computed at 0.3/0.5/0.7/0.9, and
the ``[mIoU] ... [avgS]`` line formatted exactly as the reference appends
it to ``evals.{trainName}.txt`` (``factory.parse_metric_line`` reads it).

Inputs are ``center_net_evaluation``'s dicts, as tensors or numpy.
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
