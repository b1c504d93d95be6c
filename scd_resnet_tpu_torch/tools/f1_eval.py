"""Detection F1 of a detections file against annotation files.

    python -m scd_resnet_tpu_torch.tools.f1_eval detections.json annots/ \\
        [--radius 24]

Counterpart of the root ``tools/f1_eval.py``. A detection is a true
positive when it is the nearest unmatched prediction within ``--radius``
pixels of an unmatched annotated center (greedy one-to-one matching in
ascending distance). ``detections.json`` is what ``python -m
scd_resnet_tpu_torch.test -o`` writes; every slide it lists under
``images`` counts, with or without detections. Prints one line a slide
and a final JSON line with the totals.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from scd_resnet_tpu_torch.data.labels import load_markers


def match_f1(pred_xy: np.ndarray, gt_xy: np.ndarray, radius: float):
    """``(tp, fp, fn, precision, recall, f1)`` of greedy one-to-one
    matching: pairs in ascending distance, each prediction and center
    used once, stopping at the first pair beyond ``radius``."""
    if len(pred_xy) == 0 or len(gt_xy) == 0:
        tp = 0
    else:
        d = np.linalg.norm(pred_xy[:, None, :] - gt_xy[None, :, :], axis=-1)
        tp = 0
        used_p = np.zeros(len(pred_xy), bool)
        used_g = np.zeros(len(gt_xy), bool)
        order = np.dstack(np.unravel_index(np.argsort(d, axis=None),
                                           d.shape))[0]
        for pi, gi in order:
            if d[pi, gi] > radius:
                break
            if used_p[pi] or used_g[gi]:
                continue
            used_p[pi] = used_g[gi] = True
            tp += 1
    fp = len(pred_xy) - tp
    fn = len(gt_xy) - tp
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    return tp, fp, fn, precision, recall, f1


def group_detections(payload, with_rhr: bool = False
                     ) -> Dict[str, List[Tuple[float, ...]]]:
    """``{image: [(x, y[, rhr]), ...]}`` from a detections file, seeded
    with every image it lists under ``images`` so that a slide with no
    detection still counts its objects as false negatives (a file
    without ``images`` gives the images that have detections)."""
    out = {image: [] for image in payload.get("images", [])}
    for det in payload["detections"]:
        row = (float(det["x"]), float(det["y"]))
        if with_rhr:
            row += (float(det.get("rhr", 0.0)),)
        out.setdefault(det["image"], []).append(row)
    return out


def annotated_centers(annotations: str, image: str,
                      required: bool = False) -> np.ndarray:
    """(N, 2) annotated centers of ``image`` from ``annotations/<stem>.txt``;
    a missing file gives none, or with ``required`` raises."""
    stem = os.path.splitext(os.path.basename(image))[0]
    path = os.path.join(annotations, stem + ".txt")
    markers = load_markers(path) if required or os.path.exists(path) else []
    return np.asarray([m.center for m in markers], np.float64).reshape(-1, 2)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Score as the command line says; returns the totals it prints."""
    parser = argparse.ArgumentParser(
        prog="python -m scd_resnet_tpu_torch.tools.f1_eval",
        description="detection F1 against annotation files")
    parser.add_argument("detections",
                        help="detections JSON (python -m "
                             "scd_resnet_tpu_torch.test -o)")
    parser.add_argument("annotations", help="annotation .txt folder")
    parser.add_argument("--radius", type=float, default=24.0,
                        help="match radius in full-resolution pixels")
    args = parser.parse_args(argv)

    with open(args.detections) as f:
        by_image = group_detections(json.load(f))

    total_tp = total_fp = total_fn = 0
    for image, preds in sorted(by_image.items()):
        gt = annotated_centers(args.annotations, image)
        pred = np.asarray(preds, np.float64).reshape(-1, 2)
        tp, fp, fn, precision, recall, f1 = match_f1(pred, gt, args.radius)
        total_tp += tp
        total_fp += fp
        total_fn += fn
        print("{}: tp={} fp={} fn={} P={:.3f} R={:.3f} F1={:.3f}".format(
            os.path.splitext(os.path.basename(image))[0], tp, fp, fn,
            precision, recall, f1))

    precision = total_tp / max(total_tp + total_fp, 1)
    recall = total_tp / max(total_tp + total_fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    totals = {"tp": total_tp, "fp": total_fp, "fn": total_fn,
              "precision": round(precision, 4), "recall": round(recall, 4),
              "f1": round(f1, 4)}
    print(json.dumps(totals))
    return totals


if __name__ == "__main__":
    main()
