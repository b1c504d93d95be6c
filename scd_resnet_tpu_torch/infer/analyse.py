"""Whole-slide inference: device tiling, batched decode, host stitch, Rhr.

Counterpart of ``scd_resnet_tpu/infer/analyse.py`` (reference
test.py:41-183) for the device-fused serving path:

- the uint8 grayscale slide uploads once; on the device it is padded
  (reflect101 on y, *symmetric* on x — ``ops/image.reflect_index``),
  cut into 512x512 clips at stride 512 - 2*64 (x-major, then y), and
  each clip is standardised;
- all clips of the slide run as one batch through the wrapper; only the
  (rows, N, K) decode rows come back to the host;
- the host thresholds at 0.3 after top-100, maps clip coordinates to
  slide pixels (``slide_x = clipX*384 - padLR + ctX*4 + offX``, toward-
  zero truncation), computes Rhr = (4 rad - 4 minL) / (2 * 4 minL), and
  drops detections outside the slide; the cornerLegacy contract's paired
  boxes go to slide pixels unrounded and are kept by their centers;
- ``fit_rhr`` fits the two-Gaussian mixture to the Rhr histogram.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.ops.augment import normalize
from scd_resnet_tpu_torch.ops.image import reflect_index

INPUT_SIZE = 512
PADDING_SIZE = 64
STRIDE = INPUT_SIZE - 2 * PADDING_SIZE
DOWNSAMPLE_RATIO = 4
SCORE_THRESHOLD = 0.3

CONTRACT_FIELDS = {
    "centerOffset": ("x", "y", "rhr"),
    "corner": ("x", "y", "score", "head"),
    "cornerLegacy": ("tlx", "tly", "brx", "bry", "score"),
}

_CORNER_HEADS = ("ct", "tl", "br")


def gauss2(x, a1, m1, s1, a2, m2, s2):
    """Two-Gaussian mixture (test.py:14)."""
    return a1 * np.exp(-((x - m1) / s1) ** 2) + a2 * np.exp(-((x - m2) / s2) ** 2)


def slide_geometry(width: int, height: int) -> Tuple[int, int, int, int]:
    """(clip_h, clip_v, pad_lr, pad_tb) for a width x height slide
    (test.py:48-65)."""
    clip_h = math.ceil((width - 2 * PADDING_SIZE) / STRIDE)
    clip_v = math.ceil((height - 2 * PADDING_SIZE) / STRIDE)
    resize_w = STRIDE * clip_h + 2 * PADDING_SIZE
    resize_h = STRIDE * clip_v + 2 * PADDING_SIZE
    if (resize_w - width) % 2 != 0:
        resize_w += 1
    if (resize_h - height) % 2 != 0:
        resize_h += 1
    return clip_h, clip_v, (resize_w - width) // 2, (resize_h - height) // 2


def coerce_gray_u8(gray: np.ndarray) -> np.ndarray:
    """A grayscale slide in the [0, 255] uint8 range the analyzer
    uploads: uint8 passes through, 16-bit rescales (x/257), other arrays
    are peak-rescaled when they exceed 255, else rounded and clipped."""
    gray = np.asarray(gray)
    if gray.dtype == np.uint8:
        return gray
    if gray.dtype == np.uint16:
        return np.round(gray / 257.0).astype(np.uint8)
    work = np.asarray(gray, np.float64)
    peak = float(work.max()) if work.size else 0.0
    if peak > 255.0:
        work = work * (255.0 / peak)
    return np.clip(np.round(work), 0.0, 255.0).astype(np.uint8)


def make_device_tiler(width: int, height: int,
                      device: torch.device) -> Callable:
    """(H, W) uint8 tensor on ``device`` -> (N, 1, 512, 512) standardised
    float32 clips, x-major then y (the reference's loop order)."""
    clip_h, clip_v, pad_lr, pad_tb = slide_geometry(width, height)
    rows = torch.from_numpy(
        reflect_index(height, pad_tb, pad_tb, "reflect101")).to(device)
    cols = torch.from_numpy(
        reflect_index(width, pad_lr, pad_lr, "symmetric")).to(device)

    def tiler(gray_u8: torch.Tensor) -> torch.Tensor:
        padded = gray_u8.index_select(0, rows).index_select(1, cols)
        # (clip_v, clip_h, 512, 512) windows -> x-major stack
        clips = padded.unfold(0, INPUT_SIZE, STRIDE).unfold(
            1, INPUT_SIZE, STRIDE)[:clip_v, :clip_h]
        clips = clips.transpose(0, 1).reshape(-1, INPUT_SIZE, INPUT_SIZE)
        return normalize(clips)[:, None]

    return tiler


def _clip_grid(clip_h: int, clip_v: int) -> Tuple[np.ndarray, np.ndarray]:
    """(grid_x, grid_y) column vectors for the x-major clip order."""
    g = np.arange(clip_h * clip_v)
    return (g // clip_v)[:, None], (g % clip_v)[:, None]


def _bounds_keep(keep: np.ndarray, slide_x: np.ndarray, slide_y: np.ndarray,
                 bounds: Optional[Tuple[int, int]]) -> np.ndarray:
    """AND the slide-bounds filter 0 <= x < W, 0 <= y < H into ``keep``
    (test.py:164-170)."""
    if bounds is None:
        return keep
    width, height = bounds
    return keep & ((slide_x >= 0) & (slide_x < width)
                   & (slide_y >= 0) & (slide_y < height))


def stitch_rows(rows: np.ndarray, clip_h: int, clip_v: int,
                pad_lr: int, pad_tb: int,
                bounds: Optional[Tuple[int, int]] = None) -> List[List[float]]:
    """centerOffset contract (10, N, K) -> ``[x, y, rhr]`` in slide
    pixels (test.py:106-141), float64 with toward-zero truncation, in
    clip-major then top-K order."""
    rows = np.asarray(rows, np.float64)[:, : clip_h * clip_v]
    (scores, _inds, ct_y, ct_x, _maj_x, _maj_y, min_l, rad,
     off_x, off_y) = rows
    grid_x, grid_y = _clip_grid(clip_h, clip_v)
    slide_x = np.trunc(grid_x * STRIDE - pad_lr + ct_x * 4 + off_x)
    slide_y = np.trunc(grid_y * STRIDE - pad_tb + ct_y * 4 + off_y)
    dminl = min_l * 4
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = (rad * 4 - dminl) / (2 * dminl)
    keep = _bounds_keep(scores > SCORE_THRESHOLD, slide_x, slide_y, bounds)
    return [
        [int(sx), int(sy), float(r)]
        for sx, sy, r in zip(slide_x[keep], slide_y[keep], ratio[keep])
    ]


def stitch_corner_rows(rows: np.ndarray, clip_h: int, clip_v: int,
                       pad_lr: int, pad_tb: int,
                       bounds: Optional[Tuple[int, int]] = None
                       ) -> List[List[float]]:
    """corner contract (12, N, K) -> ``[x, y, score, head]``, head in
    {"ct", "tl", "br"}."""
    rows = np.asarray(rows, np.float64)[:, : clip_h * clip_v]
    grid_x, grid_y = _clip_grid(clip_h, clip_v)
    detections: List[List[float]] = []
    for h, head in enumerate(_CORNER_HEADS):
        scores, _inds, ys, xs = rows[4 * h: 4 * h + 4]
        slide_x = np.trunc(grid_x * STRIDE - pad_lr + xs * 4)
        slide_y = np.trunc(grid_y * STRIDE - pad_tb + ys * 4)
        keep = _bounds_keep(scores > SCORE_THRESHOLD, slide_x, slide_y,
                            bounds)
        detections.extend(
            [int(x), int(y), float(s), head]
            for x, y, s in zip(slide_x[keep], slide_y[keep], scores[keep]))
    return detections


def stitch_legacy_boxes(rows: np.ndarray, clip_h: int, clip_v: int,
                        pad_lr: int, pad_tb: int,
                        bounds: Optional[Tuple[int, int]] = None
                        ) -> List[List[float]]:
    """cornerLegacy contract (N, 1000, 8) paired boxes -> ``[tlx, tly,
    brx, bry, score]`` in slide pixels, float64; rejected pairs (score -1)
    fall to the threshold, and the bounds keep boxes whose center is in
    the slide (``scd_resnet_tpu/infer/analyse.py:350-375``)."""
    rows = np.asarray(rows, np.float64)[: clip_h * clip_v]
    grid_x, grid_y = _clip_grid(clip_h, clip_v)
    tlx = grid_x * STRIDE - pad_lr + rows[:, :, 0] * 4
    tly = grid_y * STRIDE - pad_tb + rows[:, :, 1] * 4
    brx = grid_x * STRIDE - pad_lr + rows[:, :, 2] * 4
    bry = grid_y * STRIDE - pad_tb + rows[:, :, 3] * 4
    scores = rows[:, :, 4]
    keep = _bounds_keep(scores > SCORE_THRESHOLD, (tlx + brx) / 2,
                        (tly + bry) / 2, bounds)
    return [
        [float(a), float(b), float(c), float(d), float(s)]
        for a, b, c, d, s in zip(tlx[keep], tly[keep], brx[keep],
                                 bry[keep], scores[keep])]


def stitch_any(rows: np.ndarray, contract: str, clip_h: int, clip_v: int,
               pad_lr: int, pad_tb: int,
               bounds: Optional[Tuple[int, int]] = None) -> List[List[float]]:
    fn = {"centerOffset": stitch_rows, "corner": stitch_corner_rows,
          "cornerLegacy": stitch_legacy_boxes}.get(contract)
    if fn is None:
        raise KeyError("unknown wrapper contract '{}'".format(contract))
    return fn(rows, clip_h, clip_v, pad_lr, pad_tb, bounds)


def dedupe_detections(detections: List[List[float]],
                      radius: float) -> List[List[float]]:
    """Greedy tile-overlap duplicate suppression: keep the first
    detection, drop later ones within ``radius`` px of a kept one."""
    kept: List[List[float]] = []
    if not detections:
        return kept
    kept_xy = np.empty((len(detections), 2), np.float64)
    n_kept = 0
    r2 = radius * radius
    for det in detections:
        if n_kept:
            d2 = kept_xy[:n_kept] - (det[0], det[1])
            if ((d2 * d2).sum(axis=1) <= r2).any():
                continue
        kept_xy[n_kept] = (det[0], det[1])
        n_kept += 1
        kept.append(det)
    return kept


def dedupe_contract(detections: List[List[float]], radius: float,
                    contract: str) -> List[List[float]]:
    """Corner peaks dedupe within each head (a tl peak never suppresses a
    ct peak); legacy boxes on their centers; point contracts on (x, y)."""
    if contract == "corner":
        out: List[List[float]] = []
        for head in _CORNER_HEADS:
            out.extend(dedupe_detections(
                [d for d in detections if d[3] == head], radius))
        return out
    if contract == "cornerLegacy":
        centered = [[(d[0] + d[2]) / 2, (d[1] + d[3]) / 2, d]
                    for d in detections]
        return [c[2] for c in dedupe_detections(centered, radius)]
    return dedupe_detections(detections, radius)


def make_device_analyzer(wrapper: Callable, width: int,
                         height: int) -> Callable:
    """Slide analyzer with the tiling on the wrapper's device.

    Returns ``analyse(gray) -> detections`` inside the slide (no dedupe:
    the service applies it per request); ``analyse.dispatch(gray)``
    enqueues the device work and returns the rows tensor (asynchronous
    on CUDA), ``analyse.finish(rows)`` copies them to the host and
    stitches."""
    device = wrapper.device
    contract = wrapper.contract
    clip_h, clip_v, pad_lr, pad_tb = slide_geometry(width, height)
    tiler = make_device_tiler(width, height, device)

    def dispatch(gray: np.ndarray) -> torch.Tensor:
        gray_u8 = torch.from_numpy(
            np.require(coerce_gray_u8(gray), requirements=["C", "W"]))
        with torch.inference_mode():
            return wrapper(tiler(gray_u8.to(device)))

    def finish(rows: torch.Tensor) -> List[List[float]]:
        return stitch_any(rows.cpu().numpy(), contract, clip_h, clip_v,
                          pad_lr, pad_tb, (width, height))

    def analyse(gray: np.ndarray) -> List[List[float]]:
        return finish(dispatch(gray))

    analyse.dispatch = dispatch
    analyse.finish = finish
    return analyse


def rhr_histogram(rhrs: Sequence[float]) -> Tuple[np.ndarray, np.ndarray]:
    """Frequency histogram over Rhr in [-0.25, 1.25) step 0.01
    (test.py:174-176)."""
    xs = np.array([(x - 25) / 100 for x in range(150)])
    ys = np.zeros(150)
    for r in rhrs:
        bucket = int(math.floor((r + 0.25) * 100))
        if 0 <= bucket < 150:
            ys[bucket] += 1
    total = ys.sum()
    if total > 0:
        ys = ys / total
    return xs, ys


def fit_rhr(rhrs: Sequence[float]):
    """Two-Gaussian fit with the reference's bounds (test.py:177-182).
    Returns ``[a1, m1, s1, a2, m2, s2]``."""
    from scipy.optimize import curve_fit

    xs, ys = rhr_histogram(rhrs)
    bounds = ([0, -0.25, 0, 0, 0, 0], [1, 0.33, 0.2, 1, 1.25, 1])
    popt, _ = curve_fit(gauss2, xs, ys, bounds=bounds, maxfev=5000)
    return list(popt)
