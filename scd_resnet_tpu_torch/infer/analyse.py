"""Whole-slide inference: tiling, batched decode, host stitch, Rhr.

Counterpart of ``scd_resnet_tpu/infer/analyse.py`` (reference
test.py:41-183). The device-fused serving path
(:func:`make_device_analyzer`):

- the uint8 grayscale slide uploads once; on the device it is padded
  (reflect101 on y, *symmetric* on x — ``ops/image.reflect_index``),
  cut into 512x512 clips at stride 512 - 2*64 (x-major, then y), and
  each clip is standardised from its exact integer moments
  (:func:`standardize_u8`), so that a clip's values do not depend on
  the batch it shares;
- all clips of the slide run as one batch through the wrapper, padded
  with blank clips to a multiple of ``BATCH_SIZE`` (cuDNN's float32
  forward sums in another order at other batches); only the (rows, N,
  K) decode rows come back to the host;
- the host thresholds at 0.3 after top-100, maps clip coordinates to
  slide pixels (``slide_x = clipX*384 - padLR + ctX*4 + offX``, toward-
  zero truncation), computes Rhr = (4 rad - 4 minL) / (2 * 4 minL), and
  drops detections outside the slide; the cornerLegacy contract's paired
  boxes go to slide pixels unrounded and are kept by their centers;
- ``max_resident_clips`` streams a giant slide in column bands of at
  most that many clips (:func:`band_plan`): each band's pixels are cut
  from the slide on the host (:func:`extract_padded_band`; the slide may
  be an ``np.memmap``, of which only the band's columns are read),
  uploaded as uint8 and cut, standardised, run and decoded on the
  device, with at most two bands in flight. Clips stack x-major, so the
  bands' rows concatenate into the monolithic order and the detections
  are the same;
- ``analyse.many`` queues every slide's device work before it reads any
  rows back;
- ``mesh`` (a list of devices, the ``data`` axis) shards the slide's
  clips over the devices, one model copy on each distinct device, as the
  JAX analyzer shards them over its mesh.

The host-tiled path (:func:`analyse_grayscale`, :func:`analyse_images`)
is the JAX package's in numpy: the clips are cut and standardised on the
host in float32 (:func:`tile_slide`) and go through a fixed-batch model,
a live wrapper or a traced bundle (``infer/wrapper.load_traced``), the
last batch padded to the bundle's batch; it streams in bands alike.

``fit_rhr`` fits the two-Gaussian mixture to the Rhr histogram.
"""

from __future__ import annotations

import copy
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.ops.image import (
    grayscale_inference_u8,
    pad_reflect_hybrid,
    reflect_index,
)

INPUT_SIZE = 512
PADDING_SIZE = 64
STRIDE = INPUT_SIZE - 2 * PADDING_SIZE
DOWNSAMPLE_RATIO = 4
SCORE_THRESHOLD = 0.3
BATCH_SIZE = 24

CONTRACT_FIELDS = {
    "centerOffset": ("x", "y", "rhr"),
    "centerSize": ("x", "y", "w", "h", "score"),
    "corner": ("x", "y", "score", "head"),
    "cornerLegacy": ("tlx", "tly", "brx", "bry", "score"),
}
# the centerSize head learns size / (DOWNSAMPLE * SIZE_REGR_FACTOR)
# (centerNet.py:47, 152-192): the full factor is undone for pixel boxes
_SIZE_SCALE = 4 * 10

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


def standardize_u8(clips: torch.Tensor) -> torch.Tensor:
    """(N, H, W) uint8 clips -> float32, each at zero mean and unit
    population variance (a constant clip at zeros), as ``ops/augment.
    normalize`` does, with the moments exact: the integer sums of x and
    x^2 are exact in int64 in any order, so a clip's result does not
    depend on how many clips share its batch (a float32 reduction's
    order does, on the card and on the CPU), and it is the same on
    either device. Only mean and variance are rounded, once, to
    float32."""
    n = clips.shape[-2] * clips.shape[-1]
    x = clips.to(torch.int32)
    total = x.sum(dim=(-2, -1), keepdim=True)
    squares = (x * x).sum(dim=(-2, -1), keepdim=True)
    mean = (total.double() / n).float()
    # n * sum x^2 - (sum x)^2 = n^2 var, exact in int64 for 8-bit pixels
    var = ((n * squares - total * total).double() / (n * n)).float()
    safe_var = torch.where(var > 0, var, torch.ones_like(var))
    return torch.where(var > 0, (x.float() - mean) / torch.sqrt(safe_var),
                       torch.zeros((), dtype=torch.float32,
                                   device=clips.device))


def _cut_clips(padded: torch.Tensor, n_cols: int, n_rows: int
               ) -> torch.Tensor:
    """A padded uint8 region (rows of ``n_rows`` clips, ``n_cols``
    columns) -> (N, 1, 512, 512) standardised float32 clips, x-major then
    y."""
    clips = padded.unfold(0, INPUT_SIZE, STRIDE).unfold(
        1, INPUT_SIZE, STRIDE)[:n_rows, :n_cols]
    clips = clips.transpose(0, 1).reshape(-1, INPUT_SIZE, INPUT_SIZE)
    return standardize_u8(clips)[:, None]


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
        return _cut_clips(padded, clip_h, clip_v)

    return tiler


def _normalize(clip: np.ndarray) -> np.ndarray:
    """Host standardisation of one float32 clip, numpy float32 as the
    JAX host path computes it."""
    mean = clip.mean()
    var = np.mean((clip - mean) ** 2)
    if var <= 0:  # constant clip (blank padding region): no information
        return np.zeros_like(clip)
    return (clip - mean) / math.sqrt(var)


def _cut_normalized(padded: np.ndarray, n_cols: int, clip_v: int
                    ) -> np.ndarray:
    """A padded host region -> (N, 512, 512) standardised clips, x-major
    then y (test.py:86-90)."""
    clips = np.empty((n_cols * clip_v, INPUT_SIZE, INPUT_SIZE), np.float32)
    i = 0
    for x in range(n_cols):
        for y in range(clip_v):
            clips[i] = _normalize(padded[y * STRIDE: y * STRIDE + INPUT_SIZE,
                                         x * STRIDE: x * STRIDE + INPUT_SIZE])
            i += 1
    return clips


def tile_slide(gray: np.ndarray) -> Tuple[np.ndarray, int, int, int, int]:
    """Pad and cut a float32 grayscale slide into overlapping standardised
    clips on the host: ``(clips (N, 512, 512), clip_h, clip_v, pad_lr,
    pad_tb)``, x-major then y."""
    height, width = gray.shape
    clip_h, clip_v, pad_lr, pad_tb = slide_geometry(width, height)
    padded = pad_reflect_hybrid(gray, pad_lr, pad_tb)
    return (_cut_normalized(padded, clip_h, clip_v),
            clip_h, clip_v, pad_lr, pad_tb)


def band_plan(clip_h: int, clip_v: int, max_resident_clips: int
              ) -> List[Tuple[int, int]]:
    """The clip grid as ``(first_column, n_columns)`` column bands of at
    most ``max_resident_clips`` clips (at least one column). Clips stack
    x-major, so the bands' rows concatenate into the monolithic order."""
    cols = max(1, max_resident_clips // clip_v)
    return [(x0, min(cols, clip_h - x0)) for x0 in range(0, clip_h, cols)]


def extract_padded_band(gray: np.ndarray, x0_clip: int, n_cols: int,
                        pad_lr: int, pad_tb: int) -> np.ndarray:
    """The pixels of ``pad_reflect_hybrid(gray, pad_lr, pad_tb)`` under
    clip columns ``[x0_clip, x0_clip + n_cols)``, from that band's source
    columns alone: ``gray`` may be an ``np.memmap``, of which the one
    slice below is the only read. A band at a slide edge rebuilds the
    symmetric x pad from its own edge columns (the pad is narrower than a
    clip stride, so the band holds its reflection source)."""
    width = gray.shape[1]
    px0 = x0_clip * STRIDE  # the band in padded x coordinates
    px1 = px0 + (n_cols - 1) * STRIDE + INPUT_SIZE
    gx0 = max(px0 - pad_lr, 0)
    gx1 = min(px1 - pad_lr, width)
    band = np.asarray(gray[:, gx0:gx1])
    # pad_reflect_hybrid's order: reflect101 on y, then symmetric on x at
    # the slide's edges (a band's inner edges are real pixels)
    band = np.pad(band, ((pad_tb, pad_tb), (0, 0)), mode="reflect")
    left = gx0 - (px0 - pad_lr)
    right = (px1 - pad_lr) - gx1
    if left or right:
        band = np.pad(band, ((0, 0), (max(left, 0), max(right, 0))),
                      mode="symmetric")
    return band


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


def stitch_size_rows(rows: np.ndarray, clip_h: int, clip_v: int,
                     pad_lr: int, pad_tb: int,
                     bounds: Optional[Tuple[int, int]] = None
                     ) -> List[List[float]]:
    """centerSize contract (6, N, K) -> ``[x, y, w, h, score]`` in slide
    pixels; no sub-pixel offset in this family, so peaks land on the 4 px
    heatmap grid (centerNet.py:194-222)."""
    rows = np.asarray(rows, np.float64)[:, : clip_h * clip_v]
    scores, _inds, ct_y, ct_x, size_w, size_h = rows
    grid_x, grid_y = _clip_grid(clip_h, clip_v)
    slide_x = np.trunc(grid_x * STRIDE - pad_lr + ct_x * 4)
    slide_y = np.trunc(grid_y * STRIDE - pad_tb + ct_y * 4)
    keep = _bounds_keep(scores > SCORE_THRESHOLD, slide_x, slide_y, bounds)
    return [
        [int(x), int(y), float(w * _SIZE_SCALE), float(h * _SIZE_SCALE),
         float(sc)]
        for x, y, w, h, sc in zip(slide_x[keep], slide_y[keep], size_w[keep],
                                  size_h[keep], scores[keep])]


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
    fn = {"centerOffset": stitch_rows, "centerSize": stitch_size_rows,
          "corner": stitch_corner_rows,
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


def _batch_axis(contract: str) -> int:
    """The clip axis of a contract's rows: the legacy contract is
    batch-major (B, 1000, 8), the stacked-row contracts (rows, B, K)."""
    return 0 if contract == "cornerLegacy" else 1


def _batched_rows(model: Callable, clips: np.ndarray, batch_size: int,
                  batch_axis: int) -> List[np.ndarray]:
    """Host clips (N, 512, 512) through the fixed-batch ``model`` (a
    wrapper or a loaded bundle, NCHW on ``model.device``), the last
    partial batch padded with zeros to the batch; the valid rows of each
    batch on the host."""
    rows = []
    for start in range(0, len(clips), batch_size):
        batch = clips[start: start + batch_size]
        valid = len(batch)
        if valid < batch_size:  # pad to the bundle's fixed shape
            batch = np.concatenate([batch, np.zeros(
                (batch_size - valid, INPUT_SIZE, INPUT_SIZE), np.float32)])
        out = model(torch.from_numpy(batch[:, None]).to(model.device))
        out = out.cpu().numpy()
        rows.append(out[:valid] if batch_axis == 0 else out[:, :valid])
    return rows


def analyse_grayscale(model: Callable, gray: np.ndarray,
                      dedupe_radius: Optional[float] = None,
                      batch_size: int = BATCH_SIZE, bounds=None,
                      max_resident_clips: Optional[int] = None
                      ) -> List[List[float]]:
    """Detections of a float32 grayscale slide through the host-tiled
    path, in ``model.contract``. ``batch_size`` must be a traced bundle's
    batch. ``bounds``: ``(width, height)``, ``"slide"`` for the slide's
    own, or None (no filter). ``max_resident_clips`` cuts the clip stack
    into column bands of at most that many clips (``gray`` may be an
    ``np.memmap``); the detections are the monolithic path's."""
    height, width = gray.shape
    clip_h, clip_v, pad_lr, pad_tb = slide_geometry(width, height)
    if bounds == "slide":
        bounds = (width, height)
    contract = model.contract
    batch_axis = _batch_axis(contract)
    all_rows = []
    if max_resident_clips and clip_h * clip_v > max_resident_clips:
        for x0, n_cols in band_plan(clip_h, clip_v, max_resident_clips):
            band = extract_padded_band(gray, x0, n_cols, pad_lr, pad_tb)
            all_rows.extend(_batched_rows(
                model, _cut_normalized(band, n_cols, clip_v), batch_size,
                batch_axis))
    else:
        clips = tile_slide(gray)[0]
        all_rows.extend(_batched_rows(model, clips, batch_size, batch_axis))
    rows = np.concatenate(all_rows, axis=batch_axis)
    detections = stitch_any(rows, contract, clip_h, clip_v, pad_lr, pad_tb,
                            bounds)
    if dedupe_radius is not None:
        detections = dedupe_contract(detections, dedupe_radius, contract)
    return detections


def read_gray_u8(source) -> np.ndarray:
    """A slide image (a path or a file object) as the uint8 inference
    grayscale (test.py:21-33): an RGB(A) image through
    ``grayscale_inference_u8``, a grayscale one of any bit depth through
    ``coerce_gray_u8``, a palette image by its colours. An image PIL
    cannot read raises its ``UnidentifiedImageError``, any other dtype or
    shape ``ValueError``."""
    from PIL import Image

    image = Image.open(source)
    if image.mode == "P":
        image = image.convert("RGB")
    color = np.asarray(image)
    if not (np.issubdtype(color.dtype, np.integer)
            or np.issubdtype(color.dtype, np.floating)):
        raise ValueError("unsupported image dtype {}".format(color.dtype))
    if color.ndim == 2:
        return coerce_gray_u8(color)
    if color.ndim == 3 and color.shape[-1] >= 3:
        return grayscale_inference_u8(coerce_gray_u8(color[..., :3]))
    raise ValueError("unsupported image shape {}".format(color.shape))


def analyse_images(model: Callable, full_path: str,
                   dedupe_radius: Optional[float] = None,
                   batch_size: int = BATCH_SIZE, bounds="slide",
                   max_resident_clips: Optional[int] = None
                   ) -> List[List[float]]:
    """Detections of one slide image through the host-tiled path, the
    slide-bounds filter on unless ``bounds=None``."""
    gray = read_gray_u8(full_path).astype(np.float32)
    return analyse_grayscale(model, gray, dedupe_radius, batch_size,
                             bounds=bounds,
                             max_resident_clips=max_resident_clips)


def make_device_analyzer(wrapper: Callable, width: int, height: int,
                         dedupe_radius: Optional[float] = None,
                         bounds="slide",
                         max_resident_clips: Optional[int] = None,
                         mesh: Optional[Sequence] = None) -> Callable:
    """Slide analyzer with the tiling on the wrapper's device.

    Returns ``analyse(gray) -> detections``, with the slide-bounds filter
    unless ``bounds=None`` (``(width, height)`` names others) and the
    tile-overlap dedupe at ``dedupe_radius`` if given.
    ``analyse.dispatch(gray)`` enqueues the device work and returns what
    ``analyse.finish`` reads back and stitches; ``analyse.many(grays)``
    queues every slide before it reads any back.

    ``max_resident_clips``: a slide of more clips streams in column bands
    (module docstring): band i + 1 is cut on the host, uploaded and queued
    before band i's rows are read back, so at most two bands (and their
    rows) are in flight; ``dispatch`` then returns the host rows of the
    whole slide, and ``many`` is a loop (several giant slides in flight is
    what the mode bounds).

    A slide, band or shard runs padded with blank clips to a multiple of
    ``BATCH_SIZE``, the host path's fixed batch: on an NVIDIA H100 80GB
    HBM3 (700 W) cuDNN's heuristics pick, for a float32 batch of 6, 12,
    20 or 35 clips, other algorithms for the heads' 3x3 convolutions,
    which sum in another order and are slower (``cornerCPoolRes10``: 12
    clips took 2374 ms where 24 took 257 ms, ``profile_serve.py``; 6
    clips 1772 ms, padded 258 ms; 35 clips 2304 ms, and rows other than
    two padded shards', ``chip_smoke.py`` phase 11 (e)); in multiples of
    24 a clip's rows are those of any other multiple, so a slide gets the
    same detections whole, in bands, over a mesh and through the
    host-tiled path.

    ``mesh``: a list of devices (the JAX analyzer's ``data`` mesh axis;
    ``serve --mesh`` and ``test --mesh`` pass every visible card). The
    slide is uploaded to and tiled on ``mesh[0]`` once; its clips are
    padded with blank clips to a multiple of the mesh's length and split
    in order, shard i copied to ``mesh[i]``; a distinct device gets its
    own copy of the model. Every shard's copy is queued before any
    shard's forward: PyTorch runs a copy between cards on the source
    card's stream, so a copy queued after shard 0's forward would wait
    for it, and the shards would run in turn. Every forward and decode is
    queued before any rows are read back, then the rows are concatenated
    and cut to the slide's clips. A device may be named more than once
    (two shards on one card). It excludes streaming: a slide that
    ``max_resident_clips`` would stream raises the JAX analyzer's
    error."""
    device = wrapper.device
    contract = wrapper.contract
    clip_h, clip_v, pad_lr, pad_tb = slide_geometry(width, height)
    batch_axis = _batch_axis(contract)
    if bounds == "slide":
        bounds = (width, height)
    n_clips = clip_h * clip_v
    streaming = bool(max_resident_clips and n_clips > max_resident_clips)
    if streaming and mesh is not None:
        raise ValueError("max_resident_clips and mesh are mutually "
                         "exclusive (shard OR stream, not both)")

    def upload(host: np.ndarray, dev: torch.device = device
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(host tensor, device tensor) of a uint8 array: from pinned
        memory without a wait on the card, so the copy queues behind the
        work already there; the caller keeps both until the rows that
        depend on them are read."""
        src = torch.from_numpy(np.require(host, requirements=["C", "W"]))
        if dev.type != "cuda":
            return src, src
        src = src.pin_memory()
        return src, src.to(dev, non_blocking=True)

    def padded_rows(model: Callable, clips: torch.Tensor) -> torch.Tensor:
        """``model``'s rows of ``clips``, run padded with blank clips to a
        multiple of ``BATCH_SIZE``."""
        n = clips.shape[0]
        if n % BATCH_SIZE:
            clips = torch.cat([clips, clips.new_zeros(
                (-n % BATCH_SIZE, *clips.shape[1:]))])
        rows = model(clips)
        return rows[:n] if batch_axis == 0 else rows[:, :n]

    def finish(inflight) -> List[List[float]]:
        rows = inflight[0]
        if isinstance(rows, list):  # a mesh's shards, cut to the slide
            rows = np.concatenate([r.cpu().numpy() for r in rows],
                                  axis=batch_axis)
            rows = rows[:n_clips] if batch_axis == 0 else rows[:, :n_clips]
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        detections = stitch_any(rows, contract, clip_h, clip_v, pad_lr,
                                pad_tb, bounds)
        if dedupe_radius is not None:
            detections = dedupe_contract(detections, dedupe_radius, contract)
        return detections

    if streaming:
        bands = band_plan(clip_h, clip_v, max_resident_clips)

        def dispatch(gray: np.ndarray):
            gray = coerce_gray_u8(gray)
            parts: List[np.ndarray] = []
            pending = None
            for x0, n_cols in bands:
                host, band = upload(extract_padded_band(gray, x0, n_cols,
                                                        pad_lr, pad_tb))
                with torch.inference_mode():
                    rows = padded_rows(wrapper, _cut_clips(band, n_cols,
                                                           clip_v))
                if pending is not None:
                    parts.append(pending[0].cpu().numpy())
                pending = (rows, host, band)
            parts.append(pending[0].cpu().numpy())
            return (np.concatenate(parts, axis=batch_axis),)

        def many(grays) -> List[List[List[float]]]:
            return [finish(dispatch(g)) for g in grays]

    elif mesh is not None:
        devices = [torch.device(d) for d in mesh]
        copies = {device: wrapper}  # one model copy per distinct device
        for dev in devices:
            if dev not in copies:
                copies[dev] = make_wrapper(copy.deepcopy(wrapper.model)
                                           .to(dev), contract)
        tiler = make_device_tiler(width, height, devices[0])
        per = -(-n_clips // len(devices))  # clips a shard, padded

        def dispatch(gray: np.ndarray):
            host, gray_dev = upload(coerce_gray_u8(gray), devices[0])
            with torch.inference_mode():
                clips = tiler(gray_dev)
                shards = []
                for i, dev in enumerate(devices):
                    shard = clips[i * per:(i + 1) * per]
                    if shard.shape[0] < per:  # blank clips to the shard size
                        shard = torch.cat([shard, shard.new_zeros(
                            (per - shard.shape[0], *shard.shape[1:]))])
                    shards.append(shard.to(dev, non_blocking=True))
                rows = [padded_rows(copies[dev], shard)
                        for dev, shard in zip(devices, shards)]
            return (rows, [host, gray_dev, clips])

    else:
        tiler = make_device_tiler(width, height, device)

        def dispatch(gray: np.ndarray):
            host, gray_u8 = upload(coerce_gray_u8(gray))
            with torch.inference_mode():
                return padded_rows(wrapper, tiler(gray_u8)), host, gray_u8

    if not streaming:
        def many(grays) -> List[List[List[float]]]:
            """Every slide's upload and device work queued before any
            rows come back, so the card runs slide i + 1 while the host
            stitches slide i; ``grays`` may be a generator that reads
            each slide as it is asked for."""
            inflight = [dispatch(g) for g in grays]
            return [finish(f) for f in inflight]

    def analyse(gray: np.ndarray) -> List[List[float]]:
        return finish(dispatch(gray))

    analyse.dispatch = dispatch
    analyse.finish = finish
    analyse.many = many
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
