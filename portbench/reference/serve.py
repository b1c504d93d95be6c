"""The plain reference of a served slide: tiling, standardisation,
forward, decode, stitch and Rhr, after the reference's ``test.py``.

- The slide is padded to ``clip_h x clip_v`` clips of 512 at stride
  512 - 2 * 64, reflected without repeating the edge on y and with it on
  x, and cut x-major, then y;
- each clip is standardised by its own mean and population variance
  (worked out in float64 from the integer pixels, rounded to float32), a
  constant clip to zeros;
- the clips go through the model in blocks, in float32;
- the heat maps pass a sigmoid, a 3x3 peak suppression and a top 100; a
  peak is kept above the 0.3 threshold and inside the slide, at
  ``trunc(clip_x * 384 - pad_x + x * 4 + offset_x)``;
- the configuration's family (``reference/<family>.py``) decodes its
  heads' rows and makes its answers from them.

Detections come clip by clip, each clip's in descending score.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.model import family as family_module
from portbench.reference.model import float32_math, identity

CLIP = 512
MARGIN = 64
STRIDE = CLIP - 2 * MARGIN
RATIO = 4
THRESHOLD = 0.3
TOP_K = 100


def geometry(width: int, height: int):
    """(clip_h, clip_v, pad_x, pad_y) of a width x height slide."""
    clip_h = math.ceil((width - 2 * MARGIN) / STRIDE)
    clip_v = math.ceil((height - 2 * MARGIN) / STRIDE)
    full_w = STRIDE * clip_h + 2 * MARGIN
    full_h = STRIDE * clip_v + 2 * MARGIN
    full_w += (full_w - width) % 2
    full_h += (full_h - height) % 2
    return clip_h, clip_v, (full_w - width) // 2, (full_h - height) // 2


def clips(gray: np.ndarray) -> np.ndarray:
    """(N, 512, 512) float32 standardised clips, x-major then y."""
    height, width = gray.shape
    clip_h, clip_v, pad_x, pad_y = geometry(width, height)
    padded = np.pad(gray, ((pad_y, pad_y), (0, 0)), mode="reflect")
    padded = np.pad(padded, ((0, 0), (pad_x, pad_x)), mode="symmetric")
    out = np.empty((clip_h * clip_v, CLIP, CLIP), np.float32)
    i = 0
    for x in range(clip_h):
        for y in range(clip_v):
            clip = padded[y * STRIDE:y * STRIDE + CLIP,
                          x * STRIDE:x * STRIDE + CLIP].astype(np.float64)
            mean = np.float32(clip.mean())
            var = np.float32(clip.var())
            if var > 0:
                out[i] = (clip.astype(np.float32) - mean) / np.sqrt(var)
            else:
                out[i] = 0.0
            i += 1
    return out


def peaks(logits: torch.Tensor):
    """Sigmoid, 3x3 peak suppression, top 100: (scores, index, y, x),
    each (B, K)."""
    heat = torch.sigmoid(logits.float())
    peak = F.max_pool2d(heat, 3, stride=1, padding=1)
    heat = torch.where(peak == heat, heat, torch.zeros_like(heat))
    b, _, h, w = heat.shape
    scores, index = torch.topk(heat.reshape(b, -1), TOP_K)
    return scores, index, torch.div(index, w, rounding_mode="floor"), index % w


def gather(feature: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) at (B, K) flat indices -> (B, K, C)."""
    b, c = feature.shape[:2]
    flat = feature.reshape(b, c, -1)
    return flat.gather(2, index[:, None, :].expand(b, c, index.shape[1])
                       ).permute(0, 2, 1)


def rows(model: torch.nn.Module, quantize: Callable, batch: np.ndarray,
         family: str, device: torch.device) -> List[np.ndarray]:
    """The decoded per-clip rows of one block of clips, float64 on the
    host, a part for each of the family's decoded heads."""
    with torch.no_grad():
        out = model(torch.from_numpy(batch[:, None]).to(device), quantize)
        parts = family_module(family).decode(out)
    return [np.stack([t.double().cpu().numpy() for t in p]) for p in parts]


def analyse(model: torch.nn.Module, gray: np.ndarray, family: str,
            device: torch.device, block: int = 16,
            quantize: Callable = identity) -> List[list]:
    """The detections of one uint8 slide (module docstring)."""
    height, width = gray.shape
    clip_h, clip_v, pad_x, pad_y = geometry(width, height)
    stack = clips(gray)
    model.eval()
    with float32_math():
        blocks = [rows(model, quantize, stack[i:i + block], family, device)
                  for i in range(0, len(stack), block)]
    parts = [np.concatenate([b[h] for b in blocks], axis=1)
             for h in range(len(blocks[0]))]
    g = np.arange(clip_h * clip_v)
    grid_x, grid_y = (g // clip_v)[:, None], (g % clip_v)[:, None]
    return family_module(family).answers(
        parts, grid_x * STRIDE - pad_x, grid_y * STRIDE - pad_y, width,
        height)
