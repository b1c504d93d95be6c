"""The training batch transform: augmentation plus label rendering.

Counterpart of ``scd_resnet_tpu/data/pipeline.augment_and_render_batch``
(reference scdx16p100.py:304-379, 416-536), centerOffset branch, NCHW:

- random horizontal/vertical flips with the matching loc-record flips;
- per-clip standardisation, variance jitter, Gaussian pixel noise;
- the tag mask (real and in-bounds objects) and flat heatmap indices;
- the Gaussian heatmap at IoU 0.5 and, with ``corner_targets=True``
  (the corner families), the top-left and bottom-right corner heatmaps
  (corners at the center -/+ (|maj|, minL), the corner radius), all
  rendered by one launch of the K1 kernel
  (``ops/gaussian.render_label_heatmaps``) on a CUDA tensor.

The random draws are an argument (:class:`Draws`), not drawn inside: the
trainer makes them from a per-step ``torch.Generator`` (:func:`draw`),
and the tests hand in the JAX package's own draws.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.ops.augment import (
    flip_locs_horizontal,
    flip_locs_vertical,
    normalize,
)
from scd_resnet_tpu_torch.ops.gaussian import render_label_heatmaps

THRESHOLD_IOU = 0.5  # scdx16p100.py:52


class Draws(NamedTuple):
    """One batch's random draws: flip_h, flip_v (B,) bool; jitter
    (B, 1, 1) and noise (B, S, S) standard normal float32."""

    flip_h: torch.Tensor
    flip_v: torch.Tensor
    jitter: torch.Tensor
    noise: torch.Tensor


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s generator, a function of (seed, step)
    alone, so a resumed run continues the sequence (the JAX trainer's
    ``fold_in(PRNGKey(seed), step)``; the bits differ)."""
    return int(np.random.SeedSequence((int(seed), int(step)))
               .generate_state(1, np.uint64)[0] >> 1)


def draw(generator: torch.Generator, batch: int, size: int,
         device: torch.device) -> Draws:
    """Fair-coin flips, a jitter and a noise field for one batch of
    ``size``-square clips, from ``generator`` (on ``device``)."""
    flips = torch.rand((2, batch), generator=generator, device=device) < 0.5
    jitter = torch.randn((batch, 1, 1), generator=generator, device=device)
    noise = torch.randn((batch, size, size), generator=generator,
                        device=device)
    return Draws(flips[0], flips[1], jitter, noise)


def identity_draws(batch: int, size: int, device: torch.device) -> Draws:
    """Draws that change nothing: no flips, zero jitter and noise
    (``x * (1 + 0) + 0`` is ``x`` exactly)."""
    no = torch.zeros(batch, dtype=torch.bool, device=device)
    return Draws(no, no, torch.zeros((batch, 1, 1), device=device),
                 torch.zeros((batch, size, size), device=device))


def augment_and_render_batch(samples: torch.Tensor, locs: torch.Tensor,
                             counts: torch.Tensor, heat_size: int,
                             augment: bool = True, draws: Draws = None,
                             noise_sv: float = 0.05, jitter_sv: float = 0.05,
                             corner_targets=False
                             ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Raw clips + loc records -> the training arrays.

    Args:
      samples: (B, S, S) raw clips, any float or uint8 dtype.
      locs: (B, K, 8) loc records in heatmap coordinates.
      counts: (B,) real object counts.
      heat_size: heatmap side (S // 4).
      augment: flips, jitter and noise from ``draws`` (training); plain
        standardisation when False (validation).

    Returns ``xs`` (B, 1, S, S) and ``ys = [heat (B, 1, Hs, Hs), tag_mask
    (B, K) bool, regr (B, K, 6), indices (B, K) int64]``, the dataset
    contract (scdx16p100.py:363-379) in NCHW; with ``corner_targets``
    ``ys`` adds ``tl`` and ``br`` (B, 1, Hs, Hs).
    """
    if corner_targets == "legacy":
        raise NotImplementedError(
            "legacy corner targets come with the cornerLegacy port (slice 7)")
    b, k = locs.shape[:2]
    samples = samples.to(torch.float32)
    locs = locs.to(torch.float32)
    present = torch.arange(k, device=locs.device)[None, :] < counts[:, None]

    if augment:
        if draws is None:
            raise ValueError("augment=True needs the batch's draws")
        flip_h = draws.flip_h[:, None, None]
        flip_v = draws.flip_v[:, None, None]
        samples = torch.where(flip_h, samples.flip(2), samples)
        samples = torch.where(flip_v, samples.flip(1), samples)
        locs = torch.where(flip_h, flip_locs_horizontal(locs, heat_size), locs)
        locs = torch.where(flip_v, flip_locs_vertical(locs, heat_size), locs)

    samples = normalize(samples)
    if augment:
        samples = samples * (1.0 + jitter_sv * draws.jitter)
        samples = samples + draws.noise * noise_sv

    cx, cy = locs[:, :, 0], locs[:, :, 1]
    tag_mask = present & (cx >= 0) & (cx < heat_size) & (cy >= 0) \
        & (cy < heat_size)
    indices = (torch.floor(cy) * heat_size + torch.floor(cx)).to(torch.int64)
    indices = torch.where(tag_mask, indices, torch.zeros_like(indices))

    regr = locs[:, :, 2:8]
    # the JAX branch masks the corners with ``present`` alone: a corner in
    # (-1, 0) truncates to 0 and is stamped there
    maps = render_label_heatmaps(locs, present, heat_size,
                                 bool(corner_targets), THRESHOLD_IOU)
    ys = [maps[0][:, None], tag_mask, regr, indices]
    if corner_targets:
        ys += [maps[1][:, None], maps[2][:, None]]
    return samples[:, None], ys
