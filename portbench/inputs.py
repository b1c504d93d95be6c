"""The benchmark's inputs, made from the run's seed.

- :func:`slide`: a uint8 grayscale slide, a noisy bright field with
  :func:`blobs` dark elliptic blobs about the size of sperm heads, one
  per ``BLOB_AREA`` pixels (a frozen copy of the port's
  ``infer/synthetic.synthetic_slide``);
- :func:`train_pool`: training clips and their loc records on the device:
  uint8 noise clips and 1 to ``max_objects`` objects a clip (centres 40
  pixels from the border, semi-axes 10-24 and 6-major full-resolution
  pixels at any angle, halo radii a few heat-map pixels beyond the minor
  axis), in the layout ``[ctX, ctY, offX, offY, majX, majY, minL, halo]``
  at heat-map scale (after the port's ``profile_kernels.render_batch``).

Each slide and the pool take their own generator from (seed, index), so
the same seed gives the same inputs.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch


def sub_seed(seed: int, *index: int) -> int:
    """A 63-bit seed of (seed, index...), for a generator of its own."""
    return int(np.random.SeedSequence((int(seed) % (2 ** 64), *index))
               .generate_state(1, np.uint64)[0] >> 1)


BLOB_AREA = 6000


def blobs(height: int, width: int) -> int:
    """The blobs that :func:`slide` places on a slide of that size."""
    return height * width // BLOB_AREA


def slide(height: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.normal(200.0, 12.0, (height, width)).astype(np.float32)
    yy, xx = np.mgrid[-16:17, -16:17]
    for _ in range(blobs(height, width)):
        cy, cx = rng.integers(16, height - 16), rng.integers(16, width - 16)
        ry, rx = rng.uniform(6, 16, 2)
        mask = (yy / ry) ** 2 + (xx / rx) ** 2 <= 1.0
        img[cy - 16:cy + 17, cx - 16:cx + 17][mask] -= rng.uniform(60, 120)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def train_pool(clips: int, size: int, max_objects: int, seed: int,
               device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(samples uint8 (P, S, S), locs float32 (P, K, 8), counts int64 (P,))
    on ``device``; K = ``max_objects``, the first ``counts`` real."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))

    def uniform(*shape):
        return torch.rand(shape, device=device, generator=gen)

    k = max_objects
    locs = torch.zeros((clips, k, 8), device=device)
    center = 40 + (size - 80) * uniform(clips, k, 2)
    locs[..., 0:2] = torch.floor(center / 4)
    locs[..., 2:4] = center - 4 * locs[..., 0:2]
    major = 10 + 14 * uniform(clips, k)
    minor = 6 + (major - 6) * uniform(clips, k)
    angle = math.pi * uniform(clips, k)
    locs[..., 4] = major * torch.cos(angle) / 4
    locs[..., 5] = major * torch.sin(angle) / 4
    locs[..., 6] = minor / 4
    locs[..., 7] = (minor + 4 + 26 * uniform(clips, k)) / 4
    counts = torch.randint(1, k + 1, (clips,), device=device, generator=gen)
    samples = torch.randint(0, 256, (clips, size, size), device=device,
                            generator=gen, dtype=torch.uint8)
    return samples, locs, counts
