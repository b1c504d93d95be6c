"""Gaussian radius from an IoU threshold (counterpart of
``scd_resnet_tpu/ops/radius.py``, reference evaluations/intersection.py:40-64).

The reference, and so the JAX package, takes each quadratic root as
``(b + sqrt(b^2 - 4ac)) / 2``, without the division by ``2a`` of the
textbook formula (the public CornerNet quirk, PARITY.md §2.7). The labels
depend on it, so it is kept exactly, and every float32 operation runs in
the JAX function's order: ``csrc/render_heatmap.cu`` repeats the same
sequence on the card.
"""

from __future__ import annotations

import torch


def _f32(value) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, as XLA's and CUDA's
    ``sqrtf``: PyTorch's vectorised CPU sqrt is off by an ulp on about
    one input in 150; through float64 the result rounds exactly once."""
    return torch.sqrt(x.double()).to(torch.float32)


def div_rn(numerator, denominator) -> torch.Tensor:
    """``numerator / denominator`` as one IEEE float32 division where one
    side is a Python number: PyTorch computes ``number / tensor`` as
    ``reciprocal(tensor) * number``, and on CUDA ``tensor / number`` as
    ``tensor * (1 / number)``, each of which rounds twice."""
    if not isinstance(numerator, torch.Tensor):
        numerator = torch.full_like(denominator, numerator)
    elif not isinstance(denominator, torch.Tensor):
        denominator = torch.full_like(numerator, denominator)
    return numerator / denominator


def corner_threshold_radius(width, height, threshold: float = 0.7
                            ) -> torch.Tensor:
    """Radius bound for corner heatmaps (intersection.py:40-44)."""
    width, height = _f32(width), _f32(height)
    sum_sq = width * width + height * height
    prod = width * height
    return ((2 * sqrt_rn(sum_sq) / prod)
            - sqrt_rn(4 * sum_sq / (prod * prod)
                         - div_rn(16 * (1 - threshold), sum_sq))) \
        / div_rn(8, sum_sq)


def center_threshold_radius(width, height, threshold: float = 0.7
                            ) -> torch.Tensor:
    """Radius bound for center heatmaps (intersection.py:46-64): the
    least of the three overlap cases' roots."""
    width, height = _f32(width), _f32(height)

    b1 = height + width
    c1 = div_rn(width * height * (1 - threshold), 1 + threshold)
    r1 = (b1 + sqrt_rn(b1 * b1 - 4 * c1)) / 2

    b2 = 2 * (height + width)
    c2 = (1 - threshold) * width * height
    r2 = (b2 + sqrt_rn(b2 * b2 - 16 * c2)) / 2

    b3 = -2 * threshold * (height + width)
    c3 = (threshold - 1) * width * height
    r3 = (b3 + sqrt_rn(b3 * b3 - 4 * (4 * threshold) * c3)) / 2

    return torch.minimum(torch.minimum(r1, r2), r3)
