"""Pooling and unpooling layer factories.

Counterpart of ``scd_resnet_tpu/models/pooling.py`` (reference
models/backbones/pooling.py:27-53), returning ``nn.Module``s on
channels-first tensors: ``PoolingType``/``UpsampleType``, the fixed-scale
``pooling_layer``, the target-size ``adaptive_pooling_layer`` (torch's
bins, ``[floor(i in / out), ceil((i + 1) in / out))``, as the JAX
factory reproduces them) and ``unpooling_layer``. The reference models
only build MaxPool(k = s = 2) and nearest upsampling
(hourglass.py:46,58); the other modes are the factories' public surface.

``unpooling_layer`` follows the JAX factory, not ``nn.Upsample``: an
integer nearest scale repeats pixels; every other mode is
``jax.image.resize``'s, with half-pixel centres, ``linear``/
``bilinear``/``trilinear`` the triangle kernel (which is torch's
``align_corners=False`` when upsampling) and ``bicubic`` the Keys
a = -0.5 kernel (torch's is a = -0.75), each axis a matrix of weights
normalised over the taps inside the input.

camelCase aliases mirror the reference's spelling.
"""

from __future__ import annotations

from enum import Enum
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn


class PoolingType(Enum):
    """models/backbones/pooling.py:27-29 (values kept)."""

    MaximalPool = 0
    AveragePool = 2


class UpsampleType(Enum):
    """models/backbones/pooling.py:31-36 (torch's mode names)."""

    NearestNeighbour = "nearest"
    Linear = "linear"
    Bilinear = "bilinear"
    Trilinear = "trilinear"
    Bicubic = "bicubic"


def pooling_layer(scale_factor: int = 2,
                  downsample_type: PoolingType = PoolingType.MaximalPool,
                  width: Optional[int] = None,
                  height: Optional[int] = None) -> nn.Module:
    """k = s = ``scale_factor`` max or average pool
    (models/backbones/pooling.py:39-44; ``width``/``height`` are accepted
    and unused, as in the reference)."""
    del width, height
    if downsample_type == PoolingType.MaximalPool:
        return nn.MaxPool2d(scale_factor, scale_factor)
    if downsample_type == PoolingType.AveragePool:
        return nn.AvgPool2d(scale_factor, scale_factor)
    raise ValueError(f"unknown pooling type: {downsample_type}")


def adaptive_pooling_layer(output_width: int, output_height: int,
                           downsample_type: PoolingType =
                           PoolingType.MaximalPool) -> nn.Module:
    """Adaptive max or average pool to (output_height, output_width)
    (models/backbones/pooling.py:45-49)."""
    size = (output_height, output_width)
    if downsample_type == PoolingType.MaximalPool:
        return nn.AdaptiveMaxPool2d(size)
    if downsample_type == PoolingType.AveragePool:
        return nn.AdaptiveAvgPool2d(size)
    raise ValueError(f"unknown pooling type: {downsample_type}")


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """jax.image's Keys cubic kernel, a = -0.5."""
    x = np.abs(x)
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0,
                   ((1.5 * x - 2.5) * x) * x + 1.0)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int,
                    kernel: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
    """(n_out, n_in) float32 weights of one axis, as
    ``jax.image.scale_and_translate`` builds them for an upscale: the
    kernel at the half-pixel source position of each output, normalised
    over the taps, zero for a position outside [-0.5, n_in - 0.5]."""
    sample = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(
        n_in / n_out) - 0.5
    w = kernel(sample[:, None] - np.arange(n_in, dtype=np.float32)[None, :])
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0).astype(np.float32)


class Unpool(nn.Module):
    """Upsample the last ``rank`` axes of a (N, C, *spatial) tensor by
    ``scale_factor`` (models/backbones/pooling.py:51-52)."""

    def __init__(self, scale_factor, mode: UpsampleType, rank: int):
        super().__init__()
        self.scale_factor, self.mode, self.rank = scale_factor, mode, rank

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != self.rank + 2:
            raise ValueError(
                f"{self.mode.value} upsample expects rank-{self.rank + 2} "
                f"channels-first input, got shape {tuple(x.shape)}")
        for axis in range(2, 2 + self.rank):
            n_in = x.shape[axis]
            n_out = int(n_in * self.scale_factor)
            if self.mode == UpsampleType.NearestNeighbour:
                if n_out == n_in * int(self.scale_factor):
                    x = x.repeat_interleave(int(self.scale_factor), dim=axis)
                else:
                    src = np.floor((np.arange(n_out) + 0.5) * n_in / n_out)
                    x = x.index_select(axis, torch.from_numpy(
                        src.astype(np.int64)).to(x.device))
                continue
            kernel = _keys_cubic if self.mode == UpsampleType.Bicubic \
                else _triangle
            w = torch.from_numpy(_resize_weights(n_in, n_out, kernel)).to(
                x.device, x.dtype)
            x = torch.movedim(torch.movedim(x, axis, -1) @ w.T, -1, axis)
        return x


def unpooling_layer(scale_factor=2,
                    upsample_type: UpsampleType =
                    UpsampleType.NearestNeighbour) -> nn.Module:
    """``nn.Upsample(scale_factor, mode)``'s counterpart: NCW for
    ``linear``, NCDHW for ``trilinear``, NCHW for the 2-D modes; another
    rank raises ``ValueError``."""
    rank = {UpsampleType.Linear: 1,
            UpsampleType.Trilinear: 3}.get(upsample_type, 2)
    return Unpool(scale_factor, upsample_type, rank)


# the reference's spelling
poolingLayer = pooling_layer
adaptivePoolingLayer = adaptive_pooling_layer
unpoolingLayer = unpooling_layer
