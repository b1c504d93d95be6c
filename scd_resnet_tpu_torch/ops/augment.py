"""Image augmentation: standardisation, noise, flips and rotation.

Counterpart of ``scd_resnet_tpu/ops/augment.py`` (reference
datasets/argumentations.py). Images are (..., H, W) tensors; a stochastic
function takes a ``torch.Generator`` where the JAX one takes a key, so
the draws (not the distributions) differ from JAX's.

:func:`rotate` takes an angle or a tensor of angles: the result's batch
shape is the image's batch shape broadcast against the angles', so one
call rotates one padded slide by all of preprocessing's angles, as
``jax.vmap(rotate)`` does there. The source coordinates are computed in
the JAX function's float32 operations and order, and clipped before the
gather. XLA's and PyTorch's float32 ``sin``/``cos`` differ in the last
bit for some angles, so a rotated image agrees with JAX's within a bound
that grows with the distance from the rotation centre, not to the bit.

The diagonal pad is an index gather (``ops/image.reflect_index``), as
``jnp.pad`` reflects as often as a pad needs, where ``F.pad`` refuses a
reflect pad as wide as the image.
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.ops.image import reflect_index

# float32(pi / 180), the factor of jnp.deg2rad on a float32 angle
_DEG2RAD = np.float32(np.pi / 180.0)
# np.pad's mode names -> reflect_index's
_INDEX_MODES = {"reflect": "reflect101", "symmetric": "symmetric",
                "edge": "edge"}


class PaddingMode(enum.Enum):
    """Padding of a rotation (argumentations.py:98-102); the values are
    ``np.pad`` mode names (torch 'replicate' is numpy 'edge')."""

    ConstantPadding = "constant"
    MirrorPadding = "reflect"
    ReplicatePadding = "edge"


class ResampleMode(enum.Enum):
    """Resampling of a rotation (argumentations.py:103-106)."""

    NearestNeighbour = "nearest"
    Bilinear = "bilinear"
    Bicubic = "bicubic"


def _mode_value(mode, default):
    if mode is None:
        return default
    return getattr(mode, "value", mode)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """Standardise each image of an (..., H, W) stack to zero mean and
    unit population variance, with no epsilon (reference
    argumentations.py:40-44). A constant image maps to zeros instead of
    0/0 = NaN."""
    images = images.to(torch.float32)
    mean = images.mean(dim=(-2, -1), keepdim=True)
    centred = images - mean
    var = centred.square().mean(dim=(-2, -1), keepdim=True)
    safe_var = torch.where(var > 0, var, torch.ones_like(var))
    return torch.where(var > 0, centred / torch.sqrt(safe_var),
                       torch.zeros_like(images))


def uniform_noise(generator: torch.Generator, image: torch.Tensor,
                  stdvar: float = 0.05) -> torch.Tensor:
    """Additive uniform noise, (U[0, 1) - 0.5) * 12 stdvar
    (argumentations.py:47-53)."""
    u = torch.rand(image.shape, generator=generator, device=image.device)
    return image + (u - 0.5) * (stdvar * 12.0)


def gaussian_noise(generator: torch.Generator, image: torch.Tensor,
                   stdvar: float = 0.05) -> torch.Tensor:
    """Additive N(0, stdvar^2) noise (argumentations.py:55-61)."""
    n = torch.randn(image.shape, generator=generator, device=image.device)
    return image + n * stdvar


def variance_jitter(generator: torch.Generator, image: torch.Tensor,
                    stdvar: float = 0.05) -> torch.Tensor:
    """The whole image times 1 + stdvar N(0, 1) (argumentations.py:63-67)."""
    g = torch.randn((), generator=generator, device=image.device)
    return image * (1.0 + stdvar * g)


def horizontal_flip(image: torch.Tensor) -> torch.Tensor:
    """Flip the width (last) axis (argumentations.py:70-71)."""
    return image.flip(-1)


def vertical_flip(image: torch.Tensor) -> torch.Tensor:
    """Flip the height axis (argumentations.py:74-75)."""
    return image.flip(-2)


def random_flip(generator: torch.Generator, image: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Independent fair-coin horizontal and vertical flips
    (argumentations.py:78-83). Returns ``(image, flip_h, flip_v)`` so that
    a caller can flip the coordinates to match."""
    flip_h, flip_v = torch.rand(2, generator=generator,
                                device=image.device) < 0.5
    image = torch.where(flip_h, horizontal_flip(image), image)
    image = torch.where(flip_v, vertical_flip(image), image)
    return image, flip_h, flip_v


def horizontal_flip_numpy(arr: np.ndarray) -> np.ndarray:
    """argumentations.py:85-86."""
    return arr[:, ::-1]


def vertical_flip_numpy(arr: np.ndarray) -> np.ndarray:
    """argumentations.py:88-89."""
    return arr[::-1, :]


def random_flip_numpy(arr: np.ndarray,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """argumentations.py:91-96, on the host with a numpy generator."""
    rng = rng or np.random.default_rng()
    if rng.uniform() > 0.5:
        arr = arr[:, ::-1]
    if rng.uniform() > 0.5:
        arr = arr[::-1, :]
    return arr


def flip_locs_horizontal(locs: torch.Tensor, heat_size: int) -> torch.Tensor:
    """Loc records (..., K, 8) under a horizontal image flip
    (scdx16p100.py:424-429): x mirrored on the heatmap grid, the x
    components of the offset and major-axis vectors negated."""
    out = locs.clone()
    out[..., 0] = heat_size - 1 - locs[..., 0]
    out[..., 2] = -locs[..., 2]
    out[..., 4] = -locs[..., 4]
    return out


def flip_locs_vertical(locs: torch.Tensor, heat_size: int) -> torch.Tensor:
    """Loc records under a vertical image flip (scdx16p100.py:430-436)."""
    out = locs.clone()
    out[..., 1] = heat_size - 1 - locs[..., 1]
    out[..., 3] = -locs[..., 3]
    out[..., 5] = -locs[..., 5]
    return out


class _Source:
    """The (..., Hp, Wp) images a rotation samples, read at integer
    coordinates of the output's batch shape: every output image reads its
    own source image through a flat index, so a source shared by many
    angles is never copied."""

    def __init__(self, images: torch.Tensor, batch: torch.Size):
        self.h, self.w = images.shape[-2:]
        self.flat = images.reshape(-1)
        n = int(np.prod(images.shape[:-2], dtype=np.int64))
        base = torch.arange(n, device=images.device) * (self.h * self.w)
        self.base = base.reshape(images.shape[:-2]).expand(batch)[
            ..., None, None]

    def __call__(self, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        return self.flat[self.base + yi.long() * self.w + xi.long()]


def _nearest_sample(src: _Source, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Nearest neighbour (the reference's rotateNearestNeighbour,
    argumentations.py:111-146); rounds half to even, as ``jnp.round``."""
    return src(torch.clamp(torch.round(ys), 0, src.h - 1),
               torch.clamp(torch.round(xs), 0, src.w - 1))


def _bilinear_sample(src: _Source, ys: torch.Tensor, xs: torch.Tensor
                     ) -> torch.Tensor:
    """Bilinear, with the lower corner clipped into the image before the
    weights are taken (the JAX sampler's order)."""
    y0 = torch.clamp(torch.floor(ys), 0, src.h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, src.w - 1)
    y1 = torch.clamp(y0 + 1, 0, src.h - 1)
    x1 = torch.clamp(x0 + 1, 0, src.w - 1)
    wy = ys - y0
    wx = xs - x0
    top = src(y0, x0) * (1 - wx) + src(y0, x1) * wx
    bot = src(y1, x0) * (1 - wx) + src(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _cubic_kernel(t: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5 (the PIL BICUBIC family)."""
    a = -0.5
    at = t.abs()
    w1 = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
    w2 = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
    return torch.where(at <= 1, w1,
                       torch.where(at < 2, w2, torch.zeros_like(at)))


def _bicubic_sample(src: _Source, ys: torch.Tensor, xs: torch.Tensor
                    ) -> torch.Tensor:
    """Bicubic (Keys a = -0.5) over the 4 x 4 neighbours, clamped at the
    edges and normalised by the weights' sum."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    out = torch.zeros_like(ys)
    norm = torch.zeros_like(ys)
    for dy in range(-1, 3):
        wy = _cubic_kernel(ys - (y0 + dy))
        yi = torch.clamp(y0 + dy, 0, src.h - 1)
        for dx in range(-1, 3):
            wx = _cubic_kernel(xs - (x0 + dx))
            xi = torch.clamp(x0 + dx, 0, src.w - 1)
            weight = wy * wx
            out = out + weight * src(yi, xi)
            norm = norm + weight
    return out / norm


_SAMPLERS = {
    "nearest": _nearest_sample,
    "bilinear": _bilinear_sample,
    "bicubic": _bicubic_sample,
}


def _angles(angle_deg, device: torch.device) -> torch.Tensor:
    """Angles in degrees as a float32 tensor on ``device``."""
    return torch.as_tensor(angle_deg, dtype=torch.float32).to(device)


def rotate(image: torch.Tensor, angle_deg, pad_mode="reflect",
           pad_value: float = 0.0, resample="bilinear") -> torch.Tensor:
    """Rotate (..., H, W) images about their centre by ``angle_deg``
    (argumentations.py:149-159): pad to the diagonal radius, resample,
    crop back to (H, W). A feature at p moves to ``R(-angle) (p - c) +
    c`` with pixel centres at integer indices and ``c = (S - 1) / 2``,
    the convention :func:`rotate_coordinates` pairs with.

    ``angle_deg`` is a number or a tensor; the result has the image's
    batch shape broadcast against the angles' shape. ``pad_mode`` and
    ``resample`` take the mode strings or the enums."""
    padded, pl, pt, h, w = _diagonal_pad(image, pad_mode, pad_value)
    return _rotate_sampled(padded, angle_deg, resample, out_shape=(h, w),
                           origin=(pt, pl),
                           center=((h - 1) / 2.0, (w - 1) / 2.0))


def rotate_non_clip(image: torch.Tensor, angle_deg, pad_mode="reflect",
                    pad_value: float = 0.0, resample="bilinear"
                    ) -> Tuple[torch.Tensor, int, int]:
    """Rotate the diagonal-padded frame without cropping back
    (argumentations.py:162-173): ``(rotated_padded, left_padding,
    top_padding)``."""
    padded, pl, pt, h, w = _diagonal_pad(image, pad_mode, pad_value)
    ph, pw = h + 2 * pt, w + 2 * pl
    rotated = _rotate_sampled(padded, angle_deg, resample,
                              out_shape=(ph, pw), origin=(0, 0),
                              center=((ph - 1) / 2.0, (pw - 1) / 2.0))
    return rotated, pl, pt


def random_rotate(generator: torch.Generator, image: torch.Tensor,
                  pad_mode="reflect", pad_value: float = 0.0,
                  resample="bilinear") -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate by a U(0, 90)-degree angle (argumentations.py:175); returns
    ``(rotated, angle_deg)`` so that coordinates can take the same angle."""
    angle = torch.rand((), generator=generator, device=image.device) * 90.0
    return rotate(image, angle, pad_mode, pad_value, resample), angle


def _diagonal_pad(image: torch.Tensor, pad_mode, pad_value: float):
    image = image.to(torch.float32)
    h, w = image.shape[-2:]
    pad_r = math.sqrt(h * h + w * w) / 2.0
    pl = int(math.ceil(pad_r - 0.5 * w))
    pt = int(math.ceil(pad_r - 0.5 * h))
    mode = _mode_value(pad_mode, "reflect")
    if mode == "constant":
        padded = torch.nn.functional.pad(image, (pl, pl, pt, pt),
                                         value=pad_value)
    else:
        mode = _INDEX_MODES.get(mode, mode)
        rows = torch.from_numpy(reflect_index(h, pt, pt, mode)).to(
            image.device)
        cols = torch.from_numpy(reflect_index(w, pl, pl, mode)).to(
            image.device)
        padded = image.index_select(-2, rows).index_select(-1, cols)
    return padded, pl, pt, h, w


def _rotate_sampled(padded: torch.Tensor, angle_deg, resample, out_shape,
                    origin, center) -> torch.Tensor:
    """Inverse-map rotation: sample ``padded`` at the source of every
    destination cell. ``origin`` offsets the destination grid into the
    padded frame; ``center`` is the rotation centre in destination
    coordinates."""
    theta = (_angles(angle_deg, padded.device) * _DEG2RAD)[..., None, None]
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    oh, ow = out_shape
    oy, ox = origin
    cy, cx = center
    ys = torch.arange(oh, dtype=torch.float32,
                      device=padded.device)[:, None] - cy
    xs = torch.arange(ow, dtype=torch.float32,
                      device=padded.device)[None, :] - cx
    # the destination -> source map rotates by +angle
    src_x = cos_t * xs - sin_t * ys + cx + ox
    src_y = sin_t * xs + cos_t * ys + cy + oy
    batch = torch.broadcast_shapes(padded.shape[:-2], theta.shape[:-2])
    src_x = src_x.expand(*batch, oh, ow)
    src_y = src_y.expand(*batch, oh, ow)
    sampler = _SAMPLERS[_mode_value(resample, "bilinear")]
    return sampler(_Source(padded, batch), src_y, src_x)


def _ulp(x: float) -> float:
    """The float32 spacing at magnitude ``x``."""
    return float(np.spacing(np.float32(max(abs(x), 1.0))))


def rotation_tolerance(image: torch.Tensor, angle_deg, pad_mode="reflect",
                       pad_value: float = 0.0, resample="bilinear",
                       clip: bool = True) -> float:
    """The largest difference two float32 rotations of ``image`` (by
    :func:`rotate`, or :func:`rotate_non_clip` when ``clip`` is False)
    may show when their ``cos`` and ``sin`` differ by one ulp, as XLA's
    and PyTorch's, or the CPU's and the card's, may.

    A source coordinate ``cos x - sin y + c + o`` then moves by at most
    ``dsrc = (|x| + |y|) 2^-23 + 5 ulp(M)``: the ulp of cos and sin times
    the destination offsets, and one rounding step of each of its five
    operations at the padded frame's size M. The bilinear sample moves by
    at most ``dsrc`` times the largest neighbour difference D of the
    padded image per axis, times the extrapolation factor ``1 + 2 v`` of
    a coordinate ``v`` pixels beyond the frame (only the unclipped
    rotation reaches beyond it); the Keys kernel's slopes over its four
    taps sum to under 2.5 and meet differences of up to 2 D, so bicubic
    takes 5 times that. Nearest may take a neighbour: D. Four ulps of the
    largest value cover the interpolation's own roundings."""
    padded, pl, pt, h, w = _diagonal_pad(image, pad_mode, pad_value)
    hp, wp = padded.shape[-2:]
    d = max(float((padded[..., 1:, :] - padded[..., :-1, :]).abs().max()),
            float((padded[..., :, 1:] - padded[..., :, :-1]).abs().max()))
    mode = _mode_value(resample, "bilinear")
    if mode == "nearest":
        return d
    oh, ow = (h, w) if clip else (hp, wp)
    theta = np.deg2rad(np.abs(np.asarray(angle_deg, np.float64))).max()
    reach = abs(np.cos(theta)) * (ow - 1) / 2 + abs(np.sin(theta)) * (
        oh - 1) / 2
    reach_y = abs(np.sin(theta)) * (ow - 1) / 2 + abs(np.cos(theta)) * (
        oh - 1) / 2
    over_x = max(0.0, reach - (wp - 1) / 2)
    over_y = max(0.0, reach_y - (hp - 1) / 2)
    dsrc = (ow + oh) / 2 * 2.0 ** -23 + 5 * _ulp(max(hp, wp))
    per_axis = dsrc * d * ((1 + 2 * over_y) + (1 + 2 * over_x))
    if mode == "bicubic":
        per_axis *= 5
    return per_axis + 4 * _ulp(float(padded.abs().max()))


def rotate_coordinates(locs: torch.Tensor, center_x: float, center_y: float,
                       angle_deg) -> torch.Tensor:
    """Rotate object records ``[ctX, ctY, offX, offY, majX, majY, ...]``
    (K, 8) clockwise by ``angle_deg`` about ``(center_x - 0.5, center_y -
    0.5)`` (scdManual.py:236-274 / scdx16p100.py:538-573), in float32.

    Positions and both direction vectors rotate by ``-angle``; zero
    vectors stay zero. ``angle_deg`` may be a tensor of angles: the result
    is then (..., K, 8), one set of records a angle."""
    locs = locs.to(torch.float32)
    a = (-_angles(angle_deg, locs.device) * _DEG2RAD)[..., None]
    cos_a = torch.cos(a)
    sin_a = torch.sin(a)
    # (0.5 - centre) in double, then float32, as JAX's weak-typed scalar
    sx = torch.tensor(np.float32(0.5 - center_x), device=locs.device)
    sy = torch.tensor(np.float32(0.5 - center_y), device=locs.device)

    def rot(x, y):
        return x * cos_a - y * sin_a, y * cos_a + x * sin_a

    rx, ry = rot(locs[:, 0] + sx, locs[:, 1] + sy)
    ox, oy = rot(locs[:, 2], locs[:, 3])
    mx, my = rot(locs[:, 4], locs[:, 5])
    rest = locs[:, 6:].expand(*a.shape[:-1], *locs[:, 6:].shape)
    return torch.cat([torch.stack([rx - sx, ry - sy, ox, oy, mx, my], -1),
                      rest], -1)
