"""Gaussian heatmap labels: one truncated-center Gaussian per object.

Counterpart of ``scd_resnet_tpu/ops/gaussian.render_heatmap`` (reference
datasets/scds/scdx16p100.py:514-531, ``drawGaussian`` 575-591), batched
over B. Per object: integer-truncated center, radius
``center_threshold_radius(2|maj|, 2 minL, iou)``, box half-width
``ceil(2r)``, ``exp(-(dx^2 + dy^2) / (2 sigma^2))`` with ``sigma = r/3``,
summed over the objects and clamped to 1, so every center is exactly 1.0
(the focal loss selects positives with ``gt == 1.0``).

:func:`render_heatmap` is the wrapper of the CUDA kernel
``csrc/render_heatmap.cu``, the port of the TPU kernel
``render_heatmap_pallas``, in two variants: the center heatmap and the
corner heatmaps (``corner_threshold_radius``, corners at the centers plus
an offset). For a CUDA tensor it launches the kernel or raises; for a
CPU tensor it computes :func:`render_heatmap_plain`. The plain version
adds the objects in order k = 0..K-1, as the kernel and the Pallas
kernel do, so that on the card the two agree to the bit.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.ops.radius import (
    center_threshold_radius,
    corner_threshold_radius,
    div_rn,
    sqrt_rn,
)

KERNEL_SOURCE = "render_heatmap.cu"
KERNEL_NAME = "render_heatmap"  # counts the center variant's launches
CORNER_KERNEL_NAME = "render_heatmap_corner"  # and the corner variant's
MAX_OBJECTS = 2048  # the kernel stages K records in shared memory
for _name in (KERNEL_NAME, CORNER_KERNEL_NAME):
    cuda_build.LAUNCHES.setdefault(_name, 0)


class Geometry(NamedTuple):
    """Per object, (B, K) each: the truncated center, whether it is a real
    object on the map, its box half-width ``ceil(2r)`` and ``2 sigma^2``."""
    cx: torch.Tensor
    cy: torch.Tensor
    mask: torch.Tensor
    roi: torch.Tensor
    two_sigma_sq: torch.Tensor


def object_geometry(locs: torch.Tensor, valid: torch.Tensor, size: int,
                    iou_threshold: float = 0.5,
                    radius_fn: Optional[Callable] = None,
                    position_offset: Optional[torch.Tensor] = None
                    ) -> Geometry:
    """What the render derives from each object before it stamps, in the
    float32 operations the kernel repeats (arguments as
    :func:`render_heatmap_plain`)."""
    locs = locs.to(torch.float32)
    px, py = locs[..., 0], locs[..., 1]
    if position_offset is not None:
        px = px + position_offset[..., 0]
        py = py + position_offset[..., 1]
    cx, cy = torch.trunc(px), torch.trunc(py)
    mask = valid.bool() & (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size)

    majx, majy = locs[..., 4], locs[..., 5]
    width = 2.0 * sqrt_rn(majx * majx + majy * majy)
    height = 2.0 * locs[..., 6]
    solver = radius_fn if radius_fn is not None else center_threshold_radius
    radius = solver(width, height, iou_threshold)
    # degenerate and masked lanes get radius 1 so they make no NaN
    radius = torch.where(mask & (radius > 0), radius, torch.ones_like(radius))
    sigma = div_rn(radius, 3.0)
    return Geometry(cx, cy, mask, torch.ceil(radius * 2.0),
                    2.0 * sigma * sigma)


def render_heatmap_plain(locs: torch.Tensor, valid: torch.Tensor, size: int,
                         iou_threshold: float = 0.5,
                         radius_fn: Optional[Callable] = None,
                         position_offset: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(B, K, 8) loc records ``[ctX, ctY, offX, offY, majX, majY, minL,
    halo]`` in heatmap coordinates and a (B, K) mask of real objects ->
    (B, size, size) float32 heatmap, in plain PyTorch.

    ``radius_fn`` defaults to ``center_threshold_radius``;
    ``position_offset`` (B, K, 2) moves the centers before stamping (the
    corner heatmaps)."""
    b, k = locs.shape[:2]
    cx, cy, mask, roi, two_sigma_sq = object_geometry(
        locs, valid, size, iou_threshold, radius_fn, position_offset)

    grid = torch.arange(size, dtype=torch.float32, device=locs.device)
    acc = torch.zeros((b, size, size), dtype=torch.float32,
                      device=locs.device)
    for i in range(k):
        dx = grid[None, None, :] - cx[:, i, None, None]  # (B, 1, S)
        dy = grid[None, :, None] - cy[:, i, None, None]  # (B, S, 1)
        gauss = torch.exp(-(dx * dx + dy * dy)
                          / two_sigma_sq[:, i, None, None])
        r = roi[:, i, None, None]
        box = (dx.abs() <= r) & (dy.abs() <= r) & mask[:, i, None, None]
        acc = acc + torch.where(box, gauss, torch.zeros_like(gauss))
    return torch.minimum(acc, torch.ones_like(acc))


def library() -> ctypes.CDLL:
    """The kernel's library, built on first use: ``render_heatmap_f32(locs,
    valid_u8, offsets, heat, B, K, S, iou_threshold, stream)`` returns a
    CUDA error code and launches uncounted (for timing the kernel alone);
    ``offsets`` is None for the center heatmap, else the (B, K, 2)
    corner offsets, which select the corner radius."""
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.render_heatmap_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def render_heatmap(locs: torch.Tensor, valid: torch.Tensor, size: int,
                   iou_threshold: float = 0.5,
                   radius_fn: Optional[Callable] = None,
                   position_offset: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Heatmaps of a batch, (B, K, 8) float32 + (B, K) -> (B, S, S), as
    :func:`render_heatmap_plain`.

    The kernel renders the center heatmap (``radius_fn`` None or
    ``center_threshold_radius``, no offset) and the corner heatmaps
    (``corner_threshold_radius``, ``position_offset`` (B, K, 2) float32
    or none); it refuses any other radius on a card."""
    if locs.dim() != 3 or locs.shape[-1] != 8:
        raise ValueError("render_heatmap takes (B, K, 8) locs, got shape {}"
                         .format(tuple(locs.shape)))
    if valid.shape != locs.shape[:2]:
        raise ValueError("valid must be (B, K) = {}, got {}".format(
            tuple(locs.shape[:2]), tuple(valid.shape)))
    if locs.dtype != torch.float32:
        raise TypeError("render_heatmap takes float32 locs, got {}"
                        .format(locs.dtype))
    if position_offset is not None and (
            position_offset.shape != (*locs.shape[:2], 2)
            or position_offset.dtype != torch.float32):
        raise ValueError("position_offset must be (B, K, 2) float32, got "
                         "{} {}".format(tuple(position_offset.shape),
                                        position_offset.dtype))
    if locs.device.type == "cpu":
        return render_heatmap_plain(locs, valid, size, iou_threshold,
                                    radius_fn, position_offset)
    if locs.device.type != "cuda" or valid.device != locs.device or (
            position_offset is not None
            and position_offset.device != locs.device):
        raise ValueError("render_heatmap runs on cuda or cpu; locs on {}, "
                         "valid on {}".format(locs.device, valid.device))
    corner = radius_fn is corner_threshold_radius
    if not corner and (radius_fn not in (None, center_threshold_radius)
                       or position_offset is not None):
        raise ValueError("the render kernel takes the center radius without "
                         "offsets or the corner radius")
    b, k = locs.shape[:2]
    if k > MAX_OBJECTS:
        raise ValueError("render_heatmap takes at most {} objects per clip, "
                         "got {}".format(MAX_OBJECTS, k))
    locs = locs.contiguous()
    valid_u8 = valid.to(torch.uint8).contiguous()
    offsets = None
    if corner:
        offsets = (position_offset.contiguous() if position_offset is not None
                   else torch.zeros((b, k, 2), device=locs.device))
    heat = torch.empty((b, size, size), dtype=torch.float32,
                       device=locs.device)
    if heat.numel() == 0:
        return heat
    lib = library()
    with torch.cuda.device(locs.device):
        stream = torch.cuda.current_stream(locs.device).cuda_stream
        status = lib.render_heatmap_f32(
            locs.data_ptr(), valid_u8.data_ptr(),
            offsets.data_ptr() if corner else None, heat.data_ptr(), b, k,
            size, float(iou_threshold), stream)
    cuda_build.check(lib, status, "render_heatmap_f32")
    cuda_build.count_launch(CORNER_KERNEL_NAME if corner else KERNEL_NAME)
    return heat
