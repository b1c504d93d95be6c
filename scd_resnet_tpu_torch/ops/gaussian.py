"""Gaussian heatmap labels: one truncated-center Gaussian per object.

Counterpart of ``scd_resnet_tpu/ops/gaussian.render_heatmap`` (reference
datasets/scds/scdx16p100.py:514-531, ``drawGaussian`` 575-591), batched
over B. Per object: integer-truncated center, radius
``center_threshold_radius(2|maj|, 2 minL, iou)``, box half-width
``ceil(2r)``, ``exp(-(dx^2 + dy^2) / (2 sigma^2))`` with ``sigma = r/3``,
summed over the objects and clamped to 1, so every center is exactly 1.0
(the focal loss selects positives with ``gt == 1.0``).

:func:`render_label_heatmaps` is the wrapper of the CUDA kernel
``csrc/render_heatmap.cu``, the port of the TPU kernel
``render_heatmap_pallas``: one launch renders every label map a batch
transform needs, (M, B, S, S), the center map and, for the corner
families, the tl and br corner maps (``corner_threshold_radius``,
corners at the centers -/+ (|maj|, minL), :func:`corner_offsets`).
:func:`render_heatmap` takes the same kernel's one-map sets: the center
map, or one corner map at the caller's offsets. For a CUDA tensor a
wrapper launches the kernel or raises; for a CPU tensor it computes the
plain version. The plain version adds the objects in order k = 0..K-1,
as the kernel and the Pallas kernel do, so that on the card the two
agree to the bit.
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
KERNEL_NAME = "render_heatmaps"  # counts every launch, whatever its maps
# a cluster of 8 blocks of 256 threads derives a clip's objects, one a
# thread; the clips are the grid's z dimension
MAX_OBJECTS = 2048
MAX_CLIPS = 65535
cuda_build.LAUNCHES.setdefault(KERNEL_NAME, 0)


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


def corner_offsets(locs: torch.Tensor):
    """The (B, K, 2) offsets from each center to its top-left and
    bottom-right corner, -/+ (|maj|, minL), as the JAX corner branch
    takes them (``scd_resnet_tpu/data/pipeline.py:147-154``). The kernel
    derives the same offsets itself; this is the plain version's."""
    maj_l = sqrt_rn(locs[:, :, 4] * locs[:, :, 4]
                    + locs[:, :, 5] * locs[:, :, 5])
    half = torch.stack([maj_l, locs[:, :, 6]], dim=-1)
    return -half, half


def render_label_heatmaps_plain(locs: torch.Tensor, valid: torch.Tensor,
                                size: int, corner_targets: bool = False,
                                iou_threshold: float = 0.5) -> torch.Tensor:
    """The label maps of a batch transform, (M, B, S, S), in plain
    PyTorch: the center map and, with ``corner_targets``, the tl and br
    corner maps (corner radius, :func:`corner_offsets`)."""
    maps = [render_heatmap_plain(locs, valid, size, iou_threshold)]
    if corner_targets:
        maps += [render_heatmap_plain(locs, valid, size, iou_threshold,
                                      radius_fn=corner_threshold_radius,
                                      position_offset=offset)
                 for offset in corner_offsets(locs.to(torch.float32))]
    return torch.stack(maps)


def library() -> ctypes.CDLL:
    """The kernel's library, built on first use:
    ``render_heatmaps_f32(locs, valid, offsets, heat, B, K, S, M,
    iou_threshold, stream)`` returns a CUDA error code and launches
    uncounted (for timing the kernel alone). ``offsets`` None and M 1:
    the center map; None and M 3: center, tl, br; (B, K, 2) offsets and
    M 1: one corner map at those offsets."""
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.render_heatmaps_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_inputs(locs: torch.Tensor, valid: torch.Tensor,
                  position_offset: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel cannot take, on every device, so the CPU
    route refuses what the card's does."""
    if locs.dim() != 3 or locs.shape[-1] != 8:
        raise ValueError("the render takes (B, K, 8) locs, got shape {}"
                         .format(tuple(locs.shape)))
    if locs.dtype != torch.float32:
        raise TypeError("the render takes float32 locs, got {}"
                        .format(locs.dtype))
    if valid.shape != locs.shape[:2]:
        raise ValueError("valid must be (B, K) = {}, got {}".format(
            tuple(locs.shape[:2]), tuple(valid.shape)))
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError("valid must be bool or uint8 (the kernel reads its "
                        "bytes), got {}".format(valid.dtype))
    if position_offset is not None and (
            position_offset.shape != (*locs.shape[:2], 2)
            or position_offset.dtype != torch.float32):
        raise ValueError("position_offset must be (B, K, 2) float32, got "
                         "{} {}".format(tuple(position_offset.shape),
                                        position_offset.dtype))
    b, k = locs.shape[:2]
    if k > MAX_OBJECTS or b > MAX_CLIPS:
        raise ValueError("the render takes at most {} clips of {} objects, "
                         "got {} of {}".format(MAX_CLIPS, MAX_OBJECTS, b, k))
    others = [valid] + ([position_offset] if position_offset is not None
                        else [])
    if any(t.device != locs.device for t in others) or \
            locs.device.type not in ("cpu", "cuda"):
        raise ValueError("the render runs on one cuda or cpu device; locs "
                         "on {}, the others on {}".format(
                             locs.device, [str(t.device) for t in others]))


def _launch(locs: torch.Tensor, valid: torch.Tensor,
            offsets: Optional[torch.Tensor], size: int, maps: int,
            iou_threshold: float) -> torch.Tensor:
    """One launch of the kernel into a fresh (maps, B, S, S) tensor."""
    b, k = locs.shape[:2]
    heat = torch.empty((maps, b, size, size), dtype=torch.float32,
                       device=locs.device)
    if heat.numel() == 0:
        return heat
    locs, valid = locs.contiguous(), valid.contiguous()
    if offsets is not None:
        offsets = offsets.contiguous()
    lib = library()
    with torch.cuda.device(locs.device):
        stream = torch.cuda.current_stream(locs.device).cuda_stream
        status = lib.render_heatmaps_f32(
            locs.data_ptr(), valid.data_ptr(),
            None if offsets is None else offsets.data_ptr(), heat.data_ptr(),
            b, k, size, maps, float(iou_threshold), stream)
    cuda_build.check(lib, status, "render_heatmaps_f32")
    cuda_build.count_launch(KERNEL_NAME)
    return heat


def render_label_heatmaps(locs: torch.Tensor, valid: torch.Tensor,
                          size: int, corner_targets: bool = False,
                          iou_threshold: float = 0.5) -> torch.Tensor:
    """Every label map of a batch transform in one launch, (B, K, 8)
    float32 + (B, K) bool -> (M, B, S, S), as
    :func:`render_label_heatmaps_plain`: M = 1 (the center map) or, with
    ``corner_targets``, M = 3 (center, tl, br). Each map is a contiguous
    view of the result."""
    if not isinstance(corner_targets, bool):
        raise ValueError("the kernel renders the center map, or the center "
                         "and corner maps (corner_targets True or False), "
                         "not corner_targets={!r}".format(corner_targets))
    _check_inputs(locs, valid)
    if locs.device.type == "cpu":
        return render_label_heatmaps_plain(locs, valid, size, corner_targets,
                                           iou_threshold)
    return _launch(locs, valid, None, size, 3 if corner_targets else 1,
                   iou_threshold)


def render_heatmap(locs: torch.Tensor, valid: torch.Tensor, size: int,
                   iou_threshold: float = 0.5,
                   radius_fn: Optional[Callable] = None,
                   position_offset: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """One heatmap of a batch, (B, K, 8) float32 + (B, K) bool -> (B, S,
    S), as :func:`render_heatmap_plain`, through the kernel's one-map
    sets: the center map (``radius_fn`` None or
    ``center_threshold_radius``, no offset), or a corner map
    (``corner_threshold_radius``, ``position_offset`` (B, K, 2) float32
    or none). It refuses any other radius."""
    corner = radius_fn is corner_threshold_radius
    if not corner and (radius_fn not in (None, center_threshold_radius)
                       or position_offset is not None):
        raise ValueError("the render kernel takes the center radius without "
                         "offsets or the corner radius")
    _check_inputs(locs, valid, position_offset)
    if locs.device.type == "cpu":
        return render_heatmap_plain(locs, valid, size, iou_threshold,
                                    radius_fn, position_offset)
    offsets = None
    if corner:
        offsets = (position_offset if position_offset is not None
                   else torch.zeros((*locs.shape[:2], 2), device=locs.device))
    return _launch(locs, valid, offsets, size, 1, iou_threshold)[0]
