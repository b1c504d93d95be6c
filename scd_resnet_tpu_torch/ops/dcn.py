"""Modulated deformable convolution (DCNv2): the bilinear gather, its
backward, and the convolution built on them.

Counterpart of ``scd_resnet_tpu/ops/dcn.py`` (l.82-217). The convolution
is a "deformable im2col": every output pixel samples the input at K
float positions (its kernel taps moved by learned offsets), each sample
is scaled by its modulation mask, and one matrix product against the
kernel gives the output. The sampling is the gather
(:func:`dcn_gather`): x (B, H, W, C) channels-last, as the JAX package
keeps it, read at float positions py, px (B, N) -> (B, N, C). Each of
the four bilinear corners is zeroed when it lies outside the map, and a
whole sample is zeroed when it leaves the outer cutoff
(-1, H) x (-1, W) (the reference's ``dmcn_im2col_bilinear``).

The CUDA kernels in ``csrc/dcn_gather.cu`` port the TPU kernel
``dcn_gather_pallas`` (``scd_resnet_tpu/ops/pallas_kernels.py:190``):
:func:`dcn_gather` wraps the forward, a ``torch.library`` operator
(``scd_resnet_tpu_torch::dcn_gather``) so that ``torch.export`` keeps it
in a traced bundle, and :func:`dcn_gather_bwd` the backward,
which returns dx, dpy and dpx (in the JAX package that backward is XLA's
derivative of the gather, l.206-216). For a CUDA tensor each launches
its kernel or raises; for a CPU tensor each computes its plain version.
:class:`DCNGather` ties the two together for autograd.

There is one route: the JAX package's onehot and Pallas lowerings (and
its ``SCD_DCN_METHOD`` switch) compute the same function and stay on the
JAX side; the tests hold the plain versions here against all three.

:func:`deform_psroi_pooling` (l.220-321) is plain PyTorch: the JAX
function computes it in XLA ops, with no Pallas kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.ops.layout import is_channels_last

KERNEL_SOURCE = "dcn_gather.cu"
KERNEL_NAME = "dcn_gather"
BWD_KERNEL_NAME = "dcn_gather_bwd"
for _name in (KERNEL_NAME, BWD_KERNEL_NAME):
    cuda_build.LAUNCHES.setdefault(_name, 0)

# shared memory one block may use on an H100, and the most channels one
# backward block takes (one a lane, ``kSlice`` in csrc/dcn_gather.cu)
SHARED_BYTES = 232448
MAX_SLICE = 32

# (corner row, corner column) offsets from (floor(py), floor(px)), in the
# order the forward adds the corners
CORNERS = ((0, 0), (0, 1), (1, 0), (1, 1))


def bilinear_corners(py: torch.Tensor, px: torch.Tensor, h: int, w: int
                     ) -> List[Tuple[torch.Tensor, ...]]:
    """The four bilinear corners of every sample, in :data:`CORNERS`
    order: (flat index into the H*W map, clamped into range; validity,
    the corner in range and the sample inside the outer cutoff; lerp
    weight; its derivative by py; its derivative by px)."""
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    ly = py - y0
    lx = px - x0
    hy = 1.0 - ly
    hx = 1.0 - lx
    inside = (py > -1) & (py < h) & (px > -1) & (px < w)
    # weight, d weight / d py, d weight / d px
    lerp = ((hy * hx, -hx, -hy), (hy * lx, -lx, hy), (ly * hx, hx, -ly),
            (ly * lx, lx, ly))
    out = []
    for (dy, dx), (weight, d_py, d_px) in zip(CORNERS, lerp):
        yi, xi = y0 + dy, x0 + dx
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w) & inside
        idx = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
        out.append((idx, valid, weight, d_py, d_px))
    return out


def _gather_rows(flat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """flat (B, HW, C) rows at idx (B, N) -> (B, N, C)."""
    return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[2]))


def dcn_gather_plain(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                     ) -> torch.Tensor:
    """The gather in plain PyTorch, ``_bilinear_gather``'s arithmetic:
    each corner's value times (lerp weight x validity), added in
    :data:`CORNERS` order. The outer cutoff is folded into each corner's
    validity, where JAX multiplies the sum by it: a sample outside the
    cutoff is a sum of zeros either way."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    out = None
    for idx, valid, weight, _, _ in bilinear_corners(py, px, h, w):
        term = _gather_rows(flat, idx) * (weight * valid)[..., None]
        out = term if out is None else out + term
    return out


def dcn_gather_bwd_plain(x: torch.Tensor, py: torch.Tensor,
                         px: torch.Tensor, g: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dpy, dpx) of :func:`dcn_gather_plain` for the cotangent ``g``
    (B, N, C), written out with ``index_add_`` (not autograd): with v_c a
    corner's validity, w_c its lerp weight and x_c its row,

        dx[corner c] += v_c w_c g
        dpy = sum_c v_c (d w_c / d py) <g, x_c>,  dpx likewise;

    floor and the validity flags pass no gradient."""
    b, h, w, c = x.shape
    flat = x.reshape(b, h * w, c)
    dx = torch.zeros((b * h * w, c), dtype=x.dtype, device=x.device)
    dpy = torch.zeros_like(py)
    dpx = torch.zeros_like(px)
    base = (torch.arange(b, device=x.device) * (h * w))[:, None]
    for idx, valid, weight, d_py, d_px in bilinear_corners(py, px, h, w):
        v = valid.to(x.dtype)
        dx.index_add_(0, (idx + base).reshape(-1),
                      (g * (weight * v)[..., None]).reshape(-1, c))
        dot = (g * _gather_rows(flat, idx)).sum(-1)
        dpy += v * d_py * dot
        dpx += v * d_px * dot
    return dx.reshape(b, h, w, c), dpy, dpx


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.dcn_gather_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.dcn_gather_bwd_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(what: str, x: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
           g: Optional[torch.Tensor] = None) -> None:
    if x.dim() != 4 or py.dim() != 2 or py.shape != px.shape \
            or py.shape[0] != x.shape[0]:
        raise ValueError("{} takes x (B, H, W, C) and py, px (B, N); got {}, "
                         "{}, {}".format(what, tuple(x.shape), tuple(py.shape),
                                         tuple(px.shape)))
    if g is not None and tuple(g.shape) != (*py.shape, x.shape[3]):
        raise ValueError("{}: g must be (B, N, C) = {}, got {}".format(
            what, (*py.shape, x.shape[3]), tuple(g.shape)))
    tensors = (x, py, px) if g is None else (x, py, px, g)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("{} takes float32, got {}".format(
            what, [t.dtype for t in tensors]))
    if any(t.device != x.device for t in tensors) \
            or x.device.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on one cuda or cpu device, got {}".format(
            what, [t.device for t in tensors]))
    if x.device.type == "cuda" and not all(t.is_contiguous()
                                           for t in tensors):
        raise ValueError("{} needs contiguous tensors".format(what))


def _launch(entry: str, tensors, x: torch.Tensor, n: int, *plan) -> None:
    """Launch ``entry`` on the current stream of ``x``'s card;
    ``tensors`` are its pointer arguments, inputs first, ``plan`` its
    integer arguments after N."""
    b, h, w, c = x.shape
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                     b, h, w, c, n, *plan, stream)
    cuda_build.check(lib, status, entry)


class BwdPlan(NamedTuple):
    """How the backward kernel cuts a (H, W, C) map: one block per image,
    slice of ``cs`` channels and tile of ``rows`` x ``cols`` pixels. The
    block sums w_c g over the samples of each of the tile's (rows + 1) x
    (cols + 1) buckets (a sample's bucket is its top-left corner (floor(py),
    floor(px)), which may lie one row or column before the tile) for each
    corner c in shared memory: float32, MAX_SLICE channels each."""
    cs: int
    rows: int
    cols: int

    def shared_bytes(self) -> int:
        return 4 * 4 * MAX_SLICE * (self.rows + 1) * (self.cols + 1)

    def parts(self, h: int, w: int, c: int) -> int:
        """Partial sums of dpy (and of dpx) per sample: one per slice and
        per tile its corners reach, slices x slots. The corners' two rows
        lie in one or two row tiles, so the slots are 2 where the plan
        cuts H into tiles, else 1, times the same for W."""
        slots = (2 if self.rows < h else 1) * (2 if self.cols < w else 1)
        return (-(-c // self.cs)) * slots


def bwd_plan(h: int, w: int, c: int) -> BwdPlan:
    """At most 32 channels a block (fewer only when C is), and as many
    whole rows of the map as fit :data:`SHARED_BYTES` (the whole 16 x 16
    DCN map: 289 buckets, 148 KB); a row too long for that is cut into
    tiles of columns."""
    cs = min(c, MAX_SLICE)

    def fits(rows: int, cols: int) -> bool:
        return BwdPlan(cs, rows, cols).shared_bytes() <= SHARED_BYTES

    if fits(h, w):
        return BwdPlan(cs, h, w)
    if fits(1, w):
        rows = 1
        while fits(rows + 1, w):
            rows += 1
        return BwdPlan(cs, rows, w)
    cols = 1
    while fits(1, cols + 1):
        cols += 1
    return BwdPlan(cs, 1, cols)


def bwd_scratch(b: int, h: int, w: int, c: int, n: int, plan: BwdPlan,
                device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's scratch: int32, each image's samples sorted
    by bucket, then its buckets' starts; float32 (2, B, parts, N), the
    blocks' partial sums of dpy and dpx per sample (:meth:`BwdPlan.parts`:
    16 at the DCN's map, at most 4 per slice on any map)."""
    index = torch.empty(b * (n + (h + 1) * (w + 1) + 1), dtype=torch.int32,
                        device=device)
    parts = torch.empty((2, b, plan.parts(h, w, c), n), dtype=torch.float32,
                        device=device)
    return index, parts


@torch.library.custom_op("scd_resnet_tpu_torch::dcn_gather", mutates_args=())
def _dcn_gather_op(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                   ) -> torch.Tensor:
    """K4's forward as an operator, so that ``torch.export`` keeps it as
    one node of an exported program: the plain version on the CPU, the
    kernel on the card (registered below), the output's shape for a fake
    tensor."""
    return dcn_gather_plain(x, py, px)


@_dcn_gather_op.register_kernel("cuda")
def _dcn_gather_cuda(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                     ) -> torch.Tensor:
    if not all(t.is_contiguous() for t in (x, py, px)):
        raise ValueError("dcn_gather needs contiguous tensors")
    b, n = py.shape
    out = torch.empty((b, n, x.shape[3]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    _launch("dcn_gather_f32", (x, py, px, out), x, n)
    cuda_build.count_launch(KERNEL_NAME)
    return out


@_dcn_gather_op.register_fake
def _dcn_gather_fake(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                     ) -> torch.Tensor:
    return x.new_empty((py.shape[0], py.shape[1], x.shape[3]))


def dcn_gather(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
               ) -> torch.Tensor:
    """Bilinear samples of x (B, H, W, C) float32 at py, px (B, N) ->
    (B, N, C), zero outside (module docstring)."""
    _check("dcn_gather", x, py, px)
    return _dcn_gather_op(x, py, px)


def dcn_gather_bwd(x: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
                   g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dpy, dpx) of :func:`dcn_gather` for the cotangent ``g``
    (B, N, C). On the card dx adds each bucket's samples in no fixed
    order; dpy and dpx are the same from run to run."""
    _check("dcn_gather_bwd", x, py, px, g)
    if x.device.type == "cpu":
        return dcn_gather_bwd_plain(x, py, px, g)
    b, n = py.shape
    _, h, w, c = x.shape
    dx = torch.empty_like(x)
    dpy = torch.empty_like(py)
    dpx = torch.empty_like(px)
    if g.numel() == 0:
        return dx.zero_(), dpy.zero_(), dpx.zero_()
    plan = bwd_plan(h, w, c)
    index, parts = bwd_scratch(b, h, w, c, n, plan, x.device)
    _launch("dcn_gather_bwd_f32", (x, py, px, g, dx, dpy, dpx, index, parts),
            x, n, *plan)
    cuda_build.count_launch(BWD_KERNEL_NAME)
    return dx, dpy, dpx


class DCNGather(torch.autograd.Function):
    """The gather with its hand-written backward: forward
    :func:`dcn_gather`, backward :func:`dcn_gather_bwd` (the kernels on
    the card, their plain versions on the CPU). It saves x, py and px."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, py: torch.Tensor, px: torch.Tensor
                ) -> torch.Tensor:
        ctx.save_for_backward(x, py, px)
        return dcn_gather(x, py, px)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, py, px = ctx.saved_tensors
        return dcn_gather_bwd(x, py, px, g.contiguous())


def sampling_positions(offset: torch.Tensor, kh: int, kw: int, stride: int,
                       padding: int, dilation: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Float positions (B, Ho, Wo, K) of every tap: the tap's place on the
    strided, padded, dilated grid (an integer, as the JAX package computes
    it) plus its (dy, dx) offset (B, Ho, Wo, K, 2)."""
    _, ho, wo, _, _ = offset.shape
    device = offset.device
    oy = torch.arange(ho, device=device) * stride - padding
    ox = torch.arange(wo, device=device) * stride - padding
    ky, kx = torch.meshgrid(torch.arange(kh, device=device),
                            torch.arange(kw, device=device), indexing="ij")
    ky = ky.reshape(-1) * dilation
    kx = kx.reshape(-1) * dilation
    base_y = (oy[:, None, None] + ky[None, None, :]).to(offset.dtype)
    base_x = (ox[None, :, None] + kx[None, None, :]).to(offset.dtype)
    return base_y + offset[..., 0], base_x + offset[..., 1]


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1, padding: int = 1, dilation: int = 1
                  ) -> torch.Tensor:
    """Modulated deformable convolution (the JAX ``deform_conv2d``, l.159).

    Args:
      x: (B, Cin, H, W) float32.
      offset: (B, Ho, Wo, K, 2) per-tap (dy, dx) offsets, K = kh * kw taps
        in raster order, as the JAX package lays them out.
      mask: (B, Ho, Wo, K) modulation scalars (already sigmoided).
      weight: (Cout, Cin, kh, kw); bias: optional (Cout,).

    Returns (B, Cout, Ho, Wo). The samples are ordered N = (Ho, Wo, K),
    so the gather's (B, N, Cin) is (B, Ho*Wo, K*Cin) as it stands, and
    the kernel reshaped to (K*Cin, Cout) (tap-major, as JAX reshapes its
    HWIO kernel) contracts it in one ``torch.matmul``."""
    b, cin, _, _ = x.shape
    cout, _, kh, kw = weight.shape
    _, ho, wo, k, _ = offset.shape
    py, px = sampling_positions(offset, kh, kw, stride, padding, dilation)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    # the operator itself where no gradient is recorded (serving, an
    # export), so that an exported program holds it
    gather = DCNGather.apply if torch.is_grad_enabled() else dcn_gather
    sampled = gather(x_nhwc, py.reshape(b, -1).contiguous(),
                     px.reshape(b, -1).contiguous())
    sampled = sampled.reshape(b, ho * wo, k, cin) * mask.reshape(
        b, ho * wo, k, 1)
    out = torch.matmul(sampled.reshape(b, ho * wo, k * cin),
                       weight.permute(2, 3, 1, 0).reshape(k * cin, cout))
    if bias is not None:
        out = out + bias
    # a channels-last x (a bfloat16 training step) keeps its layout: the
    # permuted product is channels-last as it stands
    return out.reshape(b, ho, wo, cout).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last if is_channels_last(x)
        else torch.contiguous_format)


def deform_psroi_pooling(x: torch.Tensor, rois: torch.Tensor,
                         trans: Optional[torch.Tensor], *, output_dim: int,
                         group_size: int, pooled_size: int,
                         spatial_scale: float, trans_std: float = 0.1,
                         sample_per_part: int = 4,
                         part_size: Optional[int] = None,
                         no_trans: bool = False) -> torch.Tensor:
    """Deformable position-sensitive ROI pooling (the JAX
    ``deform_psroi_pooling``, l.220; reference dcn.roipool.cpp:59-144).

    Args:
      x: (B, C, H, W) with C = output_dim * group_size^2.
      rois: (N, 5) rows ``[batch_index, x1, y1, x2, y2]`` in input pixels.
      trans: (N, 2, part_size, part_size) normalised bin displacements,
        channel 0 dx and 1 dy, as the reference lays them out (unused
        with ``no_trans``).

    Returns (N, output_dim, pooled_size, pooled_size): bin (i, j) of
    channel ``ctop`` is the mean of the in-bounds bilinear samples, on a
    ``sample_per_part``-square grid from the bin's corner moved by its
    part's displacement, of input channel ``(ctop g + gh) g + gw`` with
    (gh, gw) the bin's group cell. Plain PyTorch gathers: the gradient to
    x and trans is autograd's, as the JAX function's is XLA's."""
    b, c, h, w = x.shape
    part_size = part_size or pooled_size
    n, p, g = rois.shape[0], pooled_size, group_size
    device = x.device

    def div(a: torch.Tensor, d: int) -> torch.Tensor:
        # a tensor divisor: CUDA divides by a Python number as a product
        # with its reciprocal, the CPU and XLA divide
        return a / torch.tensor(float(d), device=device)

    batch_idx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    bin_w = div(roi_w, p)
    bin_h = div(roi_h, p)
    sub_w = div(bin_w, sample_per_part)
    sub_h = div(bin_h, sample_per_part)

    # the bins' parts and group cells in the JAX function's float32
    # arithmetic, on the host
    ip = np.arange(p, dtype=np.float32)
    part = torch.from_numpy(np.floor(ip / np.float32(p) * np.float32(
        part_size)).astype(np.int64)).to(device)
    cell = torch.from_numpy(np.clip(np.floor(
        (np.arange(p) * g).astype(np.float32) / np.float32(p)), 0,
        g - 1).astype(np.int64)).to(device)
    bins = torch.arange(p, device=device)
    if no_trans:
        trans_x = torch.zeros((n, p, p), device=device)
        trans_y = torch.zeros((n, p, p), device=device)
    else:
        trans_x = (trans[:, 0] * trans_std)[:, part][:, :, part]
        trans_y = (trans[:, 1] * trans_std)[:, part][:, :, part]
    wstart = (bins[None, None, :] * bin_w[:, None, None] + x1[:, None, None]
              + trans_x * roi_w[:, None, None])
    hstart = (bins[None, :, None] * bin_h[:, None, None] + y1[:, None, None]
              + trans_y * roi_h[:, None, None])

    # sample positions (N, p, p, s, 1) and (N, p, p, 1, s) at i * sub_bin
    s = torch.arange(sample_per_part, dtype=torch.float32, device=device)
    sy = hstart[..., None, None] + s[:, None] * sub_h[:, None, None, None,
                                                      None]
    sx = wstart[..., None, None] + s[None, :] * sub_w[:, None, None, None,
                                                      None]
    inside = (sx >= -0.5) & (sx <= w - 0.5) & (sy >= -0.5) & (sy <= h - 0.5)
    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)

    # bin (i, j) of channel ctop reads input channel (ctop g + gh) g + gw;
    # its plane's offset in x, (N, p, p, 1, 1, output_dim)
    group = cell[:, None] * g + cell[None, :]
    channel = (torch.arange(output_dim, device=device) * (g * g))[
        None, None, :] + group[:, :, None]
    plane = (batch_idx[:, None, None, None] * c + channel[None]) * (h * w)
    plane = plane[:, :, :, None, None, :]
    flat_x = x.reshape(-1)

    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    ly = sy - y0
    lx = sx - x0
    total = 0
    for dy, dx in CORNERS:
        yi, xi = y0 + dy, x0 + dx
        weight = (ly if dy else 1 - ly) * (lx if dx else 1 - lx)
        # sy and sx are clipped, so only the upper corners can leave the map
        valid = (yi < h) & (xi < w)
        pixel = (torch.clamp(yi, max=h - 1) * w
                 + torch.clamp(xi, max=w - 1)).long()[..., None]
        # one gather a corner, (N, p, p, s, s, output_dim); its gradient
        # is a scatter-add into x
        index = plane + pixel
        total = total + flat_x.gather(0, index.reshape(-1)).reshape(
            index.shape) * (weight * valid)[..., None]
    count = inside.sum(dim=(3, 4))[..., None]
    pooled = (total * inside[..., None]).sum(dim=(3, 4)) / torch.clamp(
        count, min=1)
    pooled = torch.where(count > 0, pooled, torch.zeros_like(pooled))
    return pooled.permute(0, 3, 1, 2)
