"""Corner pooling: directional running max over NCHW feature maps, and
its gradient.

Counterpart of ``scd_resnet_tpu/ops/corner_pool.py`` (NHWC there; NHWC
axis 1/2 is NCHW dim 2/3 here). The four pools:

- ``top_pool``    — out[i] = max over rows i..H-1  (reverse, dim 2)
- ``bottom_pool`` — out[i] = max over rows 0..i    (forward, dim 2)
- ``left_pool``   — out[j] = max over cols j..W-1  (reverse, dim 3)
- ``right_pool``  — out[j] = max over cols 0..j    (forward, dim 3)

Two CUDA kernels in ``csrc/corner_pool.cu``: :func:`corner_pool` wraps
the forward (the port of the TPU kernel ``corner_pool_pallas``), a
``torch.library`` operator (``scd_resnet_tpu_torch::corner_pool``) so
that ``torch.export`` keeps it in a traced bundle, and
:func:`corner_pool_bwd` the backward (the port of
``corner_pool_bwd_pallas``). For a CUDA tensor each launches its kernel
or raises; for a CPU tensor each computes its plain version.
:class:`CornerPool` ties the two together for autograd, so the pools'
gradient goes through the backward kernel on the card and through
:func:`corner_pool_bwd_plain` on the CPU. ``torch.cummax``'s own
autograd is on no path: it sends a tied gradient to the *last* tied
element, where the JAX package and the reference's C++ pools send it to
the first.
"""

from __future__ import annotations

import ctypes

import torch

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.ops import layout

KERNEL_SOURCE = "corner_pool.cu"
# one count per __global__ kernel: the H walk and the W warp scan
KERNEL_NAMES = {2: "corner_pool_h", 3: "corner_pool_w"}
BWD_KERNEL_NAMES = {2: "corner_pool_bwd_h", 3: "corner_pool_bwd_w"}
for _name in (*KERNEL_NAMES.values(), *BWD_KERNEL_NAMES.values()):
    cuda_build.LAUNCHES.setdefault(_name, 0)


def corner_pool_plain(x: torch.Tensor, dim: int, reverse: bool
                      ) -> torch.Tensor:
    """Running max along ``dim`` in plain PyTorch (the kernel's
    reference; the CPU path)."""
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def corner_pool_bwd_plain(x: torch.Tensor, g: torch.Tensor, dim: int,
                          reverse: bool) -> torch.Tensor:
    """Gradient of the running max along ``dim`` with respect to ``x``
    for the cotangent ``g``, in plain PyTorch: the scan-free VJP of
    ``scd_resnet_tpu/ops/corner_pool._pool_bwd``.

    The cotangent of out[i] belongs to the running argmax at i, a tie
    going to the element scanned first. Argmax segments start where x
    strictly exceeds every earlier element ("new max"), so with R the
    suffix sum of g, grad = is_new * (R - R at the next new max)."""
    if reverse:
        x, g = x.flip(dim), g.flip(dim)
    n = x.shape[dim]
    running = torch.cummax(x, dim).values
    first = torch.full_like(running.narrow(dim, 0, 1), float("-inf"))
    is_new = x > torch.cat([first, running.narrow(dim, 0, n - 1)], dim)
    suffix = torch.cumsum(g.flip(dim), dim).flip(dim)
    # the index of the first new max strictly after each position (n if
    # none), as a reverse running min over the new-max positions
    shape = [1] * x.dim()
    shape[dim] = n
    positions = torch.arange(n, device=x.device).view(shape).expand_as(x)
    new_at = torch.where(is_new, positions, torch.full_like(positions, n))
    upto = torch.cummin(new_at.flip(dim), dim).values.flip(dim)
    after = torch.cat([upto.narrow(dim, 1, n - 1),
                       torch.full_like(upto.narrow(dim, 0, 1), n)], dim)
    padded = torch.cat([suffix, torch.zeros_like(suffix.narrow(dim, 0, 1))],
                       dim)
    grad = torch.where(is_new, suffix - padded.gather(dim, after),
                       torch.zeros_like(suffix))
    return grad.flip(dim) if reverse else grad


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    for fn, pointers in ((lib.corner_pool_f32, 2),
                         (lib.corner_pool_bwd_f32, 3)):
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * pointers + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, x: torch.Tensor, dim: int) -> None:
    if x.dim() != 4:
        raise ValueError("{} takes (B, C, H, W), got shape {}".format(
            what, tuple(x.shape)))
    if dim not in KERNEL_NAMES:
        raise ValueError("{} dim must be 2 or 3, got {}".format(what, dim))
    if x.dtype != torch.float32:
        raise TypeError("{} takes float32, got {}".format(what, x.dtype))
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError("{} runs on cuda or cpu, not {}".format(
            what, x.device))


def _launch(entry: str, tensors, dim: int, reverse: bool) -> None:
    """Launch ``entry`` on the current stream of the first tensor's card;
    ``tensors`` are the kernel's pointer arguments, inputs first."""
    b, c, h, w = tensors[0].shape
    lib = _library()
    device = tensors[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        status = getattr(lib, entry)(*(t.data_ptr() for t in tensors),
                                     b, c, h, w, dim, int(reverse), stream)
    cuda_build.check(lib, status, entry)


@torch.library.custom_op("scd_resnet_tpu_torch::corner_pool", mutates_args=())
def _corner_pool_op(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """K2 as an operator, so that ``torch.export`` keeps it as one node
    of an exported program: the plain version on the CPU, the kernel on
    the card (registered below), the output's shape for a fake tensor."""
    return corner_pool_plain(x, dim, reverse)


@_corner_pool_op.register_kernel("cuda")
def _corner_pool_cuda(x: torch.Tensor, dim: int, reverse: bool
                      ) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("corner_pool needs an NCHW-contiguous tensor")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    _launch("corner_pool_f32", (x, y), dim, reverse)
    cuda_build.count_launch(KERNEL_NAMES[dim])
    return y


@_corner_pool_op.register_fake
def _corner_pool_fake(x: torch.Tensor, dim: int, reverse: bool
                      ) -> torch.Tensor:
    return torch.empty_like(x)


def corner_pool(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Directional running max of a (B, C, H, W) float32 tensor along
    ``dim`` (2 = H, 3 = W), reversed for the top/left pools."""
    _check("corner_pool", x, dim)
    return _corner_pool_op(x, dim, reverse)


def corner_pool_bwd(x: torch.Tensor, g: torch.Tensor, dim: int,
                    reverse: bool) -> torch.Tensor:
    """Gradient of :func:`corner_pool` with respect to ``x`` for the
    cotangent ``g`` (same shape), first-occurrence tie routing."""
    _check("corner_pool_bwd", x, dim)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError("corner_pool_bwd: g must match x ({}, {}, {}), got "
                         "({}, {}, {})".format(tuple(x.shape), x.dtype,
                                               x.device, tuple(g.shape),
                                               g.dtype, g.device))
    if x.device.type == "cpu":
        return corner_pool_bwd_plain(x, g, dim, reverse)
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("corner_pool_bwd needs NCHW-contiguous tensors")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    _launch("corner_pool_bwd_f32", (x, g, dx), dim, reverse)
    cuda_build.count_launch(BWD_KERNEL_NAMES[dim])
    return dx


class CornerPool(torch.autograd.Function):
    """The running max with its first-occurrence gradient: forward
    :func:`corner_pool`, backward :func:`corner_pool_bwd` (the kernels on
    the card, their plain versions on the CPU). float32 in and out; it
    saves only its input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, reverse: bool
                ) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.dim, ctx.reverse = dim, reverse
        return corner_pool(x, dim, reverse)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        return corner_pool_bwd(x, g.contiguous(), ctx.dim, ctx.reverse), \
            None, None


def _pool(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Public pool entry: always computes in float32 (exact for bf16 and
    fp16 inputs, since a running max only returns input values); the
    casts stay outside :class:`CornerPool`, as the JAX ``_pool`` keeps
    them outside its custom VJP. Each cast also converts between the
    caller's layout and the kernels' NCHW, in the same copy, forward and
    backward (``ops/layout``). Where no gradient is recorded (serving,
    validation, an export) the operator is called directly, so that an
    exported program holds it."""
    pool = CornerPool.apply if torch.is_grad_enabled() else corner_pool
    kernels = (KERNEL_NAMES[dim], BWD_KERNEL_NAMES[dim])
    y = pool(layout.kernel_input(x, kernels, torch.float32), dim, reverse)
    return layout.caller_output(y, layout.is_channels_last(x), kernels,
                                x.dtype)


def top_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 2, True)


def bottom_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 2, False)


def left_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 3, True)


def right_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 3, False)
