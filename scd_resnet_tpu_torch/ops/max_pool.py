"""The stem's 3x3 / stride 2 / pad 1 max pool, with a hand-written backward.

Counterpart of ``scd_resnet_tpu/models/layers.max_pool_3x3_s2`` (the
reference's ``nn.MaxPool2d(3, 2, 1)``, residuals.py:61), NCHW. The
forward is ``F.max_pool2d``, as the JAX forward is XLA's
``reduce_window`` and no Pallas kernel. The backward routes each
window's gradient to its first maximum in raster order, the tie rule of
XLA's SelectAndScatter and PyTorch's own pool, and is the CUDA kernel
``csrc/max_pool_bwd.cu``: the port of the TPU kernel ``pool_bwd_pallas``
(``tools/pool_bwd_pallas_probe.py``), which the JAX package measured and
left out of its step.

:func:`max_pool_3x3_s2_bwd` is the kernel's wrapper: for a CUDA tensor
it launches the kernel or raises, for a CPU tensor it computes
:func:`max_pool_3x3_s2_bwd_plain`. :class:`MaxPool3x3S2` ties the
forward and that backward together for autograd; it saves only its
input, where PyTorch's pool saves an int64 index per output.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.ops import layout

KERNEL_SOURCE = "max_pool_bwd.cu"
KERNEL_NAME = "max_pool_3x3_s2_bwd"
ENTRY = {torch.float32: "max_pool_3x3_s2_bwd_f32",
         torch.bfloat16: "max_pool_3x3_s2_bwd_bf16"}
cuda_build.LAUNCHES.setdefault(KERNEL_NAME, 0)


def output_size(n: int) -> int:
    """Output side of the 3x3 / stride 2 / pad 1 pool for input side n."""
    return (n - 1) // 2 + 1


def max_pool_3x3_s2_bwd_plain(x: torch.Tensor, dy: torch.Tensor
                              ) -> torch.Tensor:
    """d(input) of ``F.max_pool2d(x, 3, 2, 1)`` for the output gradient
    ``dy``, in plain PyTorch: every window's nine taps are compared with
    its maximum in raster order, the first equal tap claims the window,
    and the claims are added back by strided slices. Padding is -inf and
    a claim by a padded tap is dropped. The sums are float32, rounded
    once to ``x``'s type; each pixel adds its windows in (oy, ox)
    ascending order, as the kernel does."""
    b, c, h, w = x.shape
    ho, wo = output_size(h), output_size(w)
    # padded so that tap (a, b) of window (oy, ox) is xp[2 oy + a, 2 ox + b]
    xp = F.pad(x.float(), (1, 2 * wo - w, 1, 2 * ho - h),
               value=float("-inf"))
    taps = [xp[:, :, a:a + 2 * ho:2, b_:b_ + 2 * wo:2]
            for a in range(3) for b_ in range(3)]
    top = taps[0]
    for tap in taps[1:]:
        top = torch.maximum(top, tap)  # propagates NaN
    claimed = torch.zeros_like(top, dtype=torch.bool)
    takes = []
    for tap in taps:
        take = (tap == top) & ~claimed
        claimed |= take
        takes.append(take)
    grad = dy.float()
    dxp = torch.zeros_like(xp)
    # the taps backwards, so each pixel adds its windows in ascending order
    for t in reversed(range(9)):
        a, b_ = divmod(t, 3)
        dxp[:, :, a:a + 2 * ho:2, b_:b_ + 2 * wo:2] += torch.where(
            takes[t], grad, torch.zeros_like(grad))
    return dxp[:, :, 1:h + 1, 1:w + 1].to(x.dtype)


def _library(entry: str) -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def max_pool_3x3_s2_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """d(input) of the 3x3 / stride 2 / pad 1 max pool of ``x`` (B, C, H,
    W) for ``dy`` (B, C, (H-1)//2+1, (W-1)//2+1), float32 or bfloat16."""
    if x.dim() != 4:
        raise ValueError("max_pool_3x3_s2_bwd takes (B, C, H, W), got shape "
                         "{}".format(tuple(x.shape)))
    want = (*x.shape[:2], output_size(x.shape[2]), output_size(x.shape[3]))
    if tuple(dy.shape) != want:
        raise ValueError("dy must be {}, got {}".format(want,
                                                        tuple(dy.shape)))
    if x.dtype not in ENTRY or dy.dtype != x.dtype:
        raise TypeError("max_pool_3x3_s2_bwd takes float32 or bfloat16 x "
                        "and dy of one type, got {} and {}".format(
                            x.dtype, dy.dtype))
    if x.device.type == "cpu" and dy.device.type == "cpu":
        return max_pool_3x3_s2_bwd_plain(x, dy)
    if x.device.type != "cuda" or dy.device != x.device:
        raise ValueError("max_pool_3x3_s2_bwd runs on cuda or cpu; x on {}, "
                         "dy on {}".format(x.device, dy.device))
    if not (x.is_contiguous() and dy.is_contiguous()):
        raise ValueError("max_pool_3x3_s2_bwd needs NCHW-contiguous tensors")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        return dx
    entry = ENTRY[x.dtype]
    lib = _library(entry)
    b, c, h, w = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = getattr(lib, entry)(x.data_ptr(), dy.data_ptr(),
                                     dx.data_ptr(), b, c, h, w, stream)
    cuda_build.check(lib, status, entry)
    cuda_build.count_launch(KERNEL_NAME)
    return dx


class MaxPool3x3S2(torch.autograd.Function):
    """``F.max_pool2d(x, 3, 2, 1)`` whose backward is
    :func:`max_pool_3x3_s2_bwd`; it saves only ``x``. A channels-last
    ``x`` (a bfloat16 training step) and its ``dy`` reach the kernel
    NCHW, and ``dx`` goes back channels-last, so that the stem's
    BatchNorm keeps its channels-last kernels (``ops/layout``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        return F.max_pool2d(x, 3, 2, 1)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        (x,) = ctx.saved_tensors
        dx = max_pool_3x3_s2_bwd(layout.to_kernel(x, KERNEL_NAME),
                                 layout.to_kernel(dy, KERNEL_NAME))
        return layout.to_caller(dx, layout.is_channels_last(x), KERNEL_NAME)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return MaxPool3x3S2.apply(x)
