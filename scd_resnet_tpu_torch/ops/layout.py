"""Memory layouts: the channels-last model of a bfloat16 training run,
and the NCHW boundary of the hand-written kernels.

cuDNN's bfloat16 convolutions run NHWC. Given NCHW tensors they wrap
every pass (forward, dgrad, wgrad) in transposes of the input, the
filter and the output; given channels-last ones they run as they are,
and PyTorch's BatchNorm takes its channels-last kernels, which split a
channel's reduction over many blocks. So the trainer lays a bfloat16
model out channels-last (:func:`to_memory_format`) and its activations
follow the filters. A float32 run stays NCHW: its steps are held to the
CPU's.

The kernels K2, K3 (``ops/corner_pool``) and K5 (``ops/max_pool``) read
and write NCHW-contiguous tensors. :func:`to_kernel` and
:func:`to_caller` convert at their boundary, each in one copy that also
casts where the kernel computes in another type; :func:`kernel_input`
and :func:`caller_output` are the same conversions with their gradients
converted back, again in one copy each. Every conversion that changes
the layout adds one to ``core/cuda_build.LAYOUT_COPIES`` under the
kernel's name and runs in a ``scd.layout.copy`` span; a cast alone
counts nothing. On an NCHW path (float32 training, serving) nothing is
converted and nothing counts.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.profiling import span


def is_channels_last(t: torch.Tensor) -> bool:
    """Whether a tensor is laid out channels-last and not NCHW (a tensor
    of one channel, or of 1x1 maps, is both, and counts as NCHW)."""
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def to_memory_format(module: nn.Module,
                     memory_format: torch.memory_format) -> None:
    """Every 4-D parameter of ``module`` copied into ``memory_format``'s
    strides, in place. ``Module.to(memory_format=...)`` leaves a tensor
    that already counts as contiguous in the new format as it was: the
    stem's one-channel filter (64, 1, 7, 7) would keep its NCHW strides,
    and cuDNN would then write the stem's output, the step's largest
    activation, NCHW."""
    for p in module.parameters():
        if p.dim() == 4:
            p.data = torch.empty_like(
                p, memory_format=memory_format).copy_(p)


def one_channel_channels_last(t: torch.Tensor) -> torch.Tensor:
    """A (B, 1, H, W) tensor (a batch of clips) as a view with
    channels-last strides. Its memory is in that order already, but
    ``Tensor.to(memory_format=...)`` keeps NCHW strides on a tensor of
    one channel, and cuDNN, which reads the layout from the strides,
    would then transpose the stem's input in its forward and wgrad."""
    if t.dim() != 4 or t.shape[1] != 1:
        raise ValueError("one_channel_channels_last takes (B, 1, H, W), got "
                         "{}".format(tuple(t.shape)))
    if not t.is_contiguous():
        t = t.contiguous()
    return t.as_strided(t.shape, torch.empty_like(
        t, memory_format=torch.channels_last).stride())


def _convert(t: torch.Tensor, dtype: torch.dtype,
             memory_format: torch.memory_format, kernel: str
             ) -> torch.Tensor:
    with span("scd.layout.copy"):
        cuda_build.count_layout_copy(kernel)
        return t.to(dtype, memory_format=memory_format)


def to_kernel(t: torch.Tensor, kernel: str,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t`` NCHW-contiguous in ``dtype`` (its own by default) for
    ``kernel``: one copy where the layout or the type differs."""
    dtype = dtype or t.dtype
    if t.is_contiguous():
        return t.to(dtype)
    return _convert(t, dtype, torch.contiguous_format, kernel)


def to_caller(t: torch.Tensor, channels_last: bool, kernel: str,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``kernel``'s NCHW output ``t`` in the caller's layout
    (channels-last or NCHW) and ``dtype``: one copy where either
    differs."""
    dtype = dtype or t.dtype
    if not channels_last or t.is_contiguous(
            memory_format=torch.channels_last):
        return t.to(dtype)
    return _convert(t, dtype, torch.channels_last, kernel)


class _ToKernel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernels, dtype):
        ctx.kernel, ctx.dtype = kernels[1], x.dtype
        ctx.channels_last = is_channels_last(x)
        return to_kernel(x, kernels[0], dtype)

    @staticmethod
    def backward(ctx, g):
        return to_caller(g, ctx.channels_last, ctx.kernel, ctx.dtype), \
            None, None


class _ToCaller(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, channels_last, kernels, dtype):
        ctx.kernel, ctx.dtype = kernels[1], y.dtype
        return to_caller(y, channels_last, kernels[0], dtype)

    @staticmethod
    def backward(ctx, g):
        return to_kernel(g, ctx.kernel, ctx.dtype), None, None, None


def kernel_input(x: torch.Tensor, kernels: Tuple[str, str],
                 dtype: torch.dtype) -> torch.Tensor:
    """:func:`to_kernel` of ``x`` for the forward kernel ``kernels[0]``,
    whose gradient goes back to ``x``'s layout and type from the
    backward kernel ``kernels[1]`` in one copy; ``x`` itself where
    nothing differs."""
    if x.is_contiguous() and x.dtype == dtype:
        return x
    if not torch.is_grad_enabled():
        return to_kernel(x, kernels[0], dtype)
    return _ToKernel.apply(x, kernels, dtype)


def caller_output(y: torch.Tensor, channels_last: bool,
                  kernels: Tuple[str, str], dtype: torch.dtype
                  ) -> torch.Tensor:
    """:func:`to_caller` of the forward kernel's output ``y``, whose
    gradient reaches the backward kernel ``kernels[1]`` NCHW-contiguous
    in ``y``'s type in one copy; ``y`` itself where nothing differs."""
    if not channels_last and y.dtype == dtype:
        return y
    if not torch.is_grad_enabled():
        return to_caller(y, channels_last, kernels[0], dtype)
    return _ToCaller.apply(y, channels_last, kernels, dtype)
