"""Corner pooling: directional running max over NCHW feature maps.

Counterpart of ``scd_resnet_tpu/ops/corner_pool.py`` (NHWC there; NHWC
axis 1/2 is NCHW dim 2/3 here). The four pools:

- ``top_pool``    — out[i] = max over rows i..H-1  (reverse, dim 2)
- ``bottom_pool`` — out[i] = max over rows 0..i    (forward, dim 2)
- ``left_pool``   — out[j] = max over cols j..W-1  (reverse, dim 3)
- ``right_pool``  — out[j] = max over cols 0..j    (forward, dim 3)

:func:`corner_pool` is the wrapper of the CUDA kernel
``csrc/corner_pool.cu`` (the port of the TPU kernel
``corner_pool_pallas``): for a CUDA tensor it launches the kernel or
raises, for a CPU tensor it computes :func:`corner_pool_plain`. Forward
only — serving runs under ``torch.inference_mode()``; the backward
kernel comes with the training slice.
"""

from __future__ import annotations

import ctypes

import torch

from scd_resnet_tpu_torch.core import cuda_build

KERNEL_SOURCE = "corner_pool.cu"
# one count per __global__ kernel: the H walk and the W warp scan
KERNEL_NAMES = {2: "corner_pool_h", 3: "corner_pool_w"}
for _name in KERNEL_NAMES.values():
    cuda_build.LAUNCHES.setdefault(_name, 0)


def corner_pool_plain(x: torch.Tensor, dim: int, reverse: bool
                      ) -> torch.Tensor:
    """Running max along ``dim`` in plain PyTorch (the kernel's
    reference; the CPU path)."""
    if reverse:
        return torch.cummax(x.flip(dim), dim).values.flip(dim)
    return torch.cummax(x, dim).values


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(KERNEL_SOURCE)
    fn = lib.corner_pool_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def corner_pool(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Directional running max of a (B, C, H, W) float32 tensor along
    ``dim`` (2 = H, 3 = W), reversed for the top/left pools."""
    if x.dim() != 4:
        raise ValueError("corner_pool takes (B, C, H, W), got shape {}"
                         .format(tuple(x.shape)))
    if dim not in KERNEL_NAMES:
        raise ValueError("corner_pool dim must be 2 or 3, got {}".format(dim))
    if x.dtype != torch.float32:
        raise TypeError("corner_pool takes float32, got {}".format(x.dtype))
    if x.device.type == "cpu":
        return corner_pool_plain(x, dim, reverse)
    if x.device.type != "cuda":
        raise ValueError("corner_pool runs on cuda or cpu, not {}"
                         .format(x.device))
    if not x.is_contiguous():
        raise ValueError("corner_pool needs an NCHW-contiguous tensor")
    b, c, h, w = x.shape
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.corner_pool_f32(x.data_ptr(), y.data_ptr(), b, c, h, w,
                                     dim, int(reverse), stream)
    cuda_build.check(lib, status, "corner_pool_f32")
    cuda_build.count_launch(KERNEL_NAMES[dim])
    return y


def _pool(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    """Public pool entry: always computes in float32 (exact for bf16 and
    fp16 inputs, since a running max only returns input values)."""
    if x.dtype != torch.float32:
        return corner_pool(x.float().contiguous(), dim, reverse).to(x.dtype)
    return corner_pool(x.contiguous(), dim, reverse)


def top_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 2, True)


def bottom_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 2, False)


def left_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 3, True)


def right_pool(x: torch.Tensor) -> torch.Tensor:
    return _pool(x, 3, False)
