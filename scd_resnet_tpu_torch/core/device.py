"""Device selection for the port's entry points.

Every entry point runs on CUDA unless its caller asks for the CPU. With
no usable GPU and no explicit ``"cpu"`` it raises: it never carries on
quietly on the host.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device`` for an entry point; ``"cuda"`` without a GPU
    raises ``RuntimeError``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA requested but torch.cuda.is_available() is false; pass "
            "device='cpu' (--device cpu) to run on the host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device {}".format(device))
    return device


def visible_cards() -> list:
    """Every visible CUDA device (the serving CLIs' ``--mesh``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def reproducible_float32() -> None:
    """Full float32 and deterministic cuDNN algorithms for serving.

    TF32 goes off for cuDNN convolutions and cuBLAS matmuls: the JAX serve
    path computes in float32, and exact float32 on the card is what lets
    its outputs be held against the CPU's. A lower precision is a
    separate decision with its own stated bound.

    cuDNN is held to deterministic algorithms, chosen by its heuristic
    rather than by timing: its default choice for the transposed
    convolutions accumulates with atomics, so a score within an ulp of
    the 0.3 threshold could pass on one request and fail on the next; the
    same slide must give the same detections."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


@contextlib.contextmanager
def training_backends(precision: str) -> Iterator[None]:
    """cuDNN and cuBLAS settings for a training run, restored on exit.

    A float32 run takes ``reproducible_float32``: its steps are held
    against the CPU's. A bfloat16 run lets cuDNN time its algorithms and
    take non-deterministic ones, for speed. The settings hold for the
    whole process, serving included, so only entry points set them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
             cudnn.benchmark)
    try:
        if precision == "bfloat16":
            cudnn.deterministic = False
            cudnn.benchmark = True
        else:
            reproducible_float32()
        yield
    finally:
        (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic,
         cudnn.benchmark) = saved
