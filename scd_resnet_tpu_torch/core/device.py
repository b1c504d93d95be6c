"""Device selection for the port's entry points.

Every entry point runs on CUDA unless its caller asks for the CPU. With
no usable GPU and no explicit ``"cpu"`` it raises: it never carries on
quietly on the host.
"""

from __future__ import annotations

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


def reproducible_float32() -> None:
    """Full float32 and deterministic cuDNN algorithms for serving.

    TF32 goes off for cuDNN convolutions and cuBLAS matmuls: the JAX serve
    path computes in float32, and exact float32 on the card is what lets
    its outputs be held against the CPU's. A lower precision is a
    separate decision with its own stated bound.

    cuDNN is held to deterministic algorithms: its default choice for the
    transposed convolutions accumulates with atomics, so a score within
    an ulp of the 0.3 threshold could pass on one request and fail on
    the next; the same slide must give the same detections."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
