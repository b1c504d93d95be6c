"""Lower precisions for the benchmark's control: each rounds the operands
of a float32 convolution (``quantize(t, role)``, role ``input`` or
``weight``).

- ``tf32``: float32 rounded to nearest (ties to even) at 10 mantissa bits,
  what a TF32 tensor core reads; the control of a float32 configuration
  whose TF32 is off;
- ``fp8``: the control of a bfloat16 configuration, as fp8 training runs a
  convolution: its input and weight in float8 e4m3 and the gradient
  arriving at its input in float8 e5m2, each with one scale a tensor (its
  largest magnitude at the format's largest value). The weight's gradient
  stays float32, as a master copy's does.
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def float32(t: torch.Tensor, role: str = "input") -> torch.Tensor:
    return t


def tf32(t: torch.Tensor, role: str = "input") -> torch.Tensor:
    bits = t.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    rounded = bits.view(torch.float32)
    return t + (rounded - t).detach()


def _round(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / largest
    return (t / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, role):
        ctx.role = role
        return _round(t.detach(), torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        if ctx.role == "weight":
            return g, None
        return _round(g, torch.float8_e5m2, E5M2_MAX), None


def fp8(t: torch.Tensor, role: str = "input") -> torch.Tensor:
    return _Fp8.apply(t, role)


QUANTIZERS = {"float32": float32, "tf32": tf32, "fp8": fp8}
