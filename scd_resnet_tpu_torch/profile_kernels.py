"""Device time of the stem pool's and the deformable gather's backward
kernels at a train step's shapes.

    python -m scd_resnet_tpu_torch.profile_kernels

It calls ``ops.max_pool.max_pool_3x3_s2_bwd`` (bf16, x (32, 64, 256,
256): the stem of every ResNet train step) and ``ops.dcn.dcn_gather_bwd``
(x (32, 16, 16, 512) float32, N = 2304 samples: a dcn_full train step)
on seeded inputs, two warm-up calls and then 20 calls each under
``torch.profiler``, and prints one JSON line: for each wrapper the
device time per call of every kernel it launched (fills included) and
their sum, with the card's name and power limit.

It uses only the wrappers' public signatures, the same since the
kernels were ported, so a copy of this file put into an older
checkout's package times that checkout's kernels (``python -m
scd_resnet_tpu_torch.profile_kernels`` from there), so old and new
designs compare on one card.
"""

from __future__ import annotations

import json
import subprocess
from typing import Callable, Dict

import torch

from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.ops import max_pool as mp

STEM_SHAPE = (32, 64, 256, 256)  # the stem pool's input in a train step
DCN_SHAPE = (32, 16, 16, 512)  # the DCN's input (B, H, W, C)
DCN_TAPS = 9
CALLS = 20


def inputs(seed: int = 5) -> Dict[str, Callable[[], object]]:
    """The two wrapper calls on seeded inputs on the card; the DCN's
    positions are its 3x3 taps moved by N(0, 1.5^2) offsets."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, c, h, w = STEM_SHAPE
    x = torch.randn(STEM_SHAPE, device="cuda", generator=gen).bfloat16()
    dy = torch.randn((b, c, mp.output_size(h), mp.output_size(w)),
                     device="cuda", generator=gen).bfloat16()
    b, h, w, c = DCN_SHAPE
    xd = torch.randn(DCN_SHAPE, device="cuda", generator=gen)
    offset = 1.5 * torch.randn((b, h, w, DCN_TAPS, 2), device="cuda",
                               generator=gen)
    py, px = (t.reshape(b, -1).contiguous()
              for t in dcn.sampling_positions(offset, 3, 3, 1, 1, 1))
    g = torch.randn((b, py.shape[1], c), device="cuda", generator=gen)
    return {"max_pool_3x3_s2_bwd": lambda: mp.max_pool_3x3_s2_bwd(x, dy),
            "dcn_gather_bwd": lambda: dcn.dcn_gather_bwd(xd, py, px, g)}


def device_kernels(fn: Callable[[], object], calls: int) -> Dict:
    """Device ms per call of each kernel ``fn`` launches, by
    ``torch.profiler`` over ``calls`` calls after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = {evt.key[:120]: evt.self_device_time_total / 1e3 / calls
               for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA}
    return {"ms": sum(kernels.values()), "kernels": kernels}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_kernels needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    result = {name: device_kernels(fn, CALLS)
              for name, fn in inputs().items()}
    result["card"] = card
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
