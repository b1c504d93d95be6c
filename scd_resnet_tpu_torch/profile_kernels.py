"""Device time of the port's kernels at a train step's shapes, by
``torch.profiler``.

    python -m scd_resnet_tpu_torch.profile_kernels

It calls, on seeded inputs, two warm-up calls and then 20 calls each:

- ``ops.max_pool.max_pool_3x3_s2_bwd`` (bf16, x (32, 64, 256, 256): the
  stem of every ResNet train step);
- ``ops.dcn.dcn_gather_bwd`` (x (32, 16, 16, 512) float32, N = 2304
  samples: a dcn_full train step);
- ``ops.gaussian.render_heatmap(locs, present, 128)`` at (32, 30, 8): the
  center heatmap of a train step;
- ``data.pipeline.augment_and_render_batch(..., augment=False)`` on 32
  clips of 512^2 (a train step's batch) without and with
  ``corner_targets``, and with them on 256 clips (a validation
  pre-render chunk): every kernel the batch transform launches, so the
  render's kernels show as the difference between the two train-shape
  lines;
- ``floor``: a one-element ``torch.add``, the least device time a
  launch takes on this card.

Loc records are drawn as the synthetic archive draws its objects
(``data/synthetic.py``) with 1-30 real objects a clip. It prints one
JSON line: for each call the device time per call of every kernel it
launched (fills included), how many times a call launched it, and
their sum, with the card's name and power limit.

It uses only the wrappers' public signatures, the same since the
kernels were ported, so a copy of this file put into an older
checkout's package times that checkout's kernels (``python -m
scd_resnet_tpu_torch.profile_kernels`` from there), so old and new
designs compare on one card.
"""

from __future__ import annotations

import json
import math
import subprocess
from typing import Callable, Dict

import torch

from scd_resnet_tpu_torch.data.pipeline import augment_and_render_batch
from scd_resnet_tpu_torch.ops import dcn
from scd_resnet_tpu_torch.ops import max_pool as mp
from scd_resnet_tpu_torch.ops.gaussian import render_heatmap

STEM_SHAPE = (32, 64, 256, 256)  # the stem pool's input in a train step
DCN_SHAPE = (32, 16, 16, 512)  # the DCN's input (B, H, W, C)
DCN_TAPS = 9
# a train step's clips and a validation pre-render chunk's; K loc
# records a clip, 512^2 clips, 128^2 heatmaps
RENDER_CLIPS = {"train": 32, "validation": 256}
RENDER_OBJECTS, CLIP, HEAT = 30, 512, 128
CALLS = 20


def render_batch(clips: int, gen: torch.Generator):
    """(samples uint8, locs, counts) of ``clips`` clips on the card: the
    synthetic archive's objects (centers 40 pixels from the border,
    semi-axes 10-24 and 6-major full-resolution pixels, any angle) in
    heatmap coordinates, 1-30 of them real in each clip."""
    def uniform(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    k = RENDER_OBJECTS
    locs = torch.zeros((clips, k, 8), device="cuda")
    center = 40 + (CLIP - 80) * uniform(clips, k, 2)
    locs[..., 0:2] = torch.floor(center / 4)
    locs[..., 2:4] = center - 4 * locs[..., 0:2]
    major = 10 + 14 * uniform(clips, k)
    minor = 6 + (major - 6) * uniform(clips, k)
    angle = math.pi * uniform(clips, k)
    locs[..., 4] = major * torch.cos(angle) / 4
    locs[..., 5] = major * torch.sin(angle) / 4
    locs[..., 6] = minor / 4
    locs[..., 7] = (minor + 4 + 26 * uniform(clips, k)) / 4
    counts = torch.randint(1, k + 1, (clips,), device="cuda", generator=gen)
    samples = torch.randint(0, 256, (clips, CLIP, CLIP), device="cuda",
                            generator=gen, dtype=torch.uint8)
    return samples, locs, counts


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
    train = render_batch(RENDER_CLIPS["train"], gen)
    validation = render_batch(RENDER_CLIPS["validation"], gen)
    locs, counts = train[1], train[2]
    present = torch.arange(locs.shape[1], device="cuda")[None, :] \
        < counts[:, None]
    one = torch.ones(1, device="cuda")
    return {"max_pool_3x3_s2_bwd": lambda: mp.max_pool_3x3_s2_bwd(x, dy),
            "dcn_gather_bwd": lambda: dcn.dcn_gather_bwd(xd, py, px, g),
            "render_heatmap": lambda: render_heatmap(locs, present, HEAT),
            "augment_and_render_batch_train": lambda: augment_and_render_batch(
                *train, HEAT, augment=False),
            "augment_and_render_batch_train_corner":
                lambda: augment_and_render_batch(*train, HEAT, augment=False,
                                                 corner_targets=True),
            "augment_and_render_batch_validation_corner":
                lambda: augment_and_render_batch(*validation, HEAT,
                                                 augment=False,
                                                 corner_targets=True),
            "floor": lambda: torch.add(one, one)}


def device_kernels(fn: Callable[[], object], calls: int) -> Dict:
    """Device ms per call of each kernel ``fn`` launches, and its
    launches per call, by ``torch.profiler`` over ``calls`` calls after
    two warm-up calls. The profiler records two rounds of ``calls`` and
    keeps the second: at the start of a trace CUPTI can miss a kernel's
    record (one of 50 render launches went missing once on the H100), so
    the first round only warms the tracer up. CUPTI has also dropped
    records inside the kept round (two of 50 once): the calls of ``fn``
    are alike, so a kernel whose records are not a whole multiple of
    ``calls`` lost some, and the measurement is taken again. A kept round
    has also come back with no device record at all (the second of three
    render measurements, on the H100): every ``fn`` measured here
    launches on the card, so such a round is taken again too. It tries
    up to five times. A lost record only lowers a count, so a complete
    round is never one that hides an extra launch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA],
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels: Dict[str, Dict[str, float]] = {}
        complete = True
        for evt in prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            complete = complete and evt.count % calls == 0
            # names that agree in their first 120 characters share a line
            line = kernels.setdefault(evt.key[:120],
                                      {"ms": 0.0, "launches": 0})
            line["ms"] += evt.self_device_time_total / 1e3 / calls
            line["launches"] += evt.count / calls
        if complete and kernels:
            break
    return {"ms": sum(k["ms"] for k in kernels.values()),
            "kernels": kernels}


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
