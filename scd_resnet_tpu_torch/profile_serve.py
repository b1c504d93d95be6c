"""Where a served slide's time goes on the card.

    python -m scd_resnet_tpu_torch.profile_serve [--requests 5] [--arch A ...]
        [--max-resident-clips N]

For ``cornerCPoolRes10``, ``centerOffsetRes10``,
``centerOffsetRes10dcn``, ``centerOffsetHourglass2``,
``cornerLegacyHourglass`` and ``centerRes10`` (or the ``--arch`` named)
at full width (seeded weights, ``infer/synthetic.py``; the centerSize
model's sizes are random and may be negative) on a seeded 3092x2056
slide (48 clips), after two warm-up requests, it prints one JSON line
per model with:

- ``e2e_ms``: host wall time of one ``analyse(slide)`` (upload, tiling,
  forward, decode, readback, stitch), mean over ``--requests``;
- ``phases_ms``: the same request cut into phases, each timed alone
  with CUDA events (host clock for the host stitch): upload, tile,
  forward, decode (wrapper minus forward), readback, stitch;
- ``kernels``: device time per request by kernel (``torch.profiler``
  over ``--requests`` requests), the largest first, and
  ``device_busy_share``: summed kernel time over the profiled wall time;
- ``peak_memory_gb``: ``torch.cuda.max_memory_allocated`` over the
  timed requests and phases;
- ``forward_gflop_per_clip``: the model's forward operations on one
  clip, counted by ``torch.utils.flop_counter`` (convolutions and
  products; the port's own kernels are not counted);
- ``modes``: ``e2e_ms`` and ``peak_memory_gb`` of the monolithic request
  and, with ``--max-resident-clips N``, of the same request streamed in
  column bands of at most N clips (``banded``, two warm-up requests
  first), with ``banded_equal``: whether its detections equal the
  monolithic ones;
- ``forward_by_batch`` (with ``--max-resident-clips N``): the wrapper's
  device time on the first N clips, on the first 24 (the batch a short
  band is padded to) and on all, and whether each batch's rows equal
  those of the same clips in the whole slide's batch.

Needs a CUDA card; float32 with TF32 off and deterministic cuDNN, as in
serving.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from scd_resnet_tpu_torch.core.device import reproducible_float32, resolve_device
from scd_resnet_tpu_torch.infer.analyse import (
    BATCH_SIZE,
    make_device_analyzer,
    make_device_tiler,
    stitch_any,
    slide_geometry,
)
from scd_resnet_tpu_torch.infer.synthetic import seeded_model, synthetic_slide
from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
from scd_resnet_tpu_torch.train.registry import get_model_profile

SLIDE_W, SLIDE_H = 3092, 2056
# arch -> seed
ARCHS = {"cornerCPoolRes10": 10, "centerOffsetRes10": 11,
         "centerOffsetRes10dcn": 12, "centerOffsetHourglass2": 13,
         "cornerLegacyHourglass": 14, "centerRes10": 15}


def device_ms(fn: Callable[[], object], n: int, warmup: int = 0) -> float:
    """Mean device time in ms of ``fn()`` over ``n`` calls, by CUDA
    events, after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def timed_requests(analyse: Callable, slide, n: int):
    """(detections, mean host ms of ``n`` requests, peak GB) after two
    warm-up requests."""
    for _ in range(2):
        analyse(slide)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(n):
        detections = analyse(slide)
    e2e_ms = (time.perf_counter() - t0) * 1e3 / n
    return detections, e2e_ms, torch.cuda.max_memory_allocated() / 1024 ** 3


def profile_arch(arch: str, seed: int, slide, n: int,
                 max_resident_clips: Optional[int] = None) -> Dict:
    device = torch.device("cuda")
    tiler = make_device_tiler(SLIDE_W, SLIDE_H, device)
    gray = torch.from_numpy(slide)
    clips = tiler(gray.to(device))
    profile = get_model_profile(arch)
    model = seeded_model(arch, seed, clips)
    wrapper = make_wrapper(model, profile.family)
    modes = {}
    if max_resident_clips:
        banded, ms, gb = timed_requests(make_device_analyzer(
            wrapper, SLIDE_W, SLIDE_H,
            max_resident_clips=max_resident_clips), slide, n)
        modes["banded"] = {"max_resident_clips": max_resident_clips,
                           "e2e_ms": ms, "peak_memory_gb": gb}
    analyse = make_device_analyzer(wrapper, SLIDE_W, SLIDE_H)
    detections, e2e_ms, gb = timed_requests(analyse, slide, n)
    modes["monolithic"] = {"e2e_ms": e2e_ms, "peak_memory_gb": gb}
    by_batch = {}
    if max_resident_clips:
        modes["banded_equal"] = banded == detections
        whole = wrapper(clips)
        axis = 0 if wrapper.contract == "cornerLegacy" else 1
        for size in (max_resident_clips, BATCH_SIZE, clips.shape[0]):
            part = clips[:size].contiguous()
            by_batch[size] = {
                "ms": device_ms(lambda: wrapper(part), n, warmup=1),
                "rows_equal_whole": torch.equal(
                    wrapper(part), whole.narrow(axis, 0, size))}

    counter = FlopCounterMode(display=False)
    with counter, torch.inference_mode():
        model(clips[:1])
    gray_dev = gray.to(device)
    rows = wrapper(clips)
    with torch.inference_mode():
        forward_ms = device_ms(lambda: model(clips), n)
        phases = {
            "upload": device_ms(lambda: gray.to(device), n),
            "tile": device_ms(lambda: tiler(gray_dev), n),
            "forward": forward_ms,
            "decode": device_ms(lambda: wrapper(clips), n) - forward_ms,
            "readback": device_ms(lambda: rows.cpu(), n),
        }
    geometry = slide_geometry(SLIDE_W, SLIDE_H)
    host_rows = rows.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(n):
        stitch_any(host_rows, wrapper.contract, *geometry, (SLIDE_W, SLIDE_H))
    phases["stitch"] = (time.perf_counter() - t0) * 1e3 / n

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            analyse(slide)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": evt.key[:120],
                            "ms_per_request": evt.self_device_time_total
                            / 1e3 / n,
                            "calls_per_request": evt.count / n})
    kernels.sort(key=lambda k: -k["ms_per_request"])
    busy_ms = sum(k["ms_per_request"] for k in kernels) * n
    return {"arch": arch, "clips": clips.shape[0],
            "detections": len(detections), "e2e_ms": e2e_ms,
            "phases_ms": phases,
            "device_busy_share": busy_ms / window_ms if window_ms else None,
            "kernels": kernels[:15],
            "forward_gflop_per_clip": counter.get_total_flops() / 1e9,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1024 ** 3,
            "modes": modes, "forward_by_batch": by_batch}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--requests", type=int, default=5)
    parser.add_argument("--arch", nargs="+", choices=sorted(ARCHS),
                        default=list(ARCHS), help="the models to profile")
    parser.add_argument("--max-resident-clips", type=int, default=None,
                        help="also time the request streamed in column "
                             "bands of at most this many clips")
    args = parser.parse_args(argv)
    resolve_device("cuda")
    reproducible_float32()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    slide = synthetic_slide(SLIDE_H, SLIDE_W, seed=2056)
    for arch in args.arch:
        result = profile_arch(arch, ARCHS[arch], slide, args.requests,
                              args.max_resident_clips)
        result["card"] = card
        print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
