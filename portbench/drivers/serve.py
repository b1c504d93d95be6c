"""Closed-loop slide serving: one client sends the next raw slide when the
previous answer is back.

Set-up makes the traffic's pool of slides and the configuration's seeded,
calibrated weights, builds the system (which warms its slide geometry),
and sends ``warmup_requests`` requests. The window cycles through the pool
for ``seconds`` (the last request may end after it) and times each
request by the host's clock. After the window, the reference analyses
each slide that was served and every answer is compared with its slide's.

What the window drives:

- :class:`System`: the port's ``InferenceService`` on a decode wrapper of
  the configuration's profile, with the serve entry point's settings (TF32
  off, deterministic cuDNN), built with the traffic's ``port`` options,
  the slide geometry warmed by the service itself; a request is
  ``analyse_raw`` of the raw uint8 body;
- :class:`Control`: the plain reference in the precision below the
  configuration's (``reference/precision.py``), behind the same calls;
- ``FAULTS``: :class:`AlteredAnswer`, each answer with one detection's
  value (Rhr or score) moved by ``ALTERATION`` where the service produces
  it.

A traffic mix whose requests take another path of the port names a driver
of its own, which can take :func:`run` from here and bring its own
``System``.
"""

from __future__ import annotations

import functools
import math
import sys
import time
import traceback
from typing import Dict

import numpy as np
import torch

from portbench import compare, flops, inputs, weights
from portbench.harness import process_age
from portbench.reference import model as reference_model
from portbench.reference import serve as reference_serve
from portbench.reference.precision import QUANTIZERS
from portbench.trace import Window

ALTERATION = 0.05


class System:
    def __init__(self, config: Dict, traffic: Dict, state: Dict,
                 device: torch.device):
        from scd_resnet_tpu_torch.core.device import reproducible_float32
        from scd_resnet_tpu_torch.infer.server import InferenceService
        from scd_resnet_tpu_torch.infer.wrapper import make_wrapper
        from scd_resnet_tpu_torch.train.registry import get_model_profile

        reproducible_float32()
        profile = get_model_profile(config["arch"])
        model = profile.build()
        model.load_state_dict(state, strict=True)
        self.service = InferenceService(
            make_wrapper(model.to(device), profile.family),
            **traffic.get("port", {}))
        self.width, self.height = traffic["width"], traffic["height"]
        self.service.warmup(self.width, self.height)

    def request(self, body: bytes):
        return self.service.analyse_raw(body, self.width, self.height)

    def counters(self) -> Dict:
        return self.service.metrics()


class Control:
    def __init__(self, config: Dict, traffic: Dict, state: Dict,
                 device: torch.device, precision: str):
        self.model = reference_model.build(config)
        self.model.load_state_dict(state, strict=True)
        self.model.to(device).eval()
        self.family, self.device = config["family"], device
        self.quantize = QUANTIZERS[precision]
        self.width, self.height = traffic["width"], traffic["height"]
        self.requests = 0

    def request(self, body: bytes):
        gray = np.frombuffer(body, np.uint8).reshape(self.height, self.width)
        self.requests += 1
        return reference_serve.analyse(self.model, gray, self.family,
                                       self.device, quantize=self.quantize)

    def counters(self) -> Dict:
        return {"requests": self.requests}


def control(config: Dict) -> functools.partial:
    return functools.partial(Control, precision=config["serve"]["control"])


class AlteredAnswer(System):
    def request(self, body: bytes):
        answer = super().request(body)
        if answer:
            answer[0] = list(answer[0])
            answer[0][2] = answer[0][2] + ALTERATION
        return answer


FAULTS = {"altered_answer": AlteredAnswer}


def run(ctx: Dict) -> Dict:
    config, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    width, height = traffic["width"], traffic["height"]
    phases = {"imports": process_age()}
    slides = [inputs.slide(height, width, inputs.sub_seed(ctx["seed"], 2, i))
              for i in range(traffic["slides"])]
    phases["inputs"] = process_age()
    reference = reference_model.build(config)
    weights.fill(reference, config["weights"]["serve"], ctx["seed"], device)
    stack = reference_serve.clips(slides[0])
    calibration = torch.from_numpy(
        stack[:traffic["calibration_clips"]])[:, None].to(device)
    # a slide's detections, as many as it has blobs, spread over its clips
    per_clip = inputs.blobs(height, width) / len(stack)
    with torch.no_grad():
        weights.calibrate(reference, config["calibrate"], calibration,
                          per_clip)
    state = weights.state_dict(reference)
    del calibration
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    phases["weights"] = process_age()

    system = ctx["system"](config, traffic, state, device)
    phases["system"] = process_age()
    bodies = [s.tobytes() for s in slides]
    for i in range(traffic["warmup_requests"]):
        system.request(bodies[i % len(bodies)])
    setup_s = process_age()
    phases["warmup"] = setup_s

    latencies, answers, served = [], [], []
    window = Window(ctx["trace"], device)
    with window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx["seconds"]:
            s = len(answers) % len(bodies)
            start = time.perf_counter()
            with window.span("portbench.request"):
                try:
                    answer = system.request(bodies[s])
                except Exception:  # a failed request is counted, not fatal
                    traceback.print_exc(file=sys.stderr)
                    answer = None
            latencies.append(time.perf_counter() - start)
            answers.append(answer)
            served.append(s)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    memory = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    counted = system.counters()["requests"]
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()

    truth = {s: reference_serve.analyse(reference, slides[s],
                                        config["family"], device,
                                        block=traffic["reference_block"])
             for s in sorted(set(served))}
    numbers = compare.serve(answers, served, truth, config["contract"])
    completed = sum(a is not None for a in answers)
    numbers["uncounted"] = abs(counted - completed
                               - traffic["warmup_requests"])
    clip_h, clip_v, _, _ = reference_serve.geometry(width, height)
    clips = clip_h * clip_v
    batch = traffic["device_batch"]
    return {
        "kind": "serve", "setup_s": setup_s, "window_s": window_s,
        "attempted": len(answers), "failed": len(answers) - completed,
        # a failed request waited at least the whole window
        "latencies_ms": [1e3 * (t if a is not None else window_s)
                         for t, a in zip(latencies, answers)],
        "clips_per_request": clips, "completed": completed,
        "flops_per_clip": flops.forward_per_clip(config, reference_serve.CLIP),
        "memory_peak_bytes": memory, "events": window.events,
        "shape": {"B": math.ceil(clips / batch) * batch,
                  "S": reference_serve.CLIP // reference_serve.RATIO,
                  "C": config.get("pool_width", 0)},
        "numbers": numbers, "phases": phases,
        "detections": sum(len(a) for a in answers if a is not None)
        / max(1, completed),
    }
