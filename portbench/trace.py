"""The traced window: ``torch.profiler`` over the measured loop, read back
from its Chrome trace.

The window and every request or step are ``record_function`` spans of the
benchmark's own (``portbench.window``, ``portbench.request``,
``portbench.step``); the window's span closes after a synchronise, so
every kernel the window queued ends inside it. :func:`read` returns the
window's bounds, the device's operations (kernels, copies and fills, with
names), the benchmark's spans, and the host's operations on the thread
that ran the window, all in microseconds on the trace's clock.
:func:`busy` is the union of device intervals, so overlapping streams are
not counted twice. :func:`breakdown` names the device operations that
took most time and the host operations under which the device sat idle
longest.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "portbench.window"
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")


class Window:
    """Context manager around the measured loop; with ``enabled`` it
    profiles it, and :attr:`events` holds what :func:`read` made of the
    trace. ``span(name)`` marks one request or step."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.events: Optional[Dict] = None
        self._stack = contextlib.ExitStack()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __enter__(self):
        if self.enabled:
            activities = [torch.profiler.ProfilerActivity.CPU,
                          torch.profiler.ProfilerActivity.CUDA]
            self._prof = self._stack.enter_context(
                torch.profiler.profile(activities=activities))
            self._stack.enter_context(torch.profiler.record_function(WINDOW))
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._stack.close()
        if self.enabled and exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.events = read(json.load(f))
            finally:
                os.remove(path)
        return False


def read(chrome: Dict) -> Dict:
    """Window bounds, device operations, spans and host operations of a
    Chrome trace holding one ``portbench.window`` span."""
    events = [e for e in chrome.get("traceEvents", chrome)
              if e.get("ph") == "X" and "dur" in e]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("portbench.")]
    window = [e for e in marks if e["name"] == WINDOW]
    if len(window) != 1:
        raise ValueError("the trace holds {} window spans".format(len(window)))
    w = window[0]
    start, end = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    device = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"], e["cat"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES
                    and start <= float(e["ts"]) < end)
    spans = defaultdict(list)
    for e in marks:
        if e is not w:
            spans[e["name"]].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"])))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATEGORIES and e is not w
                  and e.get("tid") == w.get("tid")
                  and start <= float(e["ts"]) < end)
    return {"window": (start, end), "device": device,
            "spans": {k: sorted(v) for k, v in spans.items()}, "host": host}


def merged(intervals) -> List[Tuple[float, float]]:
    """Sorted, overlapping intervals merged."""
    out: List[List[float]] = []
    for s, e in sorted((float(i[0]), float(i[1])) for i in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy(intervals, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] that the union of ``intervals`` covers."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(intervals))


def gaps(events: Dict) -> List[Tuple[float, float]]:
    """The window's stretches with no device operation running."""
    lo, hi = events["window"]
    out, at = [], lo
    for s, e in merged(d[:2] for d in events["device"]):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(events: Dict, top: int = 10) -> Dict[str, list]:
    """``device_ops``: [name, seconds] of the device operations that took
    most time; ``idle_gaps``: [host operation, seconds] of the idle time
    under each host operation (the innermost one open at a gap's middle;
    ``host idle`` where none was), the largest first."""
    per_op = defaultdict(float)
    for s, e, name, _ in events["device"]:
        per_op[_short(name)] += (e - s) / 1e6
    idle = defaultdict(float)
    host = events["host"]
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for s, e in gaps(events):
        mid = (s + e) / 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        idle[_short(stack[-1][2]) if stack else "host idle"] += (e - s) / 1e6
    ranked = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                 key=lambda kv: -kv[1])[:top]]
    return {"device_ops": ranked(per_op), "idle_gaps": ranked(idle)}
