"""A device trace of a window of training steps or served requests, and
the port's named spans inside it.

Counterpart of ``scd_resnet_tpu/core/profiling.py``, on
``torch.profiler``. The window comes from the same environment
variables, so no code changes to take a trace:

    SCD_PROFILE_DIR=/tmp/trace SCD_PROFILE_START=100 SCD_PROFILE_STEPS=5 \\
        python -m scd_resnet_tpu_torch.train exp.json

The trace starts when ``step`` sees ``it == start`` and stops when it sees
``it >= start + steps`` (the trainer calls it before each step, with the
step's 1-based number; ``infer/server.InferenceService`` before each
request, with the request's), or at ``close``. It is written as a Chrome
trace, ``trace.{first}-{last}.json`` in the directory (the steps it
holds; ``last`` is ``end`` when ``close`` is not told the step), with
the host's and (on a card) the device's activity; Perfetto and
``chrome://tracing`` open it.

:func:`span` marks a phase of the port (``scd.<layer>.<phase>``: the
analyzer's upload, tile, forward, readback and stitch, the train step's
feed, draws, transform, forward, loss, backward and optimizer, the
collectives) as a ``record_function`` range, so that it lands in the
same trace as the kernels, copies and fills, on the same clock. It costs
a range only while a profiler runs (this module's, the benchmark's, any
other); otherwise it is one shared no-op.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
import torch.autograd.profiler as autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs; else a shared ``nullcontext``, so an untraced call
    enters no range (a range costs about 13 us on the host even with no
    profiler, the check about 1). Two checks: ``_profiler_enabled`` is
    this thread's profiler, and reads false under one of all threads
    (:class:`StepProfiler`'s), which sets the process's flag."""
    if (autograd_profiler._is_profiler_enabled
            or torch._C._autograd._profiler_enabled()):
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepProfiler:
    """Starts and stops a ``torch.profiler`` trace around a step window.

    The trace holds every thread of the process and may start and stop on
    different ones, as a threaded server's requests do (a profiler of one
    thread sees only that thread, and must stop where it started)."""

    def __init__(self, trace_dir: Optional[str] = None,
                 start_step: Optional[int] = None, num_steps: int = 5):
        self.trace_dir = trace_dir or os.environ.get("SCD_PROFILE_DIR")
        env_start = os.environ.get("SCD_PROFILE_START")
        self.start_step = (start_step if start_step is not None
                           else int(env_start) if env_start else None)
        self.num_steps = int(os.environ.get("SCD_PROFILE_STEPS", num_steps))
        self._profile: Optional[torch.profiler.profile] = None
        self.trace_path: Optional[str] = None

    @property
    def enabled(self) -> bool:
        return bool(self.trace_dir) and self.start_step is not None

    @property
    def active(self) -> bool:
        return self._profile is not None

    def step(self, it: int) -> None:
        """Call once a training iteration, before its step."""
        if not self.enabled:
            return
        if not self.active and it == self.start_step:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profile = torch.profiler.profile(
                activities=activities,
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True))
            self._profile.start()
        elif self.active and it >= self.start_step + self.num_steps:
            self._stop(it - 1)

    def close(self, last: Optional[int] = None) -> None:
        """Stop an open trace: the run ended inside the window, its last
        step ``last``."""
        if self.active:
            self._stop(last)

    def _stop(self, last: Optional[int]) -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        profile, self._profile = self._profile, None
        profile.stop()
        os.makedirs(self.trace_dir, exist_ok=True)
        self.trace_path = os.path.join(self.trace_dir, "trace.{}-{}.json".format(
            self.start_step, "end" if last is None else last))
        profile.export_chrome_trace(self.trace_path)
