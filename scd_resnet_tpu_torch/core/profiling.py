"""A device trace of a window of training steps.

Counterpart of ``scd_resnet_tpu/core/profiling.py``, on
``torch.profiler``. The window comes from the same environment
variables, so no code changes to take a trace:

    SCD_PROFILE_DIR=/tmp/trace SCD_PROFILE_START=100 SCD_PROFILE_STEPS=5 \\
        python -m scd_resnet_tpu_torch.train exp.json

The trace starts when ``step`` sees ``it == start`` and stops when it sees
``it >= start + steps`` (the trainer calls it before each step, with the
step's 1-based number), or at ``close``. It is written as a Chrome trace,
``trace.{first}-{last}.json`` in the directory (the steps it holds;
``last`` is ``end`` when ``close`` is not told the step), with the
host's and (on a card) the device's activity; Perfetto and
``chrome://tracing`` open it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


class StepProfiler:
    """Starts and stops a ``torch.profiler`` trace around a step window."""

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
            self._profile = torch.profiler.profile(activities=activities)
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
