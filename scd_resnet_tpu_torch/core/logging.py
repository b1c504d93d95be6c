"""Console logger, the live progress line and per-step JSONL telemetry.

Counterpart of ``scd_resnet_tpu/core/logging.py`` (reference logger.py:39-61
for the colours and the tqdm loss bar it replaces).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional

_RESET = "\033[0m"
_COLORS = {
    "info": "\033[34m",       # blue
    "info_green": "\033[32m",  # green
    "warn": "\033[33m",       # yellow
    "err": "\033[31m",        # red
}


class Logger:
    @staticmethod
    def info(msg: str) -> None:
        print(_COLORS["info"] + msg + _RESET, flush=True)

    @staticmethod
    def info_green(msg: str) -> None:
        print(_COLORS["info_green"] + msg + _RESET, flush=True)

    # reference-compatible alias
    infoGreen = info_green

    @staticmethod
    def warn(msg: str) -> None:
        print(_COLORS["warn"] + msg + _RESET, flush=True)

    @staticmethod
    def err(msg: str) -> None:
        print(_COLORS["err"] + msg + _RESET, file=sys.stderr, flush=True)

    @staticmethod
    def log(msg: str) -> None:
        print(_RESET + msg, flush=True)


class ProgressLine:
    """Live in-place training progress — the interactive counterpart of the
    reference's tqdm loss bar (logger.py:63-80, networkFactory.py:159-162).

    Writes ``\\r``-refreshed ``[train] it I/T  loss L  ips R`` to stderr.
    Enabled on a TTY or with ``SCD_PROGRESS=1``; disabled with
    ``SCD_PROGRESS=0``. The loss value is only printed when the caller
    passes one — the training loop keeps per-step losses ON DEVICE and
    only hands over a float at its sync points, so the bar never forces a
    device round-trip.
    """

    def __init__(self, enabled: Optional[bool] = None) -> None:
        import os

        if enabled is None:
            env = os.environ.get("SCD_PROGRESS")
            if env is not None:
                enabled = env not in ("0", "false", "")
            else:
                enabled = sys.stderr.isatty()
        self.enabled = bool(enabled)
        self._last_loss: Optional[float] = None
        self._dirty = False

    def update(self, step: int, total: int, ips: float,
               loss: Optional[float] = None) -> None:
        if not self.enabled:
            return
        if loss is not None:
            self._last_loss = float(loss)
        loss_text = (
            "{:.4f}".format(self._last_loss)
            if self._last_loss is not None else "  -   "
        )
        sys.stderr.write(
            "\r[train] it {}/{}  loss {}  ips {:.2f}   ".format(
                step, total, loss_text, ips
            )
        )
        sys.stderr.flush()
        self._dirty = True

    def clear(self) -> None:
        """Erase the line before a normal log print so output stays clean
        (the tqdm-interception analog, logger.py:71-80)."""
        if self.enabled and self._dirty:
            sys.stderr.write("\r\033[K")
            sys.stderr.flush()
            self._dirty = False


class StepTelemetry:
    """Append-only JSONL telemetry of training steps.

    The reference only shows a live tqdm loss bar (networkFactory.py:159-162);
    here every step can additionally be recorded as one JSON line with wall
    time, so throughput regressions are diagnosable after the fact.
    """

    def __init__(self, path: Optional[str] = None, every: int = 50) -> None:
        self.path = path
        self.every = max(1, every)
        self._fh = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def record(self, step: int, payload: Dict[str, Any]) -> None:
        if self._fh is None or step % self.every != 0:
            return
        payload = dict(payload)
        payload["step"] = step
        payload["t"] = round(time.perf_counter() - self._t0, 4)
        self._fh.write(json.dumps(payload) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
