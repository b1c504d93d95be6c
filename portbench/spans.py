"""The port's own spans in a traced window: ``scd.<layer>.<phase>``
``record_function`` ranges (``scd_resnet_tpu_torch/core/profiling.
span``), which :func:`portbench.trace.read` returns among the host
operations of the window's thread. A checkout whose port has no such
span gives the readers nothing to read, and they return None."""

from __future__ import annotations

from typing import Dict, Optional


def ms_per_request(record: Dict, name: str) -> Optional[float]:
    """Host ms of the spans ``name`` that start inside a traced request
    (``portbench.request``), summed and divided by the requests; None
    untraced, outside serving, or where no such span was recorded."""
    events = record["events"]
    if record["kind"] != "serve" or events is None:
        return None
    requests = events["spans"].get("portbench.request", [])
    ranges = [(s, e) for s, e, n in events["host"] if n == name]
    if not requests or not ranges:
        return None
    total = sum(e - s for s, e in ranges
                if any(lo <= s < hi for lo, hi in requests))
    return total / len(requests) / 1e3

