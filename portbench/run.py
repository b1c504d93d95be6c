"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json`` and the port
(``scd_resnet_tpu_torch``), on a machine with the cards the cell asks for.
It makes the cell's inputs and weights from the seed, builds and warms
the system (counted in ``setup_s``), measures for ``--seconds`` (with
``--trace 1`` a window of at most the traffic's ``trace_seconds`` under
``torch.profiler``), checks what the window produced against the plain
reference (``portbench/reference``), and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or its per-layer ones with ``--trace 1``),
``device`` and, traced, ``breakdown``; ``built``, whether set-up built
or compiled anything into the checkout's caches (the first run of a cell
in a checkout does); ``checks`` last, each compared number beside its
limit, as on the last lines of standard error.

Exits 2 without a result when no card (or too few) is visible, and 3 when
the process holds a module of the JAX stack or of the JAX package once
the window has closed. Builds and kernel caches stay in ``build/`` of the
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, on the path: the folder's module
# names (trace, inputs, ...) would shadow the standard library's
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import harness  # noqa: E402


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path in the checkout."""
    build = root / "build"
    os.environ["SCD_COMPILE_CACHE_DIR"] = str(build)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.pop("SCD_NO_COMPILE_CACHE", None)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return "unknown ({})".format(err)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unknown"


def run_cell(bench, entry, seed: int, seconds: float, trace: bool, device,
             system=None, files=None):
    """One run of cell ``entry`` on ``device``: ``(result, numbers,
    limits, record)``. ``system`` replaces the system under test (the
    control, or a planted fault); ``files`` the cell's configuration,
    traffic and limits (``harness.cell_files``)."""
    import torch

    from portbench import compare
    from portbench import trace as tracing
    from scd_resnet_tpu_torch.core.compile_cache import (
        enable_compilation_cache,
    )

    before = harness.build_state()
    enable_compilation_cache()
    files = files or harness.cell_files(bench, entry)
    traffic = files["traffic"]
    drive = harness.driver(traffic["driver"])
    if trace:
        seconds = min(seconds, traffic["trace_seconds"])
    with tempfile.TemporaryDirectory() as scratch:
        record = drive.run({
            "config": files["config"], "traffic": traffic, "seed": seed,
            "seconds": seconds, "trace": trace, "device": device,
            "system": system or drive.System, "workdir": scratch})
    record["cell"] = entry["name"]
    limits = files["limits"]
    numbers = record["numbers"]
    metrics = harness.read_metrics(
        harness.metrics_of(bench, entry["name"], trace), record)
    result = {
        "correct": compare.verdict(numbers, limits)
        and record["failed"] == 0,
        "attempted": record["attempted"], "failed": record["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu",
                   "count": entry["chips"],
                   "memory_peak_bytes": record["memory_peak_bytes"]},
    }
    events = record["events"]
    if events is not None:
        lo, hi = events["window"]
        result["device"]["busy_s"] = tracing.busy(
            [d[:2] for d in events["device"]], lo, hi) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = tracing.breakdown(events)
    # a run that built or compiled anything into the checkout's caches:
    # its set-up holds the build, and is not a warm run's
    result["built"] = harness.build_state() != before
    result["checks"] = harness.checks_line(numbers, limits)
    return result, numbers, limits, record


def control(files):
    """The cell's control: the reference in the precision below the
    configuration's, in the system's place."""
    return harness.driver(files["traffic"]["driver"]).control(
        files["config"])


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cache_dirs()
    bench = harness.benchmark()
    entry = harness.cell(bench, args.workload)
    started = {"python": harness.process_age()}
    import torch

    started["torch"] = harness.process_age()
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        print("portbench: the cell needs {} CUDA card(s); {} visible".format(
            entry["chips"], torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.zeros(1, device=device)
    started["cuda"] = harness.process_age()
    result, numbers, limits, record = run_cell(
        bench, entry, args.seed, args.seconds, bool(args.trace), device)
    record["phases"] = dict(started, **record["phases"])

    found = harness.forbidden_modules()
    if found:
        print("portbench: the process holds {}; no result".format(
            ", ".join(found)), file=sys.stderr)
        return 3
    card = power_limit()
    result["device"]["card"] = card
    print("portbench: {} seed {} on {}: setup {:.3f} s ({}), window "
          "{:.3f} s, {} attempted, {} failed".format(
              args.workload, args.seed, card, record["setup_s"],
              "built" if result["built"] else "nothing built",
              record["window_s"], record["attempted"], record["failed"]),
          file=sys.stderr)
    print("portbench: set-up phases (s since process start): {}".format(
        ", ".join("{} {:.2f}".format(k, v)
                  for k, v in record["phases"].items())), file=sys.stderr)
    if "detections" in record:
        print("portbench: {:.1f} detections a request".format(
            record["detections"]), file=sys.stderr)
    for name, value in sorted(numbers.items()):
        if name not in limits:
            print("portbench: {} {}".format(name, value), file=sys.stderr)
    for name, check in result["checks"].items():
        print("check {} {} limit {}".format(name, check["value"],
                                            check["limit"]), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
