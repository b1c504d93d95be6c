"""Readings that the limits of a cell are set from (``limits/<cell>.json``).

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... \
        [--control-seeds 7 8 9] [--fault half_batch --fault-seeds 4 5 6] \
        [--seconds 2] [--out FILE]

In one process on the card: the system under test on each seed (a short
window at the cell's own load), then the control (the plain reference in
the precision below the configuration's, in the system's place) and any
planted fault (the ``FAULTS`` of the traffic's driver) on theirs. Each
run's compared numbers,
``correct`` under the current limits and its end-to-end metrics go to one
JSON line a run on standard output (and to ``--out``). The lower reading
of a number is the largest over the system's seeds; the upper, the
smallest over the control's (or a fault's).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root, not this folder, on the path: the folder's module
# names (trace, inputs, ...) would shadow the standard library's
sys.path[:] = [str(ROOT)] + [p for p in sys.path
                             if Path(p or ".").resolve() != ROOT / "portbench"]

from portbench import harness  # noqa: E402
from portbench.run import cache_dirs, control, run_cell  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--fault", default=None)
    parser.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--precision", default=None,
                        help="run the system in this training precision "
                        "(a witness), not the configuration's")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    cache_dirs()
    import torch

    bench = harness.benchmark()
    entry = harness.cell(bench, args.workload)
    files = harness.cell_files(bench, entry)
    if args.precision:
        files["config"]["train"]["precision"] = args.precision
    device = torch.device("cuda", 0)
    runs = [("system", s, None) for s in args.seeds]
    runs += [("control", s, control(files)) for s in args.control_seeds]
    if args.fault:
        faults = harness.driver(files["traffic"]["driver"]).FAULTS
        runs += [(args.fault, s, faults[args.fault])
                 for s in args.fault_seeds]
    out = open(args.out, "a") if args.out else None
    for kind, seed, system in runs:
        t0 = time.perf_counter()
        result, numbers, limits, record = run_cell(
            bench, entry, seed, args.seconds, False, device, system=system,
            files=files)
        line = json.dumps({
            "workload": args.workload, "kind": kind, "seed": seed,
            "correct": result["correct"], "numbers": numbers,
            "metrics": {k: v["value"] for k, v in result["metrics"].items()},
            "attempted": record["attempted"],
            "detections": record.get("detections"),
            "memory_peak_bytes": record["memory_peak_bytes"],
            "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
