"""What every cell shares: finding its files by name, the metrics it
reports, the readers that compute them, and the result's last line.

A cell (``workloads`` entry of ``BENCHMARK.json``) names a configuration
(``configs/<config>.json``, whose ``family`` names the reference's module
``reference/<family>.py``) and a traffic mix (``traffic/<traffic>.json``,
whose ``driver`` names the module under ``drivers/`` that runs it and
holds the system under test). Its limits are ``limits/<cell>.json``. A
metric is reported in the cells its ``workloads`` list names (an
end-to-end metric without one, in every cell); its value comes from
``metrics/<name>.py``'s ``read(record)``, which returns None when the run
gives it nothing to read (the metric is then left out).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "scd_resnet_tpu")


def process_age() -> float:
    """Seconds since this process started, from ``/proc/self/stat`` (its
    start in clock ticks since boot) and ``/proc/uptime``."""
    with open("/proc/self/stat") as f:
        started = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - started / os.sysconf("SC_CLK_TCK")


def build_state(root: Path = ROOT) -> Dict[str, int]:
    """Every file of the checkout's build and kernel caches (``build/``)
    with its modification time: a run whose set-up built or compiled
    anything changes it."""
    build = root / "build"
    if not build.is_dir():
        return {}
    return {str(p): p.stat().st_mtime_ns for p in build.rglob("*")
            if p.is_file()}


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: Dict, name: str) -> Dict:
    for entry in bench["workloads"]:
        if entry["name"] == name:
            return entry
    raise KeyError("no workload named {!r} in BENCHMARK.json".format(name))


def cell_files(bench: Dict, entry: Dict) -> Dict:
    """The cell's configuration, traffic and limits."""
    config = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {"config": load_json(ROOT / config["file"]),
            "traffic": load_json(HERE / "traffic" / (entry["traffic"]
                                                     + ".json")),
            "limits": load_json(HERE / "limits" / (entry["name"] + ".json"))}


def metrics_of(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The end-to-end metrics (``trace`` False) or per-layer ones (True)
    that the cell reports: an end-to-end metric in the cells its
    ``workloads`` list names, or in every cell without the list; a
    per-layer metric in the cells its ``workloads`` list names, which it
    must have."""
    if not trace:
        return [m for m in bench["end_to_end"]
                if cell_name in m.get("workloads", [cell_name])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise KeyError("per-layer metric {!r} has no workloads list"
                           .format(m["name"]))
    return [m for m in bench["per_layer"] if cell_name in m["workloads"]]


def reader(name: str) -> Callable[[Dict], Optional[float]]:
    path = HERE / "metrics" / (name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver(name: str):
    """The traffic's driver, ``portbench/drivers/<name>.py``: its
    ``run(ctx)``, the ``System`` under test, ``control(config)`` and its
    ``FAULTS``."""
    return importlib.import_module("portbench.drivers." + name)


def read_metrics(metrics: List[Dict], record: Dict) -> Dict[str, Dict]:
    out = {}
    for m in metrics:
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's (compared whole: ``scd_resnet_tpu_torch`` is the port)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def nearest_rank(values: List[float], q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) of ``values``."""
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q * len(ordered))) - 1]


def checks_line(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Dict[str, float]]:
    return {name: {"value": float(numbers[name]), "limit": limit}
            for name, limit in limits.items()}
