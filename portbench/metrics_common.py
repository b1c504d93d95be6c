"""Arithmetic that several per-layer readers share: the table of peaks
(``peaks.json``), the device's idle share of a traced window, and the
port's kernels against their rooflines (``kernels/*.json``)."""

from __future__ import annotations

import ast
import json
import operator
import re
from typing import Dict, List, Optional

from portbench.harness import HERE
from portbench.trace import busy

_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Pow: operator.pow}


def peaks() -> Dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def peak(precision: str) -> float:
    return float(peaks()["flops_per_s"][precision])


def idle_share(record: Dict) -> Optional[float]:
    """100 x (1 - busy / window) of the traced window, or None untraced."""
    events = record["events"]
    if events is None:
        return None
    lo, hi = events["window"]
    return 100.0 * (1.0 - busy([d[:2] for d in events["device"]], lo, hi)
                    / (hi - lo))


def evaluate(expression: str, shape: Dict[str, int]) -> int:
    """An integer expression over the cell's shape names (``B``, ``S``,
    ...) with + - * // ** only."""
    def walk(node):
        if isinstance(node, ast.Expression):
            return walk(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, int):
            return node.value
        if isinstance(node, ast.Name):
            return int(shape[node.id])
        if isinstance(node, ast.BinOp) and type(node.op) in _OPS:
            return _OPS[type(node.op)](walk(node.left), walk(node.right))
        raise ValueError("unsupported expression {!r}".format(expression))
    return walk(ast.parse(expression, mode="eval"))


def kernels() -> List[Dict]:
    """Every kernel data file: ``name`` (the kernel's name in the trace,
    matched as a whole word), ``bytes`` and ``flops`` a launch (expressions
    over the cell's shape), ``precision`` (the peak its operations run
    at)."""
    out = []
    for path in sorted((HERE / "kernels").glob("*.json")):
        with open(path) as f:
            out.append(json.load(f))
    return out


def kernel_roofline(record: Dict) -> Optional[float]:
    """100 x the sum of the port's kernel launches' roofline times over the
    sum of their measured times in the traced window; None where none
    ran."""
    events = record["events"]
    if events is None:
        return None
    table = peaks()
    bound = measured = 0.0
    for kernel in kernels():
        pattern = re.compile(r"\b{}\b".format(re.escape(kernel["name"])))
        launches = [d for d in events["device"]
                    if d[3] == "kernel" and pattern.search(d[2])]
        if not launches:
            continue
        per_launch = max(
            evaluate(kernel["bytes"], record["shape"]) / table["bytes_per_s"],
            evaluate(kernel["flops"], record["shape"])
            / table["flops_per_s"][kernel["precision"]])
        bound += per_launch * len(launches)
        measured += sum(e - s for s, e, _, _ in launches) / 1e6
    if measured == 0.0:
        return None
    return 100.0 * bound / measured
