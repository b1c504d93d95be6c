"""The numbers that decide ``correct``: what the timed path produced
against the plain reference, each held to its limit.

Serving (``serve``): the answers of every request completed in the window
against the reference's answers for the same slide. Detections are keyed
by the contract's ``key`` fields (slide pixel and, for corners, the head);
within a key they pair in order of their ``value`` field, a side's extra
detections left out so that the pairs' widest gap is least.

- ``unmatched``: the most detections that one request has with no partner
  in the reference's answer, or the reference's with none in it (a
  detection moved by one pixel counts twice);
- ``value_gap``: the widest gap of a paired detection's value (Rhr or
  score), ``|program - reference| / max(1, |reference|)``;
- ``failed``: requests that raised, or never came;
- ``uncounted``: the service's request counter against the requests it
  answered, warm-up included (exact).

Training (``train``), from the first three steps the window's own call
made in set-up, against the reference's three steps from the same state,
rows and draws. Leaves whose reference gradient norm is below a
thousandth of the median leaf's are left out (they move by round-off
alone under Adam). A leaf's gap is ``| |program| - |reference| |`` over
the larger of the reference's norm of that leaf and of the median leaf.

- ``first_loss_gap``: ``|program - reference| / |reference|`` of the
  first step's loss;
- ``grad_gap``: the median leaf's gap of the first gradient as Adam holds
  it (its first moment after one step over 1 - beta1);
- ``change_gap``: the median leaf's gap of the parameters' change over
  the three steps;
- ``nonfinite_losses``: window steps whose loss is not finite.

Reported beside them and not compared (``PERF.md`` §2 gives why):
``loss_gap`` (the widest of the three losses' gaps), ``grad_gap_worst``
and ``change_gap_worst`` (the worst leaf's), and both sides' losses.
"""

from __future__ import annotations

from collections import defaultdict
from itertools import combinations
from typing import Dict, List, Optional

import numpy as np
import torch


def _index(detections: List[list], key, value: int) -> Dict:
    out = defaultdict(list)
    for det in detections:
        out[tuple(det[i] for i in key)].append(float(det[value]))
    for values in out.values():
        values.sort()
    return out


def _gap(x: float, y: float) -> float:
    if not np.isfinite(x) and not np.isfinite(y):
        return 0.0
    if not (np.isfinite(x) and np.isfinite(y)):
        return np.inf
    return abs(x - y) / max(1.0, abs(y))


def _paired_gap(ours: List[float], theirs: List[float]) -> float:
    """The widest gap of one key's sorted values, paired in order; the
    longer list's extra values (detections that one side has and the
    other has not, counted as unmatched) are left out so as to make that
    gap least."""
    n = min(len(ours), len(theirs))
    if n == 0:
        return 0.0
    best = np.inf
    for keep_ours in combinations(range(len(ours)), n):
        for keep_theirs in combinations(range(len(theirs)), n):
            best = min(best, max(_gap(ours[i], theirs[j]) for i, j in
                                 zip(keep_ours, keep_theirs)))
    return best


def detections(program: List[list], reference: List[list], contract: Dict
               ) -> Dict[str, float]:
    """``unmatched`` and ``value_gap`` of one request's answer."""
    key, value = contract["key"], contract["value"]
    ours, theirs = _index(program, key, value), _index(reference, key, value)
    unmatched, gap = 0, 0.0
    for k in set(ours) | set(theirs):
        a, b = ours.get(k, []), theirs.get(k, [])
        unmatched += abs(len(a) - len(b))
        gap = max(gap, _paired_gap(a, b))
    return {"unmatched": unmatched, "value_gap": gap}


def serve(answers: List[Optional[List[list]]], slides: List[int],
          reference: Dict[int, List[list]], contract: Dict
          ) -> Dict[str, float]:
    """The serving numbers over every request (``answers[i]`` None for a
    failed one, of slide ``slides[i]``)."""
    out = {"unmatched": 0, "value_gap": 0.0, "failed": 0}
    for answer, s in zip(answers, slides):
        if answer is None:
            out["failed"] += 1
            continue
        numbers = detections(answer, reference[s], contract)
        out["unmatched"] = max(out["unmatched"], numbers["unmatched"])
        out["value_gap"] = max(out["value_gap"], numbers["value_gap"])
    return out


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def _gaps(ours: Dict[str, float], theirs: Dict[str, float], keep
          ) -> List[float]:
    median = float(np.median([theirs[k] for k in keep]))
    return [abs(ours[k] - theirs[k]) / max(theirs[k], median) for k in keep]


def train(program: Dict, reference: Dict, start: Dict[str, torch.Tensor]
          ) -> Dict[str, float]:
    """The training numbers. ``program`` and ``reference`` hold
    ``losses``, ``grad`` (by parameter name) and ``params`` (after the
    steps); ``start`` the parameters both began from."""
    ref_grad = _norms(reference["grad"])
    median = float(np.median(list(ref_grad.values())))
    keep = [k for k, n in ref_grad.items() if n >= 1e-3 * median]
    loss_gaps = [abs(a - b) / abs(b) for a, b in
                 zip(program["losses"], reference["losses"])]
    change_p = _norms({k: program["params"][k].to(start[k].device) - start[k]
                       for k in keep})
    change_r = _norms({k: reference["params"][k] - start[k] for k in keep})
    grad = _gaps(_norms({k: program["grad"][k] for k in keep}), ref_grad,
                 keep)
    change = _gaps(change_p, change_r, keep)
    return {"loss_gap": max(loss_gaps), "first_loss_gap": loss_gaps[0],
            "losses": list(program["losses"]),
            "reference_losses": list(reference["losses"]),
            "grad_gap": float(np.median(grad)),
            "change_gap": float(np.median(change)),
            "grad_gap_worst": max(grad), "change_gap_worst": max(change),
            "leaves_left_out": len(ref_grad) - len(keep)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number at or under its limit (NaN fails)."""
    return all(float(numbers[name]) <= limit for name, limit in limits.items())
