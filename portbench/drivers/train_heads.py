"""Training steps as the ``train`` driver runs them, with one more compared
number: the first forward's heads.

On the published CornerNet's 104 layers at seeded step-0 weights, a
rounding anywhere in the forward reaches the second stack's heads and the
loss many times amplified: a relative nudge of 1e-3 to the input moves a
loss term by up to 18 %, so bfloat16 and the fp8 control both put the
first loss some percent from float32's, and the loss and the gradient's
norms do not tell the precisions apart (``PERF.md`` section 2). The first
stack's heads still do:

- ``head_gap``: the widest, over the first stack's heads (each corner's
  heat, tag and offset maps), of ``||program - reference|| /
  ||reference||`` in the first step's forward from the step-0 weights,
  over the clips both took (the ``half_batch`` fault takes the batch's
  first half).

The system, the control and the faults are ``train``'s; each is built
with a forward hook on its model that keeps the first call's first stack
and then removes itself. After the window the reference's forward is
computed from the same seed's weights, pool and first batch, in training
mode (the batch's moments), in float32.
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import inputs, weights
from portbench.drivers import train
from portbench.reference import model as reference_model
from portbench.reference import train as reference_train

System, FAULTS, control = train.System, train.FAULTS, train.control


def _model(system) -> torch.nn.Module:
    """The module a step calls: the port's model, or the reference's under
    the control."""
    factory = getattr(system, "factory", None)
    return factory.model if factory is not None else system.trainer.model


def keep_first(model: torch.nn.Module, kept: Dict) -> None:
    """Fill ``kept`` with the first stack of ``model``'s next forward, in
    float32, once."""

    def hook(module, args, outs):
        handle.remove()
        kept.update({k: v.detach().float().clone()
                     for k, v in outs[0].items()})

    handle = model.register_forward_hook(hook)


def _reference_heads(ctx: Dict) -> Dict[str, torch.Tensor]:
    """The float32 reference's first stack on the first step's batch."""
    config, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    size, pool, seed = traffic["clip"], traffic["pool"], ctx["seed"]
    samples, locs, counts = inputs.train_pool(
        pool, size, traffic["max_objects"], seed, device)
    model = reference_model.build(config)
    weights.fill(model, config["weights"]["train"], seed, device)
    feed = train.Feed(seed, pool, traffic["rows"] // pool, traffic["batch"],
                      size, device)
    idx, draws = feed.next()
    rows = torch.from_numpy(idx % pool).to(device)
    job = config["train"]
    x, _ = reference_train.transform(
        samples[rows], locs[rows], counts[rows], draws, size // 4,
        reference_model.family(config["family"]).CORNER_MAPS,
        job["heatIou"], job["noise"], job["jitter"])
    model.train()
    with torch.no_grad(), reference_model.float32_math():
        return dict(model(x)[0])


def head_gap(program: Dict[str, torch.Tensor],
             reference: Dict[str, torch.Tensor]) -> float:
    """The module docstring's ``head_gap``; infinite where the program
    kept no forward."""
    if not program:
        return float("inf")
    gaps = []
    for name, want in reference.items():
        got = program[name].to(want.device).double()
        want = want[:len(got)].double()
        gaps.append(float(torch.linalg.vector_norm(got - want)
                          / torch.linalg.vector_norm(want)))
    return max(gaps)


def run(ctx: Dict) -> Dict:
    kept: Dict[str, torch.Tensor] = {}
    make = ctx["system"]

    def build(*args):
        system = make(*args)
        keep_first(_model(system), kept)
        return system

    record = train.run(dict(ctx, system=build))
    record["numbers"]["head_gap"] = head_gap(kept, _reference_heads(ctx))
    return record
