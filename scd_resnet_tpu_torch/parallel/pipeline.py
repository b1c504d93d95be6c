"""Pipeline parallelism over a rank's devices (GPipe), stage = one
hourglass stack.

Counterpart of ``scd_resnet_tpu/parallel/pipeline.py``. The stacked
hourglass (stackHourglass.py:130-272) repeats one body per stack:
hourglass -> prediction ConvBlock -> heads, plus the merge that makes the
next stack's ``inter`` input, the only activation one stack passes on.
Stage s runs on ``devices[s]`` of one process: the JAX package's
``pipe`` mesh axis, with ``.to(devices[s + 1], non_blocking=True)`` for
its ``ppermute``. The schedule (:func:`pipeline_apply`) runs M + S - 1
ticks; in tick t stage s takes microbatch t - s. Each device has its own
stream, so the stages of a tick overlap when they sit on different
cards. Autograd records the copies between devices, so the backward is
the reverse pipeline, as ``jax.grad`` through ``ppermute`` is.

In one process only the valid ticks run (the JAX ``scan`` feeds the
drain ticks a repeated microbatch and masks their results), so a stage
in train mode moves its BatchNorm statistics once a microbatch, in
microbatch order: :func:`pipeline_train_apply`'s semantics come from the
eager schedule alone.

A stage is :class:`StackStage`, a view of one stack of the plain model.
The JAX package's homogeneous ``HourglassPipelineStage`` (every stage
with a merge, so that the stage trees stack over the ``pipe`` axis) and
its ``init_stage_stack`` have no counterpart: here the stages are a
list of modules on their own devices, and nothing needs them alike.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
from torch import nn

from scd_resnet_tpu_torch.models.hourglass import StackHourglass
from scd_resnet_tpu_torch.models.layers import BatchNorm, checkpointed
from scd_resnet_tpu_torch.parallel.collectives import reduce_sum_


def _stack(items: List[Any]) -> Any:
    """Stack a list of tensors, or of dicts of tensors, along a new dim 0."""
    if isinstance(items[0], dict):
        return {k: torch.stack([it[k] for it in items]) for k in items[0]}
    return torch.stack(items)


def sequential_apply(stages: Sequence, microbatches,
                     devices: Optional[Sequence[torch.device]] = None) -> Any:
    """Ground truth: every microbatch through every stage in a plain loop,
    stage s on ``devices[s]`` (default: where its parameters are). Heads
    come back shaped (S, M, mb, ...) on the first stage's device (a dict
    of such for a multi-head stage)."""
    if devices is None:
        devices = [next(s.parameters()).device for s in stages]
    heads = [[] for _ in stages]
    for m in range(len(microbatches)):
        inter = microbatches[m].to(devices[0])
        for s, stage in enumerate(stages):
            inter, head = stage(inter.to(devices[s]))
            heads[s].append(head)
    return _stack([_to(_stack(h), devices[0]) for h in heads])


def _to(head, device):
    if isinstance(head, dict):
        return {k: v.to(device) for k, v in head.items()}
    return head.to(device)


def pipeline_apply(stages: Sequence, microbatches,
                   devices: Sequence[torch.device],
                   remat: bool = False) -> Any:
    """The GPipe forward: stage s (a module, or any callable returning
    ``(next_inter, head)``; the last one's ``next_inter`` may be None)
    runs on ``devices[s]``; microbatch m enters stage 0 at tick m, and a
    stage's ``next_inter`` goes one stage on per tick. M + S - 1 ticks.
    Heads come back shaped (S, M, mb, ...) on ``devices[0]``, equal to
    :func:`sequential_apply`'s. ``remat`` recomputes each stage
    application in the backward (``models/layers.checkpointed``)."""
    n_stages, n_micro = len(stages), len(microbatches)
    inbox: List[Optional[torch.Tensor]] = [None] * n_stages
    heads: List[List[Any]] = [[None] * n_micro for _ in range(n_stages)]
    for tick in range(n_micro + n_stages - 1):
        # last stage first, so a stage reads last tick's delivery before
        # the stage before it delivers the next one
        for s in reversed(range(n_stages)):
            m = tick - s
            if not 0 <= m < n_micro:
                continue
            inp = microbatches[m].to(devices[0], non_blocking=True) \
                if s == 0 else inbox[s]
            nxt, head = checkpointed(stages[s], inp, enabled=remat)
            heads[s][m] = head
            if s + 1 < n_stages:
                inbox[s + 1] = nxt.to(devices[s + 1], non_blocking=True)
    return _stack([_to(_stack(h), devices[0]) for h in heads])


def average_running_stats(modules: Sequence[nn.Module], group) -> None:
    """Running BatchNorm statistics averaged over a data group (the JAX
    pipeline's ``pmean`` of the stage statistics after the step)."""
    if group is None:
        return
    size = torch.distributed.get_world_size(group)
    with torch.no_grad():
        for module in modules:
            for bn in module.modules():
                if isinstance(bn, BatchNorm):
                    for buf in (bn.running_mean, bn.running_var):
                        buf.copy_(reduce_sum_(buf.clone(), group) / size)


def pipeline_train_apply(stages: Sequence[nn.Module], microbatches,
                         devices: Sequence[torch.device],
                         data_group=None, remat: bool = False) -> Any:
    """:func:`pipeline_apply` with the stages in train mode: BatchNorm
    normalises by each microbatch's moments and moves its running
    statistics once a microbatch, in microbatch order (the only ticks
    there are; module docstring). With ``data_group`` the moments stay
    rank-local and the running statistics are averaged over the group
    afterwards (``average_running_stats``)."""
    for stage in stages:
        stage.train()
    heads = pipeline_apply(stages, microbatches, devices, remat)
    average_running_stats(stages, data_group)
    return heads


class StackStage(nn.Module):
    """Stack ``s`` of a plain ``StackHourglass`` as a pipeline stage, on
    the model's own submodules (shared, not copied: the model's
    ``state_dict`` and parameters stay what they are). The last stack
    computes no merge and returns ``(None, heads)``."""

    def __init__(self, model: StackHourglass, s: int):
        super().__init__()
        self.hourglass = model.hourglassStack[s]
        self.prediction = model.redimConvolution[s]
        self.heads = nn.ModuleDict({name: getattr(model, name)[s]
                                    for name in model.terminal_names})
        self.merge = None if s == model.stacks - 1 else nn.ModuleList(
            [model.shortcutLayers[s], model.convPrevHourglass[s],
             model.interHourglassLayers[s]])

    def forward(self, inter: torch.Tensor):
        cnv = self.prediction(self.hourglass(inter))
        heads = {name: head(cnv) for name, head in self.heads.items()}
        if self.merge is None:
            return None, heads
        shortcut, previous, residual = self.merge
        return residual(torch.relu(shortcut(inter) + previous(cnv))), heads


def make_pipelined_stack_forward(model: StackHourglass,
                                 devices: Sequence[torch.device],
                                 n_micro: int, data_group=None,
                                 remat: bool = False):
    """A drop-in forward for the plain ``CenterNetHourglass`` (the JAX
    ``make_pipelined_stack_forward``), as a GPipe pipeline of its stacks
    over ``devices``: stack s's submodules move to ``devices[s]``, the
    preprocess to ``devices[0]``.

    ``forward(xs) -> [per-stack head dicts of (B, ...)]`` on
    ``devices[0]``, the plain forward's output. The preprocess runs on the
    whole batch on ``devices[0]`` (its BatchNorms take moments over the
    data group when the trainer set one); the batch is cut into
    ``n_micro`` microbatches that run through the stacks as
    :func:`pipeline_train_apply` says when the model is in train mode
    (``data_group`` averages the stacks' statistics), through
    :func:`pipeline_apply` in eval mode, and each stack's heads are
    concatenated back to (B, ...) for the loss.

    Each stage is the plain model's own per-stack submodules
    (:class:`StackStage`), so ``state_dict`` names, checkpoints and the
    optimizer are the plain model's, and gradients land on its
    parameters. The last stack computes no merge: the JAX stage computes
    one and discards it (zero gradient, its statistics dropped), so it
    needs ``split_stack_variables`` to make the stacks' trees alike and
    ``merge_stage_stats`` to scatter the statistics back; here neither
    exists. ``remat`` recomputes each stage application in the
    backward."""
    stages = [StackStage(model, s) for s in range(model.stacks)]
    model.preprocess.to(devices[0])
    for stage, device in zip(stages, devices):
        stage.to(device)

    def forward(xs: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        inter = model.preprocess(xs)
        mbs = inter.reshape((n_micro, inter.shape[0] // n_micro)
                            + tuple(inter.shape[1:]))
        heads = pipeline_train_apply(stages, mbs, devices, data_group,
                                     remat) if model.training \
            else pipeline_apply(stages, mbs, devices)
        return [{k: v[s].reshape((-1,) + tuple(v.shape[3:]))
                 for k, v in heads.items()} for s in range(model.stacks)]

    return forward
