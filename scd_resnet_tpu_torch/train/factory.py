"""The trainer: one train step on one card, and the schedule loop.

Counterpart of ``scd_resnet_tpu/train/factory.py`` (reference
models/networkFactory.py) for the centerOffset, corner and cornerLegacy
families on one card:

- ``make_lr_schedule`` / ``make_optimizer``: Adam, or SGD with momentum
  0.9 and weight decay 1e-4, on optax's piecewise-constant schedule. The
  update with 0-based count n uses ``schedule(n)``, so a milestone at
  11,000 already decays the update of count 11,000, as optax does;
- the step: augment + render (K1 on the card; the corner families'
  tl/br heatmaps too, the cornerLegacy family's in two launches) ->
  forward, under
  ``torch.autocast(bfloat16)`` when ``precision`` is ``bfloat16`` ->
  loss in float32 -> backward -> update. Parameters, BatchNorm
  statistics and the loss stay float32. A bfloat16 model is laid out
  channels-last, its Adam state and activations following it, and a
  float32 one NCHW (``ops/layout``); checkpoints hold the plain layout;
- ``remat``: a model with a ``remat`` argument (the stacked hourglasses)
  recomputes its own parts in the backward; any other model has its
  whole forward recomputed (``models/layers.checkpointed``), as the JAX
  trainer falls back to ``jax.checkpoint`` of the forward. The
  BatchNorm statistics move once a step either way;
- a device-resident dataset (``residency`` auto/device/host,
  ``storageDtype``): the training rows sit on the card in the storage
  dtype and each step sends an index vector; host streaming when they
  do not fit the budget;
- validation at the ``validation`` cadence: the [Tr] line on the
  last trained batch and the [It] line on the validation set, which the
  dataset renders once. The port runs eagerly, so the last batch's
  augmented arrays still exist and the [Tr] line reads them (the JAX
  trainer rebuilds them from the same key); the JAX trainer, when its
  validation set is resident, renders it again on every pass;
- ``bestSnapshotMetric``, the loss CSVs, ``evals.{trainName}.txt``, JSONL
  telemetry, the stop at a non-finite loss, SIGTERM/SIGINT preemption
  and exact resume from ``currentIter``;
- with ``debug`` (the train CLI's ``-debug``), overlay PNGs of the last
  trained batch at every validation boundary
  (:meth:`NetworkFactory.dump_debug_overlays`);
- a ``torch.profiler`` trace of the step window that ``SCD_PROFILE_DIR``,
  ``SCD_PROFILE_START`` and ``SCD_PROFILE_STEPS`` name
  (``core/profiling.StepProfiler``). Under any profiler a step's phases
  are spans (``core/profiling.span``): ``scd.step.feed`` (the batch's
  rows to the card), ``draws``, ``transform`` (augment and render),
  ``optimizer`` (the learning rate and ``zero_grad``; then the update),
  ``forward``, ``loss`` and ``backward``; the loop's
  ``scd.train.validate`` and ``scd.train.snapshot``; and on a mesh the
  collectives, ``scd.collective.bn_stats``, ``loss_counts``,
  ``grad_sum``, ``report`` and ``stop_flag``.

Each step's draws come from a ``torch.Generator`` seeded from
(seed + 1, step) (``data/pipeline.step_seed``), the JAX trainer's
``fold_in(PRNGKey(seed + 1), step)``, so a resumed run continues the
sequence. The validation set is cut into whole batches (a remainder is
dropped, ``data/dataset.get_validation_set``), so no batch carries
padding rows and no decoded score needs the JAX trainer's padding mask.

The mesh (``meshShape``/``meshAxes``, ``parallel/mesh.py``; the JAX
trainer's ``factory.py:177-277``), for ranks started by ``torchrun``:

- ``data``: each rank trains its block of the global batch. Every rank
  draws the global batch's ``Draws`` and keeps its rows, so the mesh is
  a placement decision, not a numerics one: BatchNorm takes the global
  batch's moments, the losses its counts, and the gradients are summed
  over the data group in buckets. A resident dataset holds shard d's rows
  on rank d (``data/dataset.device_shards``). Streamed from the host, a
  rank packs only its block of the batch; on N torchrun nodes
  (``parallel/mesh.node_layout``) node n reads ``order[n::N]`` of each
  epoch, the JAX trainer's per-host split, and each rank takes its block
  of its node's batch, as a JAX device takes its block of its host's.
  Without ``meshShape`` under
  ``torchrun`` the data axis is the world size; a batch it does not
  divide raises, since a rank cannot sit idle the way a spare JAX device
  does;
- ``model``: wide kernels keep a slice of their output channels on each
  model rank and run column-parallel (``parallel/mesh.shard_model``);
  Adam runs on the slices; a checkpoint gathers them, so it loads into
  the single-card trainer and the serving wrapper;
- ``pipe``: the stacked hourglass as a GPipe pipeline of its stacks over
  the rank's devices, in ``pipelineMicrobatches`` microbatches
  (``parallel/pipeline.make_pipelined_stack_forward``);
- validation shards each batch over the data ranks and gathers the
  decoded rows before the metric battery (a batch the data axis does not
  divide runs whole on every rank), so every rank gets the same lines;
  only rank 0 writes checkpoints, loss rows, evals, telemetry, traces
  and overlays; every rank loads the same checkpoint; a stop request on
  any rank stops them all at the same step (the flag summed on the host
  each step over a gloo group, so the check waits for no card).

A run without ``torchrun`` and without ``meshShape`` takes none of these
paths; a mesh of one rank and one device computes what it computes.
"""

from __future__ import annotations

import inspect
import json
import os
import re
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from scd_resnet_tpu_torch.core import cuda_build
from scd_resnet_tpu_torch.core.checkpoint import (
    load_state_dict,
    load_training_checkpoint,
    save_training_checkpoint,
)
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.core.logging import Logger, ProgressLine, StepTelemetry
from scd_resnet_tpu_torch.core.profiling import StepProfiler, span
from scd_resnet_tpu_torch.data.dataset import SCDDataset, as_storage
from scd_resnet_tpu_torch.data.pipeline import (
    Draws,
    augment_and_render_batch,
    draw,
    step_seed,
)
from scd_resnet_tpu_torch.models.center_net_offset import (
    CenterNetHourglass,
    as_stack_list,
)
from scd_resnet_tpu_torch.models.layers import BatchNorm, checkpointed
from scd_resnet_tpu_torch.models.resnet import init_like_flax
from scd_resnet_tpu_torch.ops.layout import (
    one_channel_channels_last,
    to_memory_format,
)
from scd_resnet_tpu_torch.ops.losses import global_counts
from scd_resnet_tpu_torch.parallel.collectives import (
    gather_rows,
    reduce_sum_,
    sync_gradients,
)
from scd_resnet_tpu_torch.parallel.mesh import (
    full_checkpoint_state,
    host_group,
    local_checkpoint_state,
    mesh_from_config,
    node_layout,
    resolve_axes,
    shard_model,
    shard_rows,
    stage_devices,
)
from scd_resnet_tpu_torch.parallel.pipeline import make_pipelined_stack_forward
from scd_resnet_tpu_torch.train.registry import get_dataset_profile, get_model_profile

_METRIC_TOKEN = re.compile(r"\[(\S+?)\]\s+([-+0-9.eE]+)")


def parse_metric_line(line: str, name: str) -> Optional[float]:
    """``[name] value`` from a [Tr]/[It] report line, or None."""
    for key, val in _METRIC_TOKEN.findall(line):
        if key == name:
            try:
                return float(val)
            except ValueError:
                return None
    return None


def overlay_markers(ys: List[np.ndarray], heat_size: int, legacy: bool,
                    j: int) -> List[Tuple[str, Any, Dict[str, Any]]]:
    """The debug overlay's markers for clip ``j`` of a batch's host
    targets ``ys`` (the batch transform's layout), as ``(ImageDraw
    method, xy, style)``, in the JAX trainer's order and arithmetic
    (``scd_resnet_tpu/train/factory.py:899-931``).

    Center and corner batches share ``[heat, mask, regr, inds, ...]``:
    each object gets a circle at its centre (the heat cell times 4 plus
    the offset, already in pixels) and its major axis. Legacy batches,
    ``[tl heat, br heat, mask, tl regr, br regr, tl inds, br inds]``, get
    the box the tl and br corners span and a circle at each corner."""
    markers: List[Tuple[str, Any, Dict[str, Any]]] = []

    def corner_px(inds_jk, regr_jk):
        x = (float(inds_jk % heat_size) + float(regr_jk[0])) * 4
        y = (float(inds_jk // heat_size) + float(regr_jk[1])) * 4
        return x, y

    mask = ys[2] if legacy else ys[1]
    for k in range(mask.shape[1]):
        if not bool(mask[j, k]):
            continue
        if legacy:
            tlx, tly = corner_px(ys[5][j, k], ys[3][j, k])
            brx, bry = corner_px(ys[6][j, k], ys[4][j, k])
            markers += [
                ("rectangle", [min(tlx, brx), min(tly, bry), max(tlx, brx),
                               max(tly, bry)], {"outline": (64, 255, 64)}),
                ("ellipse", [tlx - 3, tly - 3, tlx + 3, tly + 3],
                 {"outline": (64, 160, 255), "width": 2}),
                ("ellipse", [brx - 3, bry - 3, brx + 3, bry + 3],
                 {"outline": (255, 160, 64), "width": 2})]
            continue
        regr, inds = ys[2], ys[3]
        cx = float(inds[j, k] % heat_size) * 4 + float(regr[j, k, 0])
        cy = float(inds[j, k] // heat_size) * 4 + float(regr[j, k, 1])
        markers += [
            ("ellipse", [cx - 3, cy - 3, cx + 3, cy + 3],
             {"outline": (255, 64, 64), "width": 2}),
            ("line", [(cx - regr[j, k, 2] * 4, cy - regr[j, k, 3] * 4),
                      (cx + regr[j, k, 2] * 4, cy + regr[j, k, 3] * 4)],
             {"fill": (64, 255, 64)})]
    return markers


def make_lr_schedule(base_lr: float, decay_steps: List[int],
                     decay_rates: List[float]) -> Callable[[int], float]:
    """optax's ``piecewise_constant_schedule(base_lr, {step: 1/rate})``:
    the rate at update count n is base_lr times the scales of every
    milestone <= n, multiplied in float32 as optax does."""
    milestones = sorted((int(s), np.float32(1.0 / float(r)))
                        for s, r in zip(decay_steps, decay_rates))

    def schedule(count: int) -> float:
        value = np.float32(base_lr)
        for boundary, scale in milestones:
            if count >= boundary:
                value = np.float32(scale * value)
        return float(value)

    return schedule


def _gather_tree(tree, group):
    """Every tensor of a decode's output (lists, tuples, dicts) gathered
    along its batch rows over ``group``."""
    if isinstance(tree, torch.Tensor):
        return gather_rows(tree, group)
    if isinstance(tree, dict):
        return {k: _gather_tree(v, group) for k, v in tree.items()}
    return type(tree)(_gather_tree(v, group) for v in tree)


def make_optimizer(name: str, params, lr: float) -> torch.optim.Optimizer:
    """Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) or SGD with
    momentum 0.9 and weight decay 1e-4 folded into the gradient."""
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9,
                               weight_decay=1e-4)
    raise ValueError("unknown optimizer '{}', currently support 'sgd' or "
                     "'adam'".format(name))


class NetworkFactory:
    """Builds the model, optimizer and dataset from a configuration and
    runs the training schedule on ``device``: a card (``cuda``, or
    ``cuda:N`` to pin every rank and stage to card N) or ``cpu``. Under
    ``torch.distributed`` (started by the caller, ``parallel/mesh.
    init_distributed``) or with ``meshShape``, on the mesh (module
    docstring)."""

    def __init__(self, config: Configuration,
                 dataset: Optional[SCDDataset] = None,
                 device: str | torch.device = "cuda",
                 seed: Optional[int] = None):
        self.config = cfg = config
        if seed is None:
            seed = int(cfg.config.get("seed", 42))
        self.debug = bool(cfg.config.get("debug", False))
        self._setup_mesh(resolve_device(device))

        self.profile = get_model_profile(cfg.modelName)
        if self.profile.loss is None:
            raise NotImplementedError(
                "profile '{}' has no training loss in the port".format(
                    cfg.modelName))
        Logger.info("Loaded model profile: {}".format(cfg.modelName))
        precision = cfg.config.get("precision", "float32")
        if precision not in ("float32", "bfloat16"):
            raise ValueError("precision must be float32 or bfloat16, not "
                             "{}".format(precision))
        # cuDNN's settings are the entry point's (core/device.training_backends)
        self.autocast = precision == "bfloat16"

        # remat as the JAX trainer sets it (factory.py:142-147, 352-354)
        remat = bool(cfg.config.get("remat", False))
        own_remat = "remat" in inspect.signature(
            self.profile.model_cls).parameters
        self.model = self.profile.build(**({"remat": True}
                                           if remat and own_remat else {}))
        self.remat_forward = remat and not own_remat
        init_like_flax(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        # the model's and the batches' layout: bf16 cuDNN runs NHWC, and a
        # float32 run stays NCHW, held to the CPU
        self.memory_format = torch.channels_last if self.autocast \
            else torch.contiguous_format
        if self.memory_format == torch.channels_last:
            to_memory_format(self.model, self.memory_format)
        self._forward = lambda xs: checkpointed(self.model, xs,
                                                enabled=self.remat_forward)
        self._eval_forward = self.model
        self.sharded: Dict[str, int] = {}
        if self.mesh is not None:
            self._parallelise(remat)
        self.loss = self.profile.loss
        self.decode = self.profile.decode
        self.evaluation = self.profile.evaluation
        self.expression = self.profile.expression

        if dataset is None:
            ds_profile = get_dataset_profile(cfg.datasetName)
            Logger.info("Loaded dataset profile: {}".format(cfg.datasetName))
            data_split = None
            if os.path.exists(cfg.dirDataSplitProfile):
                with open(cfg.dirDataSplitProfile) as f:
                    data_split = json.load(f)
            if self.world > 1:  # every rank has read it before rank 0
                dist.barrier(  # writes it again
                    device_ids=[self.device.index]
                    if dist.get_backend() == dist.Backend.NCCL else None)
            dataset = SCDDataset(
                cfg.dirDatafile, data_split,
                argument_ratio=ds_profile.argument_ratio,
                partition=ds_profile.partition,
                train_subset=ds_profile.train_subset,
                split_profile_path=cfg.dirDataSplitProfile
                if self.rank == 0 else None, seed=seed,
                storage_dtype=cfg.storageDtype, device=self.device)
        self.dataset = dataset
        self.heat_size = dataset.heat_size
        self.sample_size = dataset.samples.shape[1]

        model_size = self.mesh.size("model") if self.mesh else 1
        self.parameter_count = sum(
            p.numel() * (model_size if name in self.sharded else 1)
            for name, p in self.model.named_parameters())
        Logger.log("Parameter Count: {}".format(self.parameter_count))
        self.schedule = make_lr_schedule(cfg.learningRate,
                                         cfg.learningRateDecay,
                                         cfg.learningRateDecayRate)
        self.optimizer = make_optimizer(cfg.optimizer,
                                        self.model.parameters(),
                                        self.schedule(0))
        self.updates = 0  # optimizer updates made: the schedule's count
        self._aug_seed = seed + 1
        self._aug_step = int(cfg.currentIteration)
        self._last_batch: Optional[Tuple[torch.Tensor, List]] = None
        # on a card, two events taking turns after each step's update:
        # the next feed asks the last one whether the card is still busy
        self._step_done = (torch.cuda.Event(), torch.cuda.Event()) \
            if self.device.type == "cuda" else None
        self._steps_done = 0
        self._stop_requested = False
        self.preempted = False
        self._setup_residency()

    # ---- the mesh ------------------------------------------------------------

    def _setup_mesh(self, device: torch.device) -> None:
        """``self.mesh`` (None on the plain path), ``self.device``, this
        rank's place and its data group."""
        cfg = self.config
        initialized = dist.is_initialized()
        self.rank = dist.get_rank() if initialized else 0
        self.world = dist.get_world_size() if initialized else 1
        self.mesh = None
        self.device = device
        self.data_group = None
        self._data_size, self._data_index = 1, 0
        mesh_shape = cfg.config.get("meshShape")
        if not mesh_shape and not initialized:
            return
        shape = mesh_shape or [self.world]
        axes = resolve_axes(shape, cfg.config.get("meshAxes")
                            if mesh_shape else None)
        local_rank = int(os.environ.get("LOCAL_RANK", self.rank))
        pipe = dict(zip(axes, shape)).get("pipe", 1)
        stages = stage_devices(device, pipe, local_rank)
        if stages[0].type == "cuda":  # the card NCCL binds this rank to
            torch.cuda.set_device(stages[0])
        self.mesh = mesh_from_config(
            shape, axes, stages, batch_size=cfg.batchSize,
            world_size=self.world, rank=self.rank)
        self.device = self.mesh.devices[0]
        # the stop flag's group: gloo on host tensors, so the per-step
        # check waits for the other ranks' loops and not for the card
        self._host_group = host_group() if self.world > 1 else None
        self.data_group = self.mesh.group("data")
        self._data_size = self.mesh.size("data")
        self._data_index = self.mesh.index("data")
        Logger.log("Mesh: {} (rank {} of {}, stages on {})".format(
            self.mesh, self.rank, self.world,
            ", ".join(str(d) for d in self.mesh.devices)))

    def _parallelise(self, remat: bool) -> None:
        """The model on the mesh: the pipeline's guards and forward (the
        JAX trainer's ``factory.py:215-244``), the model axis's shards,
        and the data group on the BatchNorms that see the whole batch."""
        cfg, mesh = self.config, self.mesh
        pipe = mesh.size("pipe")
        bn_scope = self.model
        if pipe > 1:
            if not isinstance(self.model, CenterNetHourglass):
                raise ValueError(
                    "a 'pipe' mesh axis pipelines the stacked-hourglass "
                    "family (stage = stack); model '{}' has no stack "
                    "boundary to cut at".format(cfg.modelName))
            if self.model.stacks != pipe:
                raise ValueError(
                    "mesh 'pipe' axis ({}) must equal the model's stack "
                    "count ({})".format(pipe, self.model.stacks))
            micro = int(cfg.config.get("pipelineMicrobatches") or 2 * pipe)
            if (cfg.batchSize % micro
                    or (cfg.batchSize // micro) % self._data_size):
                raise ValueError(
                    "batchSize {} must split into {} microbatches of a "
                    "size divisible by the data axis ({})".format(
                        cfg.batchSize, micro, self._data_size))
            Logger.log(
                "Pipeline-parallel training: {} stages x {} microbatches "
                "(bubble fraction {:.0%})".format(
                    pipe, micro, (pipe - 1) / (micro + pipe - 1)))
            self.pipeline_microbatches = micro
            bn_scope = self.model.preprocess
        if mesh.size("model") > 1:
            self.sharded = shard_model(self.model, mesh)
            Logger.log("Model axis: {} of {} parameters sharded over {} "
                       "ranks".format(len(self.sharded),
                                      len(list(self.model.parameters())),
                                      mesh.size("model")))
        if pipe > 1:
            self._forward = make_pipelined_stack_forward(
                self.model, mesh.devices, self.pipeline_microbatches,
                self.data_group, remat)
            self._eval_forward = make_pipelined_stack_forward(
                self.model, mesh.devices, 1)
        for module in bn_scope.modules():
            if isinstance(module, BatchNorm):
                module.process_group = self.data_group

    def _any_stop(self) -> bool:
        """Whether any rank asked to stop (every rank calls it each
        step), summed on the host over ``self._host_group``."""
        if self.world == 1:
            return self._stop_requested
        with span("scd.collective.stop_flag"):
            flag = torch.tensor([float(self._stop_requested)])
            return bool(reduce_sum_(flag, self._host_group).item() > 0)

    def request_stop(self, signum=None, frame=None) -> None:
        """Stop at the next step boundary with a full checkpoint (the
        SIGTERM/SIGINT handler of ``begin_training``)."""
        self._stop_requested = True

    # ---- the step ------------------------------------------------------

    def draws_for_step(self, step: int, batch: int) -> Draws:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self._aug_seed, step))
        return draw(gen, batch, self.sample_size, self.device)

    def _step(self, samples: torch.Tensor, locs: torch.Tensor,
              counts: torch.Tensor, draws: Optional[Draws]):
        with span("scd.step.draws"):
            if draws is None:
                draws = self.draws_for_step(
                    self._aug_step, samples.shape[0] * self._data_size)
            if self.mesh is not None:  # this rank's rows of the global draws
                draws = Draws(*(shard_rows(self.mesh, d) for d in draws))
        self._aug_step += 1
        with span("scd.step.transform"):
            xs, ys = augment_and_render_batch(
                samples, locs, counts, self.heat_size, draws=draws,
                corner_targets=self.profile.corner_targets)
            if self.memory_format == torch.channels_last:
                xs = one_channel_channels_last(xs)
        with span("scd.step.optimizer"):
            lr = self.schedule(self.updates)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
            self.optimizer.zero_grad(set_to_none=True)
        with span("scd.step.forward"):
            self.model.train()
            with torch.autocast(self.device.type, dtype=torch.bfloat16,
                                enabled=self.autocast):
                outs = self._forward(xs)
        with span("scd.step.loss"), global_counts(self.data_group):
            loss, stats = self.loss(as_stack_list(outs), ys)
        with span("scd.step.backward"):
            loss.backward()
        if self.data_group is not None:
            with span("scd.collective.grad_sum"):
                sync_gradients(self.model.parameters(), self.data_group)
        with span("scd.step.optimizer"):
            self.optimizer.step()
        if self._step_done is not None:
            self._step_done[self._steps_done % 2].record(
                torch.cuda.current_stream(self.device))
            self._steps_done += 1
        self.updates += 1
        self._last_batch = (xs, ys)
        if self.data_group is None:
            return loss.detach(), [s.detach() for s in stats]
        # the ranks' shares summed: the global batch's loss, on every rank
        with span("scd.collective.report"):
            report = reduce_sum_(torch.stack([loss.detach()] + [
                s.detach() for s in stats]), self.data_group)
        return report[0], list(report[1:])

    def train(self, samples, locs, counts, draws: Optional[Draws] = None):
        """One step on a host batch (numpy or tensors): on a data axis the
        global batch, of which this rank trains its rows."""
        if self.mesh is not None:
            samples, locs, counts = (shard_rows(self.mesh, a)
                                     for a in (samples, locs, counts))
        return self.train_rows(samples, locs, counts, draws)

    def train_rows(self, samples, locs, counts,
                   draws: Optional[Draws] = None):
        """One step on this rank's rows of the global batch (all of it
        without a data axis)."""
        with span("scd.step.feed"):
            rows = [torch.as_tensor(a).to(self.device)
                    for a in (samples, locs, counts)]
        return self._step(*rows, draws)

    def train_resident(self, idx: np.ndarray, draws: Optional[Draws] = None):
        """One step on the resident rows ``idx``, int32 or int64, numpy
        or a tensor (on a data axis the global index vector, shard-major,
        of which this rank takes its block of local indices). On a card
        the host never waits for it here (:meth:`_feed_index`), so it
        queues this step while the card still runs the previous one."""
        with span("scd.step.feed"):
            if self.mesh is not None:
                idx = shard_rows(self.mesh, np.asarray(idx))
            idx = self._feed_index(idx)
            rows = [t.index_select(0, idx) for t in (
                self._ds_samples, self._ds_locs, self._ds_counts)]
        return self._step(*rows, draws)

    def _feed_index(self, idx) -> torch.Tensor:
        """``idx`` on ``self.device``. A host vector bound for a card is
        pinned and copied without blocking: a pageable copy ends in a
        synchronise, and the caching host allocator keeps the pinned
        block until the copy has read it. Each such step is counted in
        ``core/cuda_build.FEED``, ``ahead`` when the previous step's
        update (``_step_done``) has not finished on the card. On the CPU,
        or for a tensor already on a card, a plain copy."""
        if self._step_done is None or (isinstance(idx, torch.Tensor)
                                       and idx.is_cuda):
            return torch.as_tensor(idx).to(self.device)
        host = torch.as_tensor(np.ascontiguousarray(idx)).pin_memory()
        idx = host.to(self.device, non_blocking=True)
        if self._steps_done:
            cuda_build.count_feed(
                not self._step_done[(self._steps_done - 1) % 2].query())
        return idx

    # ---- the resident dataset ----------------------------------------------

    def _setup_residency(self) -> None:
        """Hold the training rows on the card when they fit
        ``residencyBudgetGB`` (``residency``: "auto" | "device" |
        "host"). The validation set is rendered by the dataset and
        streamed per batch."""
        cfg = self.config
        self.resident = False
        mode = cfg.config.get("residency", "auto")
        if mode not in ("auto", "device", "host"):
            raise ValueError("residency must be auto, device or host, not "
                             "{}".format(mode))
        if mode == "host":
            return
        storage = cfg.storageDtype
        itemsize = {"float32": 4, "float16": 2, "uint8": 1}[storage]
        clip_elems = int(np.prod(self.dataset.samples.shape[1:]))
        # rows shard over the data axis (a rank holds its shard)
        shards, self._local_train = self.dataset.device_shards(
            self._data_size)
        rows = shards[self._data_index]
        train_bytes = len(rows) * clip_elems * itemsize
        budget = float(cfg.config.get("residencyBudgetGB", 8.0)) * 1024 ** 3
        if mode == "auto" and train_bytes > budget:
            Logger.warn(":: factory :: dataset ({:.1f} GB as {}) exceeds the "
                        "residency budget; streaming batches from host"
                        .format(train_bytes / 1024 ** 3, storage))
            return
        if len(rows) < cfg.batchSize // self._data_size:
            Logger.warn(":: factory :: fewer training rows than one batch; "
                        "streaming from host")
            return
        Logger.log("Uploading device-resident dataset: {} clips, {:.2f} GB "
                   "as {}".format(len(rows), train_bytes / 1024 ** 3, storage))
        self._ds_samples = torch.from_numpy(
            as_storage(self.dataset.samples[rows], storage)).to(self.device)
        self._ds_locs = torch.from_numpy(self.dataset.locs[rows]).to(
            self.device)
        self._ds_counts = torch.from_numpy(self.dataset.counts[rows]).to(
            self.device)
        self.resident = True

    # ---- validation --------------------------------------------------------

    @torch.no_grad()
    def validate(self, xs: torch.Tensor, ys: List[torch.Tensor]
                 ) -> Dict[str, Any]:
        """The metric battery of one batch, in eval mode; on a data axis
        each rank decodes its rows and the decoded rows are gathered (a
        batch the axis does not divide runs whole on every rank)."""
        xs = xs.to(self.device)
        ys = [y.to(self.device) for y in ys]
        if self.data_group is not None and xs.shape[0] % self._data_size == 0:
            decoded = _gather_tree(self._decode(shard_rows(self.mesh, xs)),
                                   self.data_group)
        else:
            decoded = self._decode(xs)
        return self.evaluation([xs], ys, *decoded)

    def _decode(self, xs: torch.Tensor):
        self.model.eval()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            outs = self._eval_forward(xs)
        return self.decode(as_stack_list(outs)[-1])

    def validate_train_batch(self) -> Dict[str, Any]:
        """The [Tr] metrics: the last trained batch, as augmented,
        through the updated model (networkFactory.py:183-188); on a data
        axis the ranks' rows gathered first."""
        xs, ys = self._last_batch
        if self.data_group is not None:
            xs = gather_rows(xs, self.data_group)
            ys = [gather_rows(y, self.data_group) for y in ys]
        return self.validate(xs, ys)

    def dump_debug_overlays(self, it: int, max_clips: int = 4) -> None:
        """``-debug``: PNGs of the first ``max_clips`` clips of the last
        trained batch, after augmentation, with their ground truth's
        markers (:func:`overlay_markers`), as
        ``dirResult/debug.{trainName}/it{it:06d}.clip{j}.png`` (the JAX
        trainer's, ``scd_resnet_tpu/train/factory.py:862-935``). Each
        clip is stretched from its own min..max to 0..255."""
        from PIL import Image, ImageDraw

        xs, ys = self._last_batch
        xs = xs[:max_clips, 0].float().cpu().numpy()
        ys = [y.cpu().numpy() for y in ys]
        legacy = self.profile.corner_targets == "legacy"
        out_dir = os.path.join(self.config.dirResult,
                               "debug.{}".format(self.config.trainName))
        os.makedirs(out_dir, exist_ok=True)
        for j, clip in enumerate(xs):
            lo, hi = float(clip.min()), float(clip.max())
            u8 = np.zeros_like(clip, np.uint8) if hi <= lo else \
                ((clip - lo) / (hi - lo) * 255.0).astype(np.uint8)
            img = Image.fromarray(u8).convert("RGB")
            draw = ImageDraw.Draw(img)
            for method, xy, style in overlay_markers(ys, self.heat_size,
                                                     legacy, j):
                getattr(draw, method)(xy, **style)
            img.save(os.path.join(out_dir,
                                  "it{:06d}.clip{}.png".format(it, j)))

    # ---- checkpoints -------------------------------------------------------

    def _checkpoint_path(self) -> str:
        return os.path.join(self.config.dirTemp, self.config.naming)

    def _best_checkpoint_path(self) -> str:
        return os.path.join(self.config.dirTemp, "{}.{}.best.pth".format(
            self.config.modelName, self.config.trainName))

    def save_parameters(self, path: Optional[str] = None) -> None:
        """The checkpoint in the plain layout (model-axis shards gathered,
        a collective), written by rank 0 alone."""
        path = path or self._checkpoint_path()
        state, opt = full_checkpoint_state(self.model, self.optimizer,
                                           self.sharded, self.mesh)
        if self.rank != 0:
            return
        Logger.warn(":: checkpoint :: saving model to {}".format(path))
        save_training_checkpoint(path, self.config.modelName, state, opt,
                                 self.config.currentIteration,
                                 self._aug_step)

    def load_parameters(self) -> None:
        path = self._checkpoint_path()
        Logger.warn(":: checkpoint :: loading model from {}".format(path))
        ckpt = load_training_checkpoint(path, self.config.modelName)
        state, opt = local_checkpoint_state(
            self.model, ckpt["state_dict"], ckpt["optimizer"], self.sharded,
            self.mesh)
        self.model.load_state_dict(state, strict=True)
        self.optimizer.load_state_dict(opt)
        # the file holds the plain layout; the state follows its parameter's
        for p, pstate in self.optimizer.state.items():
            for key, value in pstate.items():
                if torch.is_tensor(value) and value.shape == p.shape:
                    pstate[key] = torch.empty_like(
                        p, dtype=value.dtype).copy_(value)
        self.updates = ckpt["step"]
        self._aug_step = ckpt["aug_step"]

    def load_pretrained(self, path: str) -> None:
        """Warm start from a port checkpoint or, for centerOffset*, a
        reference ``.pth`` (networkFactory.py:138-144): weights and
        BatchNorm statistics only."""
        Logger.warn(":: factory :: loading from pretrained: {}".format(path))
        state, _ = local_checkpoint_state(
            self.model, load_state_dict(path, self.config.modelName),
            {"state": {}, "param_groups": []}, self.sharded, self.mesh)
        self.model.load_state_dict(state, strict=True)

    # ---- the schedule loop ---------------------------------------------------

    def validation_expression(self) -> str:
        """The family's metric line over the whole validation set, in
        batches of ``validationBatchSize`` (the [It] line's body)."""
        return self.expression([
            self.validate(item["xs"][0], item["ys"]) for item in
            self.dataset.get_validation_set(
                self.config.validationBatchSize,
                corner_targets=self.profile.corner_targets)])

    def _validation_lines(self, it: int) -> Tuple[str, str]:
        tr_line = "[Tr] {}:     ".format(format(it, "7d")) + \
            self.expression([self.validate_train_batch()])
        it_line = "[It] {}:     ".format(format(it, "7d")) + \
            self.validation_expression()
        return tr_line, it_line

    def begin_training(self, telemetry_path: Optional[str] = None
                       ) -> Dict[str, Any]:
        """Run the schedule from ``currentIter`` to ``iterations``.

        Returns a summary: steps run, their wall seconds (validation and
        checkpoints included) and clips per second over them, the last
        iteration reached, the kernel launches the run made
        (``core/cuda_build.LAUNCHES``, by kernel name), the tensors it
        converted at the kernels' NCHW boundary (``LAYOUT_COPIES``) and
        ``feed_ahead_share``, the share of its resident steps on a card
        fed before the card had finished the previous one (``FEED``;
        None on the CPU or streamed from the host)."""
        cfg = self.config
        if cfg.currentIteration > 0:
            self.load_parameters()
        elif cfg.pretrain is not None:
            if not os.path.exists(cfg.pretrain):
                raise FileNotFoundError("pretrained model does not exist: "
                                        "{}".format(cfg.pretrain))
            self.load_pretrained(cfg.pretrain)

        launches_before = dict(cuda_build.LAUNCHES)
        copies_before = dict(cuda_build.LAYOUT_COPIES)
        feed_before = dict(cuda_build.FEED)
        it = cfg.currentIteration
        self._aug_step = int(it)
        total = cfg.totalIterations
        # streamed from the host, node n of N reads order[n::N] of each
        # epoch (the JAX trainer's per-host split) and each rank packs its
        # block of its node's batch; one node reads the whole order
        nodes, node = (1, 0) if self.resident else node_layout()
        if self.resident:
            steps_per_epoch = self.dataset.steps_per_epoch_resident(
                cfg.batchSize, self._data_size, self._local_train)
        else:
            steps_per_epoch = self.dataset.steps_per_epoch(cfg.batchSize,
                                                           nodes)
            if nodes > 1:
                Logger.log("Epoch split over {} nodes: node {} reads "
                           "{} of {} training rows".format(
                               nodes, node, len(self.dataset.order[
                                   node::nodes]), len(self.dataset)))
        if steps_per_epoch == 0:
            raise RuntimeError(
                "this node's dataset shard ({} of {} rows over {} node(s)) "
                "yields no batches of size {}".format(
                    len(self.dataset.order[node::nodes]), len(self.dataset),
                    nodes, cfg.batchSize))
        epoch, skip = divmod(it, steps_per_epoch)
        per_rank = cfg.batchSize // self._data_size  # the mesh checked it
        rows = slice(self._data_index * per_rank,
                     (self._data_index + 1) * per_rank)

        loss_rows: List[Tuple[int, torch.Tensor]] = []
        eval_lines = ["Experiment: {}\n".format(cfg.trainName),
                      "Parameter Count: {}\n".format(self.parameter_count)]
        writer = self.rank == 0  # one writer on shared storage
        telemetry = StepTelemetry(telemetry_path if writer else None,
                                  first_step=it)
        progress = ProgressLine(None if writer else False)
        profiler = StepProfiler()
        if not writer:
            profiler.trace_dir = None
        t_start = time.perf_counter()
        steps_this_run = 0
        best_val: Optional[float] = None
        best_it = 0
        best_metric_warned = False

        prev_handlers = {}
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                prev_handlers[sig] = signal.signal(sig, self.request_stop)
        except ValueError:  # not the main thread: keep the caller's
            prev_handlers = {}

        def flush_rows(upto: int) -> None:
            nonlocal loss_rows
            if loss_rows and not writer:
                loss_rows = []
            if loss_rows:
                its = np.asarray([row[0] for row in loss_rows], np.float64)
                values = torch.stack([row[1] for row in loss_rows]).cpu()
                rows = np.column_stack([its, values.double().numpy()])
                np.savetxt(os.path.join(cfg.dirResult, "losses.{}.{}.txt"
                                        .format(cfg.trainName, upto)),
                           rows, delimiter=",", fmt="%.5f")
                loss_rows = []

        def batches(epoch: int, skip: int):
            """(step function, its arguments) for one epoch."""
            if self.resident:
                for idx in self.dataset.epoch_local_indices(
                        cfg.batchSize, epoch, skip,
                        num_shards=self._data_size,
                        local_train=self._local_train):
                    yield self.train_resident, (idx,)
            else:
                for batch in self.dataset.epoch_batches(
                        cfg.batchSize, epoch, skip, nodes, node, rows):
                    yield self.train_rows, batch

        finished = it >= total
        try:
            while not finished:
                for step, args in batches(epoch, skip):
                    cfg.update_iteration(it)
                    it += 1
                    profiler.step(it)
                    loss, stats = step(*args)

                    if it % cfg.validationFrequency == 0:
                        progress.clear()
                        if self.debug and writer:
                            self.dump_debug_overlays(it)
                        with span("scd.train.validate"):
                            tr_line, it_line = self._validation_lines(it)
                        eval_lines.append(tr_line + "\n" + it_line + "\n")
                        Logger.info_green(tr_line)
                        Logger.info(it_line)
                        if cfg.bestSnapshotMetric:
                            value = parse_metric_line(
                                it_line, cfg.bestSnapshotMetric)
                            if value is None:
                                if not best_metric_warned:
                                    best_metric_warned = True
                                    Logger.warn(
                                        ":: factory :: bestSnapshotMetric "
                                        "'{}' not in this family's report "
                                        "line; best tracking disabled".format(
                                            cfg.bestSnapshotMetric))
                            elif (best_val is None
                                  or (value < best_val
                                      if cfg.bestSnapshotMode == "min"
                                      else value > best_val)):
                                best_val, best_it = value, it
                                cfg.update_iteration(it)
                                with span("scd.train.snapshot"):
                                    self.save_parameters(
                                        self._best_checkpoint_path())
                        # a diverged run stops here with its state saved
                        if not torch.isfinite(loss).item():
                            cfg.update_iteration(it)
                            self.save_parameters()
                            flush_rows(it)
                            raise FloatingPointError(
                                "non-finite loss at iteration {}; state "
                                "saved to {}".format(
                                    it, self._checkpoint_path()))

                    # kept on the card: a host read here would wait for
                    # the step; the rows go to the host at a snapshot
                    loss_rows.append((it, torch.stack([loss, *stats])))
                    steps_this_run += 1
                    telemetry.record(it)
                    progress.update(
                        it, total,
                        steps_this_run / (time.perf_counter() - t_start),
                        loss=float(loss)
                        if it % cfg.validationFrequency == 0 else None)

                    if it % cfg.snapshotFrequency == 0:
                        progress.clear()
                        cfg.update_iteration(it)
                        with span("scd.train.snapshot"):
                            self.save_parameters()
                            flush_rows(it)

                    self._stop_requested = self._any_stop()
                    if self._stop_requested and it < total:
                        progress.clear()
                        cfg.update_iteration(it)
                        self.save_parameters()
                        flush_rows(it)
                        line = ("Preempted at iteration {} (state saved to "
                                "{}; resume with currentIter={})").format(
                                    it, self._checkpoint_path(), it)
                        eval_lines.append(line + "\n")
                        Logger.warn(":: factory :: " + line)
                        self.preempted = True
                        finished = True
                    if it >= total:
                        finished = True
                    if finished:
                        break
                skip = 0
                epoch += 1

            # a schedule that ends off a snapshot boundary keeps its tail
            if (not self.preempted and steps_this_run > 0
                    and it % cfg.snapshotFrequency != 0):
                cfg.update_iteration(it)
                self.save_parameters()
                flush_rows(it)
            if cfg.bestSnapshotMetric and best_val is not None:
                line = "[Best] [{}] {} at iteration {} -> {}".format(
                    cfg.bestSnapshotMetric, best_val, best_it,
                    self._best_checkpoint_path())
                eval_lines.append(line + "\n")
                Logger.info(line)
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            seconds = time.perf_counter() - t_start
            progress.clear()
            telemetry.close()
            profiler.close(it)
            for sig, handler in prev_handlers.items():
                signal.signal(sig, handler)
            if writer:
                with open(os.path.join(cfg.dirResult, "evals.{}.txt".format(
                        cfg.trainName)), "w") as f:
                    f.writelines(eval_lines)
        fed = [cuda_build.FEED.get(k, 0) - feed_before.get(k, 0)
               for k in ("steps", "ahead")]
        return {"steps": steps_this_run, "seconds": seconds,
                "clips_per_s": steps_this_run * cfg.batchSize / seconds
                if seconds > 0 else 0.0,
                "last_iteration": it,
                "launches": {name: count - launches_before.get(name, 0)
                             for name, count in cuda_build.LAUNCHES.items()},
                "layout_copies": {
                    name: count - copies_before.get(name, 0)
                    for name, count in cuda_build.LAYOUT_COPIES.items()},
                "feed_ahead_share": fed[1] / fed[0] if fed[0] else None}
