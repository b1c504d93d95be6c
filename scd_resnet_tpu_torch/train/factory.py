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
  statistics and the loss stay float32;
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
  (``core/profiling.StepProfiler``).

Each step's draws come from a ``torch.Generator`` seeded from
(seed + 1, step) (``data/pipeline.step_seed``), the JAX trainer's
``fold_in(PRNGKey(seed + 1), step)``, so a resumed run continues the
sequence. The validation set is cut into whole batches (a remainder is
dropped, ``data/dataset.get_validation_set``), so no batch carries
padding rows and no decoded score needs the JAX trainer's padding mask.
Not carried over yet: the device mesh and data parallelism, and the
pipeline schedule.
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

from scd_resnet_tpu_torch.core.checkpoint import (
    load_state_dict,
    load_training_checkpoint,
    save_training_checkpoint,
)
from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.core.logging import Logger, ProgressLine, StepTelemetry
from scd_resnet_tpu_torch.core.profiling import StepProfiler
from scd_resnet_tpu_torch.data.dataset import SCDDataset, as_storage
from scd_resnet_tpu_torch.data.pipeline import (
    Draws,
    augment_and_render_batch,
    draw,
    step_seed,
)
from scd_resnet_tpu_torch.models.center_net_offset import as_stack_list
from scd_resnet_tpu_torch.models.layers import checkpointed
from scd_resnet_tpu_torch.models.resnet import init_like_flax
from scd_resnet_tpu_torch.train.registry import get_dataset_profile, get_model_profile

_METRIC_TOKEN = re.compile(r"\[(\S+?)\]\s+([-+0-9.eE]+)")
_UNSUPPORTED = ("meshShape", "meshAxes", "pipelineMicrobatches")


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
    runs the training schedule on ``device``."""

    def __init__(self, config: Configuration,
                 dataset: Optional[SCDDataset] = None,
                 device: str | torch.device = "cuda",
                 seed: Optional[int] = None):
        self.config = cfg = config
        self.device = resolve_device(device)
        if seed is None:
            seed = int(cfg.config.get("seed", 42))
        for key in _UNSUPPORTED:
            if cfg.config.get(key):
                raise NotImplementedError(
                    "'{}' is a JAX-trainer option the port does not have "
                    "yet".format(key))
        self.debug = bool(cfg.config.get("debug", False))

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
            dataset = SCDDataset(
                cfg.dirDatafile, data_split,
                argument_ratio=ds_profile.argument_ratio,
                partition=ds_profile.partition,
                train_subset=ds_profile.train_subset,
                split_profile_path=cfg.dirDataSplitProfile, seed=seed,
                storage_dtype=cfg.storageDtype, device=self.device)
        self.dataset = dataset
        self.heat_size = dataset.heat_size
        self.sample_size = dataset.samples.shape[1]

        self.parameter_count = sum(p.numel()
                                   for p in self.model.parameters())
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
        self._stop_requested = False
        self.preempted = False
        self._setup_residency()

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
        if draws is None:
            draws = self.draws_for_step(self._aug_step, samples.shape[0])
        self._aug_step += 1
        self.model.train()
        xs, ys = augment_and_render_batch(
            samples, locs, counts, self.heat_size, draws=draws,
            corner_targets=self.profile.corner_targets)
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            outs = checkpointed(self.model, xs, enabled=self.remat_forward)
        loss, stats = self.loss(as_stack_list(outs), ys)
        loss.backward()
        self.optimizer.step()
        self.updates += 1
        self._last_batch = (xs, ys)
        return loss.detach(), [s.detach() for s in stats]

    def train(self, samples, locs, counts, draws: Optional[Draws] = None):
        """One step on a host batch (numpy or tensors)."""
        return self._step(*(torch.as_tensor(a).to(self.device)
                            for a in (samples, locs, counts)), draws)

    def train_resident(self, idx: np.ndarray, draws: Optional[Draws] = None):
        """One step on the resident rows ``idx`` of ``dataset.order``."""
        idx = torch.as_tensor(idx).to(self.device)
        return self._step(self._ds_samples.index_select(0, idx),
                          self._ds_locs.index_select(0, idx),
                          self._ds_counts.index_select(0, idx), draws)

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
        train_bytes = len(self.dataset.order) * clip_elems * itemsize
        budget = float(cfg.config.get("residencyBudgetGB", 8.0)) * 1024 ** 3
        if mode == "auto" and train_bytes > budget:
            Logger.warn(":: factory :: dataset ({:.1f} GB as {}) exceeds the "
                        "residency budget; streaming batches from host"
                        .format(train_bytes / 1024 ** 3, storage))
            return
        if len(self.dataset.order) < cfg.batchSize:
            Logger.warn(":: factory :: fewer training rows than one batch; "
                        "streaming from host")
            return
        rows = np.asarray(self.dataset.order)
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
        """The metric battery of one batch, in eval mode."""
        xs = xs.to(self.device)
        ys = [y.to(self.device) for y in ys]
        self.model.eval()
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            outs = self.model(xs)
        decoded = self.decode(as_stack_list(outs)[-1])
        return self.evaluation([xs], ys, *decoded)

    def validate_train_batch(self) -> Dict[str, Any]:
        """The [Tr] metrics: the last trained batch, as augmented,
        through the updated model (networkFactory.py:183-188)."""
        xs, ys = self._last_batch
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
        path = path or self._checkpoint_path()
        Logger.warn(":: checkpoint :: saving model to {}".format(path))
        save_training_checkpoint(path, self.config.modelName,
                                 self.model.state_dict(),
                                 self.optimizer.state_dict(),
                                 self.config.currentIteration,
                                 self._aug_step)

    def load_parameters(self) -> None:
        path = self._checkpoint_path()
        Logger.warn(":: checkpoint :: loading model from {}".format(path))
        ckpt = load_training_checkpoint(path, self.config.modelName)
        self.model.load_state_dict(ckpt["state_dict"], strict=True)
        self.optimizer.load_state_dict(ckpt["optimizer"])
        self.updates = ckpt["step"]
        self._aug_step = ckpt["aug_step"]

    def load_pretrained(self, path: str) -> None:
        """Warm start from a port checkpoint or, for centerOffset*, a
        reference ``.pth`` (networkFactory.py:138-144): weights and
        BatchNorm statistics only."""
        Logger.warn(":: factory :: loading from pretrained: {}".format(path))
        self.model.load_state_dict(
            load_state_dict(path, self.config.modelName), strict=True)

    # ---- the schedule loop ---------------------------------------------------

    def _validation_lines(self, it: int) -> Tuple[str, str]:
        tr_line = "[Tr] {}:     ".format(format(it, "7d")) + \
            self.expression([self.validate_train_batch()])
        batches = [self.validate(item["xs"][0], item["ys"]) for item in
                   self.dataset.get_validation_set(
                       self.config.validationBatchSize,
                       corner_targets=self.profile.corner_targets)]
        it_line = "[It] {}:     ".format(format(it, "7d")) + \
            self.expression(batches)
        return tr_line, it_line

    def begin_training(self, telemetry_path: Optional[str] = None
                       ) -> Dict[str, Any]:
        """Run the schedule from ``currentIter`` to ``iterations``.

        Returns a summary: steps run, their wall seconds (validation and
        checkpoints included) and clips per second over them, and the
        last iteration reached."""
        cfg = self.config
        if cfg.currentIteration > 0:
            self.load_parameters()
        elif cfg.pretrain is not None:
            if not os.path.exists(cfg.pretrain):
                raise FileNotFoundError("pretrained model does not exist: "
                                        "{}".format(cfg.pretrain))
            self.load_pretrained(cfg.pretrain)

        it = cfg.currentIteration
        self._aug_step = int(it)
        total = cfg.totalIterations
        loss_rows: List[Tuple[int, torch.Tensor]] = []
        eval_lines = ["Experiment: {}\n".format(cfg.trainName),
                      "Parameter Count: {}\n".format(self.parameter_count)]
        telemetry = StepTelemetry(telemetry_path)
        progress = ProgressLine()
        profiler = StepProfiler()
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
            if loss_rows:
                its = np.asarray([row[0] for row in loss_rows], np.float64)
                values = torch.stack([row[1] for row in loss_rows]).cpu()
                rows = np.column_stack([its, values.double().numpy()])
                np.savetxt(os.path.join(cfg.dirResult, "losses.{}.{}.txt"
                                        .format(cfg.trainName, upto)),
                           rows, delimiter=",", fmt="%.5f")
                loss_rows = []

        steps_per_epoch = self.dataset.steps_per_epoch(cfg.batchSize)
        if steps_per_epoch == 0:
            raise RuntimeError("the dataset's {} training rows yield no "
                               "batch of {}".format(len(self.dataset),
                                                    cfg.batchSize))
        epoch, skip = divmod(it, steps_per_epoch)

        def batches(epoch: int, skip: int):
            """(step function, its arguments) for one epoch."""
            if self.resident:
                for idx in self.dataset.epoch_local_indices(
                        cfg.batchSize, epoch, skip):
                    yield self.train_resident, (idx,)
            else:
                for batch in self.dataset.epoch_batches(
                        cfg.batchSize, epoch, skip):
                    yield self.train, batch

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
                        if self.debug:
                            self.dump_debug_overlays(it)
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
                    ips = steps_this_run / (time.perf_counter() - t_start)
                    telemetry.record(it, {"ips": ips})
                    progress.update(
                        it, total, ips,
                        loss=float(loss)
                        if it % cfg.validationFrequency == 0 else None)

                    if it % cfg.snapshotFrequency == 0:
                        progress.clear()
                        cfg.update_iteration(it)
                        self.save_parameters()
                        flush_rows(it)

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
            with open(os.path.join(cfg.dirResult, "evals.{}.txt".format(
                    cfg.trainName)), "w") as f:
                f.writelines(eval_lines)
        return {"steps": steps_this_run, "seconds": seconds,
                "clips_per_s": steps_this_run * cfg.batchSize / seconds
                if seconds > 0 else 0.0,
                "last_iteration": it}
