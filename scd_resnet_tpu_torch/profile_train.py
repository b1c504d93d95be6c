"""Where a training step's time goes on the card.

    python -m scd_resnet_tpu_torch.profile_train [--config configs/exp74.json]
        [--archive PATH] [--steps 20]

Trains the configuration's model under its settings (``configs/exp74.json``,
``centerOffsetRes10``, by default; ``configs/cpool_best.json`` trains
``cornerCPoolRes10`` and ``configs/dcn_full.json``
``centerOffsetRes10dcn``; all 512x512 clips, batch 32, bf16 autocast, Adam)
on the seeded synthetic stand-in for the ``scdx16p100`` archive
(``SYNTHETIC_ARCHIVE``, 256 clips; written to ``build/profile_train/``
unless ``--archive`` names a copy, such as the one ``chip_smoke.py``
writes), with the training rows resident on the card. After 10 warm-up
steps (cuDNN autotunes its algorithms in the first ones) it prints one
JSON line:

- ``step_ms`` and ``clips_per_s``: host wall time of ``--steps`` steps
  ending in a synchronise, per step;
- ``phases_ms``: one step cut into phases, each timed alone with CUDA
  events over ``--steps`` calls: gather (the batch's rows by index),
  augment+render (the batch transform, heatmaps by the render kernel),
  render (the kernel alone: one launch of every label map the batch
  transform renders, the center map and for a corner model the tl and
  br maps), forward (training mode, autocast), and
  forward+loss+backward;
- ``kernels``: device time per step by kernel name (``torch.profiler``
  over ``--steps`` steps), the largest first, ``device_busy_share``
  (summed kernel time over the profiled wall time), the port's own
  kernels' lines (``port_kernels``: the render, the corner pools, the
  stem pool's backward, the deformable gather and its backward) and the
  lines of PyTorch's max-pool
  backward or ``cummax`` (``library_pool_kernels``, which the port's
  kernels replace: empty when the step runs through them);
- ``peak_memory_gb``: ``torch.cuda.max_memory_allocated`` over the run.

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Dict

import torch

from scd_resnet_tpu_torch.core.config import Configuration
from scd_resnet_tpu_torch.core.device import resolve_device, training_backends
from scd_resnet_tpu_torch.data.pipeline import augment_and_render_batch
from scd_resnet_tpu_torch.data.synthetic import make_archive
from scd_resnet_tpu_torch.models.center_net_offset import as_stack_list
from scd_resnet_tpu_torch.ops.gaussian import render_label_heatmaps
from scd_resnet_tpu_torch.profile_serve import device_ms
from scd_resnet_tpu_torch.train.factory import NetworkFactory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP74 = os.path.join(REPO, "configs", "exp74.json")
CPOOL_BEST = os.path.join(REPO, "configs", "cpool_best.json")
DCN_FULL = os.path.join(REPO, "configs", "dcn_full.json")
# the synthetic stand-in for the scdx16p100 archive of the configurations
# (``make_archive``'s arguments): 2 x 128 clips of 512^2, half of them
# validation
SYNTHETIC_ARCHIVE = {"num_images": 2, "reps": 1, "clips_per_image": 128,
                     "size": 512, "seed": 74}
RENDER_KERNEL = "render_heatmaps_kernel"
# the port's __global__ kernels, and PyTorch's that they replace
PORT_KERNELS = (RENDER_KERNEL, "pool_h_kernel", "pool_w_kernel",
                "pool_bwd_h_kernel", "pool_bwd_w_kernel",
                "max_pool_bwd_kernel", "dcn_gather_kernel",
                "dcn_gather_bwd_kernel", "dcn_bucket_sort_kernel",
                "dcn_parts_sum_kernel")
LIBRARY_POOL_KERNELS = ("max_pool_backward", "cummax")
WARMUP_STEPS = 10


def settings(config: str, data_dir: str, work: str,
             **overrides) -> Dict[str, Any]:
    """The configuration file ``config`` with its archive in ``data_dir``,
    its outputs under ``work`` and ``overrides`` on top."""
    with open(config) as f:
        values = json.load(f)
    values.update(dirDataset=data_dir + "/", dirTemp=work + "/temp/",
                  dirResult=work + "/results/", **overrides)
    return values


def build_factory(config: str, archive: str, work: str) -> NetworkFactory:
    cfg = Configuration()
    cfg.update_config(settings(config, os.path.dirname(archive), work,
                               residency="device"))
    if os.path.basename(cfg.dirDatafile) != os.path.basename(archive):
        raise ValueError("the archive must be named {}".format(
            os.path.basename(cfg.dirDatafile)))
    return NetworkFactory(cfg, device="cuda")


def profile(factory: NetworkFactory, steps: int) -> Dict:
    batch = factory.config.batchSize
    indices = []
    epoch = 0
    while len(indices) < WARMUP_STEPS + 3 * steps:
        indices.extend(factory.dataset.epoch_local_indices(batch, epoch))
        epoch += 1
    feed = iter(indices)
    for _ in range(WARMUP_STEPS):
        factory.train_resident(next(feed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    for _ in range(steps):
        factory.train_resident(next(feed))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps

    # the phases of one step, each alone, on one fixed batch
    idx = torch.as_tensor(next(feed)).cuda()
    gathered = (factory._ds_samples.index_select(0, idx),
                factory._ds_locs.index_select(0, idx),
                factory._ds_counts.index_select(0, idx))
    draws = factory.draws_for_step(0, batch)
    corner_targets = factory.profile.corner_targets
    xs, ys = augment_and_render_batch(*gathered, factory.heat_size,
                                      draws=draws,
                                      corner_targets=corner_targets)
    locs = gathered[1].float().contiguous()
    present = (torch.arange(locs.shape[1], device="cuda")[None, :]
               < gathered[2][:, None])
    model, autocast = factory.model, factory.autocast
    model.train()

    def forward():
        with torch.autocast("cuda", dtype=torch.bfloat16, enabled=autocast):
            return model(xs)

    def forward_backward():
        model.zero_grad(set_to_none=True)
        loss, _ = factory.loss(as_stack_list(forward()), ys)
        loss.backward()

    phases = {
        "gather": device_ms(lambda: [t.index_select(0, idx) for t in (
            factory._ds_samples, factory._ds_locs, factory._ds_counts)],
            steps, warmup=2),
        "augment_render": device_ms(lambda: augment_and_render_batch(
            *gathered, factory.heat_size, draws=draws,
            corner_targets=corner_targets), steps, warmup=2),
        "render_kernel": device_ms(lambda: render_label_heatmaps(
            locs, present, factory.heat_size, bool(corner_targets)),
            steps, warmup=2),
        "forward": device_ms(forward, steps, warmup=2),
        "forward_loss_backward": device_ms(forward_backward, steps,
                                           warmup=2),
    }

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            factory.train_resident(next(feed))
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": evt.key[:120],
                            "ms_per_step": evt.self_device_time_total
                            / 1e3 / steps,
                            "calls_per_step": evt.count / steps})
    kernels.sort(key=lambda k: -k["ms_per_step"])
    busy_ms = sum(k["ms_per_step"] for k in kernels) * steps
    render = [k for k in kernels if RENDER_KERNEL in k["name"]]
    port = [k for k in kernels if any(n in k["name"] for n in PORT_KERNELS)]
    library = [k for k in kernels
               if any(n in k["name"] for n in LIBRARY_POOL_KERNELS)]
    return {"arch": factory.config.modelName, "batch": batch,
            "clip": factory.sample_size,
            "precision": factory.config.config["precision"],
            "step_ms": step_ms, "clips_per_s": batch * 1e3 / step_ms,
            "phases_ms": phases,
            "device_busy_share": busy_ms / window_ms if window_ms else None,
            "render_kernel": render[0] if render else None,
            "port_kernels": port, "library_pool_kernels": library,
            "kernels": kernels[:30],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1024 ** 3}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", default=EXP74,
                        help="the configuration to train (default exp74)")
    parser.add_argument("--archive", default=os.path.join(
        REPO, "build", "profile_train", "scdx16p100.d"))
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args(argv)
    resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], check=True,
                          capture_output=True, text=True).stdout.strip()
    if not os.path.exists(args.archive):
        os.makedirs(os.path.dirname(args.archive), exist_ok=True)
        make_archive(args.archive, **SYNTHETIC_ARCHIVE)
    work = os.path.join(REPO, "build", "profile_train")
    with open(args.config) as f:
        precision = json.load(f).get("precision", "float32")
    with training_backends(precision):
        result = profile(build_factory(args.config, args.archive, work),
                         args.steps)
    result["card"] = card
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
