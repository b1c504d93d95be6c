"""Training steps back to back on rows held on the device.

Set-up draws the traffic's pool of clips and the configuration's seeded
step-0 weights, builds the system over ``rows`` rows (row r is pool clip
r mod ``pool``), and runs ``warmup_steps`` steps through the window's own
call and feed; the first three take rows of distinct pool clips, and the
system's first gradient (Adam's first moment after one step), its three
losses and its parameters after three steps are kept. The window runs
steps for ``seconds`` and ends in a synchronise. After it, the reference
takes the same three steps from the same state, rows and draws.

What the window drives:

- :class:`System`: the port's ``NetworkFactory`` under the train entry
  point's backend settings for the configuration's precision, its
  ``Configuration`` given the job's settings and the traffic's ``port``
  ones (``residency``, ``storageDtype``), over the cell's rows; a step is
  ``train_resident`` with the benchmark's draws;
- :class:`Control`: the plain reference in the precision below the
  configuration's (``reference/precision.py``), behind the same calls;
- ``FAULTS``: ``unchanged``, a step that leaves the parameters as they
  were; ``half_batch``, a step that leaves out half of the batch and
  takes the mean over the rest.

A traffic mix whose steps take another path of the port (rows streamed
from the host, several cards) names a driver of its own, which can take
:func:`run` from here and bring its own ``System``.
"""

from __future__ import annotations

import functools
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import compare, flops, inputs, weights
from portbench.harness import process_age
from portbench.reference import model as reference_model
from portbench.reference import train as reference_train
from portbench.reference.precision import QUANTIZERS
from portbench.trace import Window

COMPARED_STEPS = 3
STORAGE = {"float16": torch.float16, "float32": torch.float32,
           "uint8": torch.uint8}


class _Rows:
    """The resident rows as the trainer reads a dataset: row r is pool
    clip r mod P, so the rows take no more host memory than the upload
    needs."""

    def __init__(self, samples: np.ndarray, locs: np.ndarray,
                 counts: np.ndarray, rows: int):
        self.pool = len(samples)
        self.samples = _Tiled(samples, rows)
        self.locs = np.tile(locs, (rows // self.pool, 1, 1))
        self.counts = np.tile(counts, rows // self.pool)
        self.heat_size = samples.shape[1] // 4
        self.order = list(range(rows))

    def device_shards(self, num_shards: int):
        per = len(self.order) // num_shards
        order = np.asarray(self.order)
        return ([order[d * per:(d + 1) * per] for d in range(num_shards)],
                [np.arange(per) for _ in range(num_shards)])


class _Tiled:
    """The rows' clips, gathered from the pool on demand by a few threads
    (a fancy index of the pool copies on one core)."""

    def __init__(self, pool: np.ndarray, rows: int):
        self._pool = pool
        self.shape = (rows,) + pool.shape[1:]
        self.dtype = pool.dtype
        self.ndim = pool.ndim

    def __getitem__(self, rows):
        index = np.asarray(rows) % len(self._pool)
        out = np.empty((len(index),) + self.shape[1:], self.dtype)
        threads = min(8, os.cpu_count() or 1)

        def fill(part: int) -> None:
            for r in range(part, len(index), threads):
                out[r] = self._pool[index[r]]

        with ThreadPoolExecutor(threads) as pool:
            list(pool.map(fill, range(threads)))
        return out


class System:
    def __init__(self, config: Dict, traffic: Dict, state: Dict,
                 pool: Dict[str, np.ndarray], device: torch.device,
                 workdir: str):
        from scd_resnet_tpu_torch.core.config import Configuration
        from scd_resnet_tpu_torch.core.device import training_backends
        from scd_resnet_tpu_torch.data.pipeline import Draws
        from scd_resnet_tpu_torch.train.factory import NetworkFactory

        job = config["train"]
        cfg = Configuration()
        cfg.update_config(dict(traffic["port"], **{
            "modelName": config["arch"], "batchSize": traffic["batch"],
            "learningRate": job["learningRate"],
            "learningRateDecay": job["learningRateDecay"],
            "learningRateDecayRate": job["learningRateDecayRate"],
            "optimizer": job["optimizer"], "precision": job["precision"],
            "dirTemp": workdir + "/", "dirResult": workdir + "/"}))
        self._backends = training_backends(job["precision"])
        self._backends.__enter__()
        rows = _Rows(pool["samples"], pool["locs"], pool["counts"],
                     traffic["rows"])
        self.factory = NetworkFactory(cfg, dataset=rows, device=device)
        if not self.factory.resident:
            raise RuntimeError("the trainer did not hold the rows on the "
                               "device: train_resident needs residency "
                               "device")
        self.factory.model.load_state_dict(state, strict=True)
        self._draws = Draws
        self.beta1 = job["betas"][0]

    def step(self, idx: np.ndarray, draws: Dict) -> torch.Tensor:
        loss, _ = self.factory.train_resident(idx, self._draws(**draws))
        return loss

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.factory.model.named_parameters())

    def first_moment(self) -> Dict[str, torch.Tensor]:
        state = self.factory.optimizer.state
        return {k: state[p]["exp_avg"] if "exp_avg" in state.get(p, {})
                else torch.zeros_like(p) for k, p in self.params().items()}

    def close(self) -> None:
        self._backends.__exit__(None, None, None)


class Control:
    def __init__(self, config: Dict, traffic: Dict, state: Dict,
                 pool: Dict[str, np.ndarray], device: torch.device,
                 workdir: str, precision: str):
        model = reference_model.build(config)
        model.load_state_dict(state, strict=True)
        model.to(device)
        size = pool["samples"].shape[1]
        self.trainer = reference_train.Trainer(model, config, size // 4,
                                               QUANTIZERS[precision])
        self.samples = torch.from_numpy(pool["samples"]).to(device)
        self.locs = torch.from_numpy(pool["locs"]).to(device)
        self.counts = torch.from_numpy(pool["counts"]).to(device)
        self.beta1 = config["train"]["betas"][0]

    def step(self, idx: np.ndarray, draws: Dict) -> torch.Tensor:
        rows = torch.from_numpy(np.asarray(idx) % len(self.samples)).to(
            self.samples.device)
        return self.trainer.step(self.samples[rows], self.locs[rows],
                                 self.counts[rows], draws)

    def params(self) -> Dict[str, torch.Tensor]:
        return self.trainer.params

    def first_moment(self) -> Dict[str, torch.Tensor]:
        return self.trainer.exp_avg

    def close(self) -> None:
        pass


def control(config: Dict) -> functools.partial:
    return functools.partial(Control, precision=config["train"]["control"])


class Unchanged(System):
    def step(self, idx: np.ndarray, draws: Dict) -> torch.Tensor:
        before = {k: p.detach().clone() for k, p in self.params().items()}
        loss = super().step(idx, draws)
        with torch.no_grad():
            for k, p in self.params().items():
                p.copy_(before[k])
        return loss


class HalfBatch(System):
    def step(self, idx: np.ndarray, draws: Dict) -> torch.Tensor:
        half = len(idx) // 2
        return super().step(idx[:half], {k: v[:half] for k, v in
                                         draws.items()})


FAULTS = {"unchanged": Unchanged, "half_batch": HalfBatch}


class Feed:
    """Each step's resident row indices (host) and draws (device): a batch
    of distinct pool clips, each from a random copy; the first
    ``COMPARED_STEPS`` batches take distinct clips between them too."""

    def __init__(self, seed: int, pool: int, copies: int, batch: int,
                 size: int, device: torch.device):
        self.rng = np.random.default_rng(inputs.sub_seed(seed, 3))
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(inputs.sub_seed(seed, 4))
        self.pool, self.copies, self.batch = pool, copies, batch
        self.size, self.device = size, device
        self.first = self.rng.permutation(pool)[:COMPARED_STEPS * batch]
        self.steps = 0

    def next(self) -> Tuple[np.ndarray, Dict[str, torch.Tensor]]:
        b = self.batch
        if self.steps < COMPARED_STEPS:
            ids = self.first[self.steps * b:(self.steps + 1) * b]
        else:
            ids = self.rng.choice(self.pool, b, replace=False)
        self.steps += 1
        idx = (self.rng.integers(0, self.copies, b) * self.pool
               + ids).astype(np.int64)
        flips = torch.rand((2, b), generator=self.gen,
                           device=self.device) < 0.5
        draws = {"flip_h": flips[0], "flip_v": flips[1],
                 "jitter": torch.randn((b, 1, 1), generator=self.gen,
                                       device=self.device),
                 "noise": torch.randn((b, self.size, self.size),
                                      generator=self.gen, device=self.device)}
        return idx, draws


def run(ctx: Dict) -> Dict:
    config, traffic, device = ctx["config"], ctx["traffic"], ctx["device"]
    size, batch, pool_size = traffic["clip"], traffic["batch"], traffic["pool"]
    phases = {"imports": process_age()}
    samples, locs, counts = inputs.train_pool(
        pool_size, size, traffic["max_objects"], ctx["seed"], device)
    storage = STORAGE[traffic["port"]["storageDtype"]]
    pool = {"samples": samples.to(storage).cpu().numpy(),
            "locs": locs.cpu().numpy(), "counts": counts.cpu().numpy()}
    phases["inputs"] = process_age()
    reference = reference_model.build(config)
    weights.fill(reference, config["weights"]["train"], ctx["seed"], device)
    state = weights.state_dict(reference)
    start = {k: v.detach().clone() for k, v in reference.named_parameters()}
    phases["weights"] = process_age()

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    system = ctx["system"](config, traffic, state, pool, device,
                           ctx["workdir"])
    phases["system"] = process_age()
    feed = Feed(ctx["seed"], pool_size, traffic["rows"] // pool_size, batch,
                size, device)
    compared: List[Tuple] = []
    program = {"losses": []}
    for step in range(traffic["warmup_steps"]):
        idx, draws = feed.next()
        loss = system.step(idx, draws)
        if step < COMPARED_STEPS:
            compared.append((idx, draws))
            program["losses"].append(loss.item())
        if step == 0:
            program["grad"] = {k: (m / (1 - system.beta1)).detach().clone()
                               for k, m in system.first_moment().items()}
        if step == COMPARED_STEPS - 1:
            program["params"] = {k: p.detach().clone()
                                 for k, p in system.params().items()}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = process_age()
    phases["warmup"] = setup_s

    losses = []
    window = Window(ctx["trace"], device)
    with window:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx["seconds"]:
            idx, draws = feed.next()
            with window.span("portbench.step"):
                losses.append(system.step(idx, draws))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    memory = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    system.close()
    del system
    if device.type == "cuda":
        torch.cuda.empty_cache()

    batches = []
    for idx, draws in compared:
        rows = torch.from_numpy(idx % pool_size).to(device)
        batches.append({"samples": samples[rows], "locs": locs[rows],
                        "counts": counts[rows], "draws": draws})
    truth = reference_train.run(reference, batches, config, size // 4)
    numbers = compare.train(program, truth, start)
    numbers["nonfinite_losses"] = failed
    corner = config["family"] != "centerOffset"
    return {
        "kind": "train", "setup_s": setup_s, "window_s": window_s,
        "attempted": len(losses), "failed": failed, "steps": len(losses),
        "batch": batch, "completed": len(losses),
        "flops_per_clip": flops.forward_per_clip(config, size),
        "memory_peak_bytes": memory, "events": window.events,
        "shape": {"B": batch, "S": size // 4, "M": 3 if corner else 1,
                  "K": traffic["max_objects"], "X": size // 2,
                  "C0": config["dims"][0], "C": config.get("pool_width", 0),
                  "E": 2 if config["train"]["precision"] == "bfloat16"
                  else 4},
        "numbers": numbers, "phases": phases,
    }
