"""Experiment configuration: the ``exp.json`` schema.

Counterpart of ``scd_resnet_tpu/core/config.py`` (reference
configuration.py:11-44 declares the keys and defaults, 150-153 merges the
user's JSON, ``{key}`` templates expand in the getters, e.g.
``dirDatafile = "{dirDataset}{datasetName}.d"``). The keys and defaults
are the JAX package's, so every experiment file of ``configs/`` loads
unchanged; unknown keys warn. The mesh keys (``meshShape``, ``meshAxes``,
``pipelineMicrobatches``) are the trainer's (``train/factory.py``,
``parallel/``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from scd_resnet_tpu_torch.core.logging import Logger

# Keys and default values of the exp.json schema, kept identical to the
# reference so any reference experiment file loads verbatim.
_DEFAULTS: Dict[str, Any] = {
    "datasetName": None,
    "modelName": None,
    "trainName": None,
    # training
    "learningRate": 0.00025,
    "learningRateDecay": [80000],
    "learningRateDecayRate": [10],
    "currentIter": 0,
    "iterations": 117000,
    "validation": 200,
    "snapshot": 2000,
    "batchSize": 32,
    "validationBatchSize": 160,
    "naming": "{modelName}.{trainName}.{currentIter}.pth",
    "namingOptimizer": "{naming}.{optimizer}.pth",
    "pretrain": None,
    "optimizer": "adam",
    # directories
    "dirData": "trainer.dataset.{datasetName}",
    "dirModel": "trainer.model.{modelName}",
    "dirTemp": "/temp/",
    "dirPretrain": "/pretrain/",
    "dirConfig": "/configs/",
    "dirResult": "/results/",
    "dirDataset": "/datasets/",
    "dirDatafile": "{dirDataset}{datasetName}.d",
    "dirDataSplitProfile": "{dirDataset}{datasetName}.split.json",
    "useGPU": False,
    # overlay PNGs of the last trained batch at every validation boundary
    # (the JAX train.py's -debug; NetworkFactory.dump_debug_overlays)
    "debug": False,
    # extensions over the reference schema:
    # conv-path compute precision — "float32" | "bfloat16" (params, BN
    # statistics and the loss stay float32)
    "precision": "float32",
    # dataset placement — "auto" | "device" (resident on the card) | "host"
    "residency": "auto",
    # device-memory budget for the resident dataset (training clips),
    # leaving the rest for parameters and activations
    "residencyBudgetGB": 8.0,
    # in-memory and on-card clip storage — "float32" | "float16" | "uint8"
    "storageDtype": "float16",
    # activation rematerialization: the stacked hourglasses recompute each
    # stack's hourglass and branch in the backward, other models their
    # whole forward (models/layers.checkpointed, as the JAX trainer's remat)
    "remat": False,
    # base PRNG seed for init/shuffling/augmentation
    "seed": 42,
    # best-checkpoint tracking: a metric name of the family's [It] line
    # (e.g. "AP50", "mIoU"); each validation pass that improves it writes
    # {modelName}.{trainName}.best.pth
    "bestSnapshotMetric": None,
    "bestSnapshotMode": "max",  # "max" | "min" (for MAE-style metrics)
    # the device mesh (axes "data", "model", "pipe") and the pipeline's
    # microbatches, as the JAX trainer's (parallel/mesh, parallel/pipeline)
    "meshShape": None,
    "meshAxes": None,
    "pipelineMicrobatches": None,
}


class Configuration:
    """Mutable experiment configuration with template-expanding getters."""

    def __init__(self) -> None:
        self.config: Dict[str, Any] = dict(_DEFAULTS)
        # lists are mutable; don't share them across instances
        self.config["learningRateDecay"] = list(_DEFAULTS["learningRateDecay"])
        self.config["learningRateDecayRate"] = list(_DEFAULTS["learningRateDecayRate"])

    # ---- merge / mutate ------------------------------------------------

    def update_config(self, config_obj: Dict[str, Any]) -> None:
        for key, value in config_obj.items():
            if key in self.config:
                self.config[key] = value
            else:
                Logger.warn(
                    ":: config :: ignoring unknown configuration key '{}'".format(key)
                )

    # reference-compatible alias (configuration.py:150)
    updateConfig = update_config

    def update_iteration(self, it: int) -> None:
        self.config["currentIter"] = int(it)

    updateIteration = update_iteration

    def update(self, name: str, value: Any) -> None:
        self.config[name] = value

    @classmethod
    def from_json(cls, path: str) -> "Configuration":
        cfg = cls()
        with open(path, "r") as f:
            cfg.update_config(json.load(f))
        return cfg

    # ---- template expansion --------------------------------------------

    def _fmt(self, key: str) -> str:
        return str(self.config[key]).format(**self.config)

    def _dir(self, key: str) -> str:
        path = self.config[key]
        if not os.path.exists(path):
            os.makedirs(path, exist_ok=True)
        return path

    # ---- getters (mirroring the reference property surface) -------------

    @property
    def pretrain(self) -> Optional[str]:
        if self.config["pretrain"] is not None:
            return self.config["dirPretrain"] + self.config["pretrain"]
        return None

    @property
    def datasetName(self) -> Optional[str]:
        return self.config["datasetName"]

    @property
    def modelName(self) -> Optional[str]:
        return self.config["modelName"]

    @property
    def trainName(self) -> Optional[str]:
        return self.config["trainName"]

    @property
    def learningRate(self) -> float:
        return self.config["learningRate"]

    @property
    def learningRateDecay(self) -> List[int]:
        return self.config["learningRateDecay"]

    @property
    def learningRateDecayRate(self) -> List[float]:
        return self.config["learningRateDecayRate"]

    @property
    def totalIterations(self) -> int:
        return self.config["iterations"]

    @property
    def snapshotFrequency(self) -> int:
        return self.config["snapshot"]

    @property
    def validationFrequency(self) -> int:
        return self.config["validation"]

    @property
    def batchSize(self) -> int:
        return self.config["batchSize"]

    @property
    def validationBatchSize(self) -> int:
        return self.config["validationBatchSize"]

    @property
    def currentIteration(self) -> int:
        return self.config["currentIter"]

    @property
    def naming(self) -> str:
        return self._fmt("naming")

    @property
    def optimizer(self) -> str:
        return self._fmt("optimizer")

    @property
    def namingOptimizer(self) -> str:
        return self.config["namingOptimizer"]

    @property
    def storageDtype(self) -> str:
        return self.config["storageDtype"]

    @property
    def bestSnapshotMetric(self) -> Optional[str]:
        return self.config["bestSnapshotMetric"]

    @property
    def bestSnapshotMode(self) -> str:
        return self.config["bestSnapshotMode"]

    @property
    def dirData(self) -> str:
        return self._fmt("dirData")

    @property
    def dirModel(self) -> str:
        return self._fmt("dirModel")

    @property
    def dirTemp(self) -> str:
        return self._dir("dirTemp")

    @property
    def dirResult(self) -> str:
        return self._dir("dirResult")

    @property
    def dirConfig(self) -> str:
        return self._dir("dirConfig")

    @property
    def dirDatafile(self) -> str:
        return self._fmt("dirDatafile")

    @property
    def dirDataSplitProfile(self) -> str:
        return self._fmt("dirDataSplitProfile")

    def useGPU(self):
        """Reference-compatible accessor (configuration.py:147-148 defines
        this as a method, shadowing the config key)."""
        return self.config["useGPU"]

