"""Model profiles the port can build, by name.

Counterpart of ``scd_resnet_tpu/train/registry.py`` for the profiles
whose model classes are ported. Widths and depths are the JAX
registry's (reference trainer/model/*.py):

- ``centerOffsetRes{10,18,34,50}``: full width, terminal hidden 128;
- ``centerOffsetRes{10,18,34,50,101}h``: half width, hidden 64;
- ``centerOffsetRes10q``: quarter width, hidden 64;
- ``centerOffsetRes10dcn``: full width, hidden 128, with the deformable
  prologue before the first deconv (``models/deformable.DCN``);
- ``cornerRes{10,18}``, ``cornerCPoolRes{10,18}``,
  ``cornerCombinedRes{10,18}``: full width, family ``corner``, trained on
  corner targets; the combined model's loss and decode split its one
  3-channel head;
- ``centerOffsetHourglass`` and ``centerOffsetHourglass2``: the stacked
  hourglass with 1 and 2 stacks at the production geometry
  (``models/center_net_offset.HOURGLASS_*``), the centerOffset contract
  from the last stack;
- ``cornerLegacyHourglass``: the 2-stack associative-embedding
  CornerNet, family ``cornerLegacy``, trained on the legacy corner
  targets (``corner_targets="legacy"``);
- ``cornerNetHourglass104``: the same CornerNet at its published
  Hourglass-104 widths (``models/corner_net_legacy.HOURGLASS104``, 201M
  parameters), trained and served as ``cornerLegacyHourglass``;
- ``centerRes10``: the size-regression CenterNet, full width, family
  ``centerSize``, loss weight 1.0 (reference models/centerNet.py).

These are 22 profiles: all 21 of the JAX registry and the port's own
``cornerNetHourglass104``.

``family`` names the deployment contract (``infer/wrapper.CONTRACTS``).
Every profile carries its training pieces (``loss``, ``decode``,
``evaluation``, ``expression``); the centerOffset ones the JAX
registry's loss weights (0.1, 0.1; reference centerOffsetRes10.py:9-17).

Dataset profiles: the 25 ``scdx{A}p{P}`` variants (A in {1,4,8,12,16}
rotation-augment intake, P in {5,10,25,50,100} percent partition), which
differ only in three constants (reference scdx1p5.py:57-60).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional

from torch import nn

from scd_resnet_tpu_torch.models import center_net as cns
from scd_resnet_tpu_torch.models import center_net_offset as cno
from scd_resnet_tpu_torch.models import corner_net as corner
from scd_resnet_tpu_torch.models import corner_net_legacy as legacy
from scd_resnet_tpu_torch.train.expression import (
    expression_center_net,
    expression_center_net_size,
    expression_corner_net,
    expression_corner_net_legacy,
)


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    name: str
    model_cls: Any
    model_params: Dict[str, Any]
    family: str = "centerOffset"
    loss: Optional[Callable] = None
    decode: Optional[Callable] = None
    evaluation: Optional[Callable] = None
    expression: Optional[Callable] = None
    # corner families train on batches that carry tl/br corner heatmaps;
    # "legacy" on the cornerLegacy targets
    corner_targets: Any = False

    def build(self, **overrides) -> nn.Module:
        return self.model_cls(**{**self.model_params, **overrides})

    @property
    def num_layers(self) -> int:
        return self.model_params["num_layers"]


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    argument_ratio: int
    partition: float
    train_subset: str


MODEL_PROFILES: Dict[str, ModelProfile] = {}
DATASET_PROFILES: Dict[str, DatasetProfile] = {}


def register_model(profile: ModelProfile) -> None:
    MODEL_PROFILES[profile.name] = profile


def get_model_profile(name: str) -> ModelProfile:
    if name not in MODEL_PROFILES:
        raise KeyError("unknown model profile '{}'; known: {}".format(
            name, sorted(MODEL_PROFILES)))
    return MODEL_PROFILES[name]


def get_dataset_profile(name: str) -> DatasetProfile:
    if name not in DATASET_PROFILES:
        raise KeyError("unknown dataset profile '{}'; known: {}".format(
            name, sorted(DATASET_PROFILES)))
    return DATASET_PROFILES[name]


FULL = (64, 64, 128, 256, 512, 256, 256, 256)
HALF = (32, 32, 64, 128, 256, 128, 128, 128)
QUARTER = (16, 16, 32, 64, 128, 64, 64, 64)


def _center_offset(name: str, num_layers: int, dims, hidden: int,
                   **extra) -> None:
    register_model(ModelProfile(
        name=name,
        model_cls=cno.CenterNetResidual,
        model_params={"num_layers": num_layers, "dims": tuple(dims),
                      "terminal_hidden": hidden, **extra},
        loss=cno.CenterNetLoss(0.1, 0.1),
        decode=cno.decode_center_net,
        evaluation=cno.center_net_evaluation,
        expression=expression_center_net,
    ))


for _depth in (10, 18, 34, 50):
    _center_offset(f"centerOffsetRes{_depth}", _depth, FULL, 128)
for _depth in (10, 18, 34, 50, 101):
    _center_offset(f"centerOffsetRes{_depth}h", _depth, HALF, 64)
_center_offset("centerOffsetRes10q", 10, QUARTER, 64)
_center_offset("centerOffsetRes10dcn", 10, FULL, 128, dcn=True)


def _corner(name: str, model_cls, num_layers: int,
            combined: bool = False) -> None:
    register_model(ModelProfile(
        name=name,
        model_cls=model_cls,
        model_params={"num_layers": num_layers, "dims": FULL},
        family="corner",
        loss=corner.CornerNetLoss(combined=combined),
        decode=functools.partial(corner.decode_corner_net,
                                 combined=combined),
        evaluation=corner.corner_net_evaluation,
        expression=expression_corner_net,
        corner_targets=True,
    ))


for _depth in (10, 18):
    _corner(f"cornerRes{_depth}", corner.CornerNetResidual, _depth)
    _corner(f"cornerCPoolRes{_depth}", corner.CornerNetCPoolResidual, _depth)
    _corner(f"cornerCombinedRes{_depth}", corner.CornerNetCombined, _depth,
            combined=True)

for _stacks, _name in ((1, "centerOffsetHourglass"),
                       (2, "centerOffsetHourglass2")):
    register_model(ModelProfile(
        name=_name,
        model_cls=cno.CenterNetHourglass,
        model_params={"stacks": _stacks},
        loss=cno.CenterNetLoss(0.1, 0.1),
        decode=cno.decode_center_net,
        evaluation=cno.center_net_evaluation,
        expression=expression_center_net,
    ))

for _name, _geometry in (("cornerLegacyHourglass", {"stacks": 2}),
                         ("cornerNetHourglass104", legacy.HOURGLASS104)):
    register_model(ModelProfile(
        name=_name,
        model_cls=legacy.CornerNetLegacy,
        model_params={"categories": 1, **_geometry},
        family="cornerLegacy",
        loss=legacy.CornerNetLegacyLoss(),
        decode=legacy.decode_corner_net_legacy_list,
        evaluation=legacy.corner_net_legacy_evaluation,
        expression=expression_corner_net_legacy,
        corner_targets="legacy",
    ))

register_model(ModelProfile(
    name="centerRes10",
    model_cls=cns.CenterNetSizeResidual,
    model_params={"num_layers": 10, "dims": FULL},
    family="centerSize",
    loss=cns.CenterNetSizeLoss(1.0),
    decode=cns.decode_center_net_size,
    evaluation=cns.center_net_size_evaluation,
    expression=expression_center_net_size,
))

for _a in (1, 4, 8, 12, 16):
    for _p in (5, 10, 25, 50, 100):
        DATASET_PROFILES[f"scdx{_a}p{_p}"] = DatasetProfile(
            name=f"scdx{_a}p{_p}", argument_ratio=_a, partition=_p / 100.0,
            train_subset=f"train{_a}p{_p}")
