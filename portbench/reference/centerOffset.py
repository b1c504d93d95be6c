"""The ``centerOffset`` family: the backbone with its layers at the top
level and heads heatmap(1), regr(4), offset(2), each a 3x3 conv
(``terminal_hidden`` wide, bias) + ReLU + 1x1 conv (bias), after the
reference's ``models/centerNetOffset.py`` ``CenterNetResidual``.

Served, it answers ``[x, y, rhr]`` with ``rhr = (4 rad - 4 minL) / (2 * 4
minL)`` from the regression head; trained, its loss is the focal loss of
the heat map plus the weighted masked L1 of the regression and offset
heads at the objects' indices.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from portbench.reference.model import (
    Backbone,
    Head,
    Layer,
    backbone_forward,
    backbone_layers,
    head_layers,
    identity,
)
from portbench.reference.serve import RATIO, THRESHOLD, gather, peaks
from portbench.reference.train import focal, masked_l1

CORNER_MAPS = False


class CenterOffset(nn.Module):
    heads = ("heatmap", "regr", "offset")

    def __init__(self, dims: Sequence[int], num_layers: int, hidden: int):
        super().__init__()
        backbone = Backbone(dims, num_layers)
        for name, module in backbone.named_children():
            self.add_module(name, module)
        c = backbone.out_features
        self.heatmap = Head(c, hidden, 1)
        self.regr = Head(c, hidden, 4)
        self.offset = Head(c, hidden, 2)

    def forward(self, x: torch.Tensor, quantize: Callable = identity
                ) -> Dict[str, torch.Tensor]:
        f = backbone_forward(self, x, quantize)
        return {name: getattr(self, name).run(f, quantize)
                for name in self.heads}


def build(config: Dict) -> nn.Module:
    return CenterOffset(config["dims"], config["num_layers"],
                        config["terminal_hidden"])


def layers(config: Dict, size: int) -> List[Layer]:
    out, c, side = backbone_layers(config, size)
    for cout in (1, 4, 2):
        out += head_layers(c, config["terminal_hidden"], cout, side)
    return out


def decode(out: Dict[str, torch.Tensor]) -> List[List[torch.Tensor]]:
    """One part: ``[score, y, x, majX, majY, minL, rad, offX, offY]``,
    each (B, K)."""
    scores, index, ys, xs = peaks(out["heatmap"])
    regr = gather(out["regr"].float(), index)
    offset = gather(out["offset"].float(), index)
    return [[scores, ys.float(), xs.float(), *regr.unbind(2),
             *offset.unbind(2)]]


def answers(parts: List[np.ndarray], base_x: np.ndarray, base_y: np.ndarray,
            width: int, height: int) -> List[list]:
    scores, ys, xs, _mx, _my, min_l, rad, off_x, off_y = parts[0]
    sx = np.trunc(base_x + xs * RATIO + off_x)
    sy = np.trunc(base_y + ys * RATIO + off_y)
    with np.errstate(divide="ignore", invalid="ignore"):
        rhr = (rad * RATIO - min_l * RATIO) / (2 * min_l * RATIO)
    keep = (scores > THRESHOLD) & (sx >= 0) & (sx < width) \
        & (sy >= 0) & (sy < height)
    return [[int(a), int(b), float(c)]
            for a, b, c in zip(sx[keep], sy[keep], rhr[keep])]


def loss(out: Dict, labels: Dict, weights) -> torch.Tensor:
    return focal(out["heatmap"], labels["heatmap"]) \
        + weights[0] * masked_l1(out["regr"], labels["index"],
                                 labels["regr"][..., 2:6], labels["mask"]) \
        + weights[1] * masked_l1(out["offset"], labels["index"],
                                 labels["regr"][..., 0:2], labels["mask"])
