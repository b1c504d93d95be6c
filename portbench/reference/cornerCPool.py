"""The ``cornerCPool`` family: the backbone beside a heatmap(1) head and
tl/br heads whose prologue is the corner-pool fusion block (two
``pool_width``-wide conv+BN+ReLU branches, a directional running max on
each, a 3x3 conv + BN of their sum plus a 1x1 conv + BN of the input,
ReLU, a 3x3 conv + BN + ReLU), each ending in a ``corner_hidden``-wide
head, after the reference's ``models/cornerNetCPool.py``.

The corner pools' gradient goes to the first maximum in scan order (the
reference's C++ pools). Served, it answers ``[x, y, score, head]`` for
the heads ``ct``, ``tl`` and ``br`` in that order; trained, its loss is
the focal loss of each of the three maps.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
from torch import nn

from portbench.reference.model import (
    Backbone,
    Conv,
    Head,
    Layer,
    Norm,
    backbone_layers,
    conv_shape,
    head_layers,
    identity,
)
from portbench.reference.serve import RATIO, THRESHOLD, peaks
from portbench.reference.train import focal

CORNER_MAPS = True
CORNER_HEADS = (("heatmap", "ct"), ("tl", "tl"), ("br", "br"))


class _RunningMax(torch.autograd.Function):
    """Running max along ``dim`` (from the far end when ``reverse``); its
    gradient goes to the position where the running max first took its
    value."""

    @staticmethod
    def forward(ctx, x, dim, reverse):
        xs = x.flip(dim) if reverse else x
        n = xs.shape[dim]
        values = torch.cummax(xs, dim).values
        before = torch.cat([torch.full_like(values.narrow(dim, 0, 1),
                                            float("-inf")),
                            values.narrow(dim, 0, n - 1)], dim)
        shape = [1] * xs.dim()
        shape[dim] = n
        positions = torch.arange(n, device=x.device).view(shape).expand_as(xs)
        source = torch.where(xs > before, positions,
                             torch.zeros_like(positions))
        source = torch.cummax(source, dim).values
        ctx.save_for_backward(source)
        ctx.dim, ctx.reverse = dim, reverse
        return values.flip(dim) if reverse else values

    @staticmethod
    def backward(ctx, g):
        (source,) = ctx.saved_tensors
        dim, reverse = ctx.dim, ctx.reverse
        gs = g.flip(dim) if reverse else g
        dx = torch.zeros_like(gs).scatter_add_(dim, source, gs.contiguous())
        return (dx.flip(dim) if reverse else dx), None, None


def running_max(x: torch.Tensor, dim: int, reverse: bool) -> torch.Tensor:
    return _RunningMax.apply(x, dim, reverse)


# (dim, reverse) of the top, left, bottom and right pools (NCHW)
TOP, LEFT, BOTTOM, RIGHT = (2, True), (3, True), (2, False), (3, False)


class ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 3, 1, 1)
        self.bn = Norm(cout)

    def run(self, x, q):
        return torch.relu(self.bn.run(self.conv.run(x, q)))


class PoolBlock(nn.Module):
    def __init__(self, c: int, width: int, pools):
        super().__init__()
        self.pools = pools
        self.branch1 = ConvBN(c, width)
        self.branch2 = ConvBN(c, width)
        self.merge_conv = Conv(width, c, 3, 1, 1)
        self.merge_bn = Norm(c)
        self.skip_conv = Conv(c, c, 1)
        self.skip_bn = Norm(c)
        self.out = ConvBN(c, c)

    def run(self, x, q):
        p1 = running_max(self.branch1.run(x, q), *self.pools[0])
        p2 = running_max(self.branch2.run(x, q), *self.pools[1])
        merged = self.merge_bn.run(self.merge_conv.run(p1 + p2, q))
        skip = self.skip_bn.run(self.skip_conv.run(x, q))
        return self.out.run(torch.relu(merged + skip), q)


class CornerHead(nn.Module):
    def __init__(self, c: int, width: int, hidden: int, pools):
        super().__init__()
        self.pool_block = PoolBlock(c, width, pools)
        self.terminal = Head(c, hidden, 1)

    def run(self, x, q):
        return self.terminal.run(self.pool_block.run(x, q), q)


class CornerCPool(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        self.backbone = Backbone(config["dims"], config["num_layers"])
        c = self.backbone.out_features
        self.heatmap = Head(c, config["terminal_hidden"], 1)
        width, hidden = config["pool_width"], config["corner_hidden"]
        self.tl_head = CornerHead(c, width, hidden, (TOP, LEFT))
        self.br_head = CornerHead(c, width, hidden, (BOTTOM, RIGHT))

    def forward(self, x: torch.Tensor, quantize: Callable = identity
                ) -> Dict[str, torch.Tensor]:
        f = self.backbone.run(x, quantize)
        return {"heatmap": self.heatmap.run(f, quantize),
                "tl": self.tl_head.run(f, quantize),
                "br": self.br_head.run(f, quantize)}


def build(config: Dict) -> nn.Module:
    return CornerCPool(config)


def layers(config: Dict, size: int) -> List[Layer]:
    out, c, side = backbone_layers(config, size)
    out += head_layers(c, config["terminal_hidden"], 1, side)
    pool = config["pool_width"]
    for _ in ("tl", "br"):
        out += [conv_shape(3, c, pool, side), conv_shape(3, c, pool, side),
                conv_shape(3, pool, c, side), conv_shape(1, c, c, side),
                conv_shape(3, c, c, side)]
        out += head_layers(c, config["corner_hidden"], 1, side)
    return out


def decode(out: Dict[str, torch.Tensor]) -> List[List[torch.Tensor]]:
    """One part a head: ``[score, y, x]``, each (B, K)."""
    parts = []
    for name, _ in CORNER_HEADS:
        scores, _index, ys, xs = peaks(out[name])
        parts.append([scores, ys.float(), xs.float()])
    return parts


def answers(parts: List[np.ndarray], base_x: np.ndarray, base_y: np.ndarray,
            width: int, height: int) -> List[list]:
    out: List[list] = []
    for (_, head), (scores, ys, xs) in zip(CORNER_HEADS, parts):
        sx = np.trunc(base_x + xs * RATIO)
        sy = np.trunc(base_y + ys * RATIO)
        keep = (scores > THRESHOLD) & (sx >= 0) & (sx < width) \
            & (sy >= 0) & (sy < height)
        out += [[int(a), int(b), float(c), head]
                for a, b, c in zip(sx[keep], sy[keep], scores[keep])]
    return out


def loss(out: Dict, labels: Dict, weights) -> torch.Tensor:
    return focal(out["heatmap"], labels["heatmap"]) \
        + focal(out["tl"], labels["tl"]) + focal(out["br"], labels["br"])
