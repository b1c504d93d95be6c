"""The ``cornerLegacy`` family: the original CornerNet (Law & Deng, ECCV
2018, arXiv:1808.01244; princeton-vl/CornerNet ``models/CornerNet.py``),
a stacked hourglass whose stacks each feed a top-left and a bottom-right
branch: a corner-pool block (``cornerCPool.PoolBlock``: top and left
pools, or bottom and right) and heat, tag and offset heads (a 3x3
convolution with bias to ``head_hidden``, ReLU, a 1x1 convolution with
bias), after the port's ``models/corner_net_legacy.py`` names.

The stem is a 7x7/s2 convolution (BN, ReLU) to 128 and a stride-2
residual to ``dims[0]``; an hourglass level holds ``modules[0]``
residuals at its width beside a stride-2 residual to the next width, the
next level (or ``modules[1]`` residuals at the innermost), residuals
back to its width and a 2x nearest upsample, summed; a 3x3 convolution
(BN, ReLU) to ``prediction_dim`` follows each stack, and between stacks
``relu(BN(1x1(inter)) + BN(1x1(cnv)))`` and a residual.

Trained, its loss over every stack is the focal loss of each corner map,
the pull and push of the corners' tags and the smooth-L1 of their
offsets, tags and offsets gathered at the corners, the sum over the
stack count. Its targets are rebuilt from the shared transform's labels
(``CORNER_MAPS`` False): the centre ``c`` from ``index``, the corners
``(c + off / 4) -/+ (|maj|, minL)`` from ``regr``, their floors as
indices and the fractions as offset targets, a corner counted where
``mask`` holds and its floor is on the map, each map a Gaussian at the
corners with the corner radius (``train.heat_map``). That is the port's
legacy transform wherever ``mask`` is the mask of real objects: every
real centre on the map and a whole number, as the benchmark's pool
places them (``inputs.train_pool``: centres 40 pixels from the border,
floors of a quarter); :func:`loss` asserts what that leaves, each
clip's counted records a prefix.

Every tensor that the port's bfloat16 autocast holds in bfloat16 (a
convolution's output but a head's final one, which the port computes in
float32; BatchNorm's; each sum of two maps) passes through
``quantize(t, "input")`` where it is made: the identity for the
reference, so that its float32 arithmetic is as written; for the
control, a rounding to the precision below the configuration's there as
well as at each convolution's operands, forward and backward
(``reference/precision.py``). A running maximum, a ReLU, an upsample and
a concatenation return input values and are not rounded.

Under the float32 trainer each stack's residuals, each branch and the
stem recompute in the backward (``torch.utils.checkpoint``), which
leaves the arithmetic as it is and fits a batch of 32 of the published
widths on the card. Served, it has no cell.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference.cornerCPool import (
    BOTTOM,
    LEFT,
    RIGHT,
    TOP,
    ConvBN,
    PoolBlock,
    running_max,
)
from portbench.reference.model import Conv, Layer, Norm, conv_shape, identity
from portbench.reference.train import corner_radius, focal, heat_map

CORNER_MAPS = False
STEM_WIDTH = 128
THRESHOLD_IOU = 0.5
HEADS = ("heat", "tag", "regr")


def _recomputed(fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, recomputed in the backward when a gradient is taken."""
    if not torch.is_grad_enabled():
        return fn(x)
    return checkpoint(fn, x, use_reentrant=False)


def _conv_bn(conv: Conv, norm: Norm, x, q):
    """``norm(conv(x))``, each output held as autocast holds it."""
    return q(norm.run(q(conv.run(x, q), "input")), "input")


def _pool_block(block: PoolBlock, x, q):
    """``cornerCPool.PoolBlock.run`` with its outputs held as autocast
    holds them (:func:`_conv_bn`)."""
    p1 = running_max(torch.relu(_conv_bn(block.branch1.conv,
                                         block.branch1.bn, x, q)),
                     *block.pools[0])
    p2 = running_max(torch.relu(_conv_bn(block.branch2.conv,
                                         block.branch2.bn, x, q)),
                     *block.pools[1])
    merged = _conv_bn(block.merge_conv, block.merge_bn, q(p1 + p2, "input"),
                      q)
    skip = _conv_bn(block.skip_conv, block.skip_bn, x, q)
    return torch.relu(_conv_bn(block.out.conv, block.out.bn,
                               torch.relu(q(merged + skip, "input")), q))


class Residual(nn.Module):
    """3x3(stride) + BN + ReLU, 3x3 + BN, plus the input or a 1x1(stride)
    + BN projection of it (``skip``), ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1)
        self.bn1 = Norm(cout)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.bn2 = Norm(cout)
        self.skip = nn.ModuleList([Conv(cin, cout, 1, stride), Norm(cout)]) \
            if stride != 1 or cin != cout else None

    def run(self, x, q):
        def body(x):
            y = torch.relu(_conv_bn(self.conv1, self.bn1, x, q))
            y = _conv_bn(self.conv2, self.bn2, y, q)
            if self.skip is not None:
                x = _conv_bn(self.skip[0], self.skip[1], x, q)
            return torch.relu(q(y + x, "input"))
        return _recomputed(body, x)


class Stack(nn.ModuleList):
    def run(self, x, q):
        for block in self:
            x = block.run(x, q)
        return x


class Hourglass(nn.Module):
    def __init__(self, n: int, dims: Sequence[int], mods: Sequence[int]):
        super().__init__()
        cur, nxt = dims[0], dims[1]
        self.preserveCurrentDimension = Stack(
            Residual(cur, cur) for _ in range(mods[0]))
        self.changeDimension = Stack(
            [Residual(cur, nxt, 2)]
            + [Residual(nxt, nxt) for _ in range(mods[0] - 1)])
        self.embeddedHourglass = Hourglass(n - 1, dims[1:], mods[1:]) \
            if n > 1 else Stack(Residual(nxt, nxt) for _ in range(mods[1]))
        self.changeDimensionBack = Stack(
            [Residual(nxt, nxt) for _ in range(mods[0] - 1)]
            + [Residual(nxt, cur)])

    def run(self, x, q):
        low = self.changeDimensionBack.run(self.embeddedHourglass.run(
            self.changeDimension.run(x, q), q), q)
        return q(self.preserveCurrentDimension.run(x, q)
                 + F.interpolate(low, scale_factor=2, mode="nearest"), "input")


class StemConv(nn.Module):
    """k x k convolution (stride) + BN + ReLU at ``conv`` / ``bn``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, (k - 1) // 2)
        self.bn = Norm(cout)

    def run(self, x, q):
        return torch.relu(_conv_bn(self.conv, self.bn, x, q))


class Head(nn.Module):
    """3x3 conv (bias) + ReLU at ``0.conv``, 1x1 conv (bias) at ``1``."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.add_module("0", nn.Module())
        getattr(self, "0").conv = Conv(cin, hidden, 3, 1, 1, bias=True)
        self.add_module("1", Conv(hidden, cout, 1, bias=True))

    def run(self, x, q):
        hidden = torch.relu(q(getattr(self, "0").conv.run(x, q), "input"))
        # the port computes the final convolution in float32
        return getattr(self, "1").run(hidden, q)


class Branch(nn.Module):
    def __init__(self, c: int, pool_width: int, hidden: int, categories: int,
                 pools):
        super().__init__()
        self.pool_block = PoolBlock(c, pool_width, pools)
        self.heat = Head(c, hidden, categories)
        self.tag = Head(c, hidden, 1)
        self.regr = Head(c, hidden, 2)

    def run(self, x, q):
        def body(x):
            f = _pool_block(self.pool_block, x, q)
            return torch.cat([getattr(self, h).run(f, q) for h in HEADS], 1)
        return _recomputed(body, x)


class CornerLegacy(nn.Module):
    def __init__(self, config: Dict):
        super().__init__()
        dims, mods = config["dims"], config["modules"]
        cur, pred = dims[0], config["prediction_dim"]
        stacks = self.stacks = config["stacks"]
        self.categories = config["categories"]
        self.preprocess = nn.ModuleList([StemConv(1, STEM_WIDTH, 7, 2),
                                         Residual(STEM_WIDTH, cur, 2)])
        self.hourglassStack = nn.ModuleList(
            Hourglass(config["iterations"], dims, mods)
            for _ in range(stacks))
        self.redimConvolution = nn.ModuleList(ConvBN(cur, pred)
                                              for _ in range(stacks))
        for corner, pools in (("tl", (TOP, LEFT)), ("br", (BOTTOM, RIGHT))):
            setattr(self, corner, nn.ModuleList(
                Branch(pred, config["pool_width"], config["head_hidden"],
                       self.categories, pools) for _ in range(stacks)))
        self.shortcutLayers = nn.ModuleList(
            nn.ModuleList([Conv(cur, cur, 1), Norm(cur)])
            for _ in range(stacks - 1))
        self.convPrevHourglass = nn.ModuleList(
            nn.ModuleList([Conv(pred, cur, 1), Norm(cur)])
            for _ in range(stacks - 1))
        self.interHourglassLayers = nn.ModuleList(
            Residual(cur, cur) for _ in range(stacks - 1))

    def forward(self, x: torch.Tensor, quantize: Callable = identity
                ) -> List[Dict[str, torch.Tensor]]:
        q = quantize
        inter = _recomputed(
            lambda x: self.preprocess[0].run(x, q), x)
        inter = self.preprocess[1].run(inter, q)
        outs = []
        for s in range(self.stacks):
            redim = self.redimConvolution[s]
            cnv = torch.relu(_conv_bn(redim.conv, redim.bn,
                                      self.hourglassStack[s].run(inter, q),
                                      q))
            out = {}
            for corner in ("tl", "br"):
                maps = getattr(self, corner)[s].run(cnv, q)
                out[corner + "_heat"] = maps[:, :self.categories]
                out[corner + "_tag"] = maps[:, self.categories:
                                            self.categories + 1]
                out[corner + "_regr"] = maps[:, self.categories + 1:]
            outs.append(out)
            if s < self.stacks - 1:
                a, b = self.shortcutLayers[s], self.convPrevHourglass[s]
                inter = torch.relu(q(_conv_bn(a[0], a[1], inter, q)
                                     + _conv_bn(b[0], b[1], cnv, q),
                                     "input"))
                inter = self.interHourglassLayers[s].run(inter, q)
        return outs


def build(config: Dict) -> nn.Module:
    return CornerLegacy(config)


def _residual_layers(cin: int, cout: int, side: int, stride: int = 1
                     ) -> List[Layer]:
    out_side = side // stride
    out = [conv_shape(3, cin, cout, out_side),
           conv_shape(3, cout, cout, out_side)]
    if stride != 1 or cin != cout:
        out.append(conv_shape(1, cin, cout, out_side))
    return out


def _hourglass_layers(n: int, dims, mods, side: int) -> List[Layer]:
    cur, nxt = dims[0], dims[1]
    out = []
    for _ in range(mods[0]):
        out += _residual_layers(cur, cur, side)
    out += _residual_layers(cur, nxt, side, 2)
    for _ in range(mods[0] - 1):
        out += _residual_layers(nxt, nxt, side // 2)
    if n > 1:
        out += _hourglass_layers(n - 1, dims[1:], mods[1:], side // 2)
    else:
        for _ in range(mods[1]):
            out += _residual_layers(nxt, nxt, side // 2)
    for _ in range(mods[0] - 1):
        out += _residual_layers(nxt, nxt, side // 2)
    out += _residual_layers(nxt, cur, side // 2)
    return out


def layers(config: Dict, size: int) -> List[Layer]:
    dims, mods = config["dims"], config["modules"]
    cur, pred = dims[0], config["prediction_dim"]
    width, hidden = config["pool_width"], config["head_hidden"]
    side = size // 4
    out = [conv_shape(7, 1, STEM_WIDTH, size // 2)]
    out += _residual_layers(STEM_WIDTH, cur, size // 2, 2)
    for s in range(config["stacks"]):
        out += _hourglass_layers(config["iterations"], dims, mods, side)
        out.append(conv_shape(3, cur, pred, side))
        for _ in ("tl", "br"):
            out += [conv_shape(3, pred, width, side),
                    conv_shape(3, pred, width, side),
                    conv_shape(3, width, pred, side),
                    conv_shape(1, pred, pred, side),
                    conv_shape(3, pred, pred, side)]
            for cout in (config["categories"], 1, 2):
                out += [conv_shape(3, pred, hidden, side),
                        conv_shape(1, hidden, cout, side)]
        if s < config["stacks"] - 1:
            out += [conv_shape(1, cur, cur, side), conv_shape(1, pred, cur, side)]
            out += _residual_layers(cur, cur, side)
    return out


def targets(labels: Dict) -> Dict[str, torch.Tensor]:
    """The legacy targets rebuilt from the shared transform's labels
    (module docstring): ``{tl,br}_{heat (B, S, S),regr (B, K, 2),inds
    (B, K)}`` and ``mask`` (B, K), both corners counted."""
    mask, index, regr = labels["mask"], labels["index"], labels["regr"]
    if not bool((mask[:, 1:] <= mask[:, :-1]).all()):
        raise AssertionError("a clip's counted records are not a prefix: a "
                             "real centre lies off the map, where the "
                             "shared transform's mask is not the legacy one")
    heat = labels["heatmap"].shape[-1]
    centre = torch.stack([index % heat, torch.div(
        index, heat, rounding_mode="floor")], dim=-1).float()
    locs = torch.cat([centre, regr], dim=-1)
    half = torch.stack([torch.sqrt(regr[..., 2] ** 2 + regr[..., 3] ** 2),
                        regr[..., 4]], dim=-1)
    exact = centre + regr[..., 0:2] / 4
    out, counted = {}, []
    for corner, true in (("tl", exact - half), ("br", exact + half)):
        ints = torch.floor(true)
        on = mask & (ints[..., 0] >= 0) & (ints[..., 0] < heat) \
            & (ints[..., 1] >= 0) & (ints[..., 1] < heat)
        inds = (ints[..., 1] * heat + ints[..., 0]).long()
        out[corner + "_inds"] = torch.where(on, inds, torch.zeros_like(inds))
        out[corner + "_regr"] = true - ints
        out[corner + "_heat"] = heat_map(locs, on, heat, corner_radius,
                                         THRESHOLD_IOU, true - centre)
        counted.append(on)
    out["mask"] = counted[0] & counted[1]
    return out


def _gather(feature: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    b, c = feature.shape[:2]
    return feature.float().reshape(b, c, -1).gather(
        2, index[:, None, :].expand(b, c, index.shape[1])).permute(0, 2, 1)


def pull_push(tl: torch.Tensor, br: torch.Tensor, mask: torch.Tensor):
    """Pull and push of (B, K) tags over the (B, K) mask of objects."""
    m = mask.float()
    n = m.sum(dim=1, keepdim=True)
    mean = (tl + br) / 2
    pull = (((tl - mean) ** 2 + (br - mean) ** 2) / (n + 1e-4) * m).sum()
    pairs = m[:, None, :] * m[:, :, None]
    n = n[:, :, None]
    dist = torch.relu(1 - (mean[:, None, :] - mean[:, :, None]).abs())
    dist = (dist - 1 / (n + 1e-4)) / ((n - 1) * n + 1e-4)
    return pull, (dist * pairs).sum()


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
    d = (pred - target).abs()
    err = torch.where(d < 1, 0.5 * d * d, d - 0.5)
    m = mask.float()
    return (err * m[..., None]).sum() / (m.sum() + 1e-4)


def loss(outs: List[Dict], labels: Dict, weights) -> torch.Tensor:
    t = targets(labels)
    total = 0
    for out in outs:
        total = total + focal(out["tl_heat"], t["tl_heat"]) \
            + focal(out["br_heat"], t["br_heat"])
        pull, push = pull_push(_gather(out["tl_tag"], t["tl_inds"])[..., 0],
                               _gather(out["br_tag"], t["br_inds"])[..., 0],
                               t["mask"])
        total = total + pull + push
        for corner in ("tl", "br"):
            total = total + smooth_l1(
                _gather(out[corner + "_regr"], t[corner + "_inds"]),
                t[corner + "_regr"], t["mask"])
    return total / len(outs)
