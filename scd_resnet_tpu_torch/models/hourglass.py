"""Recursive hourglass and the stacked-hourglass network.

Counterpart of ``scd_resnet_tpu/models/hourglass.py`` (reference
models/backbones/hourglass.py:61-114, stackHourglass.py:130-272), NCHW.
One hourglass level:

    up1  = residual stack at the current width          (preserve)
    low  = downsample -> residual stack to the next width (change)
    low2 = recurse, or the central residual stack at the innermost level
    low3 = residual stack back to the current width     (change back)
    out  = up1 + 2x nearest-neighbour upsample of low3

Downsampling is a 2x2 max pool (``pool_downsample``) or a stride-2 first
residual, which both hourglass profiles use. The stacked network: a 4x
preprocess (7x7/s2 ConvBlock + stride-2 ``Residual``), then per stack
hourglass -> 3x3 ConvBlock to the prediction width -> terminal heads,
with a shortcut merge between stacks. ``forward`` returns the list of
per-stack head dicts; decode reads the last.

Submodules carry the reference's torch names
(``scd_resnet_tpu/core/torch_convert.py:143-160``): ``preprocess.{0,1}``,
``hourglassStack.{s}`` with ``preserveCurrentDimension``,
``changeDimension``, ``embeddedHourglass`` and ``changeDimensionBack``,
``redimConvolution.{s}``, ``{head}.{s}.{0,1}``, and for more than one
stack ``shortcutLayers``, ``convPrevHourglass`` and
``interHourglassLayers``; ``export_center_net_hourglass`` output loads
with ``strict=True``.

``remat=True`` recomputes each stack's hourglass in the backward
(``models/layers.checkpointed``), as the JAX ``nn.remat`` does; the
parameters and state-dict keys are the same either way. Under a profiler
each stack's hourglass call, its recompute included, is an
``scd.model.hourglass`` span (``core/profiling.span``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from scd_resnet_tpu_torch.core.profiling import span
from scd_resnet_tpu_torch.models.layers import (
    ConvBlock,
    batch_norm,
    checkpointed,
    conv1x1,
    max_pool_2x2_s2,
)
from scd_resnet_tpu_torch.models.resnet import Residual, TerminalHead, TerminalSpec


class ResidualStack(nn.Sequential):
    """``modules`` residuals, the width change and stride in the first
    (utility.py:35-42 ``stackLayers``)."""

    def __init__(self, in_features: int, features: int, modules: int,
                 first_stride: int = 1):
        super().__init__(Residual(in_features, features, first_stride),
                         *(Residual(features, features)
                           for _ in range(1, modules)))


class ResidualStackReverted(nn.Sequential):
    """``modules`` residuals, the width change in the last
    (utility.py:44-49 ``stackLayersReverted``)."""

    def __init__(self, in_features: int, features: int, modules: int):
        super().__init__(*(Residual(in_features, in_features)
                           for _ in range(modules - 1)),
                         Residual(in_features, features))


class Hourglass(nn.Module):
    """Recursive hourglass (hourglass.py:61-114); its input has
    ``dimensions[0]`` channels and an even side at every level."""

    def __init__(self, iterations: int, dimensions: Sequence[int],
                 modules: Sequence[int], pool_downsample: bool = True):
        super().__init__()
        dims, mods = tuple(dimensions), tuple(modules)
        cur, nxt = dims[0], dims[1]
        self.pool_downsample = pool_downsample
        self.preserveCurrentDimension = ResidualStack(cur, cur, mods[0])
        self.changeDimension = ResidualStack(
            cur, nxt, mods[0], 1 if pool_downsample else 2)
        self.embeddedHourglass = (
            Hourglass(iterations - 1, dims[1:], mods[1:], pool_downsample)
            if iterations > 1 else ResidualStack(nxt, nxt, mods[1]))
        self.changeDimensionBack = ResidualStackReverted(nxt, cur, mods[0])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up1 = self.preserveCurrentDimension(x)
        low = max_pool_2x2_s2(x) if self.pool_downsample else x
        low = self.changeDimensionBack(self.embeddedHourglass(
            self.changeDimension(low)))
        # nearest neighbour, as the JAX package's jnp.repeat twice: exact
        return up1 + F.interpolate(low, scale_factor=2, mode="nearest")


class StackHourglass(nn.Module):
    """Stacked hourglass with terminal heads (stackHourglass.py:130-272).

    ``terminals`` are (name, out_features, final_bias | None); each head
    is ConvBlock(3x3 to ``dimensions[0]``, biased, no BN) + Conv1x1, its
    final conv in float32. Returns a list of per-stack ``{head: (B, C,
    H/4, W/4)}`` dicts (:meth:`heads`)."""

    def __init__(self, iterations: int = 5, stacks: int = 1,
                 dimensions: Sequence[int] = (128, 128, 192, 192, 192, 256),
                 modules: Sequence[int] = (2, 2, 2, 2, 2, 4),
                 prediction_dim: int = 256,
                 terminals: Sequence[Tuple[str, int, Optional[float]]] = (
                     ("heatmap", 1, -2.19),),
                 pool_downsample: bool = False, remat: bool = False):
        super().__init__()
        cur = dimensions[0]
        self.stacks = stacks
        self.remat = remat
        self.preprocess = nn.Sequential(ConvBlock(1, 128, 7, stride=2),
                                        Residual(128, cur, stride=2))
        self.hourglassStack = nn.ModuleList(
            Hourglass(iterations, dimensions, modules, pool_downsample)
            for _ in range(stacks))
        self.redimConvolution = nn.ModuleList(
            ConvBlock(cur, prediction_dim) for _ in range(stacks))
        self.terminal_names = tuple(name for name, _, _ in terminals)
        for name, features, bias in terminals:
            spec = TerminalSpec(name, features, cur, final_bias=bias)
            setattr(self, name, nn.ModuleList(
                TerminalHead(prediction_dim, spec, block=True)
                for _ in range(stacks)))
        self.shortcutLayers = nn.ModuleList(
            nn.Sequential(conv1x1(cur, cur), batch_norm(cur))
            for _ in range(stacks - 1))
        self.convPrevHourglass = nn.ModuleList(
            nn.Sequential(conv1x1(prediction_dim, cur), batch_norm(cur))
            for _ in range(stacks - 1))
        self.interHourglassLayers = nn.ModuleList(
            Residual(cur, cur) for _ in range(stacks - 1))

    def heads(self, stack: int, cnv: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Stack ``stack``'s head outputs on its prediction features."""
        return {name: getattr(self, name)[stack](cnv)
                for name in self.terminal_names}

    def hourglass(self, stack: int, x: torch.Tensor) -> torch.Tensor:
        """Stack ``stack``'s hourglass on ``x``."""
        with span("scd.model.hourglass"):
            return self.hourglassStack[stack](x)

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        inter = self.preprocess(x)
        outs = []
        for s in range(self.stacks):
            kp = checkpointed(self.hourglass, s, inter, enabled=self.remat)
            cnv = self.redimConvolution[s](kp)
            outs.append(self.heads(s, cnv))
            if s < self.stacks - 1:
                inter = torch.relu(self.shortcutLayers[s](inter)
                                   + self.convPrevHourglass[s](cnv))
                inter = self.interHourglassLayers[s](inter)
        return outs
