"""CornerNet with corner pooling on the ResNet backbone (serving path).

Counterpart of ``CornerNetCPoolResidual`` in
``scd_resnet_tpu/models/corner_net.py`` (reference cornerNetCPool.py):
a plain center heatmap head beside tl/br heads whose prologue is the
corner-pool fusion block. Top and left pools feed ``tl_head``, bottom
and right ``br_head`` — four launches of the corner-pool kernel per
forward on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from scd_resnet_tpu_torch.models.layers import ConvBlock, batch_norm, conv1x1, conv3x3
from scd_resnet_tpu_torch.models.resnet import DEFAULT_DIMENSIONS, ResNetBackbone
from scd_resnet_tpu_torch.ops.corner_pool import (
    bottom_pool,
    left_pool,
    right_pool,
    top_pool,
)
from scd_resnet_tpu_torch.ops.decode import extract_topk, non_maximum_suppression

CLASS_DIMENSION = 1
POOL_WIDTH = 128
HEAD_HIDDEN = 128


def _heat_head(in_features: int) -> nn.Sequential:
    """Conv3x3(128, bias) + ReLU + Conv1x1(1, bias), heat prior -2.19."""
    head = nn.Sequential(conv3x3(in_features, HEAD_HIDDEN, bias=True),
                         nn.ReLU(),
                         conv1x1(HEAD_HIDDEN, CLASS_DIMENSION, bias=True))
    nn.init.constant_(head[2].bias, -2.19)
    return head


class CornerPoolBlock(nn.Module):
    """Corner-pool fusion block (cornerNetCPool.py:53-122): two 128-wide
    conv branches with directional pools, merged 3x3 conv + BN, plus a
    1x1 conv + BN shortcut, ReLU, and a final 3x3 conv block."""

    def __init__(self, features: int,
                 pools: Tuple[Callable[[torch.Tensor], torch.Tensor], ...]):
        super().__init__()
        self.pools = pools
        self.branch1 = ConvBlock(features, POOL_WIDTH)
        self.branch2 = ConvBlock(features, POOL_WIDTH)
        self.merge_conv = conv3x3(POOL_WIDTH, features)
        self.merge_bn = batch_norm(features)
        self.skip_conv = conv1x1(features, features)
        self.skip_bn = batch_norm(features)
        self.out = ConvBlock(features, features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p1 = self.pools[0](self.branch1(x))
        p2 = self.pools[1](self.branch2(x))
        merged = self.merge_bn(self.merge_conv(p1 + p2))
        shortcut = self.skip_bn(self.skip_conv(x))
        return self.out(torch.relu(merged + shortcut))


class CornerHead(nn.Module):
    """CornerPool prologue + Conv3x3(128)+ReLU+Conv1x1 terminal
    (cornerNetCPool.py:163-199)."""

    def __init__(self, features: int,
                 pools: Tuple[Callable[[torch.Tensor], torch.Tensor], ...]):
        super().__init__()
        self.pool_block = CornerPoolBlock(features, pools)
        self.terminal = _heat_head(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.terminal(self.pool_block(x))


class CornerNetCPoolResidual(nn.Module):
    """Corner detector with real corner pooling on the tl/br heads
    (cornerNetCPool.py:220-236)."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS):
        super().__init__()
        self.backbone = ResNetBackbone(num_layers, (), dims)
        features = self.backbone.out_features
        self.heatmap = _heat_head(features)
        self.tl_head = CornerHead(features, (top_pool, left_pool))
        self.br_head = CornerHead(features, (bottom_pool, right_pool))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        features = self.backbone(x)
        return {"heatmap": self.heatmap(features),
                "tl": self.tl_head(features),
                "br": self.br_head(features)}


def decode_corner_net(out_dict: Dict[str, torch.Tensor], k: int = 100,
                      nms_kernel_size: int = 3):
    """3x sigmoid -> NMS -> top-K (cornerNet.py:272-304; plain sigmoid,
    not clamped). Returns ``[ctS, ctI, ctY, ctX, tlS, tlI, tlY, tlX,
    brS, brI, brY, brX, out_dict]``."""
    rows = []
    for head in ("heatmap", "tl", "br"):
        heat = non_maximum_suppression(torch.sigmoid(out_dict[head]),
                                       nms_kernel_size)
        scores, inds, _cats, ys, xs = extract_topk(heat, k)
        rows += [scores, inds, ys, xs]
    return rows + [out_dict]
