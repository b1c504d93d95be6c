"""Building blocks: BatchNorm, Conv+BN+ReLU, the 7x7/s2 stem.

Counterpart of ``scd_resnet_tpu/models/layers.py``, NCHW. Serving runs
the models in eval mode, where BatchNorm normalises with its running
statistics exactly as flax's ``use_running_average=True`` does (eps 1e-5).
The JAX stem conv is a space-to-depth lowering of a 7x7/s2/p3 conv; here
it is that plain conv, with the same kernel.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax's 0.9


def batch_norm(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv3x3(in_features: int, features: int, stride: int = 1,
            bias: bool = False) -> nn.Conv2d:
    """3x3 conv, pad 1 (models/backbones/utility.py:125-127)."""
    return nn.Conv2d(in_features, features, 3, stride, 1, bias=bias)


def conv1x1(in_features: int, features: int, stride: int = 1,
            bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, 1, stride, 0, bias=bias)


class ConvBlock(nn.Module):
    """k x k same-size Conv -> BN -> ReLU (convolutions.py:25-49);
    ``with_bn=False`` drops the BN and gives the conv a bias."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1,
                 with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                              (kernel_size - 1) // 2, bias=not with_bn)
        self.bn = batch_norm(features) if with_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x)


def stem(features: int) -> nn.Sequential:
    """7x7/s2/p3 conv + BN + ReLU + 3x3/s2/p1 max pool
    (residuals.py:210-215); indices 0/1 carry the reference's
    ``preprocess.{0,1}`` state-dict names."""
    return nn.Sequential(
        nn.Conv2d(1, features, 7, 2, 3, bias=False),
        batch_norm(features),
        nn.ReLU(),
        nn.MaxPool2d(3, 2, 1),
    )
