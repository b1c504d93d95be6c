"""The deformable modules: the modulated deformable convolution (DCNv2)
and deformable PSROI pooling.

Counterpart of ``scd_resnet_tpu/models/deformable.DCN`` (l.20-57), NCHW:
an internal 3x3 conv, ``conv_offset_mask``, predicts 3 K channels (K = 9
taps) from the input, and the layer convolves the input at the taps
moved by those offsets, each sample scaled by its mask
(``ops/dcn.deform_conv2d``). The channels split as the JAX module splits
them (``jnp.split(om, 3)``): 0..K-1 are every tap's dy, K..2K-1 its dx,
2K..3K-1 its mask logits, put through a sigmoid. (DCNv2's and
torchvision's ops interleave the offsets as (2k, 2k+1) instead.)

The whole layer computes in float32, under autocast too: the JAX DCN
takes its input cast to float32 and its offset conv has no ``dtype``
(``scd_resnet_tpu/models/resnet.py:240``), so the offsets, the gather
and the product are float32 in a bfloat16 train step.

``conv_offset_mask`` starts at zero (flax ``zeros_init``): a fresh layer
samples the plain 3x3 grid with mask 0.5, that is half a plain conv plus
the bias. ``models/resnet.init_like_flax`` keeps it so.

``DCNPooling`` is ``scd_resnet_tpu/models/deformable.DCNPooling``
(l.60-101; reference dcn_v2.py:282-344): a pass of PSROI pooling without
displacements feeds two ``deform_fc_dim``-wide ``Linear`` + ReLU layers
and a zero-initialised ``Linear`` that predicts every bin's normalised
displacement, and a second, deformable pass pools with them. The first
pass is flattened channels-last, (N, p, p, C), and the displacements
read as (N, p, p, 2), as the flax module lays them out, so flax's
``Dense_0..2`` kernels carry over transposed
(``core/convert.dcn_pooling_state_dict``). On no model's path.
"""

from __future__ import annotations

import torch
from torch import nn

from scd_resnet_tpu_torch.models.layers import autocast_off
from scd_resnet_tpu_torch.ops.dcn import deform_conv2d, deform_psroi_pooling

# flax's lecun_normal: a normal truncated to +-2 std whose std is divided
# by this constant, so that the truncated draw has variance 1 / fan_in
TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``nn.initializers.lecun_normal()`` on an (out, in, ...) kernel:
    fan_in is everything but the first axis."""
    std = (1.0 / weight[0].numel()) ** 0.5 / TRUNCATED_NORMAL_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class DCN(nn.Module):
    """Modulated deformable conv with its own offset and mask predictor
    (``scd_resnet_tpu/models/deformable.DCN``). Parameters: ``weight``
    (Cout, Cin, k, k), ``bias`` (Cout,) and ``conv_offset_mask``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1):
        super().__init__()
        self.taps = kernel_size * kernel_size
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.conv_offset_mask = nn.Conv2d(in_features, 3 * self.taps,
                                          kernel_size, stride, padding)
        self.weight = nn.Parameter(torch.empty(features, in_features,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(features))
        with torch.no_grad():
            nn.init.zeros_(self.conv_offset_mask.weight)
            nn.init.zeros_(self.conv_offset_mask.bias)
            lecun_normal_(self.weight)

    def offsets_and_mask(self, x: torch.Tensor):
        """(offset (B, Ho, Wo, K, 2) as (dy, dx), mask (B, Ho, Wo, K)) of
        a float32 input, in the JAX module's layout."""
        k = self.taps
        om = self.conv_offset_mask(x)
        offset = torch.stack([om[:, :k], om[:, k:2 * k]], dim=-1)
        mask = torch.sigmoid(om[:, 2 * k:])
        return offset.permute(0, 2, 3, 1, 4), mask.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with autocast_off(x.device.type):
            x = x.float()
            offset, mask = self.offsets_and_mask(x)
            return deform_conv2d(x, offset, mask, self.weight, self.bias,
                                 self.stride, self.padding, self.dilation)


class DCNPooling(nn.Module):
    """Deformable PSROI pooling with a learned displacement branch. Input
    x (B, C, H, W) with C = output_dim group_size^2, rois (N, 5); output
    (N, output_dim, pooled_size, pooled_size). With ``no_trans`` it is
    the first pass alone."""

    def __init__(self, output_dim: int, pooled_size: int = 7,
                 group_size: int = 1, spatial_scale: float = 1.0 / 4,
                 trans_std: float = 0.1, sample_per_part: int = 4,
                 deform_fc_dim: int = 1024, no_trans: bool = False):
        super().__init__()
        self.pool_args = dict(output_dim=output_dim, group_size=group_size,
                              pooled_size=pooled_size,
                              spatial_scale=spatial_scale,
                              trans_std=trans_std,
                              sample_per_part=sample_per_part)
        self.pooled_size, self.no_trans = pooled_size, no_trans
        if no_trans:
            return
        p = pooled_size
        self.fc = nn.Sequential(
            nn.Linear(p * p * output_dim, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, deform_fc_dim), nn.ReLU(),
            nn.Linear(deform_fc_dim, p * p * 2))
        with torch.no_grad():
            for layer in self.fc[:3:2]:
                lecun_normal_(layer.weight)
                nn.init.zeros_(layer.bias)
            nn.init.zeros_(self.fc[4].weight)
            nn.init.zeros_(self.fc[4].bias)

    def forward(self, x: torch.Tensor, rois: torch.Tensor) -> torch.Tensor:
        base = deform_psroi_pooling(x, rois, None, no_trans=True,
                                    **self.pool_args)
        if self.no_trans:
            return base
        n, p = rois.shape[0], self.pooled_size
        trans = self.fc(base.permute(0, 2, 3, 1).reshape(n, -1))
        trans = trans.reshape(n, p, p, 2).permute(0, 3, 1, 2)
        return deform_psroi_pooling(x, rois, trans, no_trans=False,
                                    **self.pool_args)
