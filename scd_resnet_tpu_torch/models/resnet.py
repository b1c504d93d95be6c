"""ResNet backbone with transposed-conv upsampling and terminal heads.

Counterpart of ``scd_resnet_tpu/models/resnet.py``, NCHW. Submodule names
follow the reference's ``CenterNetResidual`` (residuals.py,
centerNetOffset.py): ``preprocess``, ``layer{1..4}.{i}``,
``deconvolutionLayers``, one attribute per terminal head. A state dict
from the reference, or from ``core/convert.py``, loads with
``strict=True``.

The flax deconvs are ``ConvTranspose(4x4, stride 2, padding "SAME")``;
their counterpart is ``ConvTranspose2d(k=4, s=2, p=1)`` with the kernel
flipped spatially and its axes swapped (``core/convert.py``).

``deconv_dcn=True`` puts a same-width modulated deformable conv
(``models/deformable.DCN``) + BatchNorm + ReLU before the first deconv,
at the S/32 map, as the JAX backbone's ``deconv_dcn`` does (l.234-242);
its modules are ``deconv_dcn`` and ``deconv_dcn_bn``, and a backbone
without it has the same state dict as before.

``Residual`` is the pre-ResNet block of the stacked hourglass
(``models/hourglass.py``), and ``TerminalHead(block=True)`` its heads.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from scd_resnet_tpu_torch.models.deformable import DCN, lecun_normal_
from scd_resnet_tpu_torch.models.layers import (
    ConvBlock,
    autocast_off,
    batch_norm,
    conv1x1,
    conv3x3,
    stem,
)

DEFAULT_DIMENSIONS = (64, 64, 128, 256, 512, 256, 256, 256)


class Residual(nn.Module):
    """Pre-ResNet residual block (residuals.py:34-79): 3x3(stride) + BN +
    ReLU, 3x3 + BN, plus the input, or a 1x1(stride) conv + BN of it when
    the stride or the width changes, then ReLU. The reference's torch
    names ``conv1/bn1/conv2/bn2/skip.{0,1}``."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(in_features, features, stride)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = batch_norm(features)
        self.skip = _projection(in_features, features, stride) \
            if stride != 1 or in_features != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + (x if self.skip is None else self.skip(x)))


class BasicBlock(nn.Module):
    """Two 3x3 convs + identity/projection shortcut (residuals.py:84-120)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        self.conv1 = conv3x3(in_features, features, stride)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features)
        self.bn2 = batch_norm(features)
        self.downsample = _projection(in_features, features, stride) \
            if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    """1x1 -> 3x3(stride) -> 1x1 x4 bottleneck (residuals.py:122-165)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = features * self.expansion
        self.conv1 = conv1x1(in_features, features)
        self.bn1 = batch_norm(features)
        self.conv2 = conv3x3(features, features, stride)
        self.bn2 = batch_norm(features)
        self.conv3 = conv1x1(features, out)
        self.bn3 = batch_norm(out)
        self.downsample = _projection(in_features, out, stride) \
            if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


def _projection(in_features: int, features: int, stride: int
                ) -> nn.Sequential:
    return nn.Sequential(conv1x1(in_features, features, stride),
                         batch_norm(features))


# depth -> (block, stage repeats); residuals.py:355-365
RESNET_SPEC: Dict[int, Tuple[type, Tuple[int, int, int, int]]] = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
    16: (BasicBlock, (1, 2, 2, 2)),
    14: (BasicBlock, (1, 2, 2, 1)),
    12: (BasicBlock, (1, 1, 2, 1)),
    10: (BasicBlock, (1, 1, 1, 1)),
}


@dataclasses.dataclass(frozen=True)
class TerminalSpec:
    """A prediction head on the upsampled features (residuals.py:167-182):
    ``hidden == 0`` is a bare 1x1 conv, else Conv3x3(hidden)+ReLU+Conv1x1.
    ``final_bias`` and ``small_init`` are the training inits; they matter
    only to a freshly built model."""

    name: str
    out_features: int
    hidden: int = 0
    final_bias: Optional[float] = None
    small_init: bool = False


class TerminalHead(nn.Sequential):
    """Conv3x3(hidden, bias) + ReLU + Conv1x1(out, bias) — indices 0/2,
    the reference's ``{head}.{0,2}`` names; ``block=True`` is the
    hourglass layout of the same head, ConvBlock(hidden, no BN) +
    Conv1x1 at indices 0 (``.0.conv``) and 1 (stackHourglass.py's
    ``convolutionConv1x1``). The final conv runs in float32 (the JAX head
    upcasts its input there)."""

    def __init__(self, in_features: int, spec: TerminalSpec,
                 block: bool = False):
        if block:
            layers = [ConvBlock(in_features, spec.hidden, with_bn=False),
                      conv1x1(spec.hidden, spec.out_features, bias=True)]
        elif spec.hidden > 0:
            layers = [conv3x3(in_features, spec.hidden, bias=True), nn.ReLU(),
                      conv1x1(spec.hidden, spec.out_features, bias=True)]
        else:
            layers = [conv1x1(in_features, spec.out_features, bias=True)]
        super().__init__(*layers)
        self.spec = spec
        final = layers[-1]
        if spec.small_init:
            nn.init.normal_(final.weight, std=0.001)
        nn.init.constant_(final.bias, spec.final_bias or 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        *body, final = self
        for layer in body:
            x = layer(x)
        # float32 even under autocast: the JAX head casts its input up and
        # keeps the final conv's dtype at float32; a float64 model computes
        # it in float64 from that float32 input, as the JAX head promotes
        with autocast_off(x.device.type):
            return final(x.float().to(final.weight.dtype))


class ResNetBackbone(nn.Module):
    """Stem + 4 stages + 3 deconv stages (+ terminal heads).

    ``forward`` returns ``{head_name: (B, out, H/4, W/4)}``; with
    ``terminals=()`` it returns the upsampled (B, dims[7], H/4, W/4)
    features for families with their own head prologues."""

    def __init__(self, num_layers: int, terminals: Sequence[TerminalSpec],
                 dimensions: Sequence[int] = DEFAULT_DIMENSIONS,
                 deconv_dcn: bool = False):
        super().__init__()
        block, stages = RESNET_SPEC[num_layers]
        dims = tuple(dimensions)
        self.preprocess = stem(dims[0])
        in_features = dims[0]
        for stage_idx, (features, blocks) in enumerate(zip(dims[1:5], stages)):
            stride = 1 if stage_idx == 0 else 2
            out = features * block.expansion
            needs_down = stride != 1 or in_features != out
            layer = [block(in_features, features, stride, needs_down)]
            layer += [block(out, features) for _ in range(1, blocks)]
            setattr(self, "layer{}".format(stage_idx + 1), nn.Sequential(*layer))
            in_features = out
        self.deconv_dcn = DCN(in_features, in_features) if deconv_dcn \
            else None
        self.deconv_dcn_bn = batch_norm(in_features) if deconv_dcn else None
        deconvs = []
        for features in dims[5:8]:
            deconv = nn.ConvTranspose2d(in_features, features, 4, 2, 1,
                                        bias=False)
            nn.init.normal_(deconv.weight, std=0.001)
            deconvs += [deconv, batch_norm(features), nn.ReLU()]
            in_features = features
        self.deconvolutionLayers = nn.Sequential(*deconvs)
        self.out_features = in_features
        self.terminal_names = tuple(spec.name for spec in terminals)
        for spec in terminals:
            setattr(self, spec.name, TerminalHead(in_features, spec))

    def forward(self, x: torch.Tensor):
        x = self.preprocess(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.deconv_dcn is not None:
            # float32 out of the DCN; the deconvs take it in autocast's type
            x = torch.relu(self.deconv_dcn_bn(self.deconv_dcn(x)))
        x = self.deconvolutionLayers(x)
        if not self.terminal_names:
            return x
        return {name: getattr(self, name)(x) for name in self.terminal_names}


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Draw fresh weights from the distributions of the JAX model's
    initialisers (``scd_resnet_tpu/models/resnet.py``), not PyTorch's
    defaults:

    - every conv kernel: ``nn.initializers.lecun_normal()``, flax
      ``nn.Conv``'s default (the stem's ``StemConv7x7S2`` names it too);
      conv biases ``zeros_init()``;
    - the deconvolution kernels: ``normal(stddev=0.001)`` (l.254);
    - the heads' final 1x1 convs (``_final_conv_inits``, l.146-157): the
      heatmap's ``lecun_normal`` with bias ``constant(-2.19)``, the
      regression and offset heads' ``normal(stddev=0.001)`` with bias 0;
    - the DCN (``scd_resnet_tpu/models/deformable.py:34-53``): its kernel
      ``lecun_normal`` on fan-in Cin * 9, its bias 0, and
      ``conv_offset_mask``'s kernel and bias ``zeros_init()``;
    - BatchNorm: flax's scale 1, bias 0, running mean 0, variance 1.
    """
    finals = {id(m[-1]): m.spec for m in model.modules()
              if isinstance(m, TerminalHead)}
    zeroed = {id(m.conv_offset_mask) for m in model.modules()
              if isinstance(m, DCN)}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DCN):
                lecun_normal_(m.weight, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.ConvTranspose2d):
                m.weight.normal_(0.0, 0.001, generator=generator)
            elif isinstance(m, nn.Conv2d):
                spec = finals.get(id(m))
                if id(m) in zeroed:
                    m.weight.zero_()
                elif spec is not None and spec.small_init:
                    m.weight.normal_(0.0, 0.001, generator=generator)
                else:
                    lecun_normal_(m.weight, generator=generator)
                if m.bias is not None:
                    bias = spec.final_bias if spec is not None else None
                    m.bias.fill_(bias if bias is not None else 0.0)
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
