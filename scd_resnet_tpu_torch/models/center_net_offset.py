"""CenterNet-with-offset, the production SCD detector (serving path).

Counterpart of ``scd_resnet_tpu/models/center_net_offset.py``: three
terminal heads on the upsampled ResNet features — heatmap(1),
regr(4: majX, majY, minL, halo), offset(2) — and the sigmoid -> NMS ->
top-K decode (reference centerNetOffset.py:219-251). The module *is* the
backbone, so its state dict carries the reference's own names
(``preprocess.*``, ``layer{i}.{j}.*``, ``deconvolutionLayers.*``,
``heatmap/regr/offset.{0,2}.*``) and reference-trained ``.pth`` files
load with ``strict=True``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from scd_resnet_tpu_torch.models.resnet import (
    DEFAULT_DIMENSIONS,
    ResNetBackbone,
    TerminalSpec,
)
from scd_resnet_tpu_torch.ops.decode import (
    extract_topk,
    non_maximum_suppression,
    reshape_gather_features,
)

CLASS_DIMENSION = 1


def as_stack_list(outs):
    """Model output as a list of per-stack head dicts (a ResNet returns
    one dict, a stacked hourglass a list)."""
    return outs if isinstance(outs, (list, tuple)) else [outs]


def _terminals(hidden: int) -> List[TerminalSpec]:
    return [
        TerminalSpec("heatmap", CLASS_DIMENSION, hidden, final_bias=-2.19),
        TerminalSpec("regr", 4, hidden, small_init=True),
        TerminalSpec("offset", 2, hidden, small_init=True),
    ]


class CenterNetResidual(ResNetBackbone):
    """ResNet-backed center detector (centerNetOffset.py:150-168);
    ``terminal_hidden=64`` is the ``h``/``q`` variant."""

    def __init__(self, num_layers: int = 10,
                 dims: Sequence[int] = DEFAULT_DIMENSIONS,
                 terminal_hidden: int = 128):
        super().__init__(num_layers, _terminals(terminal_hidden), dims)


def decode_center_net(out_dict: Dict[str, torch.Tensor], k: int = 100,
                      nms_kernel_size: int = 3):
    """sigmoid -> NMS -> top-K -> gather on NCHW heads.

    Returns ``[scores, indices, y, x, offset(B,K,2), regr(B,K,4),
    out_dict]``."""
    heat = out_dict["heatmap"].float()
    heat = non_maximum_suppression(torch.sigmoid(heat), nms_kernel_size)
    scores, indices, _categories, ys, xs = extract_topk(heat, k)
    regression = reshape_gather_features(out_dict["regr"], indices)
    offset = reshape_gather_features(out_dict["offset"], indices)
    return [scores, indices, ys, xs, offset, regression, out_dict]
