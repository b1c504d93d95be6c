"""Carry the JAX package's trained variables into the port's modules.

``state_dict_from_flax(arch, params, batch_stats)`` takes the flax
variables as nested dicts of numpy arrays (what the JAX checkpoints
hold) and returns the port model's state dict, following flax's
auto-names (``ResNetBackbone_0/Conv_0``, ``BasicBlock_k/BatchNorm_j``,
``ConvTranspose_j``, ``tl_head/CornerPoolBlock_0/...``). Layouts:

- conv kernels HWIO -> OIHW;
- flax ``ConvTranspose(4x4, s2, "SAME")`` kernels (kh, kw, in, out) ->
  ``ConvTranspose2d(k4, s2, p1)`` weights (in, out, kh, kw), flipped
  spatially;
- BatchNorm ``scale/bias`` + ``mean/var`` -> ``weight/bias`` +
  ``running_mean/running_var`` (flax wraps its ``nn.BatchNorm`` in one
  more ``BatchNorm_0`` scope).

flax numbers a backbone's BatchNorms in the order it builds them: the
stem's is ``BatchNorm_0``, then (with ``deconv_dcn``) the DCN's, then one
per deconv stage, so the deconvs' start at ``BatchNorm_2`` in a DCN
model and at ``BatchNorm_1`` without one. The DCN's kernels
(``deconv_dcn/kernel`` and ``deconv_dcn/conv_offset_mask/kernel``) are
HWIO like every conv's.

For the ``centerOffset`` family the result carries the reference's names,
the same dict ``scd_resnet_tpu/core/torch_convert.export_center_net_residual``
writes. ``cornerRes*`` and ``cornerCombinedRes*`` share that layout with
their own heads (``heatmap``/``tl``/``br``, or one 3-channel
``heatmap``), and so does ``centerRes10`` (``heatmap``/``size``);
``cornerCPoolRes*`` nests the backbone under
``backbone.`` beside its center head and two corner-pool heads.

The stacked hourglasses are walked along the port model the profile
builds, so any geometry converts. flax numbers their recursive modules
itself: in a ``Hourglass_k``, ``ResidualStack_0`` (up1),
``ResidualStack_1`` (the downsampling stack), then ``Hourglass_0`` or, at
the innermost level, ``ResidualStack_2``, then
``ResidualStackReverted_0``; in a ``Residual``, ``Conv_0..2`` and
``BatchNorm_0..2``, the third pair (the 1x1 skip) only where the stride
or width changes. The stem is ``ConvBlock_0`` + ``Residual_0``, stack s's
prediction conv ``ConvBlock_{s+1}``, its heads ``{head}_{s}``
(``ConvBlock_0`` + ``Conv_0``), and between stacks s and s + 1 the
shortcut ``Conv_{2s}``/``BatchNorm_{2s}``, the previous-prediction
``Conv_{2s+1}``/``BatchNorm_{2s+1}`` and ``Residual_{s+1}``.
``centerOffsetHourglass*`` nests all of it under ``StackHourglass_0``
(the result is the dict ``export_center_net_hourglass`` writes);
``cornerLegacyHourglass`` keeps it at the root, with ``tl_{s}``/``br_{s}``
branches of ``CornerPoolBlock_0`` and the heads ``ConvBlock_{0,1,2}`` +
``heat``/``tag``/``regr``.

``dcn_pooling_state_dict(params)`` carries a flax ``DCNPooling``'s
``Dense_0..2`` (kernels (in, out), transposed) into the port's
``DCNPooling.fc.{0,2,4}``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

from scd_resnet_tpu_torch.models.center_net import CenterNetSizeResidual
from scd_resnet_tpu_torch.models.center_net_offset import CenterNetResidual
from scd_resnet_tpu_torch.models.corner_net import (
    CornerNetCombined,
    CornerNetCPoolResidual,
    CornerNetResidual,
)
from scd_resnet_tpu_torch.models.corner_net_legacy import (
    BRANCH_HEADS,
    CornerNetLegacy,
)
from scd_resnet_tpu_torch.models.hourglass import Hourglass, StackHourglass
from scd_resnet_tpu_torch.models.resnet import RESNET_SPEC, Residual
from scd_resnet_tpu_torch.train.registry import get_model_profile

StateDict = Dict[str, torch.Tensor]
# the terminal heads of each model that is a ResNetBackbone itself
TERMINAL_HEADS = {
    CenterNetResidual: ("heatmap", "regr", "offset"),
    CenterNetSizeResidual: ("heatmap", "size"),
    CornerNetResidual: ("heatmap", "tl", "br"),
    CornerNetCombined: ("heatmap",),
}


def _tensor(value) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def _conv(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel).transpose(3, 2, 0, 1))


def _deconv(kernel) -> torch.Tensor:
    return _tensor(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1))


class _Writer:
    """Walks one flax subtree (params + batch stats) into ``sd``."""

    def __init__(self, sd: StateDict, params: Mapping, stats: Mapping):
        self.sd, self.params, self.stats = sd, params, stats

    def sub(self, *path: str) -> "_Writer":
        params, stats = self.params, self.stats
        for part in path:
            params = params[part]
            stats = stats.get(part, {})
        return _Writer(self.sd, params, stats)

    def conv(self, key: str, name: str, bias: bool = False) -> None:
        self.sd[key + ".weight"] = _conv(self.params[name]["kernel"])
        if bias:
            self.sd[key + ".bias"] = _tensor(self.params[name]["bias"])

    def bn(self, key: str, name: str) -> None:
        p = self.params[name]["BatchNorm_0"]
        s = self.stats[name]["BatchNorm_0"]
        self.sd[key + ".weight"] = _tensor(p["scale"])
        self.sd[key + ".bias"] = _tensor(p["bias"])
        self.sd[key + ".running_mean"] = _tensor(s["mean"])
        self.sd[key + ".running_var"] = _tensor(s["var"])
        self.sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    def conv_block(self, key: str, name: str) -> None:
        """layers.ConvBlock: Conv_0 + BatchNorm_0 -> ``.conv``/``.bn``."""
        block = self.sub(name)
        block.conv(key + ".conv", "Conv_0")
        block.bn(key + ".bn", "BatchNorm_0")


def _backbone(w: _Writer, prefix: str, num_layers: int) -> None:
    block, stages = RESNET_SPEC[num_layers]
    n_convs = 3 if block.expansion != 1 else 2
    w.conv(prefix + "preprocess.0", "Conv_0")
    w.bn(prefix + "preprocess.1", "BatchNorm_0")
    blk = 0
    for stage_idx, repeats in enumerate(stages):
        for i in range(repeats):
            key = "{}layer{}.{}".format(prefix, stage_idx + 1, i)
            b = w.sub("{}_{}".format(block.__name__, blk))
            for j in range(n_convs):
                b.conv("{}.conv{}".format(key, j + 1), "Conv_{}".format(j))
                b.bn("{}.bn{}".format(key, j + 1), "BatchNorm_{}".format(j))
            if "Conv_{}".format(n_convs) in b.params:
                b.conv(key + ".downsample.0", "Conv_{}".format(n_convs))
                b.bn(key + ".downsample.1", "BatchNorm_{}".format(n_convs))
            blk += 1
    bn = 1  # the next BatchNorm_{bn} after the stem's
    if "deconv_dcn" in w.params:
        dcn = w.sub("deconv_dcn")
        w.sd[prefix + "deconv_dcn.weight"] = _conv(dcn.params["kernel"])
        w.sd[prefix + "deconv_dcn.bias"] = _tensor(dcn.params["bias"])
        dcn.conv(prefix + "deconv_dcn.conv_offset_mask", "conv_offset_mask",
                 bias=True)
        w.bn(prefix + "deconv_dcn_bn", "BatchNorm_{}".format(bn))
        bn += 1
    for j in range(3):
        w.sd["{}deconvolutionLayers.{}.weight".format(prefix, 3 * j)] = \
            _deconv(w.params["ConvTranspose_{}".format(j)]["kernel"])
        w.bn("{}deconvolutionLayers.{}".format(prefix, 3 * j + 1),
             "BatchNorm_{}".format(bn))
        bn += 1


def _terminal_heads(root: _Writer, num_layers: int, heads) -> None:
    """A ``ResNetBackbone`` with terminal heads as the model itself
    (``ResNetBackbone_0/{head}/Conv_{0,1}`` -> ``{head}.{0,2}``)."""
    w = root.sub("ResNetBackbone_0")
    _backbone(w, "", num_layers)
    for head in heads:
        h = w.sub(head)
        h.conv(head + ".0", "Conv_0", bias=True)
        h.conv(head + ".2", "Conv_1", bias=True)


def _pool_block(pb: _Writer, key: str) -> None:
    """A ``CornerPoolBlock_0`` scope into ``{key}.*``."""
    pb.conv_block(key + ".branch1", "ConvBlock_0")
    pb.conv_block(key + ".branch2", "ConvBlock_1")
    pb.conv(key + ".merge_conv", "Conv_0")
    pb.bn(key + ".merge_bn", "BatchNorm_0")
    pb.conv(key + ".skip_conv", "Conv_1")
    pb.bn(key + ".skip_bn", "BatchNorm_1")
    pb.conv_block(key + ".out", "ConvBlock_2")


def _corner_cpool(root: _Writer, num_layers: int) -> None:
    _backbone(root.sub("ResNetBackbone_0"), "backbone.", num_layers)
    root.conv("heatmap.0", "Conv_0", bias=True)
    root.conv("heatmap.2", "Conv_1", bias=True)
    for head in ("tl_head", "br_head"):
        h = root.sub(head)
        _pool_block(h.sub("CornerPoolBlock_0"), head + ".pool_block")
        h.conv(head + ".terminal.0", "Conv_0", bias=True)
        h.conv(head + ".terminal.2", "Conv_1", bias=True)


def _residual(w: _Writer, key: str, module: Residual) -> None:
    """A ``Residual_k`` scope into ``{key}.conv1/bn1/conv2/bn2[/skip]``."""
    for j in (1, 2):
        w.conv("{}.conv{}".format(key, j), "Conv_{}".format(j - 1))
        w.bn("{}.bn{}".format(key, j), "BatchNorm_{}".format(j - 1))
    if module.skip is not None:
        w.conv(key + ".skip.0", "Conv_2")
        w.bn(key + ".skip.1", "BatchNorm_2")


def _residual_stack(w: _Writer, key: str, stack: nn.Sequential) -> None:
    for i, module in enumerate(stack):
        _residual(w.sub("Residual_{}".format(i)), "{}.{}".format(key, i),
                  module)


def _hourglass(w: _Writer, key: str, module: Hourglass) -> None:
    _residual_stack(w.sub("ResidualStack_0"),
                    key + ".preserveCurrentDimension",
                    module.preserveCurrentDimension)
    _residual_stack(w.sub("ResidualStack_1"), key + ".changeDimension",
                    module.changeDimension)
    inner = module.embeddedHourglass
    if isinstance(inner, Hourglass):
        _hourglass(w.sub("Hourglass_0"), key + ".embeddedHourglass", inner)
    else:
        _residual_stack(w.sub("ResidualStack_2"), key + ".embeddedHourglass",
                        inner)
    _residual_stack(w.sub("ResidualStackReverted_0"),
                    key + ".changeDimensionBack", module.changeDimensionBack)


def _block_head(w: _Writer, key: str, block: str, final: str) -> None:
    """A ConvBlock(no BN) + 1x1 head: ``{block}/Conv_0`` -> ``.0.conv``,
    ``final`` -> ``.1``."""
    w.sub(block).conv(key + ".0.conv", "Conv_0", bias=True)
    w.conv(key + ".1", final, bias=True)


def _stacked(w: _Writer, model: StackHourglass) -> None:
    w.conv_block("preprocess.0", "ConvBlock_0")
    _residual(w.sub("Residual_0"), "preprocess.1", model.preprocess[1])
    for s in range(model.stacks):
        _hourglass(w.sub("Hourglass_{}".format(s)),
                   "hourglassStack.{}".format(s), model.hourglassStack[s])
        w.conv_block("redimConvolution.{}".format(s),
                     "ConvBlock_{}".format(s + 1))
        for head in model.terminal_names:
            _block_head(w.sub("{}_{}".format(head, s)),
                        "{}.{}".format(head, s), "ConvBlock_0", "Conv_0")
        if isinstance(model, CornerNetLegacy):
            for corner in ("tl", "br"):
                b = w.sub("{}_{}".format(corner, s))
                key = "{}.{}".format(corner, s)
                _pool_block(b.sub("CornerPoolBlock_0"), key + ".pool_block")
                for i, head in enumerate(BRANCH_HEADS):
                    _block_head(b, "{}.{}".format(key, head),
                                "ConvBlock_{}".format(i), head)
        if s < model.stacks - 1:
            for j, name in enumerate(("shortcutLayers",
                                      "convPrevHourglass")):
                w.conv("{}.{}.0".format(name, s), "Conv_{}".format(2 * s + j))
                w.bn("{}.{}.1".format(name, s),
                     "BatchNorm_{}".format(2 * s + j))
            _residual(w.sub("Residual_{}".format(s + 1)),
                      "interHourglassLayers.{}".format(s),
                      model.interHourglassLayers[s])


def state_dict_from_flax(arch: str, params: Mapping[str, Any],
                         batch_stats: Mapping[str, Any]) -> StateDict:
    """The port model's state dict for profile ``arch`` from the JAX
    model's ``params`` and ``batch_stats`` trees."""
    profile = get_model_profile(arch)
    sd: StateDict = {}
    root = _Writer(sd, params, batch_stats)
    if issubclass(profile.model_cls, StackHourglass):
        model = profile.build()
        _stacked(root if isinstance(model, CornerNetLegacy)
                 else root.sub("StackHourglass_0"), model)
    elif profile.model_cls is CornerNetCPoolResidual:
        _corner_cpool(root, profile.num_layers)
    else:
        _terminal_heads(root, profile.num_layers,
                        TERMINAL_HEADS[profile.model_cls])
    return sd


def dcn_pooling_state_dict(params: Mapping[str, Any]) -> StateDict:
    """The port ``DCNPooling``'s state dict from a flax ``DCNPooling``'s
    ``params``: ``Dense_j`` -> ``fc.{2 j}`` with the kernel transposed."""
    sd: StateDict = {}
    for j in range(3):
        dense = params["Dense_{}".format(j)]
        sd["fc.{}.weight".format(2 * j)] = _tensor(
            np.asarray(dense["kernel"]).T)
        sd["fc.{}.bias".format(2 * j)] = _tensor(dense["bias"])
    return sd
