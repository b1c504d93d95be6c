"""Seeded weights for both sides of a cell, made on the device.

One ``torch.Generator`` on the device draws one standard normal and one
uniform vector over every float leaf of the reference model's state dict
(two large calls); each leaf takes its slice, scaled by its recipe:

- ``serve`` (a served model with no trained weights): convolution kernels
  N(0, 1/fan_in), convolution biases N(0, 0.1^2), BatchNorm scale and
  running variance U(0.5, 1.5), shift and running mean N(0, 0.1^2). Random
  weights give heat maps with no structure, so the configuration's
  ``calibrate`` entry rescales each named head's final 1x1 convolution,
  channel by channel, on the reference's own logits over a few of the
  cell's clips: a heat channel to standard deviation ``std``, shifted so
  that ``detections_per_blob`` peaks a blob of the slide lie above the
  serving threshold (a slide then answers about as many detections as it
  has heads), a regression channel to the ``mean`` and ``std`` a real
  head gives (head sizes and halo radii of a few heat-map pixels), so
  that the served Rhr is well conditioned as on a real slide;
- ``train`` (the state at step 0 of a training job): convolution kernels
  N(0, 1/fan_in), transposed ones N(0, 0.001^2), biases 0, the heat heads'
  final bias -2.19, the regression heads' final kernels N(0, 0.001^2),
  BatchNorm scale 1, shift 0, mean 0, variance 1: the distributions of the
  trainer's own initialiser.

The state dict is handed to the reference and loaded strictly into the
system under test.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.model import Conv, Norm, float32_math

SCORE_THRESHOLD = 0.3


def _leaves(model: nn.Module):
    """(module, name, tensor) of every float leaf, in state-dict order."""
    for mod_name, module in model.named_modules():
        if isinstance(module, Conv):
            yield module, mod_name + ".weight", module.weight
            if module.bias is not None:
                yield module, mod_name + ".bias", module.bias
        elif isinstance(module, Norm):
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                yield module, mod_name + "." + leaf, getattr(module, leaf)


def _fan_in(conv: Conv) -> int:
    w = conv.weight
    return (w.shape[0] if conv.transposed else w.shape[1]) \
        * w.shape[2] * w.shape[3]


@torch.no_grad()
def fill(model: nn.Module, recipe: Dict, seed: int,
         device: torch.device) -> None:
    """Draw ``model``'s leaves on ``device`` from ``seed`` by ``recipe``
    (the configuration's ``weights`` entry for this traffic's kind)."""
    leaves = list(_leaves(model))
    total = sum(t.numel() for _, _, t in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    kind = recipe["kind"]
    heat = set(recipe.get("heat_heads", ()))
    small = set(recipe.get("small_heads", ()))
    at = 0
    for module, name, tensor in leaves:
        n = tensor.numel()
        z = normal[at:at + n].view(tensor.shape)
        u = uniform[at:at + n].view(tensor.shape)
        at += n
        leaf = name.rsplit(".", 1)[1]
        head = name.rsplit(".", 1)[0]
        if isinstance(module, Conv):
            if leaf == "bias":
                if kind == "serve":
                    value = 0.1 * z
                else:
                    value = torch.full_like(z, recipe["heat_bias"]
                                            if head in heat else 0.0)
            elif kind == "train" and (module.transposed or head in small):
                value = 0.001 * z
            else:
                value = z / math.sqrt(_fan_in(module))
        elif kind == "serve":
            value = 0.5 + u if leaf in ("weight", "running_var") else 0.1 * z
        else:
            value = torch.full_like(z, 1.0 if leaf in ("weight",
                                                       "running_var") else 0.0)
        tensor.data = value.clone()
    model.to(device)


@torch.no_grad()
def calibrate(model: nn.Module, heads: Dict, clips: torch.Tensor,
              blobs_per_clip: float) -> None:
    """Rescale the final convolution of each head named in ``heads``
    (``{"<head module>": {"output": <forward key>, "std": [...], "mean":
    [...]} | {"output": ..., "std": s, "detections_per_blob": d}}``) on
    the logits of ``clips`` (N, 1, H, W), channel by channel (module
    docstring); the slide has ``blobs_per_clip`` blobs a clip."""
    finals = dict(model.named_modules())
    for name in heads:
        conv = finals[name]
        conv.weight.sub_(conv.weight.mean(dim=1, keepdim=True))
        conv.bias.zero_()
    model.eval()
    with float32_math():
        out = model(clips)
    logit = math.log(SCORE_THRESHOLD / (1 - SCORE_THRESHOLD))
    for name, spec in heads.items():
        conv = finals[name]
        z = out[spec["output"]].double()
        for channel in range(z.shape[1]):
            zc = z[:, channel]
            if "detections_per_blob" in spec:
                scale = spec["std"] / zc.std().item()
                # the peaks a 3x3 suppression keeps, highest first
                top = F.max_pool2d(zc[:, None], 3, 1, 1)[:, 0]
                found = zc[zc == top].sort(descending=True).values
                k = round(spec["detections_per_blob"] * blobs_per_clip
                          * len(zc))
                bias = logit - scale * 0.5 * (found[k - 1] + found[k]).item()
            else:
                scale = spec["std"][channel] / zc.std().item()
                bias = spec["mean"][channel] - scale * zc.mean().item()
            conv.weight[channel].mul_(scale)
            conv.bias[channel].fill_(bias)


def state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of the model's state dict."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
