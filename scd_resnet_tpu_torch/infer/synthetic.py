"""Seeded synthetic slides and seeded models for exercising the serving
path without trained weights (``chip_smoke.py``, ``profile_serve``).

``synthetic_slide`` draws a uint8 grayscale slide: a noisy bright
background with dark elliptic blobs about the size of sperm heads.

``seeded_model`` builds a profile's model with weights drawn from a seed:
conv kernels (the DCN's kernel and its offset conv included) N(0,
1/fan_in), conv biases and BatchNorm bias/mean N(0, 0.1), BatchNorm
scale/var U(0.5, 1.5). A DCN's offsets then land between pixels, some
beyond the map, and its masks spread around 0.5. Random weights give a
heat map with no structure, so the heat heads (the ``TerminalHead``s
that carry the -2.19 heat prior, found in the built model) have their
final 1x1 conv made zero-mean over its inputs and rescaled on the
caller's clips, output channel by output channel: each channel's logits
get standard deviation 2 and their 99.7th percentile sits at the 0.3
serving threshold, which leaves a few dozen distinct peaks per clip.
The legacy CornerNet pairs its corners by their tags (at most 1 apart)
and offsets, which random weights spread far enough to reject every
pair: its tag and offset heads are made zero-mean the same way and
rescaled to standard deviation 0.5 about 0 (tags) and 0.25 about 0.5
(offsets).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from scd_resnet_tpu_torch.infer.analyse import SCORE_THRESHOLD
from scd_resnet_tpu_torch.models.corner_net_legacy import CornerBranch
from scd_resnet_tpu_torch.models.deformable import DCN
from scd_resnet_tpu_torch.models.resnet import TerminalHead
from scd_resnet_tpu_torch.train.registry import get_model_profile


def synthetic_slide(height: int, width: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    slide = rng.normal(200.0, 12.0, (height, width)).astype(np.float32)
    yy, xx = np.mgrid[-16:17, -16:17]
    for _ in range(height * width // 6000):
        cy, cx = rng.integers(16, height - 16), rng.integers(16, width - 16)
        ry, rx = rng.uniform(6, 16, 2)
        mask = (yy / ry) ** 2 + (xx / rx) ** 2 <= 1.0
        slide[cy - 16:cy + 17, cx - 16:cx + 17][mask] -= rng.uniform(60, 120)
    return np.clip(np.round(slide), 0, 255).astype(np.uint8)


def seeded_model(arch: str, seed: int, clips: torch.Tensor) -> nn.Module:
    """Profile ``arch``'s model, eval mode on ``clips.device``, weights
    from ``seed`` and heat heads calibrated on ``clips`` (N, 1, H, W)."""
    profile = get_model_profile(arch)
    model = profile.build()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, DCN):
                w = module.weight
                w.copy_(torch.randn(w.shape, generator=gen)
                        / math.sqrt(w[0].numel()))
                module.bias.copy_(0.1 * torch.randn(module.bias.shape,
                                                    generator=gen))
            elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)):
                w = module.weight
                fan_in = w[0].numel() if isinstance(module, nn.Conv2d) \
                    else w.shape[0] * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
                if module.bias is not None:
                    module.bias.copy_(0.1 * torch.randn(module.bias.shape,
                                                        generator=gen))
            elif isinstance(module, nn.BatchNorm2d):
                n = module.num_features
                module.weight.copy_(0.5 + torch.rand(n, generator=gen))
                module.running_var.copy_(0.5 + torch.rand(n, generator=gen))
                module.bias.copy_(0.1 * torch.randn(n, generator=gen))
                module.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
        heads = [m for m in model.modules() if isinstance(m, TerminalHead)
                 and m.spec.final_bias is not None]
        if not heads:
            raise ValueError("{} has no heat head to calibrate".format(arch))
        # head -> (standard deviation, mean) of its calibrated outputs
        spreads = {}
        for branch in model.modules():
            if isinstance(branch, CornerBranch):
                spreads[id(branch.tag)] = (branch.tag, 0.5, 0.0)
                spreads[id(branch.regr)] = (branch.regr, 0.25, 0.5)
        calibrated = heads + [head for head, _, _ in spreads.values()]
        for head in calibrated:
            head[-1].weight.sub_(head[-1].weight.mean(dim=1, keepdim=True))
            head[-1].bias.zero_()
        model = model.to(clips.device).eval()
        logits = {}
        hooks = [head.register_forward_hook(
            lambda m, args, out: logits.__setitem__(id(m), out))
            for head in calibrated]
        try:
            with torch.inference_mode():
                model(clips)
        finally:
            for hook in hooks:
                hook.remove()
        for head in calibrated:
            conv = head[-1]
            z = logits[id(head)].double().transpose(0, 1).flatten(1)
            for channel, zc in enumerate(z):
                if id(head) in spreads:
                    _, std, mean = spreads[id(head)]
                    scale = std / zc.std().item()
                    bias = mean - scale * zc.mean().item()
                else:
                    scale = 2.0 / zc.std().item()
                    bias = (math.log(SCORE_THRESHOLD / (1 - SCORE_THRESHOLD))
                            - scale * torch.quantile(zc, 0.997).item())
                conv.weight[channel].mul_(scale)
                conv.bias[channel].fill_(bias)
    return model
