"""Deployment wrappers: model + decode -> one stacked tensor per family.

Counterpart of ``scd_resnet_tpu/infer/wrapper.py`` for the ported
contracts (``CONTRACTS``):

- ``centerOffset``: (10, B, K) ``[ctScores, ctInds, ctY, ctX, majX,
  majY, minL, rad, offX, offY]`` (reference
  trainer/wrappers/centerOffsetResidual.py:5-23, test.py:103);
- ``corner``: (12, B, K) ``[ctS, ctI, ctY, ctX, tlS, tlI, tlY, tlX,
  brS, brI, brY, brX]`` (cornerNet.py:272-304);
- ``cornerLegacy``: batch-major (B, 1000, 8) paired boxes ``[tlX, tlY,
  brX, brY, score, tlScore, brScore, category]``, rejected pairs at score
  -1 (cornerNetLegacy.py:332-446).

A wrapper takes an NCHW float32 batch (B, 1, 512, 512) on the model's
device and returns the stacked rows there, computed under
``torch.inference_mode()``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from scd_resnet_tpu_torch.core.checkpoint import load_state_dict
from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.models.center_net_offset import as_stack_list
from scd_resnet_tpu_torch.train.registry import get_model_profile

CONTRACTS = {
    "centerOffset": ["ctScores", "ctInds", "ctY", "ctX", "majX", "majY",
                     "minL", "rad", "offX", "offY"],
    "corner": ["ctScores", "ctInds", "ctY", "ctX", "tlScores", "tlInds",
               "tlY", "tlX", "brScores", "brInds", "brY", "brX"],
    "cornerLegacy": ["(B, 1000, 8): tlX, tlY, brX, brY, score, tlScore, "
                     "brScore, category"],
}


def make_wrapper(model: nn.Module, family: str = "centerOffset") -> Callable:
    """fn(batch NCHW) -> the family's stacked decode tensor; the callable
    carries ``.contract``, ``.rows``, ``.model`` and ``.device``."""
    if family == "centerOffset":
        from scd_resnet_tpu_torch.models.center_net_offset import decode_center_net

        def stack(out):
            scores, inds, ys, xs, offset, regr, _ = decode_center_net(out)
            return torch.stack([
                scores, inds.float(), ys, xs,
                regr[:, :, 0],  # major axis x
                regr[:, :, 1],  # major axis y
                regr[:, :, 2],  # minor axis length
                regr[:, :, 3],  # radius
                offset[:, :, 0], offset[:, :, 1],
            ])

    elif family == "corner":
        from scd_resnet_tpu_torch.models.corner_net import decode_corner_net

        # a combined model's one 3-channel head is split before decoding
        combined = getattr(model, "combined", False)

        def stack(out):
            return torch.stack([r.float() for r in decode_corner_net(
                out, combined=combined)[:12]])

    elif family == "cornerLegacy":
        from scd_resnet_tpu_torch.models.corner_net_legacy import (
            decode_corner_net_legacy as stack,
        )

    else:
        raise KeyError("unknown wrapper family '{}'; known: {}".format(
            family, sorted(CONTRACTS)))

    model.eval()

    def wrapped(inputs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            # decode consumes the final stack (the JAX package's choice)
            return stack(as_stack_list(model(inputs))[-1])

    wrapped.contract = family
    wrapped.rows = CONTRACTS[family]
    wrapped.model = model
    wrapped.device = next(model.parameters()).device
    return wrapped


def load_wrapper(checkpoint_path: str, arch: str,
                 device: str | torch.device = "cuda") -> Callable:
    """Checkpoint -> decode wrapper for profile ``arch`` on ``device``
    (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    profile = get_model_profile(arch)
    model = profile.build()
    model.load_state_dict(load_state_dict(checkpoint_path, arch), strict=True)
    return make_wrapper(model.to(device), profile.family)
