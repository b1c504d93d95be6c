"""The port's checkpoints.

A port checkpoint is ``torch.save({"arch": name, "state_dict": sd})``.
The loader also takes a reference-layout ``.pth`` (a bare state dict,
possibly ``module.``-prefixed by DataParallel) for the ``centerOffset*``
profiles, whose modules carry the reference's names. JAX msgpack
checkpoints are not read here; carry them across with
``core/convert.state_dict_from_flax``.
"""

from __future__ import annotations

from typing import Dict

import torch

from scd_resnet_tpu_torch.train.registry import get_model_profile


def save_checkpoint(path: str, arch: str,
                    state_dict: Dict[str, torch.Tensor]) -> str:
    get_model_profile(arch)  # refuse unknown names before writing
    torch.save({"arch": arch,
                "state_dict": {k: v.detach().cpu()
                               for k, v in state_dict.items()}}, path)
    return path


def load_state_dict(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """The state dict for profile ``arch`` from a port checkpoint or,
    for ``centerOffset*``, a reference ``.pth``."""
    profile = get_model_profile(arch)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and "arch" in obj:
        if obj["arch"] != arch:
            raise ValueError("checkpoint {} holds '{}', not '{}'".format(
                path, obj["arch"], arch))
        return obj["state_dict"]
    if profile.family != "centerOffset":
        raise ValueError("{} is not a port checkpoint; only centerOffset* "
                         "profiles load reference .pth files".format(path))
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in obj.items()}
