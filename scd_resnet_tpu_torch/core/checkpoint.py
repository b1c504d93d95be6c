"""The port's checkpoints.

A serve checkpoint is ``torch.save({"arch": name, "state_dict": sd})``.
A training checkpoint adds what an exact resume needs: the optimizer
state (``optimizer``), the iteration it was taken at (``step``, which is
also the optimizer's update count and so its place on the LR schedule)
and the augmentation counter (``aug_step``). Either kind serves.

``load_state_dict`` also takes a reference-layout ``.pth`` (a bare state
dict, possibly ``module.``-prefixed by DataParallel) for the
``centerOffset*`` profiles, whose modules carry the reference's names.
JAX msgpack checkpoints are not read here; carry them across with
``core/convert.state_dict_from_flax``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

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


def save_training_checkpoint(path: str, arch: str,
                             state_dict: Dict[str, torch.Tensor],
                             optimizer_state: Dict[str, Any], step: int,
                             aug_step: int) -> str:
    """Write a training checkpoint atomically: a kill mid-write (the
    preemption this file exists for) leaves the previous file whole."""
    get_model_profile(arch)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"arch": arch,
               "state_dict": {k: v.detach().cpu()
                              for k, v in state_dict.items()},
               "optimizer": optimizer_state, "step": int(step),
               "aug_step": int(aug_step)}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_training_checkpoint(path: str, arch: str) -> Dict[str, Any]:
    """A training checkpoint of profile ``arch``, tensors on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict) or "optimizer" not in obj:
        raise ValueError("{} is not a training checkpoint".format(path))
    if obj["arch"] != arch:
        raise ValueError("checkpoint {} holds '{}', not '{}'".format(
            path, obj["arch"], arch))
    return obj
