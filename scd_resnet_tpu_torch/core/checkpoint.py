"""The port's checkpoints.

A serve checkpoint is ``torch.save({"arch": name, "state_dict": sd})``.
A training checkpoint adds what an exact resume needs: the optimizer
state (``optimizer``), the iteration it was taken at (``step``, which is
also the optimizer's update count and so its place on the LR schedule)
and the augmentation counter (``aug_step``). Either kind serves.

``load_state_dict`` reads three kinds of file, told apart by their
leading bytes (:func:`checkpoint_kind`):

- a torch file (a zip, or a legacy pickle): a port checkpoint, or for the
  ``centerOffset*`` profiles, whose modules carry the reference's names,
  a reference-layout ``.pth`` (a bare state dict, possibly
  ``module.``-prefixed by DataParallel);
- the JAX package's checkpoint, one msgpack map (flax
  ``serialization.to_bytes`` of params, batch stats, optimizer state and
  step): read by ``core/msgpack`` (:func:`load_flax_params`) and carried
  into the port's names by ``core/convert.state_dict_from_flax``, for
  every profile;
- anything else is an error naming the path.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import torch

from scd_resnet_tpu_torch.core import msgpack
from scd_resnet_tpu_torch.core.convert import state_dict_from_flax
from scd_resnet_tpu_torch.train.registry import get_model_profile

ZIP_MAGIC = b"PK\x03\x04"
PICKLE_PROTO = 0x80  # a legacy torch file opens with pickle's PROTO opcode


def plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the CPU in the plain (NCHW-contiguous) layout, whatever
    layout it was trained in (a bfloat16 run's are channels-last)."""
    return t.detach().cpu().clone(memory_format=torch.contiguous_format)


def save_checkpoint(path: str, arch: str,
                    state_dict: Dict[str, torch.Tensor]) -> str:
    get_model_profile(arch)  # refuse unknown names before writing
    torch.save({"arch": arch,
                "state_dict": {k: plain(v) for k, v in state_dict.items()}},
               path)
    return path


def checkpoint_kind(path: str) -> str:
    """``"torch"`` or ``"flax"`` by the file's leading bytes; anything
    else raises. A legacy pickle opens with PROTO (0x80) and its protocol
    number; a JAX checkpoint with a msgpack map of at least one entry
    (0x81-0x8f, or map 16/32)."""
    with open(path, "rb") as f:
        head = f.read(4)
    if head == ZIP_MAGIC or (len(head) >= 2 and head[0] == PICKLE_PROTO
                             and 2 <= head[1] <= 5):
        return "torch"
    if head[:1] != bytes([PICKLE_PROTO]) and msgpack.is_msgpack_map(head):
        return "flax"
    raise ValueError("{} is neither a torch file nor the JAX package's "
                     "msgpack checkpoint (leading bytes {!r})".format(
                         path, head))


def load_flax_params(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(params, batch_stats)`` of a JAX package checkpoint as nested
    dicts of numpy arrays (``scd_resnet_tpu/core/checkpoint.
    load_params_only``)."""
    with open(path, "rb") as f:
        raw = msgpack.unpackb(f.read())
    if not (isinstance(raw, dict) and "params" in raw
            and "batch_stats" in raw):
        raise ValueError("{} is a msgpack map without params and "
                         "batch_stats, not a JAX checkpoint".format(path))
    return raw["params"], raw["batch_stats"]


def load_state_dict(path: str, arch: str) -> Dict[str, torch.Tensor]:
    """The state dict for profile ``arch`` from a port checkpoint, the
    JAX package's checkpoint or, for ``centerOffset*``, a reference
    ``.pth``."""
    profile = get_model_profile(arch)
    if checkpoint_kind(path) == "flax":
        return state_dict_from_flax(arch, *load_flax_params(path))
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
    preemption this file exists for) leaves the previous file whole.
    Every tensor, the optimizer's included, is written :func:`plain`."""
    get_model_profile(arch)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    optimizer_state = dict(optimizer_state, state={
        idx: {k: plain(v) if torch.is_tensor(v) else v
              for k, v in pstate.items()}
        for idx, pstate in optimizer_state["state"].items()})
    payload = {"arch": arch,
               "state_dict": {k: plain(v) for k, v in state_dict.items()},
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
