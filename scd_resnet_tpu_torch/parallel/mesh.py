"""The device mesh: processes, process groups, the tensor-parallel
sharding rule and column-parallel layers.

Counterpart of ``scd_resnet_tpu/parallel/mesh.py``. The JAX package runs
one controller over a ``jax.sharding.Mesh`` and lets GSPMD insert the
collectives. Here:

- the ``data`` and ``model`` axes run across processes, one rank a card,
  started by ``torchrun`` (:func:`init_distributed`). Ranks are laid out
  row-major over those axes in the order ``meshAxes`` names them, and
  every line of an axis (the ranks that differ only in that coordinate)
  is one ``torch.distributed`` process group;
- the ``pipe`` axis runs inside a process, over a list of devices
  (``parallel/pipeline.py``): world size = data x model, and every rank
  holds ``pipe`` devices (:attr:`Mesh.devices`).

The ``data`` axis splits the batch (:func:`shard_rows`); BatchNorm takes
its moments over the data group (``models/layers.BatchNorm``), the
losses their counts (``ops/losses.global_counts``), and the trainer sums
the gradients. The ``model`` axis shards the output channels of wide
kernels (:func:`param_sharding_rule`, :func:`shard_model`).
"""

from __future__ import annotations

import os
import types
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from scd_resnet_tpu_torch.models.deformable import DCN
from scd_resnet_tpu_torch.models.layers import autocast_off
from scd_resnet_tpu_torch.ops.dcn import deform_conv2d
from scd_resnet_tpu_torch.parallel.collectives import (
    copy_to_group,
    gather_from_group,
)

DEFAULT_AXES = {1: ("data",), 2: ("data", "model"),
                3: ("data", "model", "pipe")}
PROCESS_AXES = ("data", "model")  # the axes that run across processes
TIMEOUT_S = 600.0  # a missing peer or a hung collective fails after this


def init_distributed(device: str | torch.device = "cuda",
                     backend: Optional[str] = None,
                     timeout_s: float = TIMEOUT_S) -> Tuple[int, int, int]:
    """``(rank, world_size, local_rank)`` from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), with the default process
    group started on first call (the counterpart of the JAX
    ``train.py``'s ``jax.distributed.initialize``). Without that
    environment: a world of one and no process group.

    ``backend``: ``nccl`` by default on CUDA (each rank its own card),
    ``gloo`` on the CPU. Ranks that share one card must ask for ``gloo``:
    NCCL refuses two ranks on one device. Every collective fails after
    ``timeout_s`` instead of waiting for a missing peer: those of the
    default group and those of every group the port makes from it (the
    axis lines, :func:`host_group`), which take the same timeout; a
    later call keeps the first call's group and timeout."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1, 0
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if not dist.is_initialized():
        if backend is None:
            backend = "gloo" if torch.device(device).type == "cpu" else "nccl"
        timeout = timedelta(seconds=timeout_s)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
        _reset_groups(timeout)
    return rank, world, local_rank


def node_layout() -> Tuple[int, int]:
    """``(nodes, node_index)`` of this process: torchrun's ``WORLD_SIZE``
    ranks in nodes of ``LOCAL_WORLD_SIZE``, this one on node
    ``GROUP_RANK``; ``(1, 0)`` without torchrun. A node is the port's
    counterpart of a JAX host: its ranks share one shard of each epoch
    (``data/dataset.epoch_batches``). Raises when the world does not
    divide into equal nodes or the node index is outside them."""
    if "WORLD_SIZE" not in os.environ:
        return 1, 0
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if local < 1 or world % local:
        raise ValueError(
            "WORLD_SIZE {} does not divide into nodes of LOCAL_WORLD_SIZE {} "
            "ranks: every node must run as many ranks".format(world, local))
    nodes = world // local
    index = int(os.environ.get("GROUP_RANK", 0))
    if not 0 <= index < nodes:
        raise ValueError("GROUP_RANK {} is outside the {} nodes of {} ranks "
                         "each".format(index, nodes, local))
    return nodes, index


# what the port made from the current default group: the axis lines by
# (axis names, shape), the host group, and the timeout they all take
_GROUPS: Dict[str, object] = {}


def _reset_groups(timeout: timedelta) -> None:
    _GROUPS.update(world=dist.group.WORLD, timeout=timeout, lines={},
                   host=None)


def _group_cache() -> Dict[str, object]:
    """``_GROUPS`` of the current default group, emptied when that group
    is not the one it was filled for (destroyed and started again, or
    started by the caller: then with ``TIMEOUT_S``)."""
    if not _GROUPS or _GROUPS["world"] is not dist.group.WORLD:
        _reset_groups(timedelta(seconds=TIMEOUT_S))
    return _GROUPS


def host_group():
    """A gloo group of every rank, for host tensors (the trainer's stop
    flag: no wait on the card), made once per default group, with its
    timeout."""
    cache = _group_cache()
    if cache["host"] is None:
        cache["host"] = dist.new_group(backend="gloo",
                                       timeout=cache["timeout"])
    return cache["host"]


class Mesh:
    """Axis names and sizes (``shape``, a dict as ``jax``'s
    ``mesh.shape``), this rank's coordinates on the process axes, its
    process groups, and the devices of its pipeline stages."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0, devices: Optional[Sequence] = None,
                 groups: Optional[Dict[str, object]] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = rank
        self.devices = [torch.device(d) for d in (devices or ["cpu"])]
        process = [a for a in self.axis_names if a in PROCESS_AXES]
        coords = np.unravel_index(rank, [self.shape[a] for a in process]) \
            if process else ()
        self.coords = {a: int(c) for a, c in zip(process, coords)}
        self._groups = dict(groups or {})

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate on a process axis (0 on others)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line of ``axis``; None for an
        axis of size 1 (a group of one is no group)."""
        if self.size(axis) == 1:
            return None
        if axis not in self._groups:
            raise RuntimeError("the mesh has no process group for axis "
                               "'{}': start the ranks with torchrun".format(
                                   axis))
        return self._groups[axis]

    def __repr__(self) -> str:
        return " x ".join("{}={}".format(a, s) for a, s in self.shape.items())


def _line_groups(axis_names, shape, rank: int) -> Dict[str, object]:
    """This rank's line of every process axis, as a process group with
    the default group's timeout. The first mesh of an ``(axis_names, shape)``
    makes every line's group (every rank makes every group, in the same
    order, so the ranks must build their meshes in the same order); a
    later mesh of the same axes and shape takes the same groups, so a
    process that builds many trainers holds one set of communicators."""
    cache = _group_cache()
    key = (tuple(axis_names), tuple(shape))
    if key not in cache["lines"]:
        process = [a for a in axis_names if a in PROCESS_AXES]
        sizes = [dict(zip(axis_names, shape))[a] for a in process]
        ranks = np.arange(int(np.prod(sizes))).reshape(sizes)
        mine = {}
        for k, axis in enumerate(process):
            lines = np.moveaxis(ranks, k, -1).reshape(-1, sizes[k])
            for line in lines:
                group = dist.new_group([int(r) for r in line],
                                       timeout=cache["timeout"])
                if rank in line:
                    mine[axis] = group
        cache["lines"][key] = mine
    return cache["lines"][key]


def create_mesh(axis_names: Sequence[str] = ("data",),
                shape: Optional[Sequence[int]] = None,
                devices: Optional[Sequence] = None,
                rank: Optional[int] = None) -> Mesh:
    """A mesh of ``shape`` (default: the world size on one ``data``
    axis), with its process groups when ``torch.distributed`` runs.
    ``devices`` are this rank's pipeline stages."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    shape = tuple(shape) if shape is not None else (world,)
    groups = _line_groups(axis_names, shape, rank) \
        if dist.is_initialized() and world > 1 else {}
    return Mesh(axis_names, shape, rank, devices, groups)


def resolve_axes(shape: Sequence[int],
                 axes: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """``meshAxes``, defaulted by the rank of ``meshShape`` and checked
    (the JAX ``mesh_from_config``'s rules and messages)."""
    shape = tuple(int(s) for s in shape)
    if axes is None:
        if len(shape) not in DEFAULT_AXES:
            raise ValueError(
                "meshShape of rank {} needs explicit meshAxes".format(
                    len(shape)))
        axes = DEFAULT_AXES[len(shape)]
    axes = tuple(str(a) for a in axes)
    if len(axes) != len(shape):
        raise ValueError(
            "meshAxes {} does not match meshShape {}".format(axes, shape))
    if "data" not in axes:
        raise ValueError("meshAxes must include a 'data' axis (the batch "
                         "shards over it); got {}".format(axes))
    return axes


def mesh_from_config(shape: Sequence[int],
                     axes: Optional[Sequence[str]] = None,
                     devices: Optional[Sequence] = None,
                     batch_size: Optional[int] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None) -> Mesh:
    """The mesh the ``meshShape``/``meshAxes`` keys describe, checked as
    the JAX package checks it: axes defaulted by rank, a ``data`` axis,
    enough devices (``world_size`` ranks of ``len(devices)`` each), and a
    batch the data axis divides. Besides, the ``data`` x ``model``
    coordinates must be exactly the world's ranks: a rank cannot sit
    idle the way a spare JAX device does."""
    shape = tuple(int(s) for s in shape)
    axes = resolve_axes(shape, axes)
    if world_size is None:
        world_size = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices) if devices is not None else ["cpu"]
    need = int(np.prod(shape))
    if need > world_size * len(devices):
        raise ValueError(
            "meshShape {} needs {} devices; only {} available".format(
                shape, need, world_size * len(devices)))
    sizes = dict(zip(axes, shape))
    processes = int(np.prod([sizes[a] for a in axes if a in PROCESS_AXES]))
    if processes != world_size:
        raise ValueError(
            "meshShape {} runs data x model = {} ranks; this run has {} "
            "(torchrun --nproc_per_node)".format(shape, processes,
                                                 world_size))
    if batch_size is not None and batch_size % sizes["data"] != 0:
        raise ValueError(
            "batchSize {} is not divisible by the mesh data axis "
            "{}".format(batch_size, sizes["data"]))
    return create_mesh(axes, shape, devices[:sizes.get("pipe", 1)], rank)


def shard_rows(mesh: Mesh, x, axis: str = "data"):
    """This rank's block of the leading (batch) dimension of ``x`` (a
    tensor or an array), the counterpart of ``batch_sharding``."""
    size, index = mesh.size(axis), mesh.index(axis)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError("a batch of {} does not split over the '{}' axis "
                         "of {}".format(x.shape[0], axis, size))
    n = x.shape[0] // size
    return x[index * n:(index + 1) * n]


# ---- the model axis ---------------------------------------------------------

def output_dim(module: nn.Module, name: str) -> Optional[int]:
    """The output-channel dimension of ``module``'s parameter ``name``:
    dim 0 of a ``Conv2d``'s, a ``Linear``'s and a ``DCN``'s
    (Cout, Cin, k, k) weight, dim 1 of a ``ConvTranspose2d``'s (Cin,
    Cout, k, k); None for biases, BatchNorm vectors and anything else. A
    flax kernel keeps its output features last in every case."""
    if name != "weight":
        return None
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    if isinstance(module, (nn.Conv2d, nn.Linear, DCN)):
        return 0
    return None


def param_sharding_rule(mesh: Mesh, module: nn.Module, name: str,
                        axis: str = "model", min_channels: int = 64
                        ) -> Optional[int]:
    """The dimension of ``module.name`` to shard over ``axis``, or None
    to replicate it: the JAX rule, a kernel whose output channels number
    at least ``min_channels`` and divide by the axis size."""
    size = mesh.size(axis)
    dim = output_dim(module, name)
    if size == 1 or dim is None:
        return None
    channels = getattr(module, name).shape[dim]
    if channels >= min_channels and channels % size == 0:
        return dim
    return None


def tree_param_shardings(mesh: Mesh, model: nn.Module, axis: str = "model"
                         ) -> Dict[str, Optional[int]]:
    """``param_sharding_rule`` of every parameter, by state-dict name."""
    out = {}
    for prefix, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            out[prefix + "." + name if prefix else name] = \
                param_sharding_rule(mesh, module, name, axis)
    return out


def _column_conv(self, x):
    y = self._conv_forward(copy_to_group(x, self.model_group), self.weight,
                           None)
    return self._gathered(y, 1)


def _column_conv_transpose(self, x):
    y = F.conv_transpose2d(copy_to_group(x, self.model_group), self.weight,
                           None, self.stride, self.padding,
                           self.output_padding, self.groups, self.dilation)
    return self._gathered(y, 1)


def _column_linear(self, x):
    return self._gathered(F.linear(copy_to_group(x, self.model_group),
                                   self.weight), -1)


def _column_dcn(self, x):
    with autocast_off(x.device.type):
        x = x.float()
        offset, mask = self.offsets_and_mask(x)
        g = self.model_group
        y = deform_conv2d(copy_to_group(x, g), copy_to_group(offset, g),
                          copy_to_group(mask, g), self.weight, None,
                          self.stride, self.padding, self.dilation)
        return self._gathered(y, 1)


def _gathered(self, y, dim):
    y = gather_from_group(y, self.model_group, dim)
    if self.bias is None:
        return y
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + self.bias.to(y.dtype).view(shape)


_COLUMN_FORWARDS = ((nn.ConvTranspose2d, _column_conv_transpose),
                    (nn.Conv2d, _column_conv), (nn.Linear, _column_linear),
                    (DCN, _column_dcn))


def shard_model(model: nn.Module, mesh: Mesh, axis: str = "model"
                ) -> Dict[str, int]:
    """Column-parallel ``model`` over ``axis``: every parameter the rule
    picks keeps this rank's slice of its output channels, and its
    module's forward runs on the slice (input gradient summed over the
    group, output channels gathered, then the full bias added; biases
    stay replicated, as the rule keeps them). Returns ``{name: dim}`` of
    the sharded parameters; with an axis of size 1, ``{}``."""
    rule = tree_param_shardings(mesh, model, axis)
    size, index = mesh.size(axis), mesh.index(axis)
    sharded = {}
    for prefix, module in model.named_modules():
        key = prefix + ".weight" if prefix else "weight"
        dim = rule.get(key)
        if dim is None:
            continue
        forward = next(f for cls, f in _COLUMN_FORWARDS
                       if isinstance(module, cls))
        weight = module.weight
        n = weight.shape[dim] // size
        module.weight = nn.Parameter(
            weight.detach().narrow(dim, index * n, n).clone())
        module.model_group = mesh.group(axis)
        module.forward = types.MethodType(forward, module)
        module._gathered = types.MethodType(_gathered, module)
        sharded[key] = dim
    return sharded


def gather_full(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The full tensor of a rank's slice ``t`` along ``dim`` (no
    gradient)."""
    with torch.no_grad():
        return gather_from_group(t.detach(), group, dim)


def slice_local(t: torch.Tensor, dim: int, mesh: Mesh, axis: str = "model"
                ) -> torch.Tensor:
    """This rank's slice of a full tensor along ``dim``."""
    n = t.shape[dim] // mesh.size(axis)
    return t.narrow(dim, mesh.index(axis) * n, n).clone()


def _map_sharded_state(model: nn.Module, opt: Dict, sharded: Dict[str, int],
                       fn, shapes: Dict[str, torch.Size]) -> Dict:
    """A copy of optimizer state dict ``opt`` with ``fn(tensor, dim)``
    applied to each sharded parameter's state tensors of shape
    ``shapes[name]`` (Adam's moments, SGD's momentum); the optimizer
    indexes its state by the parameters' order."""
    opt = {"state": {k: dict(v) for k, v in opt["state"].items()},
           "param_groups": opt["param_groups"]}
    for idx, (name, _) in enumerate(model.named_parameters()):
        if name not in sharded or idx not in opt["state"]:
            continue
        pstate = opt["state"][idx]
        for key, value in pstate.items():
            if torch.is_tensor(value) and value.shape == shapes[name]:
                pstate[key] = fn(value, sharded[name])
    return opt


def full_checkpoint_state(model: nn.Module, optimizer, sharded: Dict[str, int],
                          mesh: Mesh, axis: str = "model"):
    """``(model state dict, optimizer state dict)`` in the plain layout:
    every sharded tensor (a weight, its Adam moments or momentum)
    gathered over ``axis``. A collective: every rank of the group calls
    it."""
    state, opt = model.state_dict(), optimizer.state_dict()
    if not sharded:
        return state, opt
    group = mesh.group(axis)
    shapes = {n: state[n].shape for n in sharded}
    for name, dim in sharded.items():
        state[name] = gather_full(state[name], dim, group)
    return state, _map_sharded_state(
        model, opt, sharded, lambda t, dim: gather_full(t, dim, group), shapes)


def local_checkpoint_state(model: nn.Module, state: Dict, opt: Dict,
                           sharded: Dict[str, int], mesh: Mesh,
                           axis: str = "model"):
    """The inverse of :func:`full_checkpoint_state`: this rank's slices
    of a plain-layout checkpoint."""
    if not sharded:
        return state, opt
    state = dict(state)
    shapes = {n: state[n].shape for n in sharded}
    for name, dim in sharded.items():
        state[name] = slice_local(state[name], dim, mesh, axis)
    return state, _map_sharded_state(
        model, opt, sharded, lambda t, dim: slice_local(t, dim, mesh, axis),
        shapes)


def full_gradients(model: nn.Module, sharded: Dict[str, int],
                   mesh: Optional[Mesh], axis: str = "model"
                   ) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient by name in the plain layout, model-axis
    shards gathered (a collective when any are sharded)."""
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad.detach()
        if name in sharded:
            g = gather_full(g, sharded[name], mesh.group(axis))
        grads[name] = g
    return grads


def stage_devices(device: str | torch.device, pipe: int, local_rank: int
                  ) -> list:
    """The devices of a rank's ``pipe`` stages: every stage on
    ``device`` when it names one (``cuda:N``, ``cpu``; how stages and
    ranks share one card), else ``cuda:{local_rank * pipe + s}``, each of
    which must exist."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return [device] * pipe
    visible = torch.cuda.device_count()
    out = [torch.device("cuda", local_rank * pipe + s) for s in range(pipe)]
    missing = [str(d) for d in out if d.index >= visible]
    if missing:
        raise RuntimeError("rank {} needs {} for its {} pipeline stage(s); "
                           "{} CUDA device(s) are visible".format(
                               local_rank, ", ".join(missing), pipe, visible))
    return out
