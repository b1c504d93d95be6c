"""Deployment wrappers: model + decode -> one stacked tensor per family,
and the traced bundle that carries them without model code.

Counterpart of ``scd_resnet_tpu/infer/wrapper.py``. Each family has a
stacked contract (``CONTRACTS``):

- ``centerOffset``: (10, B, K) ``[ctScores, ctInds, ctY, ctX, majX,
  majY, minL, rad, offX, offY]`` (reference
  trainer/wrappers/centerOffsetResidual.py:5-23, test.py:103);
- ``centerSize``: (6, B, K) ``[ctScores, ctInds, ctY, ctX, sizeW,
  sizeH]`` (the reference's commented unpack, test.py:102); sizes in
  heatmap units / SIZE_REGR_FACTOR, as the head learns them;
- ``corner``: (12, B, K) ``[ctS, ctI, ctY, ctX, tlS, tlI, tlY, tlX,
  brS, brI, brY, brX]`` (cornerNet.py:272-304);
- ``cornerLegacy``: batch-major (B, 1000, 8) paired boxes ``[tlX, tlY,
  brX, brY, score, tlScore, brScore, category]``, rejected pairs at score
  -1 (cornerNetLegacy.py:332-446).

A wrapper takes an NCHW float32 batch (B, 1, 512, 512) on the model's
device and returns the stacked rows there, computed under
``torch.inference_mode()``.

The traced bundle is the port's counterpart of the JAX package's
StableHLO bundle (and of the reference's TorchScript file):
``save_traced`` exports the model and its family's decode with
``torch.export`` at one fixed NCHW input shape, in eval mode with no
gradient, and writes a zip holding ``program.pt2`` (``torch.export.save``)
and ``meta.json`` (``format`` ``scd-resnet-tpu-torch.traced.v1``,
``input_shape``, ``contract``, ``rows``, ``torch_version``, ``device``).
The port's kernels on the path (the corner pools, the deformable gather)
are ``torch.library`` operators, so the program holds them as nodes and a
loaded bundle launches (and counts) them like the live model.
``load_traced`` returns the program as a callable; it needs the torch
that wrote the bundle, and refuses the JAX package's bundles.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Callable, Dict, Tuple

import torch
from torch import nn

from scd_resnet_tpu_torch.core.checkpoint import load_state_dict
from scd_resnet_tpu_torch.core.device import resolve_device
from scd_resnet_tpu_torch.models.center_net_offset import as_stack_list
from scd_resnet_tpu_torch.train.registry import ModelProfile, get_model_profile

CONTRACTS = {
    "centerOffset": ["ctScores", "ctInds", "ctY", "ctX", "majX", "majY",
                     "minL", "rad", "offX", "offY"],
    "centerSize": ["ctScores", "ctInds", "ctY", "ctX", "sizeW", "sizeH"],
    "corner": ["ctScores", "ctInds", "ctY", "ctX", "tlScores", "tlInds",
               "tlY", "tlX", "brScores", "brInds", "brY", "brX"],
    "cornerLegacy": ["(B, 1000, 8): tlX, tlY, brX, brY, score, tlScore, "
                     "brScore, category"],
}
TRACED_FORMAT = "scd-resnet-tpu-torch.traced.v1"
JAX_TRACED_FORMAT = "scd-resnet-tpu.traced.v1"


def _stacker(model: nn.Module, family: str) -> Callable:
    """The family's decode of one stack's head dict into its contract."""
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

    elif family == "centerSize":
        from scd_resnet_tpu_torch.models.center_net import decode_center_net_size

        def stack(out):
            scores, inds, ys, xs, size, _ = decode_center_net_size(out)
            return torch.stack([scores, inds.float(), ys, xs,
                                size[:, :, 0], size[:, :, 1]])

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
    return stack


class DecodedModel(nn.Module):
    """The model and its family's decode as one module: NCHW batch ->
    the stacked contract (the module ``save_traced`` exports)."""

    def __init__(self, model: nn.Module, family: str):
        super().__init__()
        self.model = model
        self.stack = _stacker(model, family)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        # decode consumes the final stack (the JAX package's choice)
        return self.stack(as_stack_list(self.model(inputs))[-1])


def make_wrapper(model: nn.Module, family: str = "centerOffset") -> Callable:
    """fn(batch NCHW) -> the family's stacked decode tensor; the callable
    carries ``.contract``, ``.rows``, ``.model`` and ``.device``."""
    decoded = DecodedModel(model, family).eval()

    def wrapped(inputs: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return decoded(inputs)

    wrapped.contract = family
    wrapped.rows = CONTRACTS[family]
    wrapped.model = model
    wrapped.device = next(model.parameters()).device
    return wrapped


def make_wrapper_for(profile: ModelProfile, state_dict: Dict[str, torch.Tensor],
                     device: str | torch.device = "cuda") -> Callable:
    """The decode wrapper of ``profile``'s model with ``state_dict``
    loaded strictly, on ``device``: the export surface ``trace`` and
    ``test -c`` use (the JAX ``make_wrapper_for``)."""
    model = profile.build()
    model.load_state_dict(state_dict, strict=True)
    return make_wrapper(model.to(resolve_device(device)), profile.family)


def load_wrapper(checkpoint_path: str, arch: str,
                 device: str | torch.device = "cuda") -> Callable:
    """Checkpoint -> decode wrapper for profile ``arch`` on ``device``
    (CUDA unless the caller asks for the CPU). The checkpoint may be the
    port's, a reference ``.pth`` or the JAX package's msgpack
    (``core/checkpoint.load_state_dict``)."""
    return make_wrapper_for(get_model_profile(arch),
                            load_state_dict(checkpoint_path, arch), device)


def save_traced(path: str, wrapper: Callable,
                input_shape: Tuple[int, ...]) -> None:
    """Export ``wrapper`` (``make_wrapper``'s) at the NCHW ``input_shape``
    on its device and write the bundle (module docstring)."""
    decoded = DecodedModel(wrapper.model, wrapper.contract).eval()
    example = torch.zeros(tuple(input_shape), dtype=torch.float32,
                          device=wrapper.device)
    with torch.no_grad():
        program = torch.export.export(decoded, (example,))
    mutated = program.graph_signature.buffers_to_mutate
    if mutated:
        raise RuntimeError("the exported program mutates buffers {} (a "
                           "BatchNorm in training mode?)".format(
                               sorted(mutated.values())))
    blob = io.BytesIO()
    torch.export.save(program, blob)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("meta.json", json.dumps({
            "format": TRACED_FORMAT,
            "input_shape": list(input_shape),
            "contract": wrapper.contract,
            "rows": CONTRACTS[wrapper.contract],
            "torch_version": torch.__version__,
            "device": wrapper.device.type,
        }))
        zf.writestr("program.pt2", blob.getvalue())


def traced_meta(path: str) -> Dict:
    """A traced bundle's ``meta.json``; the JAX package's bundles and
    anything else that is not the port's are refused."""
    with zipfile.ZipFile(path) as zf:
        meta = json.loads(zf.read("meta.json"))
    if meta.get("format") == JAX_TRACED_FORMAT:
        raise ValueError(
            "{} is a JAX StableHLO bundle ({}), which the port cannot run; "
            "export the checkpoint with python -m "
            "scd_resnet_tpu_torch.trace".format(path, JAX_TRACED_FORMAT))
    if meta.get("format") != TRACED_FORMAT:
        raise ValueError("{} is not a traced bundle of the port (format "
                         "{!r})".format(path, meta.get("format")))
    return meta


def load_traced(path: str, device: str | torch.device = "cuda"
                ) -> Tuple[Callable, Tuple[int, ...]]:
    """A traced bundle as ``(callable, input_shape)``. The callable takes
    an NCHW float32 batch of ``input_shape`` on ``device`` and returns the
    contract's rows there; it carries ``.contract``, ``.rows`` and
    ``.device``. The bundle must have been exported on a ``device`` of
    the same type."""
    device = resolve_device(device)
    meta = traced_meta(path)
    with zipfile.ZipFile(path) as zf:
        blob = zf.read("program.pt2")
    if meta["device"] != device.type:
        raise ValueError("{} was exported on {}, not {}; trace it again with "
                         "--device {}".format(path, meta["device"],
                                              device.type, device.type))
    # the operators the program may hold must be registered before loading
    from scd_resnet_tpu_torch.ops import corner_pool, dcn  # noqa: F401

    try:
        program = torch.export.load(io.BytesIO(blob))
    except Exception as exc:
        raise RuntimeError(
            "{} was written by torch {} and cannot be read by torch {}: "
            "{}".format(path, meta.get("torch_version"), torch.__version__,
                        exc)) from exc
    module = program.module()

    def call(batch: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return module(batch)

    call.contract = meta["contract"]
    call.rows = meta["rows"]
    call.device = device
    return call, tuple(meta["input_shape"])
