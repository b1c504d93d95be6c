"""The shared parts of the benchmark's plain reference models, in float32
PyTorch, and the lookup of a configuration's family by name.

A configuration's ``family`` names a module of this package,
``portbench/reference/<family>.py``, which exports

- ``build(config)``: the model, parameters uninitialised, its parameter
  names those of the reference's state dicts, so that one seeded state
  dict loads into it and into the system under test alike;
- ``layers(config, size)``: every convolution of one ``size``-square
  clip's forward, as ``(k, C_in, C_out, H, W)`` (``portbench/flops.py``);
- ``decode(out)`` and ``answers(parts, base_x, base_y, width, height)``:
  a served block's heat maps to per-clip rows, and the rows to the
  slide's detections (``serve.py``);
- ``CORNER_MAPS`` and ``loss(out, labels, weights)``: the training labels
  it needs and its loss (``train.py``).

So a new family is a new file. What this module holds is what the
families share: the ResNet backbone (7x7/s2 stem with a 3x3/s2 max pool,
``STAGE_BLOCKS[num_layers]`` basic blocks a stage at widths
``dims[1:5]``, three 4x4/s2 transposed convolutions to ``dims[5:8]``)
and its heads. The forward is written with ``torch.nn.functional`` so
that every convolution passes its input and weight through
``quantize(t, role)`` first (role ``input`` or ``weight``): the identity
for the reference, a rounding to a lower precision for the benchmark's
control. TF32 is off while it computes (:func:`float32_math`). BatchNorm
normalises with the batch's biased moments in training mode and with the
running statistics in eval mode (eps 1e-5); the running statistics are
not updated, since nothing compares them. The stem pool's gradient goes
to the first maximum of its window in raster order (``F.max_pool2d``'s
own rule).
"""

from __future__ import annotations

import contextlib
import importlib
from types import ModuleType
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
# basic blocks in each of the four stages, by the ResNet's depth
STAGE_BLOCKS = {10: (1, 1, 1, 1), 18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
# (k, C_in, C_out, H, W): H x W the output (the input for a transposed one)
Layer = Tuple[int, int, int, int, int]


def identity(t: torch.Tensor, role: str = "input") -> torch.Tensor:
    return t


@contextlib.contextmanager
def float32_math() -> Iterator[None]:
    """TF32 off for cuDNN's convolutions and cuBLAS's products while the
    reference computes (PyTorch lets cuDNN use TF32 by default), the
    settings restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = saved


class Conv(nn.Module):
    """Weight (and bias) of a convolution; ``transposed`` holds a
    (C_in, C_out, k, k) transposed-convolution kernel."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False,
                 transposed: bool = False):
        super().__init__()
        shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None
        self.stride, self.padding = stride, padding
        self.transposed = transposed

    def run(self, x: torch.Tensor, quantize: Callable) -> torch.Tensor:
        fn = F.conv_transpose2d if self.transposed else F.conv2d
        return fn(quantize(x, "input"), quantize(self.weight, "weight"),
                  self.bias, self.stride, self.padding)


class Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))
        self.register_buffer("running_mean", torch.empty(c))
        self.register_buffer("running_var", torch.empty(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def run(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return F.batch_norm(x, None, None, self.weight, self.bias, True,
                                0.0, BN_EPS)
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class Block(nn.Module):
    """Basic residual block: 3x3(stride)+BN+ReLU, 3x3+BN, plus the input
    or a 1x1(stride)+BN projection of it, ReLU."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride, 1)
        self.bn1 = Norm(cout)
        self.conv2 = Conv(cout, cout, 3, 1, 1)
        self.bn2 = Norm(cout)
        self.downsample = nn.ModuleList([Conv(cin, cout, 1, stride),
                                         Norm(cout)]) \
            if stride != 1 or cin != cout else None

    def run(self, x, q):
        y = torch.relu(self.bn1.run(self.conv1.run(x, q)))
        y = self.bn2.run(self.conv2.run(y, q))
        if self.downsample is not None:
            x = self.downsample[1].run(self.downsample[0].run(x, q))
        return torch.relu(y + x)


class Head(nn.Module):
    """3x3 conv (bias) + ReLU + 1x1 conv (bias), at indices 0 and 2."""

    def __init__(self, cin: int, hidden: int, cout: int):
        super().__init__()
        self.add_module("0", Conv(cin, hidden, 3, 1, 1, bias=True))
        self.add_module("2", Conv(hidden, cout, 1, bias=True))

    def run(self, x, q):
        return getattr(self, "2").run(torch.relu(getattr(self, "0").run(x, q)),
                                      q)


class Backbone(nn.Module):
    def __init__(self, dims: Sequence[int], num_layers: int):
        super().__init__()
        self.preprocess = nn.ModuleDict({"0": Conv(1, dims[0], 7, 2, 3),
                                         "1": Norm(dims[0])})
        cin = dims[0]
        for i, (cout, blocks) in enumerate(zip(dims[1:5],
                                               STAGE_BLOCKS[num_layers])):
            stage = [Block(cin, cout, 1 if i == 0 else 2)]
            stage += [Block(cout, cout, 1) for _ in range(blocks - 1)]
            self.add_module("layer{}".format(i + 1), nn.ModuleList(stage))
            cin = cout
        deconvs = {}
        for i, cout in enumerate(dims[5:8]):
            deconvs[str(3 * i)] = Conv(cin, cout, 4, 2, 1, transposed=True)
            deconvs[str(3 * i + 1)] = Norm(cout)
            cin = cout
        self.deconvolutionLayers = nn.ModuleDict(deconvs)
        self.out_features = cin

    def run(self, x, q):
        return backbone_forward(self, x, q)


def backbone_forward(m: nn.Module, x: torch.Tensor, q: Callable
                     ) -> torch.Tensor:
    """The backbone whose modules ``m`` holds under the reference's
    names."""
    x = torch.relu(m.preprocess["1"].run(m.preprocess["0"].run(x, q)))
    x = F.max_pool2d(x, 3, 2, 1)
    for i in range(1, 5):
        for block in getattr(m, "layer{}".format(i)):
            x = block.run(x, q)
    for i in range(3):
        conv = m.deconvolutionLayers[str(3 * i)]
        norm = m.deconvolutionLayers[str(3 * i + 1)]
        x = torch.relu(norm.run(conv.run(x, q)))
    return x


def conv_shape(k: int, cin: int, cout: int, side: int) -> Layer:
    return (k, cin, cout, side, side)


def backbone_layers(config: Dict, size: int
                    ) -> Tuple[List[Layer], int, int]:
    """The backbone's convolutions on a ``size``-square clip, its output
    width and side."""
    dims = config["dims"]
    side = size // 2
    out = [conv_shape(7, 1, dims[0], side)]
    side //= 2  # the stem's max pool
    cin = dims[0]
    for stage, (cout, blocks) in enumerate(zip(
            dims[1:5], STAGE_BLOCKS[config["num_layers"]])):
        if stage:
            side //= 2
        out += [conv_shape(3, cin, cout, side),
                conv_shape(3, cout, cout, side)]
        if stage or cin != cout:
            out.append(conv_shape(1, cin, cout, side))
        out += [conv_shape(3, cout, cout, side)] * (2 * (blocks - 1))
        cin = cout
    for cout in dims[5:8]:
        out.append(conv_shape(4, cin, cout, side))  # transposed: input side
        cin, side = cout, side * 2
    return out, cin, side


def head_layers(cin: int, hidden: int, cout: int, side: int) -> List[Layer]:
    """A :class:`Head`'s convolutions."""
    return [conv_shape(3, cin, hidden, side), conv_shape(1, hidden, cout, side)]


def family(name: str) -> ModuleType:
    """The module of family ``name``, ``portbench/reference/<name>.py``."""
    return importlib.import_module("portbench.reference." + name)


def build(config: Dict) -> nn.Module:
    """The reference model of a configuration (its ``family``'s)."""
    return family(config["family"]).build(config)


def layers(config: Dict, size: int) -> List[Layer]:
    """Every convolution of one ``size``-square clip's forward."""
    return family(config["family"]).layers(config, size)
