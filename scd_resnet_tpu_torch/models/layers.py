"""Building blocks: BatchNorm, Conv+BN+ReLU, the 7x7/s2 stem, the 2x2
max pool, and activation rematerialisation.

Counterpart of ``scd_resnet_tpu/models/layers.py``, NCHW. The stem's max
pool takes its backward from the port's kernel (``ops/max_pool.py``).
:func:`checkpointed` is the counterpart of flax's ``nn.remat``: a
module's activations are recomputed in the backward instead of stored,
and the recompute leaves the BatchNorm statistics alone, as flax drops
the recompute's state updates.
In eval mode
BatchNorm normalises with its running statistics exactly as flax's
``use_running_average=True`` does (eps 1e-5). In training mode it keeps
flax's running statistics, which differ from ``nn.BatchNorm2d``'s: see
:class:`BatchNorm`.
The JAX stem conv is a space-to-depth lowering of a 7x7/s2/p3 conv; here
it is that plain conv, with the same kernel.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from scd_resnet_tpu_torch.core.profiling import span
from scd_resnet_tpu_torch.ops.max_pool import max_pool_3x3_s2
from scd_resnet_tpu_torch.parallel.collectives import all_reduce_sum, block_pad

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch convention; flax's 0.9
# set on the thread that recomputes a checkpointed forward (the autograd
# engine's thread for CUDA tensors)
_RECOMPUTE = threading.local()


@contextlib.contextmanager
def recomputing():
    """While active on this thread, training-mode BatchNorms normalise as
    usual but leave their running statistics and ``num_batches_tracked``
    alone."""
    before = getattr(_RECOMPUTE, "active", False)
    _RECOMPUTE.active = True
    try:
        yield
    finally:
        _RECOMPUTE.active = before


def autocast_off(device_type: str):
    """A region that computes in its inputs' types under autocast: the
    context that disables autocast where it is on, else nothing (so an
    exported model, traced with autocast off, holds no autocast region)."""
    if torch.is_autocast_enabled(device_type):
        return torch.autocast(device_type, enabled=False)
    return contextlib.nullcontext()


def checkpointed(fn, *args, enabled: bool = True):
    """``fn(*args)`` with its activations recomputed in the backward
    (``torch.utils.checkpoint``, non-reentrant), the recompute under
    :func:`recomputing`, so each BatchNorm's statistics move once a step,
    as under flax's ``nn.remat``. A plain call when not ``enabled`` or
    when no gradient is recorded (validation, serving). The models draw
    no random numbers, so no RNG state is stashed."""
    if not (enabled and torch.is_grad_enabled()):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recomputing()))


class BatchNorm(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training-mode update keeps flax's running
    statistics (``scd_resnet_tpu/models/layers.BatchNorm``, flax
    ``nn.BatchNorm(momentum=0.9)``):

        running_mean = 0.9 running_mean + 0.1 mean(x)
        running_var  = 0.9 running_var  + 0.1 var(x),  var biased (/ n)

    ``nn.BatchNorm2d`` puts the unbiased variance (/ (n - 1)) into
    ``running_var``. The batch is normalised by its biased variance
    either way, and eval mode and the state-dict names are
    ``nn.BatchNorm2d``'s, so reference ``.pth`` files load with
    ``strict=True``.

    The batch moments come from the same fused ``F.batch_norm`` call that
    normalises the batch (into scratch buffers, momentum 1); the unbiased
    variance is then scaled by (n - 1) / n. Under :func:`recomputing`
    the statistics are not touched.

    ``process_group`` (set by the trainer on a ``data`` mesh axis of more
    than one rank) makes the training-mode moments those of the global
    batch, as the JAX step's BatchNorm over a data-sharded batch: each
    rank's per-channel count, mean and M2 are summed over the group by
    a differentiable all-reduce (a ``scd.collective.bn_stats`` span under
    a profiler) and combined in rank order, the batch is
    normalised by the global biased variance in float32, and the running
    statistics move by the global moments. Every rank must run the same
    BatchNorms in the same order, a recompute's included. Without a
    group the fused path above runs."""

    process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.process_group is not None:
            return self._cross_replica(x)
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0,
                         self.eps)
        if getattr(_RECOMPUTE, "active", False):
            return y
        n = x.numel() // x.shape[1]
        with torch.no_grad():  # mean and var are saved for the backward
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var * ((n - 1) / n), alpha=self.momentum)
            self.num_batches_tracked.add_(1)
        return y

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        group = self.process_group
        size = dist.get_world_size(group)
        xf = x.float()
        n = xf.numel() // xf.shape[1]
        var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
        row = torch.stack([torch.full_like(mean, n), mean, var * n])
        with span("scd.collective.bn_stats"):
            stats = all_reduce_sum(block_pad(
                row[None], dist.get_rank(group), size, 0), group)
        counts, means, m2s = stats.unbind(1)  # (ranks, C) each
        total = counts.sum(0)
        mean = (counts * means).sum(0) / total
        var = (m2s + counts * (means - mean) ** 2).sum(0) / total
        scale = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * scale[:, None, None] \
            + self.bias[:, None, None]
        if not getattr(_RECOMPUTE, "active", False):
            with torch.no_grad():
                self.running_mean.mul_(1.0 - self.momentum).add_(
                    mean, alpha=self.momentum)
                self.running_var.mul_(1.0 - self.momentum).add_(
                    var, alpha=self.momentum)
                self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


def batch_norm(features: int) -> BatchNorm:
    return BatchNorm(features, eps=BN_EPS, momentum=BN_MOMENTUM)


def conv3x3(in_features: int, features: int, stride: int = 1,
            bias: bool = False) -> nn.Conv2d:
    """3x3 conv, pad 1 (models/backbones/utility.py:125-127)."""
    return nn.Conv2d(in_features, features, 3, stride, 1, bias=bias)


def conv1x1(in_features: int, features: int, stride: int = 1,
            bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(in_features, features, 1, stride, 0, bias=bias)


class ConvBlock(nn.Module):
    """k x k same-size Conv -> BN -> ReLU (convolutions.py:25-49);
    ``with_bn=False`` drops the BN and gives the conv a bias."""

    def __init__(self, in_features: int, features: int,
                 kernel_size: int = 3, stride: int = 1,
                 with_bn: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(in_features, features, kernel_size, stride,
                              (kernel_size - 1) // 2, bias=not with_bn)
        self.bn = batch_norm(features) if with_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x)


def max_pool_2x2_s2(x: torch.Tensor) -> torch.Tensor:
    """2x2/s2 max pool, ``nn.MaxPool2d(2, 2)`` (hourglass.py:46; the JAX
    package's reduce-window, no Pallas kernel)."""
    return F.max_pool2d(x, 2, 2)


class StemMaxPool(nn.Module):
    """``nn.MaxPool2d(3, 2, 1)``'s forward; its backward is the port's
    kernel (``ops/max_pool.MaxPool3x3S2``). No parameters, no state."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool_3x3_s2(x)


def stem(features: int) -> nn.Sequential:
    """7x7/s2/p3 conv + BN + ReLU + 3x3/s2/p1 max pool
    (residuals.py:210-215); indices 0/1 carry the reference's
    ``preprocess.{0,1}`` state-dict names."""
    return nn.Sequential(
        nn.Conv2d(1, features, 7, 2, 3, bias=False),
        batch_norm(features),
        nn.ReLU(),
        StemMaxPool(),
    )
