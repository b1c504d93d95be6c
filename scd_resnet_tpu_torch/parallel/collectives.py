"""The collectives of the parallel layer, over ``torch.distributed``
process groups.

A gather is one rule, :func:`_gather`: on NCCL an
``all_gather_into_tensor``; on gloo, which reduces CUDA tensors but
gathers only CPU ones (ranks that share a card, the CPU tests), the sum
of zero-filled full-size tensors, each rank's block written at its
offset (``x + 0`` is ``x`` exactly), at about twice the bytes.
Half-precision and boolean tensors cross the wire as float32 and uint8,
exactly.

- :func:`all_reduce_sum`: differentiable sum; its backward sums the
  gradients as well, the rule for a value every rank's loss reads
  (cross-replica BatchNorm moments);
- :func:`copy_to_group` / :func:`gather_from_group`: the two halves of a
  column-parallel layer (the ``model`` axis). The input enters unchanged
  and its gradient is summed over the group (each rank's slice of output
  channels gives a part of it); the output slices are gathered and the
  gradient of a rank's slice is its block of the full gradient, which
  every rank of the group holds alike;
- :func:`gather_rows` and :func:`reduce_sum_`: plain, for results.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 1024 ** 2  # gradient all-reduce buckets


def _wire(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in (torch.bfloat16, torch.float16):
        return t.float()
    if t.dtype == torch.bool:
        return t.to(torch.uint8)
    return t


def reduce_sum_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group`` (no gradient); returns ``t``."""
    wire = _wire(t)
    dist.all_reduce(wire, group=group)
    if wire is not t:
        t.copy_(wire)
    return t


def block_pad(x: torch.Tensor, index: int, size: int, dim: int
              ) -> torch.Tensor:
    """``x`` at block ``index`` of ``size`` along ``dim``, zeros elsewhere
    (differentiable: the gradient of ``x`` is its block)."""
    n = x.shape[dim]
    parts = []
    if index:
        shape = list(x.shape)
        shape[dim] = index * n
        parts.append(x.new_zeros(shape))
    parts.append(x)
    if index < size - 1:
        shape = list(x.shape)
        shape[dim] = (size - 1 - index) * n
        parts.append(x.new_zeros(shape))
    return torch.cat(parts, dim) if len(parts) > 1 else x


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (module
    docstring: all-gather on NCCL, a padded sum on gloo)."""
    index, size = dist.get_rank(group), dist.get_world_size(group)
    if dist.get_backend(group) != dist.Backend.NCCL:
        return reduce_sum_(block_pad(x, index, size, dim).contiguous(),
                           group)
    wire = _wire(x.movedim(dim, 0)).contiguous()
    out = wire.new_empty((size * wire.shape[0],) + tuple(wire.shape[1:]))
    dist.all_gather_into_tensor(out, wire, group=group)
    return out.to(x.dtype).movedim(0, dim).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return reduce_sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, differentiable."""
    return _AllReduceSum.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return reduce_sum_(grad.clone(), ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``group``."""
    return _CopyToGroup.apply(x, group)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.dim = dim
        ctx.index, ctx.n = dist.get_rank(group), x.shape[dim]
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    gradient of this rank's block is its block of the output's gradient."""
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 (no gradient)."""
    with torch.no_grad():
        return _GatherFromGroup.apply(x, group, 0)


def sync_gradients(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum every parameter's gradient over ``group`` in buckets of about
    ``BUCKET_BYTES`` (one flat all-reduce a bucket, per device and dtype).
    A parameter without a gradient has none on any rank (the ranks run
    the same graph) and is left out."""
    buckets = {}
    for p in params:
        if p.grad is None:
            continue
        bucket = buckets.setdefault((p.grad.device, p.grad.dtype), [[0]])
        if bucket[-1][0] > BUCKET_BYTES:
            bucket.append([0])
        bucket[-1][0] += p.grad.numel() * p.grad.element_size()
        bucket[-1].append(p.grad)
    for bucket in buckets.values():
        for _, *grads in bucket:
            flat = reduce_sum_(torch.cat([g.reshape(-1) for g in grads]),
                               group)
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
