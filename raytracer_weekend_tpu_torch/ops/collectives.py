"""Sums and gathers over one axis of the render mesh (torch.distributed).

The primitives the geometry axis of the staged trace (`integrator`) and the
shard body (`parallel.shard`) run, kept apart from `parallel.mesh`, which
sets up the process groups and places the ranks: a mesh axis reaches them
as an `Axis`, its size, this rank's index along it and its process group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as a rank sees it: its size, the rank's index along it
    and the process group of the ranks on it (None where the size is 1)."""

    size: int
    index: int
    group: object = None


class _AllSum(torch.autograd.Function):
    """Sum over a process group; its backward sums the cotangents over the
    same group (the adjoint of y_i = sum_j x_j)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Sum of `x` over the axis, the same on every rank of it. A float
    tensor that needs a gradient goes through `_AllSum`; anything else is
    summed without autograd. The identity on an axis of size 1."""
    if axis.size == 1:
        return x
    if x.requires_grad:
        return _AllSum.apply(x, axis.group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=axis.group)
    return y


def gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(size, *x.shape): row i holds rank i's `x`, on every rank, with no
    gradient. torch's gloo backend has no all_gather for CUDA tensors, so
    this is an all_reduce of a zero-filled buffer in which each rank fills
    its own row (+inf + 0 stays +inf): one code path for gloo and nccl."""
    if axis.size == 1:
        return x.detach()[None]
    buf = torch.zeros((axis.size, *x.shape), dtype=x.dtype, device=x.device)
    buf[axis.index] = x.detach()
    dist.all_reduce(buf, group=axis.group)
    return buf
