"""Collectives over a process group that autograd differentiates.

Each forward is one ``torch.distributed`` call; each backward is its true
adjoint (the gradient of the sum of every rank's loss):

* :func:`all_to_all`: the tiled all-to-all of ``jax.lax.all_to_all(...,
  tiled=True)`` -- ``x`` split in ``n`` along ``split_axis``, block ``i``
  sent to group rank ``i``, the received blocks concatenated along
  ``concat_axis`` in rank order; its adjoint is the reverse exchange;
* :func:`all_gather`: the group's blocks concatenated along ``dim``; its
  adjoint is a reduce-scatter (sum);
* :func:`all_reduce_mean`: ``jax.lax.pmean``; its adjoint is the mean of
  the cotangents.

and, for serving (no autograd; ``models/layers.py``'s tensor-parallel
paths), :func:`all_reduce_sum` and :func:`all_reduce_max`: every rank's
``x`` summed (or its largest value taken) element by element, in ``x``'s
dtype (the callers say which they pass).  They, and :func:`all_gather`,
are each one ``torch.distributed`` call (so ``launch.hloparse.Recorder``
records it, on meta tensors under the dry-run's fake group too), and the
identity on a group of one rank, which issues none.

A collective that fails raises (``torch.distributed``'s own errors).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import Tensor


def tiled_all_to_all(x: Tensor, group, split_axis: int,
                     concat_axis: int) -> Tensor:
    """The tiled all-to-all without autograd (one
    ``all_to_all_single``)."""
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide evenly over {n} ranks")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = (group, split_axis, concat_axis)
        return tiled_all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return (tiled_all_to_all(g, group, concat_axis, split_axis), None,
                None, None)


def all_to_all(x: Tensor, group, split_axis: int, concat_axis: int) -> Tensor:
    return _AllToAll.apply(x, group, split_axis, concat_axis)


def _gather(x: Tensor, group, dim: int) -> Tensor:
    if dist.get_world_size(group) == 1:
        return x
    return torch.cat(gather_blocks(x, group).unbind(0), dim=dim)


def gather_blocks(x: Tensor, group) -> Tensor:
    """The group's ``x`` stacked in rank order, ``(n, *x.shape)`` (one
    ``all_gather_into_tensor``; ``x`` has at least one dim)."""
    n = dist.get_world_size(group)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out.view(n, *x.shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.args = (group, dim)
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        group, dim = ctx.args
        n = dist.get_world_size(group)
        send = torch.stack(g.chunk(n, dim=dim)).contiguous()
        out = torch.empty(send.shape[1:], dtype=g.dtype, device=g.device)
        dist.reduce_scatter_tensor(out, send.flatten(0, 1), group=group)
        return out, None, None


def all_gather(x: Tensor, group, dim: int = 0) -> Tensor:
    return _AllGather.apply(x, group, dim)


def _mean(x: Tensor, group) -> Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.group), None


def all_reduce_mean(x: Tensor, group) -> Tensor:
    return _AllReduceMean.apply(x, group)


def _all_reduce(x: Tensor, group, op) -> Tensor:
    if dist.get_world_size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """The group's ``x`` summed, in ``x``'s dtype (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: Tensor, group) -> Tensor:
    """The group's ``x``, largest element by element (a new tensor)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)

