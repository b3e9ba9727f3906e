"""The collectives of the sharded BUSCA model, with their gradients
(Megatron's f and g operators and their relatives).

Every rank of a tp group computes the replicated parts of the model
identically, so a replicated tensor's gradient is the same on each of
them.  Hence:

- :func:`copy_to_group` (f): the identity forward; the backward sums the
  gradient over the group.  It stands before a column-parallel op, whose
  ranks each see a part of the input's gradient.
- :func:`reduce_from_group` (g): the forward sums the partial results over
  the group; the backward is the identity.  It ends a row-parallel op.
- :func:`gather_channels`: the forward concatenates each rank's channel
  block (dim 1); the backward keeps the rank's own block.  A split
  convolution's output goes whole into the next layer through it.
- :func:`all_reduce_sum`: sums over a group forward and backward, for
  statistics whose every rank's share enters every rank's loss (the dp
  ranks' BN sums: the loss summed over dp depends on each rank's share
  through the global statistics).

All of them take a ``ProcessGroup`` and run its backend's collective
(gloo on the CPU, NCCL on the card).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        ctx.width = x.shape[1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.width, ctx.width), None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over ``group`` (Megatron's f)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward, identity backward (Megatron's g)."""
    return _ReduceFromGroup.apply(x, group)


def gather_channels(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's channel block ``[N, C / n, ...]`` concatenated along
    dim 1 in rank order; the backward keeps this rank's block."""
    return _GatherChannels.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group``, forward and backward."""
    return _AllReduceSum.apply(x, group)
