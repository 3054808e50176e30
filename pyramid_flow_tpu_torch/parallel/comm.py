"""The differentiable collectives the parallel paths share.

``all_to_all`` is ``torch.distributed.nn.functional.all_to_all_single``
(its backward is the same exchange with the roles swapped). ``all_gather``
is this module's own :class:`AllGather`: torch's differentiable all_gather
emulates its backward on gloo with ``scatter`` calls that name the source
by its rank in the group where the global rank is expected, which fails on
every subgroup that does not hold global ranks ``0 .. n-1`` (the sp groups
of a mesh with dp or fsdp above 1). Its backward here is one
``all_to_all_single`` and a sum, on every backend.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

__all__ = ["all_gather", "all_to_all", "slot", "AllGather"]


class AllGather(torch.autograd.Function):
    """``x`` on every rank of ``group`` -> ``[n, *x.shape]``, rank order.
    The gradient of a rank's ``x`` is the sum over ranks of their gradient
    of its slot."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.stack(out)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        recv = torch.empty_like(grad)  # recv[j]: rank j's grad of my slot
        dist.all_to_all_single(recv, grad, group=ctx.group)
        return recv.sum(0), None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all_gather: ``[n, *x.shape]`` in rank order."""
    return AllGather.apply(x, group)


class _ZerosOf(torch.autograd.Function):
    """Zeros shaped like one slot of ``gathered``, on its graph."""

    @staticmethod
    def forward(ctx, gathered):
        ctx.shape = gathered.shape
        return gathered.new_zeros(gathered.shape[1:])

    @staticmethod
    def backward(ctx, grad):
        return grad.new_zeros(ctx.shape)


def slot(gathered: torch.Tensor, index: int) -> torch.Tensor:
    """Slot ``index`` of an :func:`all_gather` result, or zeros where there
    is no such rank. The zeros stay on the gather's graph: its backward is
    a collective, so every rank must run it, also the one that uses none of
    the slots (the first rank's halo, the last rank's next frame)."""
    if 0 <= index < gathered.shape[0]:
        return gathered[index]
    return _ZerosOf.apply(gathered)


def all_to_all(x: torch.Tensor, group, scatter_dim: int, gather_dim: int
               ) -> torch.Tensor:
    """Differentiable all_to_all over ``group``: split ``scatter_dim`` into
    one chunk per rank, send chunk ``j`` to rank ``j``, and concatenate what
    arrives along ``gather_dim``."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=scatter_dim)).contiguous()
    recv = dist_fn.all_to_all_single(torch.empty_like(send), send,
                                     group=group)
    return torch.cat(recv.unbind(0), dim=gather_dim)
