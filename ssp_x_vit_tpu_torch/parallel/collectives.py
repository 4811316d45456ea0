"""The collectives of the port's data, tensor and fully-sharded parallelism.

The JAX package writes none: GSPMD inserts them from the arrays' placements.
Here every collective is written where the math needs it, through these few
helpers. Each takes a process group; ``None`` means one process and returns
its input untouched, so a single-device forward runs no collective and
stays bit for bit what it was.

The tensor-parallel region follows Megatron-LM (two ``autograd.Function``
pairs):

- :func:`copy_to_tp`: identity forward, all-reduce backward. It sits where a
  replicated activation enters column-parallel weights: each rank's
  backward holds only its columns' share of the activation's gradient.
- :func:`reduce_from_tp`: all-reduce forward, identity backward. It sums the
  row-parallel partial products. ``torch.distributed.nn.functional.
  all_reduce`` is not used: its backward all-reduces again, which multiplies
  the gradients by the group size.
- :func:`gather_from_tp`: all-gather along an axis forward, this rank's
  slice backward (the vocab-sharded logits, the input of a replicated int4
  row layer).
- :func:`fsdp_gather`: all-gather along an axis forward, reduce-scatter
  backward (a fully sharded weight used inside a layer body).

``all_gather_single`` / ``reduce_scatter_single`` are taken where this
PyTorch has them (2.13 deprecates the ``*_tensor`` names), else the
``*_tensor`` names.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def _all_gather(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def all_reduce_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place (no autograd); ``t`` itself back."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def gather_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (no autograd)."""
    n = dist.get_world_size(group)
    dim = dim % t.dim()
    t = t.contiguous().reshape((1,) + tuple(t.shape))
    out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    _all_gather(out, t, group)   # rank-major along the leading axis
    return out.movedim(0, dim).flatten(dim, dim + 1)


def scatter_sum_along(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim`` of ``t`` summed over the ranks (no autograd)."""
    n = dist.get_world_size(group)
    dim = dim % t.dim()
    parts = t.unflatten(dim, (n, t.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = torch.empty((1,) + tuple(parts.shape[1:]), dtype=t.dtype, device=t.device)
    _reduce_scatter(out, parts, group)   # rank-major along the leading axis
    return out[0]


def rank_slice(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal slice of ``t`` along ``dim`` (a view)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = t.shape[dim] // n
    return t.narrow(dim, r * size, size)


class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous().clone(), ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return rank_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _FsdpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_along(g, ctx.dim, ctx.group), None, None


def copy_to_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over ``group``; in place on ``x`` (a fresh partial product)
    when no gradient flows through it."""
    if group is None:
        return x
    if not (torch.is_grad_enabled() and x.requires_grad):
        return all_reduce_sum(x.contiguous(), group)
    return _ReduceFromRegion.apply(x, group)


def gather_from_tp(x: torch.Tensor, group: Group, dim: int = -1) -> torch.Tensor:
    return x if group is None else _GatherFromRegion.apply(x, dim, group)


def fsdp_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _FsdpGather.apply(x, dim, group)
