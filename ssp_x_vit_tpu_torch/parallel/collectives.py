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

Point-to-point hand-offs along a named axis (pipeline stages, the ring of
sequence parallelism) go through ``batch_isend_irecv`` with the group's
neighbours in rank order:

- :func:`exchange`: any set of sends and receives to relative neighbours as
  one batch (the 1F1B tick's four hand-offs, a ring hop's rotation);
- :func:`send_next` / :func:`recv_prev` and the reverse :func:`send_prev` /
  :func:`recv_next`; under autograd ``send_next``'s backward receives the
  cotangent from the next rank and ``recv_prev``'s sends it to the previous
  one (``_SendNext`` / ``_RecvPrev``), so a GPipe backward runs the reverse
  hand-offs by itself;
- :func:`ring_rotate`: JAX's ``ppermute`` with ``perm = [(i, (i+1) % n)]``
  (the identity at n = 1, which sends nothing), and :func:`ring_rotate_start`,
  which posts it and returns a handle to wait on, so a hop's kernel runs while
  the next chunk travels.

NCCL creates a group's communicator at its first collective, which every rank
of the group must join; :func:`warm_group` runs a one-element all-reduce
first, so the first point-to-point batch never creates it.

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


def _peer(group, offset: int) -> int:
    """The global rank ``offset`` places after this one in ``group``'s order."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return dist.get_global_rank(group, (r + offset) % n)


_WARM = set()


def warm_group(group, device) -> None:
    """One all-reduce of an element over ``group`` (once per group and process)."""
    if group is None or id(group) in _WARM:
        return
    dist.all_reduce(torch.zeros(1, device=device), group=group)
    _WARM.add(id(group))


class Pending:
    """Posted hand-offs: ``wait()`` returns the received buffers (and keeps the
    sent tensors alive until then)."""

    def __init__(self, works, sent, received):
        self.works, self.sent, self.received = works, sent, received

    def wait(self):
        for w in self.works:
            w.wait()
        self.works, self.sent = [], []
        return self.received


def exchange(sends, recvs, group) -> Pending:
    """Post ``sends`` [(tensor, offset)] and ``recvs`` [(buffer, offset)] to the
    ranks ``offset`` away in ``group`` as one ``batch_isend_irecv``."""
    sent = [t.contiguous() for t, _ in sends]
    ops = [dist.P2POp(dist.isend, t, _peer(group, off), group=group)
           for t, (_, off) in zip(sent, sends)]
    ops += [dist.P2POp(dist.irecv, buf, _peer(group, off), group=group) for buf, off in recvs]
    works = dist.batch_isend_irecv(ops) if ops else []
    return Pending(works, sent, [buf for buf, _ in recvs])


def _recv(shape, dtype, device, offset: int, group) -> torch.Tensor:
    buf = torch.empty(shape, dtype=dtype, device=device)
    exchange([], [(buf, offset)], group).wait()
    return buf


def send_prev(t: torch.Tensor, group) -> None:
    exchange([(t, -1)], [], group).wait()


def recv_next(shape, dtype, device, group) -> torch.Tensor:
    return _recv(shape, dtype, device, 1, group)


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.meta = group, (x.shape, x.dtype, x.device)
        exchange([(x.detach(), 1)], [], group).wait()
        return x.new_zeros(())

    @staticmethod
    def backward(ctx, _):
        return recv_next(*ctx.meta, ctx.group), None


class _RecvPrev(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchor, shape, dtype, group):
        ctx.group = group
        return _recv(shape, dtype, anchor.device, -1, group)

    @staticmethod
    def backward(ctx, g):
        send_prev(g, ctx.group)
        return None, None, None, None


def send_next(x: torch.Tensor, group) -> torch.Tensor:
    """Send ``x`` to the next rank of ``group``. Returns a zero scalar: under
    autograd add it to the loss, and the backward receives ``x``'s cotangent
    from the next rank there."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _SendNext.apply(x, group)
    exchange([(x, 1)], [], group).wait()
    return x.new_zeros(())


def recv_prev(shape, dtype, device, group, *, requires_grad: bool = False) -> torch.Tensor:
    """A tensor received from the previous rank of ``group``; with
    ``requires_grad`` its cotangent goes back to that rank in the backward."""
    if requires_grad and torch.is_grad_enabled():
        anchor = torch.zeros((), device=device, requires_grad=True)
        return _RecvPrev.apply(anchor, tuple(shape), dtype, group)
    return _recv(shape, dtype, device, -1, group)


def ring_rotate_start(tensors, group) -> Pending:
    """Post one ring step of a tensor or a tuple of them: each to the next
    rank, the previous rank's into new buffers (``.wait()``, in order). At one
    rank nothing travels."""
    tensors = (tensors,) if isinstance(tensors, torch.Tensor) else tuple(tensors)
    if group is None or dist.get_world_size(group) == 1:
        return Pending([], [], list(tensors))
    return exchange([(t, 1) for t in tensors], [(torch.empty_like(t), -1) for t in tensors],
                    group)


def ring_rotate(t: torch.Tensor, group) -> torch.Tensor:
    """JAX's ``ppermute(t, perm=[(i, (i + 1) % n)])`` over ``group``."""
    return ring_rotate_start(t, group).wait()[0]


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
