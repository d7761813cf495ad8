"""A named mesh axis as a process group, and the differentiable
collectives the parallel modules run over it.

The reference names a mesh axis inside ``shard_map`` and calls
``ppermute``, ``all_to_all`` and ``psum`` on it; JAX differentiates them.
Here an :class:`Axis` is ``size`` ranks of the run's process group, this
rank at ``index``, with the port's :class:`~consensusml_tpu_torch.comm.
transport.Transport` over their subgroup (``exchange`` and
``all_reduce_sum``), and each collective that a gradient crosses is a
``torch.autograd.Function`` whose backward is the collective's transpose:

- :func:`ppermute`: a cyclic shift by ``shift`` (route ``(i + shift, i -
  shift)``); backward, the shift back;
- :func:`all_to_all`: the reference's ``all_to_all(tiled=True)``;
  backward, the all-to-all that undoes it;
- :func:`copy_to`: identity forward, all-reduce backward (a replicated
  activation entering a split computation), and :func:`reduce_from`, the
  converse (a split computation's partial sums leaving it): Megatron's
  ``f`` and ``g``. Their sums run in f32 and are cast back;
- :func:`gather_to`: the pieces of a tensor split along a dim, whole on
  every rank (an all-gather), for a consumer that every rank runs alike
  (a gathered embedding table): backward, each rank keeps its piece of
  the gradient, which is the same on every rank.

Every rank of the world takes part in making every axis's subgroup
(:func:`make_axes`), as ``torch.distributed.new_group`` requires.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from consensusml_tpu_torch.comm.transport import Transport, make_transport

__all__ = ["Axis", "make_axes", "ppermute", "all_to_all", "all_gather", "copy_to", "reduce_from", "gather_to",
           "all_reduce_sum"]


@dataclasses.dataclass(frozen=True)
class Axis:
    """``size`` ranks of one mesh axis, this rank at ``index``, over
    ``transport`` (whose group ranks are the axis indices)."""

    name: str
    index: int
    size: int
    transport: Transport

    def route(self, shift: int) -> tuple[int, int]:
        """``(dst, src)`` of a cyclic shift by ``shift``: send to ``i +
        shift``, receive from ``i - shift``."""
        return (self.index + shift) % self.size, (self.index - shift) % self.size


def make_axes(name: str, members: list[list[int]], rank: int, device, dist_backend: str = "gloo") -> Axis:
    """The :class:`Axis` of ``rank`` among ``members`` (each a list of world
    ranks, in axis order; together a partition of the world). Every rank
    must call this with the same ``members``: each list's subgroup is made
    by all of them."""
    mine = None
    for ranks in members:
        group = dist.new_group(ranks=list(ranks), backend=dist_backend)
        if rank in ranks:
            mine = (group, list(ranks))
    if mine is None:
        raise ValueError(f"rank {rank} is in none of the {name!r} axis groups {members}")
    group, ranks = mine
    index = ranks.index(rank)
    transport = make_transport(dist_backend, group, index, torch.device(device), ranks)
    return Axis(name=name, index=index, size=len(ranks), transport=transport)


def all_reduce_sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``x`` summed over the axis, in f32, cast back to ``x``'s dtype."""
    if axis.size == 1:
        return x
    return axis.transport.all_reduce_sum([x.float()])[0].to(x.dtype)


def _shift(x: torch.Tensor, axis: Axis, shift: int) -> torch.Tensor:
    if axis.size == 1 or shift % axis.size == 0:
        return x
    return axis.transport.exchange([x.contiguous()], [axis.route(shift)])[0][0]


def all_gather(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (one shape on all), concatenated along ``dim`` in
    rank order: ``size - 1`` shifts, all posted before any is waited on."""
    if axis.size == 1:
        return x
    x = x.contiguous()
    got: list = [None] * axis.size
    got[axis.index] = x
    posted = [(axis.route(s)[1], axis.transport.exchange_start([x], [axis.route(s)])) for s in range(1, axis.size)]
    for src, inflight in posted:
        got[src] = inflight.wait()[0][0]
    return torch.cat(got, dim=dim)


class _GatherTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim, ctx.n = axis, dim, x.shape[dim]
        return all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n), None, None


def gather_to(x: torch.Tensor, axis: Axis | None, dim: int) -> torch.Tensor:
    """The whole of a tensor split along ``dim`` over the axis, on every
    rank; its gradient is taken to be the same on every rank (a consumer
    every rank runs alike), so each keeps its own piece of it."""
    if axis is None or axis.size == 1:
        return x
    return _GatherTo.apply(x, axis, dim)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return _shift(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.axis, -ctx.shift), None, None


def ppermute(x: torch.Tensor, axis: Axis, shift: int = 1) -> torch.Tensor:
    """The value ``shift`` ranks back along the axis, cyclically: rank
    ``i`` receives rank ``i - shift``'s ``x`` (the reference's ``ppermute``
    with ``perm = [(i, i + shift)]``). Differentiable."""
    return _Ppermute.apply(x, axis, shift)


def _all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    p = axis.size
    if x.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split into {p}")
    chunks = [c.contiguous() for c in x.chunk(p, dim=split_dim)]
    got: list = [None] * p
    got[axis.index] = chunks[axis.index]
    posted = []
    for s in range(1, p):
        dst, src = axis.route(s)
        posted.append((src, axis.transport.exchange_start([chunks[dst]], [(dst, src)])))
    for src, inflight in posted:
        got[src] = inflight.wait()[0][0]
    return torch.cat(got, dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, split_dim, concat_dim)
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(g.contiguous(), axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The reference's ``all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into ``size`` pieces along ``split_dim``,
    piece ``j`` sent to rank ``j``, the pieces received concatenated along
    ``concat_dim`` in rank order. Differentiable."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """Identity forward, all-reduce backward: a value every rank of the
    axis holds whole, entering work split over it."""
    if axis is None or axis.size == 1:
        return x
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of work
    split over the axis, leaving it whole on every rank."""
    if axis is None or axis.size == 1:
        return x
    return _ReduceFrom.apply(x, axis)
